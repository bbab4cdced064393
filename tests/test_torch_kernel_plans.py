"""The decompositions of the port's two hand kernels, held to JAX.

The CUDA kernels run only on the card, so their index arithmetic is
modelled here in numpy from the same plan (`kernels/checksum.py`) and the
same lane and multiplier layout (`csrc/integrity_word.cu`), and the
models are held bit-equal to the JAX functions: B1 cut into segments
with look-back carries and per-segment b parts summed with a 32-bit
wrap, B2 cut into a peeled head, 16-byte vectors and a tail. All data is
uint32, so the tolerance is zero. The tests marked `cuda` hold the
kernels against their plain versions on the card, on ragged, misaligned
and few-long-row inputs, and skip where there is no card.
"""
import json
import os
import re

import numpy as np
import pytest
import torch

from brpc_tpu_torch.convert import words_from_numpy, words_to_numpy
from brpc_tpu_torch.kernels import _build
from brpc_tpu_torch.kernels.checksum import (Plan, adler_frame_checksum,
                                             adler_frame_checksum_ref, plan,
                                             thread_ranges)
from brpc_tpu_torch.kernels.integrity import integrity_word, integrity_word_ref

_RNG = np.random.default_rng(4321)
_M32 = 0xFFFFFFFF
_MOD = 65521


def _jax_checksum(arr):
    import jax.numpy as jnp

    from brpc_tpu.parallel.collective_echo import _adler_frame_checksum
    return np.asarray(_adler_frame_checksum(jnp.asarray(arr)))


def _jax_integrity_word(arr):
    import jax.numpy as jnp

    from brpc_tpu.device_path import _integrity_word
    return int(_integrity_word(jnp.asarray(arr)))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device found")
    return torch.device("cuda")


# --- B1: the kernel's decomposition in numpy --------------------------

def _halves(words):
    w = words.astype(np.int64)
    return np.stack([w & 0xFFFF, w >> 16], axis=-1).reshape(-1)


def _look_back(flags, seg):
    """The kernel's look-back: windows of 32 predecessors, each adding
    totals back to the nearest inclusive prefix (status 2)."""
    carry, end = 0, seg
    while True:
        window = [flags[j] if j >= 0 else (2, 0)
                  for j in range(end - 1, end - 33, -1)]
        status = [s for s, _ in window]
        first = status.index(2) if 2 in status else 31
        assert all(s != 0 for s in status[:first + 1])
        carry = (carry + sum(v for _, v in window[:first + 1])) & _M32
        if 2 in status:
            return carry
        end -= 32


def _model_b1(arr, p, rng):
    """B1 as the kernel computes it under plan `p`. Steps (segments) run
    in ticket order; when a segment looks back, segment 0 has published
    its inclusive prefix and each later predecessor either its total or
    its inclusive prefix, at random."""
    batch, n = arr.shape
    out = np.zeros(batch, np.uint32)
    for row in range(batch):
        ranges = {}
        for step, t, start, stop in thread_ranges(p, n, row):
            ranges.setdefault(step, []).append((start, stop))
        totals, inclusive, b_row, carry = {}, {}, 0, 0
        for step in sorted(ranges):
            halves = [_halves(arr[row, s:e]) if e > s else np.zeros(0, np.int64)
                      for s, e in ranges[step]]
            step_total = sum(int(h.sum()) for h in halves) & _M32
            if p.layout == "split":
                flags = {j: (2, inclusive[j]) if j == 0 or rng.random() < 0.05
                         else (1, totals[j]) for j in range(step)}
                carry = _look_back(flags, step) if step else 0
                totals[step] = step_total
                inclusive[step] = (carry + step_total) & _M32
            b_step, run = 0, carry
            for h in halves:  # thread by thread, in scan order
                s1 = (run + np.cumsum(h)) & _M32
                b_step = (b_step + int((s1 % _MOD).sum())) & _M32
                run = (run + int(h.sum())) & _M32
            b_row = (b_row + b_step) & _M32  # one atomicAdd per step
            if p.layout == "warp":
                carry = (carry + step_total) & _M32
        s_end = inclusive[max(inclusive)] if p.layout == "split" else carry
        out[row] = ((b_row % _MOD) << 16) | (s_end % _MOD)
    return out


def _small(layout, threads, vecs, off, batch, n):
    """A plan with a small geometry, so that short rows cut into many
    steps; `segs_per_row` as `plan` computes it."""
    p = Plan(layout, off, threads, vecs, 1, 0)
    if layout == "split":
        head = max((r * n + off) % 4 for r in range(min(batch, 4)))
        p = p._replace(segs_per_row=-(-(head + n) // p.step_words))
    return p


B1_MODEL_CASES = {
    # name: (plan geometry, batch, n)
    "split 32-word segments cut rows mid-row": (("split", 4, 2), 3, 301),
    "split one-word last segment": (("split", 4, 2), 2, 97),
    "split odd word counts, >32 segments (two look-back windows)":
        (("split", 2, 1), 2, 555),
    "split one segment a row": (("split", 8, 4), 5, 77),
    "warp tiles of 16 words, ragged rows": (("warp", 2, 2), 4, 61),
    "warp one tile a row": (("warp", 32, 8), 3, 1000),
}


@pytest.mark.parametrize("off", [0, 1, 2, 3])
@pytest.mark.parametrize("case", list(B1_MODEL_CASES))
def test_b1_decomposition_matches_jax(case, off):
    (layout, threads, vecs), batch, n = B1_MODEL_CASES[case]
    arr = _RNG.integers(0, 2**32, (batch, n), dtype=np.uint32)
    p = _small(layout, threads, vecs, off, batch, n)
    rng = np.random.default_rng(off)
    np.testing.assert_array_equal(_model_b1(arr, p, rng), _jax_checksum(arr))


@pytest.mark.parametrize("shape", [(5, 8193), (2, 12345)])
def test_b1_decomposition_at_the_kernel_geometry(shape):
    """The kernel's own plan: (5, 8193) leaves a one-word last segment
    at off 0, (2, 12345) is odd."""
    arr = _RNG.integers(0, 2**32, shape, dtype=np.uint32)
    want = _jax_checksum(arr)
    for off in range(4):
        p = plan(*shape, off)
        assert p.layout == "split"
        np.testing.assert_array_equal(
            _model_b1(arr, p, np.random.default_rng(off)), want)


def test_b1_all_ones_1mib_row_through_the_model():
    arr = np.full((1, 262144), 0xFFFFFFFF, np.uint32)
    got = _model_b1(arr, plan(1, 262144, 0), np.random.default_rng(0))
    assert int(got[0]) == 0x31DD0069


@pytest.mark.parametrize("shape", [(8, 1024), (4096, 1024), (3, 4097),
                                   (32, 262144), (256, 262144), (1, 262147)])
def test_b1_plan_covers_every_word_once(shape):
    """A row's ranges depend on the row only through its head, (row * n
    + off) % 4, which repeats every 4 rows: rows 0-7 and the last one
    stand for all."""
    batch, n = shape
    for off in range(4):
        p = plan(batch, n, off)
        assert p.layout == ("warp" if n <= 4096 else "split")
        for row in sorted({*range(min(batch, 8)), batch - 1}):
            r = np.array([(s, e) for _, _, s, e in thread_ranges(p, n, row)
                          if e > s])
            assert r[0, 0] == 0 and r[-1, 1] == n
            # In scan order, each range starts where the last one stopped.
            assert (r[1:, 0] == r[:-1, 1]).all()


def test_b1_plan_layouts():
    assert plan(8, 1024, 0) == Plan("warp", 0, 32, 8, 1, 0)
    assert plan(4096, 1024, 0) == Plan("warp", 0, 32, 4, 8, 0)
    p = plan(256, 262144, 0)
    assert (p.layout, p.segs_per_row, p.step_words) == ("split", 32, 8192)
    # A head before the row's first word can add a segment.
    assert plan(1, 262144, 1).segs_per_row == 33
    assert plan(32, 262144, 0).segs_per_row == 32


# --- B2: vector lanes and multipliers in numpy ------------------------

def _model_b2(words, off, cluster=16, threads=1024, unroll=8):
    """B2 as the kernel computes it: `head` scalar words up to the first
    16-byte boundary, uint4 vectors strided over the cluster's threads
    in rounds of `unroll`, lanes x..w taking 2i+1..2i+7, then the tail;
    per-thread sums, per-block partials and the cluster's sum, all
    wrapping."""
    n = words.size
    head = min(n, (4 - off) % 4)
    n_vec = (n - head) // 4
    w = words.astype(np.uint64)
    vec = w[head:head + 4 * n_vec].reshape(-1, 4)
    m = (2 * (head + 4 * np.arange(n_vec, dtype=np.uint64)) + 1) & _M32
    lanes = np.stack([m, m + 2, m + 4, m + 6], axis=1) & _M32
    per_vec = ((vec * lanes) & _M32).sum(axis=1) & _M32
    stride = cluster * threads
    thread_acc = np.zeros(stride, np.uint64)
    np.add.at(thread_acc, np.arange(n_vec) % stride, per_vec)
    scalars = list(range(head)) + list(range(head + 4 * n_vec, n))
    for i in scalars:  # threads 0-7 of cluster rank 0
        thread_acc[0] += (int(w[i]) * (2 * i + 1)) & _M32
    blocks = (thread_acc & _M32).reshape(cluster, threads).sum(axis=1) & _M32
    return int(blocks.sum()) & _M32


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 130048, 261121, 523264])
@pytest.mark.parametrize("off", [0, 1, 2, 3])
def test_b2_decomposition_matches_jax(n, off):
    arr = _RNG.integers(0, 2**32, n, dtype=np.uint32)
    want = _jax_integrity_word(arr) if n else 0
    assert _model_b2(arr, off) == want
    assert _model_b2(arr, off, cluster=8) == want


# --- the build's staleness check --------------------------------------

def test_kernel_library_is_stale_after_a_header_or_flag_change(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// kernel")
    header = csrc / "k.cuh"
    header.write_text("// shared")
    so, stamp = tmp_path / "lib.so", tmp_path / "lib.so.flags"
    flags = ["-O3", "-gencode", "arch=compute_90a,code=sm_90a"]
    assert _build.stale(so, stamp, csrc, flags)  # nothing built yet
    so.write_bytes(b"")
    stamp.write_text(json.dumps(flags))
    t = so.stat().st_mtime
    os.utime(csrc / "k.cu", (t - 10, t - 10))
    os.utime(header, (t - 10, t - 10))
    assert not _build.stale(so, stamp, csrc, flags)
    assert _build.stale(so, stamp, csrc, flags + ["-lineinfo"])
    os.utime(header, (t + 10, t + 10))
    assert _build.stale(so, stamp, csrc, flags)


# --- on the card ------------------------------------------------------

def _misaligned(arr, dev):
    """A contiguous view of `arr` on the card that starts one word into
    its storage."""
    flat = words_from_numpy(np.concatenate([np.zeros(1, np.uint32),
                                            arr.reshape(-1)]), dev)
    return flat[1:].view(arr.shape)


B1_CARD_CASES = {
    "random(32,262144)": lambda: _RNG.integers(0, 2**32, (32, 262144),
                                               dtype=np.uint32),
    "random(5,262147)": lambda: _RNG.integers(0, 2**32, (5, 262147),
                                              dtype=np.uint32),
    "ones(3,8193)": lambda: np.full((3, 8193), 0xFFFFFFFF, np.uint32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("case", list(B1_CARD_CASES) + ["random(7,1021)"])
def test_b1_kernel_on_ragged_and_misaligned_rows(case, aligned):
    dev = _cuda()
    arr = (B1_CARD_CASES[case]() if case in B1_CARD_CASES
           else _RNG.integers(0, 2**32, (7, 1021), dtype=np.uint32))
    x = words_from_numpy(arr, dev) if aligned else _misaligned(arr, dev)
    assert (x.data_ptr() % 16 == 0) == aligned
    before = adler_frame_checksum.launches
    got = words_to_numpy(adler_frame_checksum(x))
    assert adler_frame_checksum.launches == before + 1
    np.testing.assert_array_equal(got, words_to_numpy(adler_frame_checksum_ref(x)))


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n", [523264, 261121, 3, 0])
def test_b2_kernel_on_long_ragged_and_misaligned_chunks(n, aligned):
    dev = _cuda()
    arr = _RNG.integers(0, 2**32, n, dtype=np.uint32)
    x = words_from_numpy(arr, dev) if aligned else _misaligned(arr, dev)
    before = integrity_word.launches
    got = words_to_numpy(integrity_word(x))
    assert integrity_word.launches == before + 1
    assert got == words_to_numpy(integrity_word_ref(x))


@pytest.mark.cuda
def test_b2_is_one_kernel_launch_per_call(tmp_path):
    """A call captured in a CUDA graph holds one kernel node and no
    memset or fill: the kernel writes its word itself."""
    dev = _cuda()
    x = words_from_numpy(_RNG.integers(0, 2**32, 261120, dtype=np.uint32), dev)
    integrity_word(x)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)  # keeps it for debug_dump
    g.enable_debug_mode()
    with torch.cuda.graph(g):
        word = integrity_word(x)
    dot = tmp_path / "b2.dot"
    g.debug_dump(str(dot))
    text = dot.read_text()
    assert len(re.findall(r"\bKERNEL\b", text)) == 1
    assert "integrity_word" in text and "MEMSET" not in text
    g.replay()
    assert words_to_numpy(word) == words_to_numpy(integrity_word_ref(x))
