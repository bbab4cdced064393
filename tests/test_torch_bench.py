"""The port's benchmark (bench_torch, BENCHMARK.json) on the CPU.

Its references agree with the JAX functions; a wrong output makes a
cell incorrect; inputs come from the seed; its byte counts equal a count
by hand; it imports no JAX and runs on no CPU by itself. The cells run
here only at a small size, on CPU tensors, through the same code the
card runs. The device path runs in a subprocess: a test worker may hold
the JAX package's libtpurpc, and the port loads its own.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_torch import bounds, cells, reference
from bench_torch.kinds import device_path as dp_kind
from bench_torch.kinds import echo_step as echo_kind
from bench_torch.__main__ import main as bench_main
from brpc_tpu_torch.convert import words_from_numpy
from brpc_tpu_torch.parallel.collective_echo import echo_step

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
DEVICE_PATH = "device_path-256MiB-1020KiB-d4"
ECHO = "echo_step-256x1MiB"
# The cells at a size the CPU runs in seconds.
SMALL = {DEVICE_PATH: {"payload_mb": 4, "chunk_kb": 508, "reps": 4},
         ECHO: {"batch": 4, "words": 4096, "calls": 30}}

_RNG = np.random.default_rng(4321)
B1_CASES = {
    "random(4,262144)": _RNG.integers(0, 2**32, (4, 262144), dtype=np.uint32),
    "ones(2,262144)": np.full((2, 262144), 0xFFFFFFFF, np.uint32),
    "random(8,1024)": _RNG.integers(0, 2**32, (8, 1024), dtype=np.uint32),
    "random(3,4097)": _RNG.integers(0, 2**32, (3, 4097), dtype=np.uint32),
}
B2_CASES = {
    "random(3,130048)": _RNG.integers(0, 2**32, (3, 130048), dtype=np.uint32),
    "ones(2,261120)": np.full((2, 261120), 0xFFFFFFFF, np.uint32),
    "random(4,7)": _RNG.integers(0, 2**32, (4, 7), dtype=np.uint32),
}


def small(cell, config=cells.config):
    return {**config(cell), **SMALL[cell]}


@pytest.mark.parametrize("case", list(B1_CASES))
def test_frame_checksum_reference_matches_jax(case):
    import jax.numpy as jnp

    from brpc_tpu.parallel.collective_echo import _adler_frame_checksum
    arr = B1_CASES[case]
    want = np.asarray(_adler_frame_checksum(jnp.asarray(arr)))
    np.testing.assert_array_equal(reference.frame_checksums(arr), want)


def test_frame_checksum_reference_wraps_b_at_32_bits():
    """On an all-ones 1 MiB row JAX's b sum wraps at 32 bits; without the
    wrap (the C++ and numpy twins) the checksum reads 0x34800069."""
    row = np.full((1, 262144), 0xFFFFFFFF, np.uint32)
    assert int(reference.frame_checksums(row)[0]) == 0x31DD0069


@pytest.mark.parametrize("case", list(B2_CASES))
def test_integrity_reference_matches_jax(case):
    import jax.numpy as jnp

    from brpc_tpu.device_path import _integrity_word
    chunks = B2_CASES[case]
    want = [int(_integrity_word(jnp.asarray(c))) for c in chunks]
    assert reference.integrity_words(chunks).tolist() == want


CRC_CASES = {
    "random(3,4096)": _RNG.integers(0, 2**32, (3, 4096), dtype=np.uint32),
    "random(2,261120)": _RNG.integers(0, 2**32, (2, 261120), dtype=np.uint32),
    "random(5,1)": _RNG.integers(0, 2**32, (5, 1), dtype=np.uint32),
}


def test_crc32c_reference_rfc3720_vectors():
    def one(data):
        return int(reference.crc32c_rows(
            np.frombuffer(data, np.uint32).reshape(1, -1))[0])
    assert one(b"12345678") == 0x6087809A
    assert one(bytes(32)) == 0x8A9136AA
    assert one(b"\xff" * 32) == 0x62A8AB43
    assert one(bytes(range(32))) == 0x46DD794E


@pytest.mark.parametrize("case", list(CRC_CASES))
def test_crc32c_reference_matches_the_frameworks(case, cpp_build):
    """The reference against the JAX package's bridge to the framework's
    crc32c, the one its device path frames and verifies with (it loads
    build/libtpurpc.so, so the build comes first)."""
    from brpc_tpu import native
    rows = CRC_CASES[case]
    assert reference.crc32c_rows(rows).tolist() == [native.crc32c(r)
                                                    for r in rows]


def test_references_import_nothing_of_the_port():
    text = (REPO / "bench_torch" / "reference.py").read_text()
    assert "brpc_tpu_torch" not in text and "import torch" not in text


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_same_seed_same_inputs_other_seed_other_inputs(cell):
    cfg = small(cell)
    a, b, c = (cells.kind(cfg).inputs(cfg, s) for s in (7, 7, 8))
    assert a.dtype == np.uint32
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_inputs_have_the_cells_shapes():
    chunks, nbytes = bounds.device_path_bytes(256, 1020)
    assert dp_kind.inputs(cells.config(DEVICE_PATH), 1).shape == (nbytes // 4,)
    assert echo_kind.inputs(small(ECHO), 1).shape == (4, 4096)
    assert cells.config(ECHO)["batch"] * cells.config(ECHO)["words"] * 4 == 256 << 20


def _device_path_outputs(cfg, seed):
    """What a correct device path returns for the seeded payload over
    two passes: its record and diag, and the references."""
    chunks, _ = bounds.device_path_bytes(cfg["payload_mb"], cfg["chunk_kb"])
    rows = dp_kind.inputs(cfg, seed).reshape(chunks, -1)
    want = dp_kind.references(rows)
    diag = {"integrity_words": list(map(int, want["integrity_words"])) * 2,
            "returned_crc32c": list(map(int, want["returned_crc32c"])) * 2,
            "returned_last_chunk": rows[-1].copy()}
    return {"device_path_ok": True}, diag, want


def test_device_path_checks_hold_on_right_outputs():
    record, diag, want = _device_path_outputs(small(DEVICE_PATH), 3)
    assert all(dp_kind.check(record, diag, want).values())


@pytest.mark.parametrize("fault", ["corrupt chunk word", "not ok",
                                   "words missing", "no words",
                                   "corrupt returned crc32c", "crcs missing",
                                   "returned chunk differs"])
def test_device_path_fault_makes_a_check_fail(fault):
    record, diag, want = _device_path_outputs(small(DEVICE_PATH), 3)
    chunks = len(want["integrity_words"])
    if fault == "corrupt chunk word":
        diag["integrity_words"][chunks + 1] ^= 1
    elif fault == "not ok":
        record["device_path_ok"] = False
    elif fault == "words missing":
        diag["integrity_words"] = diag["integrity_words"][:-1]
    elif fault == "no words":
        diag["integrity_words"] = []
    elif fault == "corrupt returned crc32c":
        diag["returned_crc32c"][chunks + 2] ^= 1 << 9
    elif fault == "crcs missing":
        del diag["returned_crc32c"]
    else:
        diag["returned_last_chunk"][-1] ^= 1
    assert not all(dp_kind.check(record, diag, want).values())


def _echo_outputs(seed):
    payload = echo_kind.inputs(small(ECHO), seed)
    c, ln, e = echo_step(words_from_numpy(payload, CPU))
    rows = np.stack([c.view(torch.int32).numpy().view(np.uint32)] * 3)
    lengths = np.stack([ln.view(torch.int32).numpy().view(np.uint32)] * 3)
    return rows, lengths, e.view(torch.int32).numpy().view(np.uint32).copy(), \
        payload, reference.frame_checksums(payload)


@pytest.mark.parametrize("fault", [None, "flipped checksum", "wrong length",
                                   "echo differs"])
def test_echo_fault_makes_a_check_fail(fault):
    rows, lengths, echoed, payload, want = _echo_outputs(5)
    if fault == "flipped checksum":
        rows[2, 1] ^= 1 << 20
    elif fault == "wrong length":
        lengths[0, 3] += 4
    elif fault == "echo differs":
        echoed[1, 7] ^= 1
    got = echo_kind.check(rows, lengths, echoed, payload, want)
    assert all(got.values()) == (fault is None)


def _echo_cell(monkeypatch, corrupt=None):
    """The echo cell at its small size on the CPU, through run_cell, with
    echo_step's outputs corrupted on one call."""
    from brpc_tpu_torch.parallel import collective_echo

    monkeypatch.setattr(cells, "config", small)
    calls = {"n": 0}

    def faulty(x):
        c, ln, e = echo_step(x)
        calls["n"] += 1
        if calls["n"] == 20 and corrupt == "checksum":
            c = (c.view(torch.int32) ^ 1).view(torch.uint32)
        if calls["n"] == 20 and corrupt == "length":
            ln = (ln.view(torch.int32) + 4).view(torch.uint32)
        return c, ln, e

    monkeypatch.setattr(collective_echo, "echo_step", faulty)
    return cells.run_cell(ECHO, 11, CPU)


def test_echo_cell_runs_correct_on_the_cpu(monkeypatch):
    out = _echo_cell(monkeypatch)
    assert out["correct"] is True
    listed = {m["name"] for m in cells.workloads()[ECHO]["metrics"]}
    # 30 calls: the 50th percentile is the highest with ten beyond it
    # (the 99.9th at the cell's 10000).
    assert listed - {"b1_kernel_ms", "b1_share_of_bound", "echo_step_ms_p99.9"} \
        <= set(out["metrics"])
    assert out["metrics"]["echo_step_calls"][0] == 30
    assert out["metrics"]["echo_step_ms_p50"][0] > 0
    # No device on the CPU: the device's numbers are absent, not made up.
    assert out["metrics"]["b1_kernel_ms"][0] is None
    assert out["metrics"]["b1_traced_launches"][0] == 0
    assert out["metrics"]["echo_device_busy_share"][0] is None


@pytest.mark.parametrize("corrupt", ["checksum", "length"])
def test_a_wrong_echo_output_makes_the_cell_incorrect(monkeypatch, corrupt):
    out = _echo_cell(monkeypatch, corrupt)
    assert out["correct"] is False
    assert out["checks"][{"checksum": "checksums",
                          "length": "lengths"}[corrupt]] is False


_DEVICE_PATH_SCRIPT = """
import json, sys
import torch
from bench_torch import cells, measure
from brpc_tpu_torch import device_path, native

small = json.loads(sys.argv[1])
fault = sys.argv[2]
real_config, real_run = cells.config, device_path.run
cells.config = lambda cell: {**real_config(cell), **small}
rates = {"h2d_gbps": 40.0, "d2h_gbps": 40.0, "duplex_gbps": 60.0}
# No card: the host link's rates are given, not measured.
measure.host_link = lambda dev, mb, kb: {
    "link_256mib": rates, "link_chunk": rates}
real_split, real_crc32c = measure.device_path_split, native.crc32c
if fault == "verify crc32c constant":
    native.crc32c = lambda data, init=0: 0

def run(**kw):
    rec = real_run(**kw)
    diag = kw["diag"]
    if fault == "corrupt chunk word":
        diag["integrity_words"][3] ^= 1 << 7
    if fault == "timed run not ok":
        rec = dict(rec, device_path_ok=False)
    if fault == "corrupt returned crc32c":
        diag["returned_crc32c"][5] ^= 1 << 30
    if fault == "returned chunk differs":
        diag["returned_last_chunk"][11] ^= 1
    if fault == "verify crc32c constant":
        rec = dict(rec, device_path_ok=True)  # as if the verify held
    if fault == "traced crc32c wrong":
        native.crc32c = lambda data, init=0: real_crc32c(data, init) ^ 1
    return rec

def split(*args):
    out = real_split(*args)
    if fault == "not ok":
        out["pipeline"]["ok"] = False
    return out

device_path.run = run
measure.device_path_split = split

if fault == "pooled verify":
    import time

    # In the traced pass each crc32c holds HOLD_S in a sleep, which
    # drops the GIL; only the pipeline's workers call it, three of them,
    # so their timed calls overlap in every pass.
    HOLD_S = 0.01
    crc32c = native.crc32c

    def held_crc32c(data, init=0):
        time.sleep(HOLD_S)
        return crc32c(data, init)

    def split(*args, _split=split):
        native.crc32c = held_crc32c
        try:
            return _split(*args)
        finally:
            native.crc32c = crc32c

    measure.device_path_split = split
    device_path._worker_count = lambda depth: 3
out = cells.run_cell("device_path-256MiB-1020KiB-d4", 9, torch.device("cpu"))
print(json.dumps({"correct": out["correct"], "checks": out["checks"],
                  "metrics": {k: v for k, (v, _) in out["metrics"].items()},
                  "split": out["device_path_split"]}))
"""


DEVICE_PATH_FAULTS = {
    "none": [],
    "corrupt chunk word": ["integrity_words"],
    "not ok": ["traced_pass_ok"],
    "timed run not ok": ["device_path_ok"],
    "corrupt returned crc32c": ["returned_crc32c"],
    "returned chunk differs": ["returned_last_chunk"],
    # A verify pass that holds whatever came back: its crc32c values no
    # longer match the reference's.
    "verify crc32c constant": ["returned_crc32c", "traced_pass_ok"],
    "traced crc32c wrong": ["traced_pass_ok"],
    # Not a fault: the traced pass's verify crc32c held 10 ms on each of
    # the pipeline's three workers.
    "pooled verify": [],
}


@pytest.mark.parametrize("fault", list(DEVICE_PATH_FAULTS))
def test_device_path_cell_on_the_cpu(fault):
    """The device path cell at 4 MiB a pass on the CPU: correct as it
    is, and with the verify crc32c held on three workers; a corrupted
    chunk word, crc32c or returned chunk of the timed run, a timed or
    traced run that is not ok, or a verify crc32c that does not compute
    the crc32c makes it incorrect. The caller and the pipeline's
    workers run the timed parts, so the host floor is at most the three
    passes' ms a chunk times the chunks; with the held crc32c the parts
    sum past the wall, and the floor and "everything else" still keep
    to it."""
    proc = subprocess.run(
        [sys.executable, "-c", _DEVICE_PATH_SCRIPT,
         json.dumps(SMALL[DEVICE_PATH]), fault],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    want = DEVICE_PATH_FAULTS[fault]
    assert out["correct"] is not want
    assert [k for k, ok in out["checks"].items() if not ok] == want
    split, got = out["split"], out["metrics"]
    parts = split["host_ms_per_chunk"]
    timed_wall = split["timed_pass_ms"] / split["chunks"]
    assert got["host_floor_share"] <= 1
    assert 0 <= parts["everything else"] <= timed_wall
    assert got["host_critical_ms_per_chunk"] <= timed_wall * (1 + 1e-12)
    if fault == "pooled verify":
        assert got["host_threads"] >= 2
        assert sum(v for k, v in parts.items()
                   if k != "everything else" and v is not None) > timed_wall
    if fault == "none":
        assert got["host_threads"] >= 2
        passes = split["host_passes"]["host_ms_per_chunk"]
        assert min(passes.values()) > 0
        assert split["host_floor_ms_at_host_pass_rates"] == pytest.approx(
            split["chunks"] * sum(passes.values()), rel=1e-9)
        # The busiest thread's share of the three passes' calls.
        assert 0 < split["host_floor_ms"] <= split["chunks"] * (
            parts["np.copyto"] + parts["native.frame_in_place"]
            + parts["native.crc32c"]) * (1 + 1e-9)
        listed = {m["name"] for m in cells.workloads()[DEVICE_PATH]["metrics"]}
        assert listed - {"device_busy_share"} <= {
            k for k, v in got.items() if v is not None}
        chunks, nbytes = bounds.device_path_bytes(4, 508)
        assert got["device_path_gbps"] == pytest.approx(
            2 * nbytes / got["device_path_pass_ms"] / 1e6)
        assert out["split"]["samples"] == {"plain": 21, "timed": 21}
        assert len(out["split"]["timed_over_plain_rounds"]) == 21
        assert out["split"]["timed_over_plain"] > 0
        assert out["split"]["chunks"] == chunks


def test_tail_percentile_has_ten_samples_beyond_it():
    assert echo_kind.tail(list(range(10000)))[0] == 99.9
    assert echo_kind.tail(list(range(1000)))[0] == 99
    assert echo_kind.tail(list(range(100)))[0] == 90
    assert echo_kind.tail(list(range(30)))[0] == 50
    assert echo_kind.tail(list(range(19))) == (None, None)


def test_echo_bound_bytes_by_hand():
    """B1 over uint32[2, 8]: 64 bytes read, 2 checksum words written."""
    assert bounds.echo_bytes(2, 8) == 2 * 8 * 4 + 2 * 4
    assert bounds.echo_ops(2, 8) == 8 * 16
    ms, by = bounds.bound(bounds.echo_bytes(256, 262144),
                          bounds.echo_ops(256, 262144))
    assert by == "bytes"
    assert ms == pytest.approx((256 * (1 << 20) + 1024) / 3.35e12 * 1e3)
    assert bounds.integrity_bytes(7) == 32 and bounds.integrity_ops(7) == 28


def test_device_path_bound_bytes_by_hand():
    """2 MiB in 508 KiB chunks: 508 KiB is 127 whole pages, 520192
    bytes; 4 of them fit in 2 MiB; each crosses the link both ways."""
    chunks, nbytes = bounds.device_path_bytes(2, 508)
    assert (chunks, nbytes) == (4, 4 * 520192)
    link = {"h2d_gbps": 40.0, "d2h_gbps": 50.0, "duplex_gbps": 60.0}
    # 2 x 2080768 bytes at 60 GB/s beat 2080768 at 40 GB/s alone.
    assert bounds.host_link_ms(nbytes, nbytes, link) == pytest.approx(
        2 * 2080768 / 60e9 * 1e3)


def test_benchmark_json_lists_the_two_one_chip_cells():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    assert spec["paths"] == ["bench_torch/"]
    work = cells.workloads()
    assert sorted(work) == sorted([DEVICE_PATH, ECHO])
    for name, w in work.items():
        assert w["chips"] == 1
        assert callable(cells.kind(cells.config(name)).run)
        assert len(cells.config(name)["source"]) <= 200
        e2e = [m for m in w["metrics"] if m["end_to_end"]]
        assert len(e2e) == 1 and e2e[0]["regression_bound"] is not None
    assert cells.end_to_end(DEVICE_PATH) == ("device_path_gbps", True)
    assert cells.end_to_end(ECHO) == ("echo_step_ms", False)


def test_without_a_card_the_command_raises(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_main(["--seed", "1"])
    assert capsys.readouterr().out == ""


def test_importing_the_benchmark_pulls_in_no_jax_and_touches_no_device():
    code = (
        "import json, sys, torch\n"
        "import bench_torch.__main__, bench_torch.pairs\n"
        "from brpc_tpu_torch import native\n"
        "from brpc_tpu_torch.kernels import _build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'brpc_tpu')]\n"
        "print(json.dumps({'bad': bad, 'cuda_init': torch.cuda.is_initialized(),\n"
        "    'libs': [native._LIB is not None, _build._LIB is not None]}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"bad": [], "cuda_init": False, "libs": [False, False]}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_cell_on_card_at_a_small_size(monkeypatch, cell):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device found")
    monkeypatch.setattr(cells, "config", small)
    out = cells.run_cell(cell, 2, torch.device("cuda"))
    assert out["correct"] is True, out["checks"]
