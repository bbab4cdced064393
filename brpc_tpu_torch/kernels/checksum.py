"""B1: the per-row frame checksum (csrc/adler_checksum.cu) and its plain
version.

Replaces brpc_tpu/parallel/collective_echo.py:23-38
(`_adler_frame_checksum`). `adler_frame_checksum` dispatches on the
tensor's device: a CPU tensor goes to `adler_frame_checksum_ref`, a CUDA
tensor launches the hand kernel (or raises). It counts its kernel
launches in `adler_frame_checksum.launches`.

`plan` chooses the kernel's layout from the row length and the words'
alignment, and `thread_ranges` says which words of a row each thread of
that layout reads, in scan order: the kernel does the same index
arithmetic, and the CPU tests hold both to JAX.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple

import torch

from brpc_tpu_torch.convert import int64_to_uint32, uint32_to_int64
from brpc_tpu_torch.kernels import _build

_MOD = 65521
_MASK = 0xFFFFFFFF

# The kernel's geometry (csrc/adler_checksum.cu): each thread owns
# `vecs` consecutive 16-byte granules (4 words each).
SPLIT_VECS = 8
SPLIT_THREADS = 256
# Rows up to this many words take layout "warp", longer ones "split".
WARP_ROW_MAX_WORDS = 4096
_SMS = 132  # H100 SXM


class Plan(NamedTuple):
    """A launch of the B1 kernel. `layout` "warp": one warp per row,
    `rows_per_block` rows a block, tiles of `threads` x `vecs` granules;
    "split": `segs_per_row` segments a row, one block of `threads`
    threads each, `threads` x `vecs` granules a segment. `off` is the
    words' offset in words from the 16-byte boundary at or before them."""
    layout: str
    off: int
    threads: int
    vecs: int
    rows_per_block: int
    segs_per_row: int

    @property
    def step_words(self) -> int:
        """Words of one warp tile ("warp") or one segment ("split")."""
        return 4 * self.threads * self.vecs


def plan(batch: int, n: int, off: int) -> Plan:
    """The layout for `batch` rows of `n` words whose first word lies
    `off` words past a 16-byte boundary."""
    if n <= WARP_ROW_MAX_WORDS:
        # As many rows a block (at most 8) as still give every SM a block;
        # with 8 rows an SM or more, 4 granules a lane let more warps share
        # an SM, else 8 cut the serial tiles of each row.
        rows = min(8, max(1, batch // _SMS))
        return Plan("warp", off, 32, 4 if rows == 8 else 8, rows, 0)
    p = Plan("split", off, SPLIT_THREADS, SPLIT_VECS, 0, 0)
    # Segments start at the 16-byte boundary at or before a row's first
    # word, so a row spans `head + n` words of segments; heads repeat
    # every 4 rows.
    head = max((r * n + off) % 4 for r in range(min(batch, 4)))
    return p._replace(segs_per_row=-(-(head + n) // p.step_words))


def thread_ranges(p: Plan, n: int, row: int) -> Iterator[tuple]:
    """(step, thread, start, stop) for every thread of row `row`: the
    row's words [start, stop) that the thread reads (stop <= start for
    none), in scan order. `step` is the warp's tile ("warp") or the
    row's segment ("split")."""
    lo = row * n + p.off
    g_first = lo >> 2
    step_granules = p.threads * p.vecs
    if p.layout == "warp":
        steps = -(-(((lo + n + 3) >> 2) - g_first) // step_granules)
    else:
        steps = p.segs_per_row
    for step in range(steps):
        for t in range(p.threads):
            g = g_first + step * step_granules + t * p.vecs
            yield (step, t, max(4 * g, lo) - lo,
                   min(4 * (g + p.vecs), lo + n) - lo)


def _scratch_bytes(batch: int, p: Plan) -> int:
    """Layout "split": look-back flags (8 bytes a segment), b slots and
    completion counts (4 bytes a row each), and the ticket."""
    return 8 * batch * p.segs_per_row + 8 * batch + 4


def adler_frame_checksum_ref(words: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: int64 arithmetic masked to 32 bits after
    the cumsum and after the b sum, which is where the JAX uint32 ops
    wrap. uint32[..., n] -> uint32[...]."""
    w = uint32_to_int64(words)
    halves = torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(
        *w.shape[:-1], -1)
    s1 = torch.cumsum(halves, dim=-1) & _MASK
    a = s1[..., -1] % _MOD
    b = ((s1 % _MOD).sum(dim=-1) & _MASK) % _MOD
    return int64_to_uint32((b << 16) | a)


def adler_frame_checksum(words: torch.Tensor) -> torch.Tensor:
    """Frame checksum of each row of uint32[..., n] -> uint32[...]."""
    if words.dtype != torch.uint32:
        raise TypeError(f"expected torch.uint32 words, got {words.dtype}")
    if words.dim() < 1 or words.shape[-1] == 0:
        raise ValueError(f"need at least one word per row, got {tuple(words.shape)}")
    if words.device.type == "cpu":
        return adler_frame_checksum_ref(words)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    n = words.shape[-1]
    batch = words.numel() // n
    p = plan(batch, n, (words.data_ptr() >> 2) & 3)
    with torch.cuda.device(words.device):
        out = torch.empty(words.shape[:-1], dtype=torch.int32,
                          device=words.device).view(torch.uint32)
        scratch, scratch_len = None, 0
        if p.layout == "split":
            scratch_len = _scratch_bytes(batch, p)
            scratch = torch.empty(scratch_len, dtype=torch.uint8,
                                  device=words.device)
        _build.launch("brpc_tpu_torch_adler_frame_checksum",
                      words.data_ptr(), out.data_ptr(), batch, n,
                      0 if p.layout == "warp" else 1, p.off, p.step_words,
                      p.rows_per_block, p.segs_per_row,
                      None if scratch is None else scratch.data_ptr(),
                      scratch_len, torch.cuda.current_stream().cuda_stream)
    adler_frame_checksum.launches += 1
    return out


adler_frame_checksum.launches = 0
