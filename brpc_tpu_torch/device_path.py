"""Device data path: framed payloads stream host -> device -> host
through a pipelined staging ring. Port of brpc_tpu/device_path.py.

The payload is cut into chunks; each chunk is staged into a slot of the
C++ framework's depth-N `DeviceStagingRing` and framed IN PLACE by the
framework (header + meta written right before the payload, no payload
memcpy: `native.frame_in_place`), so that H2D of chunk i+1, the device
integrity kernel (B2) on chunk i, and D2H + crc32c verification of chunk
i-1 overlap.

On CUDA the ring path works like this: the ring's slot memory is
registered once with cudaHostRegister (page-rounded, overlapping spans
merged), so the H2D `copy_(non_blocking=True)` on a side stream is a
true async DMA; the kernel runs on the current stream after the H2D
event; D2H goes on a second side stream into a per-slot pinned RETURN
buffer (never back into the staging slot, which still holds the sent
bytes and would make the crc check vacuous); retiring a chunk waits on
its D2H event, checks crc32c(return buffer) against the crc staged at
frame time, and only then completes (recycles) the slot. On the CPU the
slot view is used zero-copy, as the JAX package does with dlpack.

The serial baseline (the retired loop: frame() with the payload copy,
blocking copy to the device, full sync, a fresh host array copied back,
unframe) runs over the same chunks; `device_path_overlap_eff` =
pipelined / serial throughput.

Run as a module for one JSON line:
    python -m brpc_tpu_torch.device_path [payload_mb] [reps] [ring_depth]
        [chunk_kb] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from collections import deque

import numpy as np
import torch

from brpc_tpu_torch import native
from brpc_tpu_torch.convert import resolve_device, words_to_numpy
from brpc_tpu_torch.kernels.integrity import integrity_word, integrity_word_ref
from brpc_tpu_torch.native import IN_PLACE_HEADROOM as HEADROOM

_PAGE = 4096


def _integrity_word(words: torch.Tensor) -> torch.Tensor:
    """Order-sensitive integrity word over uint32 words: a weighted
    wraparound sum (odd per-position multipliers, so swapping any two
    distinct words changes it). Runs kernel B2 on a CUDA tensor."""
    return integrity_word(words)


def _touch_kernel(x: torch.Tensor) -> tuple:
    """The on-device integrity step over one chunk: returns (x, word)
    with x the very input tensor (no copy, the twin of the JAX
    package's donated buffer). Proves the device READ the bytes."""
    return x, _integrity_word(x)


def _register_spans(ring) -> list[tuple[int, int]]:
    """The ring's slots rounded out to page bounds, overlapping or
    touching spans merged: slab slots need not be page-aligned and their
    size is not a page multiple, so neighbouring slots can share a page,
    and registering a page twice fails."""
    spans = sorted((p & ~(_PAGE - 1),
                    (p + ring.slot_bytes + _PAGE - 1) & ~(_PAGE - 1))
                   for p in (s.ctypes.data for s in ring.slots))
    merged: list[list[int]] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b - a) for a, b in merged]


class _ChunkPipeline:
    """Drives the staging ring at a given depth.

    copy_mode=True reproduces the RETIRED loop shape per chunk, run at
    depth 1 with nothing in flight. copy_mode=False is the ring path:
    payload staged once into the slot, framed in place, and depth-N
    chunks in flight so H2D/compute/D2H of neighbouring chunks overlap.
    On CUDA the ring path owns host registrations, device buffers,
    pinned return buffers and streams: call close() when done."""

    # Never park forever on the ring: a wedged device stream must
    # surface as an error; on timeout the ring is poisoned so every
    # other thread parked on it unblocks too.
    ACQUIRE_TIMEOUT_US = 30_000_000

    def __init__(self, ring, chunks, dev, depth, copy_mode):
        self.ring = ring
        self.chunks = chunks          # list of uint32 chunk arrays
        self.dev = dev
        self.depth = depth
        self.copy_mode = copy_mode
        self.chunk_bytes = chunks[0].nbytes
        self.crcs = [0] * ring.depth  # staged crc per in-flight slot
        self.ok = True
        self.dev_checks = []
        self.registered_spans: list[int] = []
        self.slot_pinned = False
        self._async = dev.type == "cuda" and not copy_mode
        if self._async:
            try:
                self._setup_cuda()
            except BaseException:
                self.close()
                raise

    def _setup_cuda(self):
        cudart = torch.cuda.cudart()
        for ptr, size in _register_spans(self.ring):
            torch.cuda.check_error(cudart.cudaHostRegister(ptr, size, 0))
            self.registered_spans.append(ptr)
        words = self.chunk_bytes // 4
        depth = self.ring.depth
        self.host = [torch.from_numpy(
            s[HEADROOM:HEADROOM + self.chunk_bytes].view(np.int32))
            for s in self.ring.slots]
        self.slot_pinned = all(h.is_pinned() for h in self.host)
        self.dbuf = [torch.empty(words, dtype=torch.int32, device=self.dev)
                     for _ in range(depth)]
        self.ret = [torch.empty(words, dtype=torch.int32, pin_memory=True)
                    for _ in range(depth)]
        self.ret_np = [r.numpy().view(np.uint32) for r in self.ret]
        self.chk = torch.empty(depth, dtype=torch.int32, pin_memory=True)
        self.chk_np = self.chk.numpy().view(np.uint32)
        self.h2d = torch.cuda.Stream(self.dev)
        self.d2h = torch.cuda.Stream(self.dev)
        self.d2h_done = [torch.cuda.Event() for _ in range(depth)]

    def close(self):
        if self.registered_spans:
            cudart = torch.cuda.cudart()
            torch.cuda.synchronize(self.dev)
            for ptr in self.registered_spans:
                torch.cuda.check_error(cudart.cudaHostUnregister(ptr))
            self.registered_spans = []

    def _h2d(self, slot):
        """The staged chunk on the device: the slot view itself on the
        CPU, an async DMA into the slot's device buffer on CUDA."""
        if not self._async:
            sa = self.ring.slots[slot]
            return torch.from_numpy(
                sa[HEADROOM:HEADROOM + self.chunk_bytes].view(np.uint32))
        with torch.cuda.stream(self.h2d):
            self.dbuf[slot].copy_(self.host[slot], non_blocking=True)
        torch.cuda.current_stream(self.dev).wait_stream(self.h2d)
        return self.dbuf[slot].view(torch.uint32)

    def _d2h(self, slot, y, chk):
        self.d2h.wait_stream(torch.cuda.current_stream(self.dev))
        with torch.cuda.stream(self.d2h):
            self.ret[slot].copy_(y.view(torch.int32), non_blocking=True)
            self.chk[slot].copy_(chk.view(torch.int32), non_blocking=True)
            self.d2h_done[slot].record()

    def _launch(self, k):
        try:
            slot = self.ring.acquire(self.ACQUIRE_TIMEOUT_US)
        except TimeoutError:
            self.ring.abort()
            raise RuntimeError(
                "staging-ring acquire timed out (lost completion or "
                "wedged device stream); ring aborted") from None
        sa = self.ring.slots[slot]
        clen = self.chunk_bytes
        if self.copy_mode:
            # Old path: frame() memcpys the external payload into the
            # staging buffer, then a blocking copy moves it again.
            fr = native.frame(k + 1, self.chunks[k], out=sa)
            foff, flen = 0, len(fr)
            poff = flen - clen
            x = torch.from_numpy(sa[poff:poff + clen].view(np.int32)).to(
                self.dev, copy=True).view(torch.uint32)
        else:
            # Ring path: stage the chunk payload once, frame in place,
            # then H2D.
            poff = HEADROOM
            np.copyto(sa[poff:poff + clen].view(np.uint32), self.chunks[k])
            foff, flen, crc = native.frame_in_place(k + 1, sa, poff, clen)
            self.crcs[slot] = crc
            x = self._h2d(slot)
        y, chk = _touch_kernel(x)
        if self._async:
            self._d2h(slot, y, chk)
        return (k, slot, foff, flen, poff, y, chk)

    def _retire(self, item):
        k, slot, foff, flen, poff, y, chk = item
        sa = self.ring.slots[slot]
        if self.copy_mode:
            # Old path: block, materialize a fresh host array, copy it
            # back into staging, then have the framework re-parse and
            # crc32c-verify the whole frame around the returned payload.
            if self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
            back = words_to_numpy(y)
            np.copyto(sa[poff:poff + self.chunk_bytes].view(np.uint32),
                      back)
            cid, _, _ = native.unframe(sa[foff:foff + flen])
            self.ok = self.ok and cid == k + 1
            check = int(words_to_numpy(chk))
        else:
            # Ring path: the returned bytes are verified DIRECTLY against
            # the crc32c the framework embedded at frame time.
            if self._async:
                self.d2h_done[slot].synchronize()
                back, check = self.ret_np[slot], int(self.chk_np[slot])
            else:
                back, check = y.numpy(), int(chk)
            self.ok = (self.ok and
                       native.crc32c(back) == self.crcs[slot])
        self.dev_checks.append(check)
        # Only now, with the D2H done, may the slot be reused.
        self.ring.complete(slot)

    def run(self, reps):
        t0 = time.monotonic()
        inflight = deque()
        for _ in range(reps):
            for k in range(len(self.chunks)):
                inflight.append(self._launch(k))
                # Serial (depth=1): drain immediately. Pipelined: keep
                # `depth` chunks in flight; retiring the oldest overlaps
                # its D2H/verify with the younger chunks' H2D + compute.
                while len(inflight) >= self.depth:
                    self._retire(inflight.popleft())
        while inflight:
            self._retire(inflight.popleft())
        return time.monotonic() - t0


def run(payload_mb: int = 4, reps: int = 5, ring_depth: int = 4,
        chunk_kb: int = 2044, device=None, diag: dict | None = None) -> dict:
    """Serial vs pipelined device path; returns the JAX package's record
    keys. device=None means CUDA. If `diag` is a dict it receives the
    pipelined ring's staging facts: host_registered_spans (page spans
    registered with cudaHostRegister) and slot_pinned (is_pinned() held
    for every slot view); and the pass's shape: chunks, and
    payload_bytes, the bytes a pass moves each way."""
    dev = resolve_device(device)
    chunk_bytes = (chunk_kb << 10) & ~4095
    n_chunks = max(1, (payload_mb << 20) // chunk_bytes)
    payload_bytes = n_chunks * chunk_bytes
    payload = np.arange(payload_bytes // 4, dtype=np.uint32)
    chunks = [payload[i * (chunk_bytes // 4):(i + 1) * (chunk_bytes // 4)]
              for i in range(n_chunks)]
    # Room for the in-place headroom (ring path) AND the copy-mode
    # frame() headroom contract (payload + 1024).
    slot_bytes = chunk_bytes + 1024

    def make_ring():
        return native.DeviceStagingRing(ring_depth, slot_bytes)

    # Warmup: kernel build + first transfers through a throwaway ring.
    warm = make_ring()
    try:
        for depth, copy_mode in ((ring_depth, False), (1, True)):
            p = _ChunkPipeline(warm, chunks, dev, depth, copy_mode)
            try:
                p.run(1)
            finally:
                p.close()
    finally:
        warm.close()

    # Serial baseline and pipelined ring, INTERLEAVED rep by rep and
    # combined by median so shared-host scheduling noise hits both paths
    # alike.
    ring_s = make_ring()
    ring_p = make_ring()
    pipe = None
    try:
        serial = _ChunkPipeline(ring_s, chunks, dev, 1, True)
        pipe = _ChunkPipeline(ring_p, chunks, dev, ring_depth, False)
        # Each timed sample spans `passes` full passes over the chunks so
        # the pipeline reaches steady state; several alternating samples
        # -> median.
        passes = max(2, (4 * ring_depth + n_chunks - 1) // n_chunks)
        samples = max(3, reps // passes)
        serial_dts, pipe_dts = [], []
        for _ in range(samples):
            serial_dts.append(serial.run(passes) / passes)
            pipe_dts.append(pipe.run(passes) / passes)
        highwater = ring_p.inflight_highwater
        registered = ring_p.registered
        if diag is not None:
            diag["host_registered_spans"] = len(pipe.registered_spans)
            diag["slot_pinned"] = pipe.slot_pinned
            diag["chunks"] = n_chunks
            diag["payload_bytes"] = payload_bytes
    finally:
        if pipe is not None:
            pipe.close()
        ring_s.close()
        ring_p.close()
    dt_serial = statistics.median(serial_dts) * reps
    dt_pipe = statistics.median(pipe_dts) * reps
    # Overlap efficiency from ADJACENT sample pairs, so host throttling
    # cancels out of the ratio.
    overlap_eff = statistics.median(
        s / p for s, p in zip(serial_dts, pipe_dts))

    # Device integrity words must agree between the two paths (same
    # chunks, same kernel); off the CPU the first chunk's word is also
    # checked against the plain version on the host.
    dev_ok = (len(pipe.dev_checks) == n_chunks * passes * samples and
              pipe.dev_checks[:n_chunks] == serial.dev_checks[:n_chunks])
    if dev.type != "cpu":
        host_chk = int(integrity_word_ref(torch.from_numpy(chunks[0])))
        dev_ok = dev_ok and pipe.dev_checks[0] == host_chk
    ok = serial.ok and pipe.ok and dev_ok

    # Bytes cross host->device and device->host once per chunk per rep.
    gbps = 2.0 * payload_bytes * reps / dt_pipe / 1e9
    serial_gbps = 2.0 * payload_bytes * reps / dt_serial / 1e9
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {
        "device_path_gbps": round(gbps, 3),
        "device_path_serial_gbps": round(serial_gbps, 3),
        "device_path_overlap_eff": round(overlap_eff, 2),
        "device_path_ring_depth": ring_depth,
        "device_path_chunk_bytes": chunk_bytes,
        "device_path_inflight_highwater": int(highwater),
        "device_path_ok": bool(ok),
        "device_path_registered_staging": bool(registered),
        "device_path_device": f"{dev.type}:{kind}",
        # Overlap needs a core for the device work next to the staging
        # thread.
        "device_path_cores": int(os.cpu_count() or 1),
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("payload_mb", type=int, nargs="?", default=4)
    ap.add_argument("reps", type=int, nargs="?", default=5)
    ap.add_argument("ring_depth", type=int, nargs="?", default=4)
    ap.add_argument("chunk_kb", type=int, nargs="?", default=1020)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    a = ap.parse_args()
    print(json.dumps(run(a.payload_mb, a.reps, a.ring_depth, a.chunk_kb,
                         a.device)))
