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
merged), so the H2D on a side stream is a true async DMA; the kernel
runs on the current stream after the H2D event; D2H goes on a second
side stream into a per-slot pinned RETURN buffer (never back into the
staging slot, which still holds the sent bytes and would make the crc
check vacuous); retiring a chunk waits on its D2H event, checks
crc32c(return buffer) against the crc staged at frame time, and only
then completes (recycles) the slot. On the CPU the slot view is used
zero-copy, as the JAX package does with dlpack.

The ring path's three host passes over the bytes (the staging copy, the
framing's crc32c, the verify crc32c) run on worker threads that the
pipeline owns (`_worker_count`); each pass drops the GIL. The caller
keeps the ring's acquires, every enqueue (H2D, B2, D2H) and the fold of
each chunk's results in chunk order. The JAX package runs all of it on
one thread; the results are the same. The copies and their events are
enqueued through the CUDA driver with the GIL held: a torch call drops
the GIL, and with workers waiting for it each drop costs the caller a
hand-over.

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
import ctypes
import json
import os
import queue
import statistics
import threading
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


def _cuda_driver():
    """The CUDA driver's async copy, event record and stream wait,
    bound with ctypes.PyDLL so the GIL stays held across each call (a
    few microseconds of enqueue)."""
    cu = ctypes.PyDLL("libcuda.so.1")
    ptr, size = ctypes.c_void_p, ctypes.c_size_t
    sigs = {"cuMemcpyHtoDAsync_v2": (ctypes.c_uint64, ptr, size, ptr),
            "cuMemcpyDtoHAsync_v2": (ptr, ctypes.c_uint64, size, ptr),
            "cuEventRecord": (ptr, ptr),
            "cuStreamWaitEvent": (ptr, ptr, ctypes.c_uint)}
    fns = {}
    for name, args in sigs.items():
        fn = getattr(cu, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
        fns[name] = fn
    return fns


def _cu(fn, *args):
    err = fn(*args)
    if err:
        raise RuntimeError(f"{fn.__name__} failed: CUresult {err}")


# Name prefix of the ring path's worker threads.
WORKER_NAME = "device-path-worker"


def _worker_count(depth: int) -> int:
    """The ring path's worker threads: one a ring slot but one, at most
    the CPUs this process may use less the caller's, at least one. Each
    worker contends with the caller for the GIL whenever one of its
    passes returns; on the H100's 8-CPU host three workers moved a
    depth-4 ring faster than four (PERF.md section 6)."""
    return max(1, min(depth - 1, len(os.sched_getaffinity(0)) - 1))


class _ChunkPipeline:
    """Drives the staging ring at a given depth.

    copy_mode=True reproduces the RETIRED loop shape per chunk, run at
    depth 1 with nothing in flight, all on the caller's thread.
    copy_mode=False is the ring path: payload staged once into the
    slot, framed in place, and depth-N chunks in flight so H2D/compute/
    D2H of neighbouring chunks overlap. Its three host passes over the
    bytes run on worker threads that the pipeline owns
    (`_worker_count`): a worker stages and frames a chunk into the slot
    the caller acquired for it, and a worker waits for a chunk's D2H,
    computes the crc32c of the returned bytes against the crc staged at
    frame time and only then completes the slot. The caller acquires
    the slots in chunk order, makes every enqueue (H2D, B2, D2H) and
    folds each chunk's results in chunk order. A worker's error aborts
    the ring, and run() raises it. The ring path owns its workers and,
    on CUDA, host registrations, device buffers, pinned return buffers
    and streams: call close() when done."""

    # Never park forever on the ring or on a worker: a wedged device
    # stream must surface as an error; on timeout the ring is poisoned
    # so every other thread parked on it unblocks too.
    ACQUIRE_TIMEOUT_US = 30_000_000
    # Seconds close() waits for each worker to stop.
    JOIN_TIMEOUT_S = 10

    def __init__(self, ring, chunks, dev, depth, copy_mode):
        self.ring = ring
        self.chunks = chunks          # list of uint32 chunk arrays
        self.dev = dev
        self.depth = depth
        self.copy_mode = copy_mode
        self.chunk_bytes = chunks[0].nbytes
        self.ok = True
        self.dev_checks = []
        self.returned_crcs = []  # ring path: crc32c of each returned chunk
        self.last_returned = None  # ring path: the last returned chunk's bytes
        self.registered_spans: list[int] = []
        self.slot_pinned = False
        self._async = dev.type == "cuda" and not copy_mode
        # Jobs for the workers: (function, args, box, chunk number);
        # each result comes back on _done as (box, chunk number, value),
        # or as the exception the job raised.
        self._jobs = queue.SimpleQueue()
        self._done = queue.SimpleQueue()
        self._pending = 0  # jobs whose result the caller has not taken
        self._workers: list[threading.Thread] = []
        self._error = None  # the first error a worker raised
        self._error_lock = threading.Lock()
        try:
            if self._async:
                self._setup_cuda()
            if not copy_mode:
                self._start_workers()
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
        self.dbuf_u32 = [b.view(torch.uint32) for b in self.dbuf]
        self.ret = [torch.empty(words, dtype=torch.int32, pin_memory=True)
                    for _ in range(depth)]
        self.ret_np = [r.numpy().view(np.uint32) for r in self.ret]
        self.chk = torch.empty(depth, dtype=torch.int32, pin_memory=True)
        self.chk_np = self.chk.numpy().view(np.uint32)
        self.h2d = torch.cuda.Stream(self.dev)
        self.d2h = torch.cuda.Stream(self.dev)
        # A slot's H2D done, its B2 done, its D2H done: made once, so an
        # enqueue creates no event.
        self.d2h_done = [torch.cuda.Event() for _ in range(depth)]
        h2d_done = [torch.cuda.Event() for _ in range(depth)]
        b2_done = [torch.cuda.Event() for _ in range(depth)]
        for ev in (*self.d2h_done, *h2d_done, *b2_done):
            ev.record(self.h2d)  # creates the event
        self._events = h2d_done + b2_done  # kept alive for the handles
        self._drv = _cuda_driver()
        self._h2d_ev = [e.cuda_event for e in h2d_done]
        self._b2_ev = [e.cuda_event for e in b2_done]
        self._d2h_ev = [e.cuda_event for e in self.d2h_done]
        self._hptr = [h.data_ptr() for h in self.host]
        self._dptr = [b.data_ptr() for b in self.dbuf]
        self._rptr = [r.data_ptr() for r in self.ret]
        self._kptr = [self.chk.data_ptr() + 4 * i for i in range(depth)]

    def _start_workers(self):
        # The ring loaded libtpurpc on this thread, so no two workers
        # meet in native.lib()'s first load.
        for i in range(_worker_count(self.ring.depth)):
            w = threading.Thread(target=self._work, name=f"{WORKER_NAME}-{i}",
                                 daemon=True)
            w.start()
            self._workers.append(w)

    def close(self):
        """Stops and joins the workers (raises if one does not stop) and
        unregisters the ring's host memory."""
        workers, self._workers = self._workers, []
        for _ in workers:
            self._jobs.put(None)
        for w in workers:
            w.join(timeout=self.JOIN_TIMEOUT_S)
        if self.registered_spans:
            cudart = torch.cuda.cudart()
            torch.cuda.synchronize(self.dev)
            for ptr in self.registered_spans:
                torch.cuda.check_error(cudart.cudaHostUnregister(ptr))
            self.registered_spans = []
        stuck = [w.name for w in workers if w.is_alive()]
        if stuck:
            raise RuntimeError(f"device-path workers did not stop: {stuck}")

    def _work(self):
        while (job := self._jobs.get()) is not None:
            fn, args, box, i = job
            try:
                self._done.put((box, i, fn(*args)))
            except Exception as e:
                with self._error_lock:
                    if self._error is None:
                        self._error = e
                # Wakes a caller parked in acquire: the pass is lost.
                self.ring.abort()
                self._done.put(e)

    def _submit(self, fn, args, box, i):
        self._jobs.put((fn, args, box, i))
        self._pending += 1

    def _take(self):
        """The next worker result into its box, on the caller; a
        worker's error is raised."""
        try:
            got = self._done.get(timeout=self.ACQUIRE_TIMEOUT_US / 1e6)
        except queue.Empty:
            self.ring.abort()
            raise RuntimeError("a device-path worker job timed out (wedged "
                               "device stream?); ring aborted") from None
        self._pending -= 1
        if isinstance(got, Exception):
            raise got
        box, i, value = got
        box[i] = value

    def _acquire(self):
        try:
            return self.ring.acquire(self.ACQUIRE_TIMEOUT_US)
        except TimeoutError:
            self.ring.abort()
            raise RuntimeError(
                "staging-ring acquire timed out (lost completion or "
                "wedged device stream); ring aborted") from None

    def _h2d(self, slot):
        """The staged chunk on the device: the slot view itself on the
        CPU, an async DMA into the slot's device buffer on CUDA."""
        if not self._async:
            sa = self.ring.slots[slot]
            return torch.from_numpy(
                sa[HEADROOM:HEADROOM + self.chunk_bytes].view(np.uint32))
        d, s = self._drv, self.h2d.cuda_stream
        _cu(d["cuMemcpyHtoDAsync_v2"], self._dptr[slot], self._hptr[slot],
            self.chunk_bytes, s)
        _cu(d["cuEventRecord"], self._h2d_ev[slot], s)
        _cu(d["cuStreamWaitEvent"],
            torch.cuda.current_stream(self.dev).cuda_stream,
            self._h2d_ev[slot], 0)
        return self.dbuf_u32[slot]

    def _d2h(self, slot, chk):
        """The slot's device buffer (B2's input, unchanged) and B2's
        word back into the slot's pinned return buffers."""
        d, s = self._drv, self.d2h.cuda_stream
        _cu(d["cuEventRecord"], self._b2_ev[slot],
            torch.cuda.current_stream(self.dev).cuda_stream)
        _cu(d["cuStreamWaitEvent"], s, self._b2_ev[slot], 0)
        _cu(d["cuMemcpyDtoHAsync_v2"], self._rptr[slot], self._dptr[slot],
            self.chunk_bytes, s)
        _cu(d["cuMemcpyDtoHAsync_v2"], self._kptr[slot], chk.data_ptr(), 4, s)
        _cu(d["cuEventRecord"], self._d2h_ev[slot], s)

    def _stage(self, k, slot):
        """On a worker: stages chunk k once into the slot the caller
        acquired and frames it in place; returns the frame's crc32c."""
        sa = self.ring.slots[slot]
        clen = self.chunk_bytes
        np.copyto(sa[HEADROOM:HEADROOM + clen].view(np.uint32), self.chunks[k])
        return native.frame_in_place(k + 1, sa, HEADROOM, clen)[2]

    def _enqueue(self, slot):
        """On the caller, once the slot's chunk is staged: H2D, B2 and
        D2H. Returns B2's input and word."""
        y, chk = _touch_kernel(self._h2d(slot))
        if self._async:
            self._d2h(slot, chk)
        return y, chk

    def _verify(self, slot, staged_crc, y, chk):
        """On a worker: the returned bytes are verified DIRECTLY against
        the crc32c the framework embedded at frame time. Returns (match,
        crc, device word, returned bytes)."""
        if self._async:
            self.d2h_done[slot].synchronize()
            back, check = self.ret_np[slot], int(self.chk_np[slot])
        else:
            back, check = y.numpy(), int(chk)
        crc = native.crc32c(back)
        # Only now, with the bytes verified and the word read, may the
        # slot (and its return buffers) be reused.
        self.ring.complete(slot)
        return crc == staged_crc, crc, check, back

    def _fold(self, verified):
        """A chunk's results, on the caller, in chunk order."""
        match, crc, check, back = verified
        self.ok = self.ok and match
        self.returned_crcs.append(crc)
        self.dev_checks.append(check)
        self.last_returned = back

    def _run_ring(self, reps):
        """The caller acquires, enqueues and folds in chunk order, each
        as soon as it can, and otherwise waits for a worker's result.
        It holds a slot from its acquire to its chunk's fold, which
        follows the slot's complete: holding fewer than the ring's
        depth, acquire never waits on a chunk not yet enqueued."""
        n_chunks = len(self.chunks)
        total = reps * n_chunks
        limit = min(self.depth, self.ring.depth)
        slots = deque()  # of the chunks acquired and not yet folded
        staged, verified = {}, {}  # chunk number -> a worker's result
        acquired = enqueued = folded = 0
        try:
            while folded < total:
                while acquired < total and acquired - folded < limit:
                    slot = self._acquire()
                    slots.append(slot)
                    self._submit(self._stage, (acquired % n_chunks, slot),
                                 staged, acquired)
                    acquired += 1
                while not self._done.empty():
                    self._take()
                if folded in verified:
                    self._fold(verified.pop(folded))
                    slots.popleft()
                    folded += 1
                elif enqueued in staged:
                    slot = slots[enqueued - folded]
                    # y and chk ride with the verify job: the D2H stream
                    # reads them after the caller has moved on.
                    y, chk = self._enqueue(slot)
                    self._submit(self._verify,
                                 (slot, staged.pop(enqueued), y, chk),
                                 verified, enqueued)
                    enqueued += 1
                else:
                    self._take()
        except BaseException as e:
            self.ring.abort()
            # No job may outlive run(): take the results still to come.
            while self._pending:
                try:
                    self._done.get(timeout=self.ACQUIRE_TIMEOUT_US / 1e6)
                except queue.Empty:
                    break
                self._pending -= 1
            if self._error is None or self._error is e:
                raise
            raise self._error  # a RingAbortedError here is its echo

    def _launch(self, k):
        """Copy mode: the retired loop's frame() and blocking copy."""
        slot = self._acquire()
        sa = self.ring.slots[slot]
        clen = self.chunk_bytes
        # Old path: frame() memcpys the external payload into the
        # staging buffer, then a blocking copy moves it again.
        fr = native.frame(k + 1, self.chunks[k], out=sa)
        foff, flen = 0, len(fr)
        poff = flen - clen
        x = torch.from_numpy(sa[poff:poff + clen].view(np.int32)).to(
            self.dev, copy=True).view(torch.uint32)
        y, chk = _touch_kernel(x)
        return (k, slot, foff, flen, poff, y, chk)

    def _retire(self, item):
        """Copy mode: block, materialize a fresh host array, copy it
        back into staging, then have the framework re-parse and
        crc32c-verify the whole frame around the returned payload."""
        k, slot, foff, flen, poff, y, chk = item
        sa = self.ring.slots[slot]
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        back = words_to_numpy(y)
        np.copyto(sa[poff:poff + self.chunk_bytes].view(np.uint32), back)
        cid, _, _ = native.unframe(sa[foff:foff + flen])
        self.ok = self.ok and cid == k + 1
        self.dev_checks.append(int(words_to_numpy(chk)))
        self.ring.complete(slot)

    def _run_serial(self, reps):
        inflight = deque()
        for _ in range(reps):
            for k in range(len(self.chunks)):
                inflight.append(self._launch(k))
                # Serial (depth=1): drain immediately.
                while len(inflight) >= self.depth:
                    self._retire(inflight.popleft())
        while inflight:
            self._retire(inflight.popleft())

    def run(self, reps):
        """`reps` whole passes over the chunks; returns their seconds.
        When it returns, no chunk is in flight and no job is queued."""
        t0 = time.monotonic()
        if self.copy_mode:
            self._run_serial(reps)
        else:
            self._run_ring(reps)
        return time.monotonic() - t0


def run(payload_mb: int = 4, reps: int = 5, ring_depth: int = 4,
        chunk_kb: int = 2044, device=None, diag: dict | None = None,
        payload: np.ndarray | None = None) -> dict:
    """Serial vs pipelined device path; returns the JAX package's record
    keys. device=None means CUDA. `payload` is the uint32 words a pass
    sends, exactly payload_bytes // 4 of them (default: np.arange). If
    `diag` is a dict it receives the pipelined ring's staging facts:
    host_registered_spans (page spans registered with cudaHostRegister)
    and slot_pinned (is_pinned() held for every slot view); the pass's
    shape: chunks, and payload_bytes, the bytes a pass moves each way;
    what the timed pipelined passes computed and took, in order:
    integrity_words, the device's word of every chunk they sent;
    returned_crc32c, the crc32c that the verify pass computed over every
    chunk that came back; returned_last_chunk, the uint32 words of the
    last chunk that came back, as a list; and pass_s, the
    seconds a pass of each timed sample."""
    dev = resolve_device(device)
    chunk_bytes = (chunk_kb << 10) & ~4095
    n_chunks = max(1, (payload_mb << 20) // chunk_bytes)
    payload_bytes = n_chunks * chunk_bytes
    if payload is None:
        payload = np.arange(payload_bytes // 4, dtype=np.uint32)
    elif payload.dtype != np.uint32 or payload.shape != (payload_bytes // 4,):
        raise ValueError(f"payload must be uint32[{payload_bytes // 4}], got "
                         f"{payload.dtype}{payload.shape}")
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
            diag["integrity_words"] = list(pipe.dev_checks)
            diag["returned_crc32c"] = list(pipe.returned_crcs)
            diag["returned_last_chunk"] = np.asarray(
                pipe.last_returned, dtype=np.uint32).tolist()
            diag["pass_s"] = list(pipe_dts)
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
