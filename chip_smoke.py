#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (brpc_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. card: name and power limit (nvidia-smi), CUDA and torch versions,
     build tools on PATH;
  2. build: the CUDA kernels (nvcc, sm_90a) and libtpurpc, in parallel,
     from the sources in this checkout, with nvcc's register and spill
     lines, each kernel's SASS instruction counts (cuobjdump) and the
     libtpurpc build route;
  3. B1 (adler_frame_checksum) held bit-equal to its plain version,
     also on ragged rows, a misaligned view and few long rows;
  4. B2 (integrity_word) held bit-equal to its plain version, also on
     a ragged length and a misaligned view;
  5. kernel and plain-version times (CUDA graph replay timed with CUDA
     events, inputs cycled over 128 MiB) at the main path's shapes and
     a few-long-rows B1 shape, against the card's bound; the launch
     floor (a one-element zero_() in the same harness) and B2's fixed
     cost (an empty input); B1 on an input
     held in L2, beside the same shape read from HBM;
     host_link: the card's host link on pinned memory, 256 MiB H2D
     alone, D2H alone and both at once on two streams, and the same at
     the device path's chunk size (1020 KiB, back-to-back copies from
     cudaHostRegister'ed buffers); this host's rates for the device
     path's per-chunk host work (np.copyto into a ring slot,
     native.frame_in_place, native.crc32c over a chunk and 256 MiB);
  6. the main path with launch counters set to 0: entry(), echo_step at
     (4096, 1024) and (256, 262144), and the device path over a 256 MiB
     payload (ring depth 4, 1020 KiB chunks); every output is checked;
     device_path_split (after the counters were read): the device path's
     bound over the host link, with the share that device_path_gbps
     reaches; one ring driven from outside the module: plain passes in
     turns with passes that have a timer around each part of the host
     work (host ms a chunk by part, the rest of the wall time as
     "everything else"; the timed passes' median wall time must lie
     within 10 % of the plain passes'), the host floor of the timed
     passes (staging copy, framing, verify crc32c) with its share, and
     one pass under torch.profiler (device ops, the device's busy
     share, the longest idle gaps with what the host did in each);
  7. launch counters: each kernel launched at least once on the main path.
  8. mesh: the five mesh steps (parallel echo, partition, all-reduce,
     all-gather, all-to-all) in a world of 8 spawned ranks on the one
     card, gloo backend (CUDA tensors; the collectives cross gloo's host
     transport), at the framework's widths: one 1 MiB request a rank,
     32 partitions of 1 MiB a rank for the partition step (B1 in every
     rank); every output checked, B1 held bit-equal to its plain version
     in every rank, the bytes each rank hands its collectives held to
     the byte model; median ms per call (host clock, synchronized), with
     the bytes model, bound (the host link, shared by the 8 ranks),
     share of bound and launch floor of each step;
  9. dryrun_multichip(8, backend="gloo") on the card, framed round trips
     included, its outputs checked;
 10. the five steps in a one-rank NCCL world on the card, bound by HBM
     bytes; then the partition and parallel echo steps once more with
     their timed calls under torch.profiler: host ms of the barrier, of
     the step's call and of the synchronize, device ms by op (B1's and
     NCCL's kernels apart), the device's busy share.
A share is bound_ms / measured ms: 1 would be the card's limit, and a
share above 1 fails the run (the bound's model is wrong).
Then the kernels line (B1's gains the mesh launches, summed over the
ranks), the card line, and last the contract line {"ok": true,
"device": {...}}.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repo. Any mismatch or exception exits non-zero.
"""
import contextlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# NVIDIA H100 SXM, data sheet: HBM3 at 3.35 TB/s; 67 TFLOP/s float32 on
# the CUDA cores, of which 32-bit integer work gets half (64 INT32 lanes
# against 128 FP32 lanes per SM and clock).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
SEED = 20261017
JAX_ALL_ONES_262144 = 0x31DD0069  # JAX _adler_frame_checksum, one all-ones 1 MiB row


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and
    integer operations over the CUDA cores' INT32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def graph_ms(fn, inputs, iters):
    """Device time of one call: at least `iters` calls, and one on each
    of `inputs` (distinct copies, so a small input is not served from
    L2), captured in a CUDA graph, replayed and timed with CUDA
    events."""
    iters = max(iters, len(inputs))
    fn(inputs[0])
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(iters):
            fn(inputs[i % len(inputs)])
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def sass_counts(obj):
    """{kernel: {"instructions": n, "ops": {opcode: count}}} from
    `cuobjdump -sass` of one object file (static counts), or an error."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        text = subprocess.run([tool, "-sass", str(obj)], capture_output=True,
                              text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        return {"error": str(e)}
    counts, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {"instructions": 0, "ops": {}}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if fn and m and m.group(1) != "NOP":
            op = m.group(1)
            counts[fn]["instructions"] += 1
            counts[fn]["ops"][op] = counts[fn]["ops"].get(op, 0) + 1
    return counts


# The device path's main-path shape (phase 6): 256 MiB a pass in
# 1020 KiB chunks, ring depth 4.
DP_PAYLOAD_MB, DP_CHUNK_KB, DP_DEPTH, DP_REPS = 256, 1020, 4, 6


def device_path_bytes(payload_mb, chunk_kb):
    """(chunks, bytes) of one pass of the device path: chunks of
    `chunk_kb` KiB rounded down to whole 4 KiB pages, as many as fit in
    `payload_mb` MiB (at least one). Each chunk crosses the host link
    once host→device and once device→host, so a pass moves `bytes` each
    way and `device_path_gbps` counts 2 × bytes a pass."""
    chunk = (chunk_kb << 10) & ~4095
    chunks = max(1, (payload_mb << 20) // chunk)
    return chunks, chunks * chunk


# The mesh phases: 1 MiB of words a row, (step, rows a rank).
MESH_WORDS = 262144
MESH_STEPS = (("parallel_echo", 1), ("partition", 32), ("allreduce", 1),
              ("allgather", 1), ("alltoall", 1))
MESH_REPS = 5
MESH_CALLS = {
    "parallel_echo": {"all_gather_into_tensor": 1, "reduce_scatter_tensor": 1},
    "partition": {"all_reduce": 1}, "allreduce": {"all_reduce": 1},
    "allgather": {"all_gather_into_tensor": 1},
    "alltoall": {"all_to_all_single": 1},
}
# Device ops a rank's card runs a call besides the collectives: the
# responder mask (arange, + 1, % n, == rank, and where, which first
# fills a one-element tensor with its scalar); the clone; B1's split
# layout (the look-back scratch's memset, the kernel) and the total
# (widen, mask, sum, mask, narrow).
MESH_OWN_LAUNCHES = {"parallel_echo": 6, "allreduce": 1, "allgather": 0,
                     "alltoall": 0, "partition": 7}


def collective_bytes(step, n, rows, words):
    """Bytes a rank hands to its collectives in one call of a mesh step
    over n ranks, from the step's shapes and what it computes, with
    `rows` × `words` uint32 words the rank's input: {"in": what the
    collectives read, "out": what they write}. An in-place all-reduce's
    tensor counts both ways. Under gloo these are the bytes that cross
    the host link: each input device→host, each output host→device."""
    w = 4 * rows * words
    if step == "parallel_echo":
        # all-gather of the requests (w -> n w), reduce-scatter of the
        # responses (n w -> w)
        return {"in": (n + 1) * w, "out": (n + 1) * w}
    if step == "allgather":
        return {"in": w, "out": n * w}
    if step in ("allreduce", "alltoall"):
        return {"in": w, "out": w}
    if step == "partition":
        # one uint32 word: the sum of the rank's checksums
        return {"in": 4, "out": 4}
    raise ValueError(f"unknown mesh step {step!r}")


def hbm_bytes(step, n, rows, words):
    """Device-memory bytes of one call of a mesh step in one rank: each
    input read once and each output written once, by the step's own ops
    and its collectives. An in-place all-reduce over one rank is the
    identity and moves nothing."""
    w = 4 * rows * words
    c = collective_bytes(step, n, rows, words)
    coll = 0 if n == 1 and step in ("allreduce", "partition") else (
        c["in"] + c["out"])
    own = {"parallel_echo": 2 * n * w,  # the mask reads n rows, writes n
           "allreduce": 2 * w,  # the clone
           "allgather": 0, "alltoall": 0,
           # B1 reads the shard and writes a checksum a row; the total
           "partition": w + 4 * rows + 4}[step]
    return own + coll


def launches_per_call(step, backend, n):
    """Device ops a rank's card runs per call of a step over n ranks: its
    own (MESH_OWN_LAUNCHES) and, per collective, under gloo one copy of
    its input to the host and one of its output back, under NCCL one
    kernel, or over one rank one copy (none for an in-place
    all-reduce, which is then the identity)."""
    per = {"gloo": 2, "nccl": 1}[backend]
    if backend == "nccl" and n == 1 and step in ("allreduce", "partition"):
        per = 0
    return MESH_OWN_LAUNCHES[step] + per * sum(MESH_CALLS[step].values())


def host_link_ms(d2h_bytes, h2d_bytes, link):
    """The least ms to move the bytes across the host link at its
    measured rates (GB/s, phase host_link), however the copies are
    ordered: each direction's bytes at that direction's rate alone, and
    all the bytes at the rate of both directions at once."""
    return max(d2h_bytes / link["d2h_gbps"], h2d_bytes / link["h2d_gbps"],
               (d2h_bytes + h2d_bytes) / link["duplex_gbps"]) / 1e6


def mesh_bound(step, backend, n, rows, words, link=None, b1_ms=0.0):
    """(bytes_model, bound_ms, bound_by) of one call of a mesh step.
    gloo, the n ranks on one card: their collective bytes share the
    card's one host link, and the partition step also runs B1 (its
    measured time, `b1_ms`) before its all-reduce. NCCL: the rank's
    device-memory bytes (`hbm_bytes`) at HBM_BYTES_PER_S."""
    if backend == "gloo":
        c = collective_bytes(step, n, rows, words)
        model = {"d2h": n * c["in"], "h2d": n * c["out"]}
        ms = host_link_ms(model["d2h"], model["h2d"], link)
        if step == "partition":
            model["b1_ms"] = b1_ms
            ms += b1_ms
        return model, ms, "host_link"
    model = {"hbm": hbm_bytes(step, n, rows, words)}
    return model, model["hbm"] / HBM_BYTES_PER_S * 1e3, "hbm"


def share(bound_ms, ms):
    """The share of its bound that a measured time reaches. Nothing
    runs faster than its bound, so a share above 1 means the bound's
    model is wrong: that raises."""
    if not 0 < bound_ms <= ms:
        raise ValueError(f"bound {bound_ms} ms against a measured {ms} ms: "
                         "the bound's model is wrong")
    return bound_ms / ms


def mesh_expected(step, full, n):
    """numpy answer of a collective step, one row a rank: `full` is the
    ranks' inputs stacked in rank order."""
    if step == "parallel_echo":
        return full
    if step == "allreduce":
        return np.tile(full.sum(axis=0, dtype=np.uint32), (n, 1))
    if step == "allgather":
        return np.tile(full.reshape(-1), (n, 1))
    return full.reshape(n, n, -1).transpose(1, 0, 2).reshape(n, -1)


def mesh_world(phase, n, backend, seed, link, b1_ms, floor_ms, profile=()):
    """Runs MESH_STEPS in an n-rank world on the card and checks every
    output and the bytes each rank hands its collectives; emits one line
    a step, with its bound, and returns B1's launches summed over the
    ranks. The steps named in `profile` run once more, after the others,
    their timed calls under torch.profiler (one line each)."""
    from brpc_tpu_torch.parallel import world
    from brpc_tpu_torch.parallel.collective_echo import shard

    cases = [{"name": step, "step": step,
              "data": ("random", seed + i, rows, MESH_WORDS),
              "keep": step != "partition"}
             for i, (step, rows) in enumerate(MESH_STEPS)]
    cases += [dict(c, name=f"{c['name']} profiled", keep=False, profile=True)
              for c in cases if c["step"] in profile]
    t0 = time.monotonic()
    results = world.run(n, "brpc_tpu_torch.parallel.collective_echo:run_cases",
                        (cases, MESH_REPS), backend=backend, device="cuda")
    wall_s = time.monotonic() - t0
    b1, ms_by_step = 0, {}
    for i, case in enumerate(cases):
        step, per_rank = case["step"], [r[i] for r in results]
        rows = case["data"][2]
        want_bytes = collective_bytes(step, n, rows, MESH_WORDS)
        for r in per_rank:
            check(r["is_cuda"] and r["device"].startswith("cuda"),
                  f"{phase} {step}: a rank ran on {r['device']}")
            check(r["calls"] == MESH_CALLS[step],
                  f"{phase} {step}: collectives per call {r['calls']}")
            check(r["bytes"] == want_bytes,
                  f"{phase} {step}: collective bytes per call {r['bytes']}, "
                  f"the model says {want_bytes}")
        if step == "partition":
            checks = np.concatenate([r["checksums"] for r in per_rank])
            total = int(checks.astype(np.int64).sum()) & 0xFFFFFFFF
            for r in per_rank:
                check(r["b1_vs_plain"] == 0 and r["echo_is_input"],
                      f"{phase}: B1 differs from its plain version in a rank")
                check(int(r["total"]) == total,
                      f"{phase}: total is not the wrapping sum of checksums")
                check(r["b1_launches"] > 0, f"{phase}: a rank never launched B1")
        elif case["keep"]:
            full = np.concatenate([shard(case["data"], r, n) for r in range(n)])
            want = mesh_expected(step, full, n)
            for r, res in enumerate(per_rank):
                check(np.array_equal(res["outputs"][0][0], want[r]),
                      f"{phase} {step}: rank {r} differs from numpy")
        b1 += sum(r["b1_launches"] for r in per_rank)
        ms = max(r["ms"] for r in per_rank)
        if case.get("profile"):
            emit(f"{phase}_profile", **profile_line(
                step, per_rank[0], ms, ms_by_step[step], b1_ms,
                launches_per_call(step, backend, n)))
            continue
        ms_by_step[step] = ms
        model, b_ms, b_by = mesh_bound(step, backend, n, rows, MESH_WORDS,
                                       link, b1_ms)
        launches = launches_per_call(step, backend, n)
        emit(phase, step=step, backend=backend, world_size=n,
             shape_per_rank=[rows, MESH_WORDS],
             ms_per_call=ms,
             ms_per_call_by_rank=[r["ms"] for r in per_rank],
             timing=(f"host clock, median of {MESH_REPS} calls a rank, each "
                     "after a barrier and ended by torch.cuda.synchronize; "
                     "the slowest rank's median"
                     + (f"; {n} ranks share one card through gloo's host "
                        "transport" if backend == "gloo" else "")),
             calls_per_call=MESH_CALLS[step],
             collective_bytes_per_call=want_bytes,
             host_staging={
                 "by_module": "nothing: collective_echo hands CUDA tensors "
                              "to torch.distributed",
                 "host_link_bytes_per_rank": (
                     {"d2h": want_bytes["in"], "h2d": want_bytes["out"]}
                     if backend == "gloo" else {"d2h": 0, "h2d": 0})},
             bytes_model=model, bound_ms=b_ms, bound_by=b_by,
             share=share(b_ms, ms), launches_per_call=launches,
             launch_floor_ms=launches * floor_ms,
             ranks=[{"device": r["device"], "cuda_tensors": r["is_cuda"],
                     "b1_launches": r["b1_launches"]} for r in per_rank],
             world_wall_s=wall_s, ok=True)
    return b1


def profile_line(step, r, ms, plain_ms, b1_ms, launches):
    """Fields of a profiled step's line from rank 0's result: where the
    host time of a call goes (barrier, the step's own call, the
    synchronize) and the device time by op, B1's kernel and NCCL's
    apart."""
    p = r["profile"]
    ops = p["device_ops"]
    b1_dev = sum(o["ms"] for o in ops if "adler" in o["name"])
    nccl_dev = sum(o["ms"] for o in ops if "nccl" in o["name"].lower())
    return {
        "step": step, "ms_per_call_profiled": ms, "ms_per_call": plain_ms,
        "host_ms": p["host_ms"],
        "device_ms": {"b1_kernel": b1_dev, "nccl_kernel": nccl_dev,
                      "other_ops": sum(o["ms"] for o in ops) - b1_dev - nccl_dev},
        "b1_alone_ms": b1_ms,
        "device_ops_per_call": p["device_ops_per"],
        "launches_per_call_model": launches,
        "device_busy_share": p["busy_share"], "device_ops": ops,
        "idle_gaps": p["idle_gaps"], "clock_shift_ms": p["clock_shift_ms"],
        "timing": "torch.profiler (CPU and CUDA) over the timed calls; "
                  "device ms are per call; host ms medians a call",
        "ok": True}


def registered(nbytes):
    """A page-aligned host buffer of `nbytes` registered with
    cudaHostRegister, as the device path registers its ring's slots
    (uint8 ndarray; unregister with `unregister`)."""
    raw = np.empty(nbytes + 4096, np.uint8)
    off = -raw.ctypes.data % 4096
    arr = raw[off:off + nbytes]
    torch.cuda.check_error(
        torch.cuda.cudart().cudaHostRegister(arr.ctypes.data, nbytes, 0))
    return arr


def unregister(arr):
    torch.cuda.check_error(
        torch.cuda.cudart().cudaHostUnregister(arr.ctypes.data))


def copy_ms(jobs, streams):
    """Device ms of copies: `jobs` holds one list of (dst, src) pairs a
    stream, queued back to back on that stream. The streams wait behind
    a spin on the current stream until every copy is queued, so they
    start together; returns each stream's ms from that start to its last
    copy's end (CUDA events)."""
    torch.cuda._sleep(40_000_000)  # ~20 ms at the SM clock
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    ends = []
    for stream, pairs in zip(streams, jobs):
        stream.wait_event(start)
        with torch.cuda.stream(stream):
            for dst, src in pairs:
                dst.copy_(src, non_blocking=True)
        end = torch.cuda.Event(enable_timing=True)
        end.record(stream)
        ends.append(end)
    torch.cuda.synchronize()
    return [start.elapsed_time(e) for e in ends]


LINK_REPS = 5


def link_rates(h2d, d2h, streams):
    """GB/s of the H2D pairs alone, the D2H pairs alone and both at once
    (two streams), medians of LINK_REPS rounds after a warm-up round;
    "duplex_gbps" is both directions' bytes over the later stream's
    end."""
    nb = [sum(d.nbytes for d, _ in pairs) for pairs in (h2d, d2h)]
    alone, both = [], []
    for _ in range(LINK_REPS + 1):
        alone.append(copy_ms([h2d], streams) + copy_ms([d2h], streams))
        both.append(copy_ms([h2d, d2h], streams))
    out = {}
    for suffix, runs in (("", alone[1:]), ("_concurrent", both[1:])):
        for i, d in enumerate(("h2d", "d2h")):
            out[f"{d}_gbps{suffix}"] = nb[i] / statistics.median(
                r[i] for r in runs) / 1e6
    out["duplex_gbps"] = statistics.median(sum(nb) / max(r) / 1e6
                                           for r in both[1:])
    return out


def host_link(native, dev, smi):
    """Phase host_link: the card's host link on pinned memory at 256 MiB
    and at the device path's chunk size (back-to-back chunk copies from
    and to cudaHostRegister'ed buffers), and this host's rates for the
    device path's per-chunk host work. Returns (link rates at 256 MiB,
    link rates at the chunk size, host ms a chunk)."""
    from brpc_tpu_torch.native import IN_PLACE_HEADROOM as headroom
    chunks_n, payload_bytes = device_path_bytes(DP_PAYLOAD_MB, DP_CHUNK_KB)
    chunk = payload_bytes // chunks_n
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    big = 256 << 20
    h_src = torch.empty(big, dtype=torch.uint8, pin_memory=True)
    h_dst = torch.empty(big, dtype=torch.uint8, pin_memory=True)
    d_src = torch.empty(big, dtype=torch.uint8, device=dev)
    d_dst = torch.empty(big, dtype=torch.uint8, device=dev)
    link = link_rates([(d_dst, h_src)], [(h_dst, d_src)], streams)
    del h_src, h_dst, d_src, d_dst

    # 32 chunks a run, each its own copy, as the ring path issues them.
    n = 32
    hr_src, hr_dst = registered(n * chunk), registered(n * chunk)
    try:
        hs, hd = torch.from_numpy(hr_src), torch.from_numpy(hr_dst)
        check(hs.is_pinned() and hd.is_pinned(),
              "host_link: registered buffers are not seen as pinned")
        ds = torch.empty(n * chunk, dtype=torch.uint8, device=dev)
        dd = torch.empty(n * chunk, dtype=torch.uint8, device=dev)
        parts = [slice(i * chunk, (i + 1) * chunk) for i in range(n)]
        link_chunk = link_rates([(dd[p], hs[p]) for p in parts],
                                [(hd[p], ds[p]) for p in parts], streams)
        del ds, dd
    finally:
        unregister(hr_src)
        unregister(hr_dst)

    # Host work a chunk, over the 257 chunks of a 256 MiB payload (each
    # read from DRAM, as the path reads them), into the slots of a ring.
    payload = np.arange(payload_bytes // 4, dtype=np.uint32)
    chunks = payload.reshape(chunks_n, -1)
    ring = native.DeviceStagingRing(DP_DEPTH, chunk + 1024)
    t = {"copyto": [], "frame_in_place": [], "crc32c": []}
    try:
        for k in range(chunks_n):
            sa = ring.slots[k % ring.depth]
            t0 = time.perf_counter()
            np.copyto(sa[headroom:headroom + chunk].view(np.uint32), chunks[k])
            t1 = time.perf_counter()
            native.frame_in_place(k + 1, sa, headroom, chunk)
            t2 = time.perf_counter()
            native.crc32c(chunks[(k + 128) % chunks_n])
            t3 = time.perf_counter()
            for key, dt in zip(t, (t1 - t0, t2 - t1, t3 - t2)):
                t[key].append(dt * 1e3)
    finally:
        ring.close()
    big_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        native.crc32c(payload)
        big_ms.append((time.perf_counter() - t0) * 1e3)
    host = {k: statistics.median(v) for k, v in t.items()}
    host["crc32c_256mib"] = statistics.median(big_ms)
    emit("host_link", nvidia_smi=smi, bytes_256mib=big,
         link_256mib=link, chunk_bytes=chunk, chunks_a_run=n,
         link_chunk=link_chunk,
         host_ms_per_chunk={k: host[k] for k in t},
         host_gbps={**{k: chunk / host[k] / 1e6 for k in t},
                    "crc32c_256mib": payload.nbytes / host["crc32c_256mib"] / 1e6},
         timing=(f"link: CUDA events, median of {LINK_REPS} runs after a "
                 "warm-up, pinned (256 MiB) or cudaHostRegister'ed (chunks) host "
                 "memory; host: perf_counter, median over the 257 chunks "
                 "of a 256 MiB payload (crc32c over 256 MiB: median of 5)"),
         ok=True)
    return link, link_chunk, host


def split_parts(device_path, native, pipe):
    """The parts of the ring path's host work a chunk: name -> the
    (owner, attribute) places the path calls it through."""
    return {
        "np.copyto": [(np, "copyto")],
        "native.frame_in_place": [(native, "frame_in_place")],
        "native.crc32c": [(native, "crc32c")],
        "DeviceStagingRing.acquire": [(pipe.ring, "acquire")],
        "Event.synchronize (D2H wait)": [(e, "synchronize")
                                         for e in pipe.d2h_done],
        "H2D enqueue (_h2d)": [(pipe, "_h2d")],
        "D2H enqueue (_d2h)": [(pipe, "_d2h")],
        "integrity_word (B2 launch)": [(device_path, "integrity_word")],
    }


_ABSENT = object()


@contextlib.contextmanager
def timed_calls(places):
    """Inside the block every callable at places[name] (owner,
    attribute) adds its calls' perf_counter seconds to the yielded
    dict's `name`; the owners get their attributes back afterwards."""
    spent = dict.fromkeys(places, 0.0)
    saved = []
    for name, owners in places.items():
        for owner, attr in owners:
            fn = getattr(owner, attr)

            def timed(*args, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*args, **kw)
                finally:
                    spent[_name] += time.perf_counter() - t0

            saved.append((owner, attr, vars(owner).get(attr, _ABSENT)))
            setattr(owner, attr, timed)
    try:
        yield spent
    finally:
        for owner, attr, old in reversed(saved):
            if old is _ABSENT:
                delattr(owner, attr)  # the class's, seen through the owner
            else:
                setattr(owner, attr, old)


# Plain and timed passes of the host split, in turns.
SPLIT_ROUNDS = 5


def host_split(device_path, native, pipe, chunks_n):
    """Host ms a chunk of the ring path: SPLIT_ROUNDS plain passes in
    turns with SPLIT_ROUNDS passes that have a perf_counter timer around
    each part's calls (the order swapped every round). Returns (the
    timed passes' split, the mean over them, with the rest of their
    wall time as "everything else"; the median wall of the plain passes
    and of the timed passes)."""
    walls = {"plain": [], "timed": []}
    spent = dict.fromkeys(split_parts(device_path, native, pipe), 0.0)
    for i in range(2 * SPLIT_ROUNDS):
        kind = ("plain", "timed")[(i + i // 2) % 2]  # p t, t p, p t, ...
        places = split_parts(device_path, native, pipe) if kind == "timed" \
            else {}
        with timed_calls(places) as one:
            t0 = time.perf_counter()
            pipe.run(1)
            walls[kind].append(time.perf_counter() - t0)
        for k, v in one.items():
            spent[k] += v
    per = 1e3 / (SPLIT_ROUNDS * chunks_n)
    split = {k: v * per for k, v in spent.items()}
    split["everything else"] = (sum(walls["timed"]) - sum(spent.values())) * per
    return split, {k: statistics.median(v) * 1e3 / chunks_n
                   for k, v in walls.items()}


def device_path_split(dev, link, link_chunk, host, record, smi):
    """Phase device_path_split: the device path's bound against the host
    link and its host floor, then one pipelined ring at the main path's
    shape driven from outside: plain passes in turns with passes that
    have a timer around each part of the host work, and one pass under
    torch.profiler (CPU and CUDA, with Python stacks)."""
    from brpc_tpu_torch import device_path, native
    from brpc_tpu_torch.profiling import profiler, trace_events, trace_summary
    chunks_n, payload_bytes = device_path_bytes(DP_PAYLOAD_MB, DP_CHUNK_KB)
    chunk = payload_bytes // chunks_n
    pass_ms = 2 * payload_bytes / (record["device_path_gbps"] * 1e9) * 1e3
    bound_ms = host_link_ms(payload_bytes, payload_bytes, link)
    bound_chunk_ms = host_link_ms(payload_bytes, payload_bytes, link_chunk)
    rates_floor_ms = chunks_n * (host["copyto"] + host["frame_in_place"]
                                 + host["crc32c"])

    payload = np.arange(payload_bytes // 4, dtype=np.uint32)
    chunks = list(payload.reshape(chunks_n, -1))
    ring = native.DeviceStagingRing(DP_DEPTH, chunk + 1024)
    pipe = None
    try:
        pipe = device_path._ChunkPipeline(ring, chunks, dev, DP_DEPTH, False)
        pipe.run(1)  # warm-up
        split, wall = host_split(device_path, native, pipe, chunks_n)
        with profiler(pipe.dbuf[0], with_stack=True) as prof:
            with torch.profiler.record_function("device_path_pass"):
                pipe.run(1)
        traced = trace_summary(trace_events(prof), "device_path_pass",
                               chunks_n)
        check(pipe.ok, "device_path_split: a returned chunk failed its crc")
    finally:
        if pipe is not None:
            pipe.close()
        ring.close()
    # The timed parts are disjoint calls, so they cannot sum past the
    # wall time of their passes: "everything else" is not negative.
    check(min(split.values()) >= 0,
          f"device_path_split: a part of the host split is negative: {split}")
    # The split is of the timed passes: it stands for the path only if
    # the timers leave the passes' wall time as it is.
    check(abs(wall["timed"] - wall["plain"]) <= 0.10 * wall["plain"],
          f"device_path_split: the timed passes take {wall['timed']} ms a "
          f"chunk against {wall['plain']} ms for the plain passes")
    check(traced["busy_share"] is not None,
          "device_path_split: torch.profiler saw no device activity")
    # The host floor of the timed passes, from their own parts: the
    # staging copy, the framing (its crc32c) and the verify crc32c.
    floor_ms = chunks_n * (split["np.copyto"] + split["native.frame_in_place"]
                           + split["native.crc32c"])
    timed_pass_ms = chunks_n * sum(split.values())
    emit("device_path_split", nvidia_smi=smi,
         device_path_gbps=record["device_path_gbps"],
         pass_bytes_each_way=payload_bytes, chunks=chunks_n,
         pass_ms=pass_ms,
         bound_ms=bound_ms, bound_by="host_link",
         share_of_bound=share(bound_ms, pass_ms),
         bound_ms_at_chunk_rates=bound_chunk_ms,
         share_of_bound_at_chunk_rates=share(bound_chunk_ms, pass_ms),
         host_floor_ms=floor_ms, timed_pass_ms=timed_pass_ms,
         share_of_host_floor=share(floor_ms, timed_pass_ms),
         # Not a bound of pass_ms: the host's rates move between phases.
         host_floor_ms_at_host_link_rates=rates_floor_ms,
         host_floor_at_host_link_rates_over_pass_ms=rates_floor_ms / pass_ms,
         wall_ms_per_chunk={"device_path_run": pass_ms / chunks_n,
                            "plain_passes": wall["plain"],
                            "timed_passes": wall["timed"]},
         host_ms_per_chunk=split,
         host_split_sum_ms=sum(split.values()),
         device_busy_share=traced["busy_share"],
         device_ops=traced["device_ops"],
         device_ops_per_chunk=traced["device_ops_per"],
         idle_gaps=traced["idle_gaps"],
         clock_shift_ms=traced["clock_shift_ms"],
         timing=(f"host: perf_counter around each part, mean of "
                 f"{SPLIT_ROUNDS} timed passes; walls: medians of "
                 f"{SPLIT_ROUNDS} plain and {SPLIT_ROUNDS} timed passes in "
                 "turns; device: torch.profiler over one pass, CPU and "
                 "CUDA, with Python stacks (np.copyto's time is its "
                 "caller _launch's own)"),
         ok=True)


def copies_for(nbytes):
    """Enough distinct copies of an input to span 128 MiB (> the 50 MB L2)."""
    return max(1, -(-(128 << 20) // nbytes))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device found", file=sys.stderr)
        return 2
    from brpc_tpu_torch import native
    from brpc_tpu_torch.convert import words_from_numpy, words_to_numpy
    from brpc_tpu_torch.device_path import run as device_path_run
    from brpc_tpu_torch.graft_entry import (dryrun_multichip, dryrun_payloads,
                                            entry)
    from brpc_tpu_torch.kernels import _build
    from brpc_tpu_torch.kernels.checksum import (adler_frame_checksum,
                                                 adler_frame_checksum_ref)
    from brpc_tpu_torch.kernels.integrity import (integrity_word,
                                                  integrity_word_ref)
    from brpc_tpu_torch.parallel.collective_echo import echo_step

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    # 1. card
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit("card", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         tools={t: shutil.which(t) for t in
                ("nvcc", "ninja", "cmake", "protoc", "g++")})

    # 2. build, both at once
    t0 = time.monotonic()
    with ThreadPoolExecutor(max_workers=2) as pool:
        kern = pool.submit(_build.build)
        rpc = pool.submit(native.build)
        kinfo, route = kern.result(), rpc.result()
    emit("build", seconds=round(time.monotonic() - t0, 3),
         kernels_so=kinfo["so"], kernels_seconds=round(kinfo["seconds"], 3),
         ptxas=kinfo["ptxas"], libtpurpc_route=route,
         b2_cluster_blocks=_build.lib().brpc_tpu_torch_integrity_word_cluster())
    for obj in sorted(_build.BUILD_DIR.glob("*.o")):
        emit("sass", object=obj.name, kernels=sass_counts(obj))

    def misaligned(arr):
        """A contiguous view of `arr` on the card that starts one word
        into its storage (not 16-byte aligned)."""
        flat = words_from_numpy(
            np.concatenate([np.zeros(1, np.uint32), arr.reshape(-1)]), dev)
        return flat[1:].view(arr.shape)

    def held(kernel, ref, arr, shifted=False):
        """Kernel and plain version on the same card tensor (a misaligned
        view if `shifted`); returns (kernel output as uint32 ndarray,
        max |kernel - plain|)."""
        x = misaligned(arr) if shifted else words_from_numpy(arr, dev)
        got = words_to_numpy(kernel(x)).astype(np.int64)
        want = words_to_numpy(ref(x)).astype(np.int64)
        torch.cuda.synchronize()
        return got, int(np.abs(got - want).max())

    # 3. B1 against its plain version
    b1_cases = {
        "random(8,1024)": rng.integers(0, 2**32, (8, 1024), dtype=np.uint32),
        "(8,96)*2654435761": (np.arange(8 * 96, dtype=np.uint32).reshape(8, 96)
                              * np.uint32(2654435761)),
        "ones(4,262144)": np.full((4, 262144), 0xFFFFFFFF, np.uint32),
        "random(2,65536)": rng.integers(0, 2**32, (2, 65536), dtype=np.uint32),
        "random(4096,1024)": rng.integers(0, 2**32, (4096, 1024),
                                          dtype=np.uint32),
        "random(256,262144)": rng.integers(0, 2**32, (256, 262144),
                                           dtype=np.uint32),
        "random(32,262144)": rng.integers(0, 2**32, (32, 262144),
                                          dtype=np.uint32),
        "random(3,4097)": rng.integers(0, 2**32, (3, 4097), dtype=np.uint32),
        "random(5,262147)": rng.integers(0, 2**32, (5, 262147),
                                         dtype=np.uint32),
        "random(7,1021)": rng.integers(0, 2**32, (7, 1021), dtype=np.uint32),
    }
    # Every case as it is, then three as views that start one word into
    # their storage.
    b1_runs = [(name, False) for name in b1_cases] + [
        (name, True) for name in ("random(7,1021)", "random(5,262147)",
                                  "random(32,262144)")]
    b1_err = 0
    for name, shifted in b1_runs:
        arr = b1_cases[name]
        got, err = held(adler_frame_checksum, adler_frame_checksum_ref, arr,
                        shifted)
        name += " misaligned" if shifted else ""
        emit("b1_vs_plain", case=name, max_abs_err=err)
        check(err == 0, f"B1 differs from its plain version on {name}")
        b1_err = max(b1_err, err)
        if name == "ones(4,262144)":
            check((got == JAX_ALL_ONES_262144).all(),
                  "B1 on all-ones 1 MiB rows differs from the JAX value")

    # 4. B2 against its plain version
    b2_err = 0
    b2_runs = [(kind, n, False) for n in (130048, 261120, 523264)
               for kind in ("random", "ones")]
    b2_runs += [("random", 261121, False), ("random", 261120, True),
                ("random", 523264, True), ("random", 3, True)]
    for kind, n, shifted in b2_runs:
        arr = (rng.integers(0, 2**32, n, dtype=np.uint32) if kind == "random"
               else np.full(n, 0xFFFFFFFF, np.uint32))
        _, err = held(integrity_word, integrity_word_ref, arr, shifted)
        case = f"{kind}({n})" + (" misaligned" if shifted else "")
        emit("b2_vs_plain", case=case, max_abs_err=err)
        check(err == 0, f"B2 differs from its plain version on {case}")
        b2_err = max(b2_err, err)

    # 5. times: the main path's shapes, a few long B1 rows, the launch
    # floor, and B1 on an input held in L2
    timings = {}

    def timed(name, fn, ref, arr, iters, plain_iters, out_bytes, ops):
        xs = [words_from_numpy(arr, dev)
              for _ in range(copies_for(arr.nbytes))]
        ms = graph_ms(fn, xs, iters)
        plain_ms = graph_ms(ref, xs[:1], plain_iters)
        b_ms, b_by = bound(arr.nbytes + out_bytes, ops)
        timings[(name, arr.shape)] = (ms, plain_ms, b_ms, b_by)
        emit("time", kernel=name, shape=list(arr.shape), ms=ms,
             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
             gbps=arr.nbytes / ms / 1e6, share_of_bound=b_ms / ms)

    for shape, iters, plain_iters in (((8, 1024), 200, 20),
                                      ((4096, 1024), 50, 10),
                                      ((32, 262144), 20, 4),
                                      ((256, 262144), 10, 2)):
        timed("adler_frame_checksum", adler_frame_checksum,
              adler_frame_checksum_ref, b1_cases[f"random({shape[0]},{shape[1]})"],
              iters, plain_iters, 4 * shape[0], 8 * shape[0] * shape[1])
    for n in (130048, 261120, 523264):
        timed("integrity_word", integrity_word, integrity_word_ref,
              rng.integers(0, 2**32, n, dtype=np.uint32), 200, 20, 4, 4 * n)
    torch.cuda.empty_cache()
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    floor_ms = graph_ms(lambda t: t.zero_(), [one], 1000)
    emit("launch_floor", what="one-element zero_() per graph node",
         ms=floor_ms)
    # B2 on no words still launches its cluster: its fixed cost.
    empty = words_from_numpy(np.zeros(0, np.uint32), dev)
    emit("fixed_cost", kernel="integrity_word", shape=[0],
         ms=graph_ms(integrity_word, [empty], 1000), launch_floor_ms=floor_ms)
    # 32 MiB, one copy replayed, stays in the 50 MB L2: the kernel's time
    # without HBM, beside its time cycled over 128 MiB above.
    x = words_from_numpy(b1_cases["random(32,262144)"], dev)
    l2_ms = graph_ms(adler_frame_checksum, [x], 50)
    emit("l2_resident", kernel="adler_frame_checksum", shape=[32, 262144],
         ms=l2_ms, hbm_ms=timings[("adler_frame_checksum", (32, 262144))][0],
         hbm_bound_ms=bound(x.numel() * 4, 0)[0])
    del x
    torch.cuda.empty_cache()

    # host_link: the card's host link and this host's per-chunk work
    link, link_chunk, host = host_link(native, dev, smi)
    torch.cuda.empty_cache()

    # 6. the main path, counters from 0
    adler_frame_checksum.launches = 0
    integrity_word.launches = 0
    fn, (payloads,) = entry()
    checksums, lengths, echoed = fn(payloads)
    echo_cases = [("entry(8,1024)", payloads, checksums, lengths, echoed)]
    for shape in ((4096, 1024), (256, 262144)):
        p = words_from_numpy(b1_cases[f"random({shape[0]},{shape[1]})"], dev)
        echo_cases.append((f"echo_step{shape}", p, *echo_step(p)))
    diag = {}
    record = device_path_run(payload_mb=DP_PAYLOAD_MB, reps=DP_REPS,
                             ring_depth=DP_DEPTH, chunk_kb=DP_CHUNK_KB,
                             diag=diag)
    torch.cuda.synchronize()
    launches = {"adler_frame_checksum": adler_frame_checksum.launches,
                "integrity_word": integrity_word.launches}

    for name, p, c, ln, e in echo_cases:
        batch, words = p.shape
        want = words_to_numpy(adler_frame_checksum_ref(p))
        got = words_to_numpy(c)
        check(c.shape == (batch,) and (got == want).all(),
              f"{name}: checksums differ from the plain version")
        check((words_to_numpy(ln) == words * 4).all(), f"{name}: length words")
        check(e is p, f"{name}: the echo is not the input tensor")
        emit("echo_step", case=name, shape=[batch, words],
             checksum0=f"{int(got[0]):#010x}", ok=True)
    emit("device_path", record=record, **diag)
    check(record["device_path_ok"], "device_path_ok is false")
    check(diag["slot_pinned"], "ring slots were not seen as pinned")
    check((diag["chunks"], diag["payload_bytes"])
          == device_path_bytes(DP_PAYLOAD_MB, DP_CHUNK_KB),
          "device_path: the pass's shape differs from the byte model")

    # device_path_split (after the counters were read): the device path's
    # bound and where its host time goes
    device_path_split(dev, link, link_chunk, host, record, smi)

    # 7. launch counters
    emit("launches", kernels=list(launches), **launches)
    for name, count in launches.items():
        check(count > 0, f"{name} was never launched on the main path")

    # 8. mesh: 8 ranks on the one card over gloo
    torch.cuda.empty_cache()
    b1_mesh_ms = timings[("adler_frame_checksum", (32, 262144))][0]
    mesh_launches = {"mesh": mesh_world("mesh", 8, "gloo", SEED, link,
                                        b1_mesh_ms, floor_ms)}

    # 9. dryrun_multichip over the same kind of world
    t0 = time.monotonic()
    dry = dryrun_multichip(8, backend="gloo")
    dry_s = time.monotonic() - t0
    req = dryrun_payloads(8)
    want = words_to_numpy(adler_frame_checksum_ref(torch.from_numpy(req)))
    check(np.array_equal(dry["outputs"], req), "dryrun: echo is not exact")
    check(np.array_equal(dry["checksums"], want), "dryrun: partition checksums")
    check(int(dry["total"]) == int(want.astype(np.int64).sum()) & 0xFFFFFFFF,
          "dryrun: total")
    check(all(dry["cuda_tensors"]) and min(dry["b1_launches"]) > 0,
          "dryrun: a rank ran without CUDA tensors or without B1")
    mesh_launches["dryrun"] = sum(dry["b1_launches"])
    emit("dryrun_multichip", n=8, backend=dry["backend"],
         devices=dry["devices"], cuda_tensors=dry["cuda_tensors"],
         b1_launches=dry["b1_launches"], total=f"{int(dry['total']):#010x}",
         framed_round_trips=16, seconds=dry_s, ok=True)

    # 10. the NCCL path: one rank on the card
    mesh_launches["nccl"] = mesh_world(
        "mesh_nccl", 1, "nccl", SEED + 100, link, b1_mesh_ms, floor_ms,
        profile=("partition", "parallel_echo"))

    entries = [
        ("adler_frame_checksum", "brpc_tpu_torch/csrc/adler_checksum.cu",
         "brpc_tpu/parallel/collective_echo.py:23", (256, 262144), b1_err),
        ("integrity_word", "brpc_tpu_torch/csrc/integrity_word.cu",
         "brpc_tpu/device_path.py:38", (261120,), b2_err),
    ]
    kernels = []
    for name, source, replaces, shape, err in entries:
        ms, plain_ms, b_ms, b_by = timings[(name, shape)]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "shape": list(shape),
            "launches": launches[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            # No single PyTorch call computes either function.
            "library_ms": None,
            "shapes": [{"shape": list(k[1]), "ms": v[0], "plain_ms": v[1],
                        "bound_ms": v[2], "bound_by": v[3]}
                       for k, v in timings.items() if k[0] == name],
            "launch_floor_ms": floor_ms})
    kernels[0]["mesh_launches"] = sum(mesh_launches.values())
    kernels[0]["mesh_launches_by_phase"] = mesh_launches
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
