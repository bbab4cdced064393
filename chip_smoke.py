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
  6. the main path with launch counters set to 0: entry(), echo_step at
     (4096, 1024), and one run of each cell of the benchmark through
     bench_torch (BENCHMARK.json; one bench_cell line each, with its
     checks against bench_torch.reference and its metrics): the echo_step
     cells, and the device path over a 256 MiB payload (ring
     depth 4, 1020 KiB chunks; the device_path line gives the count of
     worker threads that run its host passes), which measures:
     host_link: the card's host link on pinned memory, 256 MiB H2D
     alone, D2H alone and both at once on two streams, and the same at
     the device path's chunk size (1020 KiB, back-to-back copies from
     cudaHostRegister'ed buffers);
     device_path_split: the device path's bound over the host link,
     with the share that device_path_gbps reaches; the traced pass,
     one ring of the path driven pass by pass: plain passes in turns
     with passes that have a timer around each part of the host work
     (host ms a chunk by part, every thread's calls summed; the
     calling thread's wall less its own union of timed calls as
     "everything else"; a timed pass's wall over its round's plain
     one, median over the rounds, must lie within 10 % of 1), the
     threads that made timed calls, the busiest thread's union of
     timed calls a chunk (host_critical_ms_per_chunk), the host floor
     of the timed passes (the busiest thread's union of its staging
     copy, framing and verify crc32c calls) with its share, and one
     pass under torch.profiler (device ops, the device's busy share,
     the longest idle gaps with what the host did in each); this
     host's rates for the three host passes over a chunk (np.copyto
     into a ring slot, native.frame_in_place, native.crc32c), each
     pass's ms a chunk on one thread and GB/s on 1 and on 4 threads at
     once (host_passes, with the CPU count); every output is checked;
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
import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from bench_torch.bounds import (MESH_CALLS, bound, collective_bytes,
                                device_path_bytes, echo_bytes, echo_ops,
                                integrity_bytes, integrity_ops,
                                launches_per_call, mesh_bound, share)
from bench_torch.measure import copies_for, graph_ms, nvidia_smi_line

SEED = 20261017
JAX_ALL_ONES_262144 = 0x31DD0069  # JAX _adler_frame_checksum, one all-ones 1 MiB row


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


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


# The mesh phases: 1 MiB of words a row, (step, rows a rank).
MESH_WORDS = 262144
MESH_STEPS = (("parallel_echo", 1), ("partition", 32), ("allreduce", 1),
              ("allgather", 1), ("alltoall", 1))
MESH_REPS = 5
# The device path's cell of BENCHMARK.json; every cell runs once on the
# main path.
DEVICE_PATH_CELL = "device_path-256MiB-1020KiB-d4"


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device found", file=sys.stderr)
        return 2
    from bench_torch import cells
    from brpc_tpu_torch import device_path, native
    from brpc_tpu_torch.convert import words_from_numpy, words_to_numpy
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

    def timed(name, fn, ref, arr, iters, plain_iters, nbytes, ops):
        xs = [words_from_numpy(arr, dev)
              for _ in range(copies_for(arr.nbytes))]
        ms = graph_ms(fn, xs, iters)
        plain_ms = graph_ms(ref, xs[:1], plain_iters)
        b_ms, b_by = bound(nbytes, ops)
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
              iters, plain_iters, echo_bytes(*shape), echo_ops(*shape))
    for n in (130048, 261120, 523264):
        timed("integrity_word", integrity_word, integrity_word_ref,
              rng.integers(0, 2**32, n, dtype=np.uint32), 200, 20,
              integrity_bytes(n), integrity_ops(n))
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

    # 6. the main path, counters from 0: entry(), echo_step at
    # (4096, 1024), and one run of each cell of the benchmark (echo_step
    # at (256, 262144); the device path with its host_link measurement
    # and its traced pass)
    adler_frame_checksum.launches = 0
    integrity_word.launches = 0
    fn, (payloads,) = entry()
    checksums, lengths, echoed = fn(payloads)
    echo_cases = [("entry(8,1024)", payloads, checksums, lengths, echoed)]
    p = words_from_numpy(b1_cases["random(4096,1024)"], dev)
    echo_cases.append(("echo_step(4096, 1024)", p, *echo_step(p)))
    cell = {name: cells.run_cell(name, SEED, dev)
            for name in sorted(cells.workloads(),
                               key=lambda n: n == DEVICE_PATH_CELL)}
    torch.cuda.synchronize()
    launches = {"adler_frame_checksum": adler_frame_checksum.launches,
                "integrity_word": integrity_word.launches}
    torch.cuda.empty_cache()

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
    for name, out in cell.items():
        emit("bench_cell", cell=name, correct=out["correct"],
             checks=out["checks"],
             metrics={k: {"value": v, "unit": u}
                      for k, (v, u) in out["metrics"].items()})
        check(out["correct"], f"{name}: a check failed: {out['checks']}")
    dp = cell[DEVICE_PATH_CELL]
    cfg = cells.config(DEVICE_PATH_CELL)
    link = dp["host_link"]["link_256mib"]
    emit("host_link", nvidia_smi=smi, **dp["host_link"], ok=True)
    record, diag = dp["record"], dp["diag"]
    emit("device_path", record=record,
         workers=device_path._worker_count(cfg["ring_depth"]), **diag)
    check(record["device_path_ok"], "device_path_ok is false")
    check(diag["slot_pinned"], "ring slots were not seen as pinned")
    check((diag["chunks"], diag["payload_bytes"])
          == device_path_bytes(cfg["payload_mb"], cfg["chunk_kb"]),
          "device_path: the pass's shape differs from the byte model")

    # device_path_split: the device path's bound and where its host time
    # goes, from the cell's traced pass
    split = dp["device_path_split"]
    emit("device_path_split", nvidia_smi=smi, **split, ok=True)
    # "everything else" is the calling thread's wall less its own union
    # of timed calls: it cannot fall below 0, however many threads run
    # parts.
    check(None not in split["host_ms_per_chunk"].values()
          and min(split["host_ms_per_chunk"].values()) >= 0,
          f"device_path_split: a part of the host split is missing or "
          f"negative: {split['host_ms_per_chunk']}")
    check(all(v is None or v > 0
              for v in split["host_passes"]["gbps"].values()),
          f"device_path_split: host pass rates {split['host_passes']}")
    # The split is of the timed samples: it stands for the path only if
    # the timers leave the samples' wall time as it is (each timed
    # sample against the plain one of its round, so the host's drift
    # through the run cancels).
    check(abs(split["timed_over_plain"] - 1) <= 0.10,
          f"device_path_split: the timed samples take "
          f"{split['timed_over_plain']} x the plain ones' wall "
          f"({split['wall_ms_per_chunk']})")
    check(split["device_busy_share"] is not None,
          "device_path_split: torch.profiler saw no device activity")

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
