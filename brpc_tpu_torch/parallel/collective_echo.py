"""The RPC data-plane computation, on one device and across ranks.

`echo_step` models what the framework does to every payload: frame it
(length + checksum header) and echo it back. The mesh builders are the
combo channels lowered onto torch.distributed collectives:
`make_parallel_echo_step` is the ParallelChannel fan-out (AllGather ->
serve -> ReduceScatter), `make_partition_echo_step` the PartitionChannel
sharding (per-rank shards + an all-reduce merge), and
`make_allreduce_step`, `make_allgather_step` and `make_alltoall_step`
the collective twins of the C++ mesh. Port of
brpc_tpu/parallel/collective_echo.py.

The steps are SPMD by process, where the JAX steps are SPMD by
`shard_map`: a JAX step takes the global uint32[n, ...] array and hands
each device its shard; a port step takes the calling rank's own shard
(what the JAX `_shard_body` sees) and returns the rank's part of the
output. Each builder takes a process group (default: the world), which
plays the role of the JAX `mesh` argument. Putting the ranks' outputs
back together in rank order gives the JAX step's global output.

Words cross the collectives as int32 bit views: gloo refuses
torch.uint32 ("Invalid scalar type"), and an int32 SUM wraps exactly as
a uint32 sum does. Only `_collective` knows about the views; callers
see torch.uint32. CUDA tensors go to the collectives as they are, also
on gloo: on torch 2.11 gloo takes them for all four collectives used
here (all_gather_into_tensor, reduce_scatter_tensor, all_to_all_single,
all_reduce), so no operand is staged through the host by this module.
gloo itself copies each CUDA operand to host memory and each result
back: the bytes that `nbytes` counts then cross the card's host link.
"""
from __future__ import annotations

import contextlib
import statistics
import time
import warnings
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist

from brpc_tpu_torch.convert import (int64_to_uint32, uint32_to_int64,
                                    words_from_numpy)
from brpc_tpu_torch.kernels.checksum import (adler_frame_checksum,
                                             adler_frame_checksum_ref)
from brpc_tpu_torch.profiling import profiler, trace_events, trace_summary

# Collective calls made by this process, by name, and the bytes of the
# operands handed to them: "in" the inputs they read, "out" the outputs
# they write (all_reduce's one tensor counts both ways).
calls: Counter = Counter()
nbytes: Counter = Counter()
# The host range that run_cases labels around each profiled call.
STEP_CALL = "step_call"


def _adler_frame_checksum(words: torch.Tensor) -> torch.Tensor:
    """Order-dependent checksum over uint32 words (last axis): plays the
    role crc32c plays in the reference's baidu_std frames. Runs kernel
    B1 on a CUDA tensor."""
    return adler_frame_checksum(words)


def echo_step(payloads: torch.Tensor) -> tuple:
    """Frame + echo a batch of payloads: returns (checksums, lengths,
    echoed) with checksums and lengths uint32[batch] and echoed the
    input tensor itself.

    payloads: uint32[batch, words].
    """
    if payloads.dim() != 2:
        raise ValueError(f"expected uint32[batch, words], got {tuple(payloads.shape)}")
    checksums = _adler_frame_checksum(payloads)
    # The echo "service": identity transform on the payload, plus a
    # framed length word.
    lengths = torch.full((payloads.shape[0],), payloads.shape[1] * 4,
                         dtype=torch.int32,
                         device=payloads.device).view(torch.uint32)
    return checksums, lengths, payloads


def _words(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32,
                       device=like.device).view(torch.uint32)


def _collective(name: str, group, out: torch.Tensor, *inputs: torch.Tensor,
                **kw) -> None:
    """torch.distributed's collective `name` on uint32 tensors through
    int32 views; writes `out` (in place for all_reduce, which takes no
    input)."""
    views = [t.view(torch.int32) for t in (out, *inputs)]
    with warnings.catch_warnings():
        # torch 2.13 renames all_gather_into_tensor and
        # reduce_scatter_tensor (FutureWarning); the old names are the
        # ones every torch this port runs on has.
        warnings.filterwarnings("ignore", category=FutureWarning,
                                message=r".*is deprecated")
        getattr(dist, name)(*views, group=group, **kw)
    calls[name] += 1
    nbytes["in"] += sum(t.nbytes for t in (inputs or (out,)))
    nbytes["out"] += out.nbytes


def make_parallel_echo_step(group=None):
    """ParallelChannel fan-out over the ranks of `group`: AllGather ->
    serve -> ReduceScatter.

    Returns a step: the rank's request uint32[1, words] -> the rank's
    merged response uint32[1, words] (row i of the JAX step's output).
    """
    def step(local: torch.Tensor) -> torch.Tensor:
        if local.dim() != 2 or local.shape[0] != 1:
            # The JAX step's responder mask has one entry a peer, so it
            # too takes exactly one request a peer.
            raise ValueError("parallel echo takes one request a rank, "
                             f"uint32[1, words]; got {tuple(local.shape)}")
        n = dist.get_world_size(group)
        me = dist.get_rank(group)
        # Fan-out: every rank sees all requests.
        all_reqs = _words((n, local.shape[1]), local)
        _collective("all_gather_into_tensor", group, all_reqs, local)
        # Request i is served by its designated responder, rank
        # (i+1) mod n; the others contribute zeros, so the merge routes
        # exactly one response to each caller with no arithmetic on the
        # payload's bits.
        req_idx = torch.arange(n, device=local.device)
        is_responder = ((req_idx + 1) % n) == me
        served = torch.where(is_responder[:, None],
                             all_reqs.view(torch.int32), 0).view(torch.uint32)
        # Merge responses back to callers (ResponseMerger).
        merged = _words(local.shape, local)
        _collective("reduce_scatter_tensor", group, merged, served,
                    op=dist.ReduceOp.SUM)
        return merged

    return step


def make_allreduce_step(group=None):
    """The mesh all-reduce: uint32[1, words] -> the elementwise uint32
    wrapping sum over the ranks, uint32[1, words], on every rank (twin
    of the C++ chunked ring, cpp/trpc/collective.h)."""
    def step(local: torch.Tensor) -> torch.Tensor:
        out = local.clone()
        _collective("all_reduce", group, out, op=dist.ReduceOp.SUM)
        return out

    return step


def make_allgather_step(group=None):
    """The mesh all-gather: every rank collects all ranks' blocks, in
    rank order. uint32[rows, words] -> uint32[1, n*rows*words]."""
    def step(local: torch.Tensor) -> torch.Tensor:
        n = dist.get_world_size(group)
        out = _words((n * local.shape[0], *local.shape[1:]), local)
        _collective("all_gather_into_tensor", group, out, local.contiguous())
        return out.reshape(1, -1)

    return step


def make_alltoall_step(group=None):
    """The mesh all-to-all: block j of rank r lands on rank j as its
    block r. uint32[1, n*block] -> uint32[1, n*block], the concatenation
    of every rank's block for this rank."""
    def step(local: torch.Tensor) -> torch.Tensor:
        n = dist.get_world_size(group)
        if local.numel() % n:
            raise ValueError(f"{local.numel()} words do not split into "
                             f"{n} blocks")
        blocks = local.reshape(n, -1)
        out = _words(blocks.shape, local)
        _collective("all_to_all_single", group, out, blocks.contiguous())
        return out.reshape(1, -1)

    return step


def make_partition_echo_step(group=None):
    """PartitionChannel sharding: each rank owns its shard of the
    partitions, serves it (frame checksum + echo), and the merged
    integrity word is one all-reduce.

    Returns a step: the rank's shard uint32[parts, words] ->
    (checksums uint32[parts], the shard itself, total uint32[]), where
    total, the uint32 wrapping sum of every rank's checksums, is the
    same on every rank.
    """
    def step(local: torch.Tensor):
        check = _adler_frame_checksum(local)
        # The local sum in int64, masked to 32 bits; the all-reduce then
        # wraps as the JAX uint32 psum does.
        total = int64_to_uint32(
            (uint32_to_int64(check).sum() & 0xFFFFFFFF).reshape(1))
        _collective("all_reduce", group, total, op=dist.ReduceOp.SUM)
        return check, local, total.reshape(())

    return step


STEPS = {
    "parallel_echo": make_parallel_echo_step,
    "allreduce": make_allreduce_step,
    "allgather": make_allgather_step,
    "alltoall": make_alltoall_step,
    "partition": make_partition_echo_step,
}


def shard(data, member: int, members: int) -> np.ndarray:
    """A rank's input of one case: `data` is either the global uint32
    array, cut by rows into `members` shards, or ("random", seed, rows,
    words), the rank's own shard drawn from numpy's generator seeded
    with (seed, member)."""
    if isinstance(data, np.ndarray):
        rows, rest = divmod(data.shape[0], members)
        if rest:
            raise ValueError(f"{data.shape[0]} rows do not split into "
                             f"{members} shards")
        return data[member * rows:(member + 1) * rows]
    _, seed, rows, words = data
    rng = np.random.default_rng((seed, member))
    return rng.integers(0, 2**32, (rows, words), dtype=np.uint32)


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def run_cases(rank, cases: list, reps: int = 0) -> list:
    """Runs mesh steps in one rank of a world (`world.run` target
    "brpc_tpu_torch.parallel.collective_echo:run_cases").

    Each case is a dict: "name", "step" (a key of STEPS), "data" (see
    `shard`), optionally "ranks" (the members of a subgroup the step
    runs over; default the world), "keep" (return the outputs; default
    True) and "profile" (run the timed calls under torch.profiler;
    default False). A member calls the step once, then `reps` timed
    calls, each after a barrier and ended by a synchronize. Returns,
    per case: the outputs, the median ms of the timed calls, the
    collective calls and operand bytes (`nbytes`) per step call, B1's
    launches, for the partition step B1's largest difference from its
    plain version on the rank's shard, and for a profiled case what
    `trace_summary` saw in the timed calls plus the median host ms of
    the barrier, of the step's own call and of the synchronize."""
    results = []
    for case in cases:
        members = case.get("ranks", list(range(rank.size)))
        # new_group is collective over the whole world, members or not.
        group = None if "ranks" not in case else dist.new_group(members)
        if rank.rank not in members:
            results.append({"name": case["name"], "member": False})
            continue
        member = members.index(rank.rank)
        local = words_from_numpy(shard(case["data"], member, len(members)),
                                 rank.device)
        step = STEPS[case["step"]](group)
        calls0, nbytes0 = Counter(calls), Counter(nbytes)
        launches0 = adler_frame_checksum.launches
        out = step(local)
        profile = case.get("profile", False)
        window = ((lambda: torch.profiler.record_function(STEP_CALL))
                  if profile else contextlib.nullcontext)
        times, host = [], []
        with (profiler(local) if profile else contextlib.nullcontext()) as prof:
            for _ in range(reps):
                _sync(local)
                tb = time.perf_counter()
                dist.barrier(group)
                t0 = time.perf_counter()
                with window():
                    step(local)
                    t1 = time.perf_counter()
                    _sync(local)
                t2 = time.perf_counter()
                times.append((t2 - t0) * 1e3)
                host.append((t0 - tb, t1 - t0, t2 - t1))
        outputs = out if isinstance(out, tuple) else (out,)
        res = {
            "name": case["name"], "member": True, "device": str(local.device),
            "is_cuda": local.is_cuda, "backend": rank.backend,
            "ms": statistics.median(times) if times else None,
            "calls": {op: c / (1 + reps) for op, c in (calls - calls0).items()},
            "bytes": {d: c / (1 + reps) for d, c in (nbytes - nbytes0).items()},
            "b1_launches": adler_frame_checksum.launches - launches0,
            "outputs": outputs if case.get("keep", True) else None,
        }
        if profile:
            res["profile"] = trace_summary(trace_events(prof), STEP_CALL, reps)
            res["profile"]["host_ms"] = {
                part: statistics.median(h[i] for h in host) * 1e3
                for i, part in enumerate(("barrier", "step", "synchronize"))}
        if case["step"] == "partition":
            check, echoed, total = outputs
            res["echo_is_input"] = echoed is local
            res["b1_vs_plain"] = int(
                (uint32_to_int64(check)
                 - uint32_to_int64(adler_frame_checksum_ref(local))).abs()
                .max())
            res["checksums"], res["total"] = check, total
        results.append(res)
    return results
