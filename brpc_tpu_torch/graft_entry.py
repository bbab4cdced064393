"""Entry points of the port, the counterparts of `__graft_entry__`.

- `entry()` returns `(echo_step, (payloads,))`: eight in-flight 4 KiB
  RPC payloads (uint32[8, 1024], arange) on the device.
- `dryrun_multichip(n)` runs the fan-out/reduce data plane over a world
  of n ranks (`parallel.world`): the ParallelChannel fan-out
  (AllGather -> serve -> ReduceScatter) and the PartitionChannel
  sharding (per-rank shards + all-reduce merge), with every request and
  response framed and unframed by the C++ framework (libtpurpc).

Where the JAX dry run frames all requests in its one process, each
rank here frames its own request and response (correlation id = its
rank): the steps are SPMD by process. libtpurpc is built before any rank
starts and is never optional: a missing library is an error.
"""
from __future__ import annotations

import numpy as np

from brpc_tpu_torch import native
from brpc_tpu_torch.convert import (resolve_device, words_from_numpy,
                                    words_to_numpy)
from brpc_tpu_torch.kernels import _build
from brpc_tpu_torch.kernels.checksum import adler_frame_checksum
from brpc_tpu_torch.parallel import world
from brpc_tpu_torch.parallel.collective_echo import (echo_step,
                                                     make_parallel_echo_step,
                                                     make_partition_echo_step)

DRYRUN_WORDS = 256


def entry(device=None):
    """Returns (fn, example_args); device=None means CUDA."""
    dev = resolve_device(device)
    payloads = np.arange(8 * 1024, dtype=np.uint32).reshape(8, 1024)
    return echo_step, (words_from_numpy(payloads, dev),)


def dryrun_payloads(n_devices: int) -> np.ndarray:
    """The dry run's requests: arange(n * 256) as uint32[n, 256], row r
    being rank r's."""
    return np.arange(n_devices * DRYRUN_WORDS, dtype=np.uint32).reshape(
        n_devices, DRYRUN_WORDS)


def dryrun_multichip(n_devices: int, device=None, backend=None) -> dict:
    """Runs the parallel echo and partition steps over n ranks with
    framed requests and responses; raises on any mismatch. device=None
    means CUDA (rank r on cuda:{r % device_count()}); `backend` as in
    `world.plan`.

    Returns what was checked: "outputs" uint32[n, 256] (the merged
    responses, equal to the requests), "checksums" uint32[n] and "total"
    uint32 (the partition step's), "backend", and per rank "devices",
    "cuda_tensors" and "b1_launches"."""
    backend, devices = world.plan(n_devices, backend, device)
    native.build()
    if devices[0].type == "cuda":
        _build.build()
    ranks = world.run(n_devices, "brpc_tpu_torch.graft_entry:_dryrun_rank",
                      backend=backend, device=devices[0].type)
    totals = {int(r["total"]) for r in ranks}
    if len(totals) != 1:
        raise RuntimeError(f"ranks disagree on the merged total: {totals}")
    return {
        "outputs": np.concatenate([r["output"] for r in ranks]),
        "checksums": np.concatenate([r["checksums"] for r in ranks]),
        "total": np.uint32(totals.pop()),
        "backend": backend,
        "devices": [r["device"] for r in ranks],
        "cuda_tensors": [r["is_cuda"] for r in ranks],
        "b1_launches": [r["b1_launches"] for r in ranks],
    }


def _framed_round_trip(cid: int, words: np.ndarray) -> np.ndarray:
    """Frame `words` with correlation id `cid` and unframe it (crc32c
    checked by the framework); returns the payload's words."""
    got_cid, pay, _ = native.unframe(native.frame(cid, words))
    if got_cid != cid:
        raise RuntimeError(f"C++ framing corrupted correlation id {cid} "
                           f"(got {got_cid})")
    return pay.view(np.uint32)


def _dryrun_rank(rank) -> dict:
    """One rank of `dryrun_multichip`."""
    request = dryrun_payloads(rank.size)[rank.rank]
    local = words_from_numpy(
        _framed_round_trip(rank.rank, request)[None].copy(), rank.device)
    launches0 = adler_frame_checksum.launches
    out = make_parallel_echo_step()(local)
    checksums, _, total = make_partition_echo_step()(local)
    # The merged response must survive the framework's framing byte-exact
    # and equal the request (echo).
    response = _framed_round_trip(rank.rank, words_to_numpy(out)[0])
    if not np.array_equal(response, request):
        raise RuntimeError(f"framed response mismatch on rank {rank.rank}")
    return {"output": out, "checksums": checksums, "total": total,
            "device": str(local.device), "is_cuda": local.is_cuda,
            "b1_launches": adler_frame_checksum.launches - launches0}
