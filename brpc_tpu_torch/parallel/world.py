"""A world of `n` ranks on torch.distributed: the port's counterpart of
the JAX `Mesh` over n devices (and of `_pin_virtual_cpu_mesh`,
__graft_entry__.py:37-61, which gives the JAX package its 8 virtual CPU
devices).

`run(n, target, args)` starts `n` processes with the `spawn` start
method (never `fork`: the caller may hold a CUDA context), joins them
in one process group through a `file://` store in a temporary directory
(no TCP port to race for), calls the port's function `target`
("module:function") in every rank as `function(rank, *args)` with a
`Rank`, and returns each rank's result with its tensors turned into
numpy arrays.

Backend and device are explicit:

- `device=None` means CUDA and raises without a card, as everywhere in
  the port; `device="cpu"` runs every rank on the CPU.
- On CUDA, rank r uses `cuda:{r % device_count()}`. The default
  backend there is "nccl", which needs a GPU of its own for each rank:
  with more ranks than GPUs, `backend=None` raises and asks for
  `backend="gloo"` (CUDA tensors, collectives over gloo's host
  transport, as on a machine with one card). On the CPU the default is
  "gloo". Nothing switches backend on its own.

The process group's timeout (`TIMEOUT`) bounds `init_process_group` and
every collective; the parent waits at most `DEADLINE_S` for the world,
and kills every rank as soon as one fails or the deadline passes, so a
hang fails the caller in bounded time.

Importing this module starts no process and touches no device.
"""
from __future__ import annotations

import datetime
import importlib
import multiprocessing.connection
import os
import pickle
import tempfile
import time
import traceback
from dataclasses import dataclass

import torch

from brpc_tpu_torch.convert import resolve_device, words_to_numpy

_PORT = "brpc_tpu_torch."
TIMEOUT = datetime.timedelta(seconds=60)
DEADLINE_S = 600.0


@dataclass(frozen=True)
class Rank:
    """What a rank's function is given: its rank and the world's size,
    its device and the backend of the world's process group."""
    rank: int
    size: int
    device: torch.device
    backend: str


def plan(n: int, backend: str | None = None, device=None):
    """(backend, [device of each rank]) for a world of `n` ranks; raises
    where the world cannot run as asked."""
    if n < 1:
        raise ValueError(f"a world needs at least one rank, got {n}")
    dev = resolve_device(device)
    if dev.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} cannot run ranks on the CPU; "
                             "use backend='gloo'")
        return "gloo", [dev] * n
    if dev.type != "cuda" or dev.index is not None:
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}: "
                         "rank r runs on cuda:{r % device_count()}")
    count = torch.cuda.device_count()
    devices = [torch.device("cuda", r % count) for r in range(n)]
    backend = "nccl" if backend is None else backend
    if backend == "nccl" and n > count:
        raise ValueError(
            f"{n} ranks on {count} GPU(s): NCCL needs a GPU of its own for "
            "each rank; pass backend='gloo' to run the ranks' CUDA tensors "
            "over gloo's host transport")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend, devices


def run(n: int, target: str, args: tuple = (), *, backend: str | None = None,
        device=None) -> list:
    """Run the port's function `target` ("module:function") in each rank
    of an `n`-rank world; returns the ranks' results in rank order."""
    module, _, name = target.partition(":")
    if not module.startswith(_PORT) or not name:
        raise ValueError(f"target must be 'brpc_tpu_torch.<module>:<function>', "
                         f"got {target!r}")
    backend, devices = plan(n, backend, device)
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="brpc_tpu_torch_world_") as tmp:
        # The arguments go through a file, not the spawn pipe: the parent
        # writes a rank's start-up data into a pipe that it holds open
        # itself until the write ends, so more than a pipe's buffer to a
        # rank that dies while starting would block the parent for good.
        with open(os.path.join(tmp, "args.pkl"), "wb") as f:
            pickle.dump(args, f)
        procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(r, n, backend, str(devices[r]), tmp, target))
            for r in range(n)]
        try:
            for p in procs:
                p.start()
            _join(procs, tmp)
        finally:
            started = [p for p in procs if p.pid is not None]
            for p in started:
                if p.is_alive():
                    p.kill()
            for p in started:
                p.join(10)
        results = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def _join(procs: list, tmp: str) -> None:
    """Wait for every rank; raise at the first rank that fails, or when
    the deadline passes."""
    end = time.monotonic() + DEADLINE_S
    pending = {p.sentinel: r for r, p in enumerate(procs)}
    while pending:
        left = end - time.monotonic()
        ready = multiprocessing.connection.wait(list(pending), max(left, 0))
        if not ready:
            raise TimeoutError(
                f"ranks {sorted(pending.values())} still running after "
                f"{DEADLINE_S:g} s; every rank is killed")
        for s in ready:
            r = pending.pop(s)
            procs[r].join()
            if procs[r].exitcode != 0:
                raise RuntimeError(f"rank {r} of {len(procs)} failed "
                                   f"(exit code {procs[r].exitcode}):\n"
                                   f"{_error_text(tmp, r)}")


def _error_text(tmp: str, r: int) -> str:
    try:
        with open(os.path.join(tmp, f"rank{r}.err")) as f:
            return f.read()
    except FileNotFoundError:
        return "(no traceback written)"


def _to_host(obj):
    """Tensors (also inside dicts, lists and tuples) as numpy arrays;
    uint32 words keep their bits."""
    if isinstance(obj, torch.Tensor):
        if obj.dtype == torch.uint32:
            return words_to_numpy(obj)
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(rank: int, n: int, backend: str, device: str, tmp: str,
               target: str) -> None:
    """A rank's process: join the group, call `target`, write the result
    (or the traceback) into the world's directory."""
    import torch.distributed as dist

    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            # The ranks share the host's cores.
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        dist.init_process_group(
            backend, init_method=f"file://{os.path.join(tmp, 'store')}",
            rank=rank, world_size=n, timeout=TIMEOUT)
        try:
            with open(os.path.join(tmp, "args.pkl"), "rb") as f:
                args = pickle.load(f)
            module, _, name = target.partition(":")
            fn = getattr(importlib.import_module(module), name)
            result = _to_host(fn(Rank(rank, n, dev, backend), *args))
        finally:
            dist.destroy_process_group()
        with open(os.path.join(tmp, f"rank{rank}.pkl.tmp"), "wb") as f:
            pickle.dump(result, f)
        os.replace(os.path.join(tmp, f"rank{rank}.pkl.tmp"),
                   os.path.join(tmp, f"rank{rank}.pkl"))
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise

