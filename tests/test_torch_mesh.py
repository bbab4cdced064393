"""Port parity: the mesh steps of brpc_tpu_torch.parallel.collective_echo
and `graft_entry.dryrun_multichip` against the JAX package, on the CPU.

The port's steps are SPMD by process: one world of 8 spawned ranks
(gloo, CPU tensors) runs every case of this module at once, the twin of
the 8-device virtual mesh that tests/conftest.py gives JAX. Each rank
gets its shard of the same numpy input; the ranks' outputs, put back
together in rank order, must equal the JAX step's output bit for bit
(uint32, no tolerance). The `cuda` test runs worlds on the card: gloo
with two ranks on cuda:0, and NCCL with one.

JAX is imported inside the tests that use it, so that the `cuda` test
runs where JAX is missing (`python -m pytest --noconftest -m cuda`).
"""
import multiprocessing
import time

import numpy as np
import pytest
import torch

import chip_smoke
from brpc_tpu_torch import native
from brpc_tpu_torch.convert import words_from_numpy
from brpc_tpu_torch.graft_entry import dryrun_multichip, dryrun_payloads
from brpc_tpu_torch.kernels import _build
from brpc_tpu_torch.kernels.checksum import adler_frame_checksum_ref
from brpc_tpu_torch.parallel import world
from brpc_tpu_torch.parallel.collective_echo import (STEP_CALL,
                                                     make_parallel_echo_step)
from brpc_tpu_torch.profiling import trace_summary

RUN_CASES = "brpc_tpu_torch.parallel.collective_echo:run_cases"
N = 8
GOLDEN = np.uint32(2654435761)


def _arange(rows, words):
    return np.arange(rows * words, dtype=np.uint32).reshape(rows, words)


# name -> (step, global input): the inputs of tests/test_collectives.py,
# and all-ones partitions whose checksums overflow 32 bits when summed.
CASES = {
    "echo_arange": ("parallel_echo", _arange(N, 128)),
    "echo_ones": ("parallel_echo", np.full((N, 64), 0xFFFFFFFF, np.uint32)),
    "partition_golden": ("partition", _arange(N, 96) * GOLDEN),
    "partition_ones_overflow": ("partition",
                                np.full((2 * N, 1024), 0xFFFFFFFF, np.uint32)),
    "allreduce": ("allreduce", _arange(N, 64) * GOLDEN),
    "allgather": ("allgather", _arange(N, 32)),
    "alltoall": ("alltoall", _arange(N, N * 16)),
}

# Collectives each step issues per call.
CALLS = {
    "parallel_echo": {"all_gather_into_tensor": 1, "reduce_scatter_tensor": 1},
    "allreduce": {"all_reduce": 1},
    "allgather": {"all_gather_into_tensor": 1},
    "alltoall": {"all_to_all_single": 1},
    "partition": {"all_reduce": 1},
}

# tests/test_collectives.py::test_cpp_mesh_allreduce_bitexact_vs_jax:
# 4 ranks, 64 KiB each, rows filled as the C++ engine fills them (seq
# 5; fixed keys in place of the mesh nodes' ports).
ALLREDUCE4_RANKS = [0, 1, 2, 3]
ALLREDUCE4_KEYS = [40001, 40002, 40003, 40004]

# The other four steps in the same 4-rank subgroup.
SUB4 = {
    "echo_4": ("parallel_echo", _arange(4, 128)),
    "partition_4": ("partition", _arange(8, 96) * GOLDEN),
    "allgather_4": ("allgather", _arange(4, 32)),
    "alltoall_4": ("alltoall", _arange(4, 4 * 16)),
}
# A case whose timed call runs under torch.profiler.
PROFILED = "allreduce_profiled"


def _fill_deterministic(seq, key, n):
    """numpy twin of CollectiveEngine::FillDeterministic, copied from
    tests/test_collectives.py, which imports JAX at the top."""
    i = np.arange(n, dtype=np.uint64)
    base = (0x9E3779B1 * (seq & 0xFFFFFFFF) +
            0x85EBCA77 * (key & 0xFFFFFFFF)) & 0xFFFFFFFF
    return ((base + 0xC2B2AE35 * i) & 0xFFFFFFFF).astype(np.uint32)


def _allreduce4_rows():
    return np.stack([_fill_deterministic(5, k, 16384)
                     for k in ALLREDUCE4_KEYS])


def _world_cases():
    cases = [{"name": name, "step": step, "data": data}
             for name, (step, data) in CASES.items()]
    cases.append({"name": "allreduce4_64k", "step": "allreduce",
                  "data": _allreduce4_rows(), "ranks": ALLREDUCE4_RANKS})
    cases += [{"name": name, "step": step, "data": data,
               "ranks": ALLREDUCE4_RANKS} for name, (step, data) in SUB4.items()]
    cases.append({"name": PROFILED, "step": "allreduce",
                  "data": CASES["allreduce"][1], "profile": True})
    return cases


@pytest.fixture(scope="module")
def ranks():
    """One 8-rank gloo world on the CPU running every case once, then
    once more timed: {case name: [rank results]}."""
    results = world.run(N, RUN_CASES, (_world_cases(), 1), backend="gloo",
                        device="cpu")
    return {case["name"]: [r[i] for r in results]
            for i, case in enumerate(_world_cases())}


def _joined(per_rank):
    """The members' outputs put back together in rank order."""
    members = [r for r in per_rank if r["member"]]
    outputs = list(zip(*(r["outputs"] for r in members)))
    return [np.concatenate([np.atleast_1d(o) for o in out])
            for out in outputs]


def _jax_step(step, data, n=N):
    import jax
    from brpc_tpu.parallel import collective_echo as jce

    builders = {"parallel_echo": jce.make_parallel_echo_step,
                "allreduce": jce.make_allreduce_step,
                "allgather": jce.make_allgather_step,
                "alltoall": jce.make_alltoall_step,
                "partition": jce.make_partition_echo_step}
    mesh = jax.sharding.Mesh(jax.devices("cpu")[:n], ("peers",))
    out = builders[step](mesh)(data)
    return [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))]


def _numpy_answer(step, data, n):
    """What each step computes, in numpy, as the ranks' outputs stacked
    in rank order (partition: checksums, echo; total apart)."""
    if step == "parallel_echo":
        return [data]
    if step == "allreduce":
        return [np.tile(data.sum(axis=0, dtype=np.uint32), (n, 1))]
    if step == "allgather":
        return [np.tile(data.reshape(-1), (n, 1))]
    if step == "alltoall":
        return [data.reshape(n, n, -1).transpose(1, 0, 2).reshape(n, -1)]
    check = adler_frame_checksum_ref(torch.from_numpy(data)).view(
        torch.int32).numpy().view(np.uint32)
    return [check, data]


@pytest.mark.parametrize("name", sorted(CASES))
def test_step_matches_jax(ranks, name):
    step, data = CASES[name]
    port = _joined(ranks[name])
    jax_out = _jax_step(step, data)
    if step == "partition":
        check, echoed, total = jax_out
        np.testing.assert_array_equal(port[0], check)
        np.testing.assert_array_equal(port[1], echoed)
        # total is replicated: every rank holds the JAX value.
        assert all(t == total for t in port[2])
        for r in ranks[name]:
            assert r["echo_is_input"] and r["b1_vs_plain"] == 0
    else:
        assert len(port) == 1 and port[0].dtype == np.uint32
        np.testing.assert_array_equal(port[0], jax_out[0])
    for got, want in zip(port, _numpy_answer(step, data, N)):
        np.testing.assert_array_equal(got, want)


def test_partition_total_wraps_at_32_bits(ranks):
    per_rank = ranks["partition_ones_overflow"]
    checks = np.concatenate([r["checksums"] for r in per_rank])
    unwrapped = int(checks.astype(np.int64).sum())
    assert unwrapped >= 1 << 32, "the case must overflow to test the wrap"
    assert {int(r["total"]) for r in per_rank} == {unwrapped & 0xFFFFFFFF}


def test_allreduce_4_ranks_64k_matches_jax(ranks):
    """The port twin of test_cpp_mesh_allreduce_bitexact_vs_jax: four
    ranks of the world, in a subgroup, against JAX on a 4-device mesh;
    that test ties the same JAX step to the C++ mesh."""
    rows = _allreduce4_rows()
    per_rank = ranks["allreduce4_64k"]
    assert [r["member"] for r in per_rank] == [r in ALLREDUCE4_RANKS
                                               for r in range(N)]
    (port,) = _joined(per_rank)
    (jax_out,) = _jax_step("allreduce", rows, n=len(ALLREDUCE4_RANKS))
    np.testing.assert_array_equal(port, jax_out)
    np.testing.assert_array_equal(
        port, np.tile(rows.sum(axis=0, dtype=np.uint32), (4, 1)))


@pytest.mark.parametrize("name", sorted(SUB4))
def test_step_in_a_4_rank_subgroup_matches_jax(ranks, name):
    step, data = SUB4[name]
    n = len(ALLREDUCE4_RANKS)
    port = _joined(ranks[name])
    jax_out = _jax_step(step, data, n=n)
    if step == "partition":
        np.testing.assert_array_equal(port[0], jax_out[0])
        np.testing.assert_array_equal(port[1], jax_out[1])
        assert all(t == jax_out[2] for t in port[2])
    else:
        np.testing.assert_array_equal(port[0], jax_out[0])
    for got, want in zip(port, _numpy_answer(step, data, n)):
        np.testing.assert_array_equal(got, want)


def _case(name):
    """(step, global input, members) of a world case."""
    if name in CASES:
        return (*CASES[name], N)
    if name in SUB4:
        return (*SUB4[name], len(ALLREDUCE4_RANKS))
    if name == PROFILED:
        return (*CASES["allreduce"], N)
    return "allreduce", _allreduce4_rows(), len(ALLREDUCE4_RANKS)


WORLD_CASES = sorted(CASES) + ["allreduce4_64k", PROFILED] + sorted(SUB4)


@pytest.mark.parametrize("name", WORLD_CASES)
def test_step_issues_its_collectives_once_per_call(ranks, name):
    """The twin of test_partition_step_compiles_with_collective: the
    partition step's merge is exactly one all_reduce a call, and every
    other step issues its own collectives once a call."""
    step = _case(name)[0]
    for r in ranks[name]:
        if r["member"]:
            assert r["calls"] == CALLS[step], (r["name"], r["calls"])


@pytest.mark.parametrize("name", WORLD_CASES)
def test_collective_bytes_match_the_model(ranks, name):
    """The operand bytes each member hands its collectives a call equal
    chip_smoke's byte model for the step at that many ranks."""
    step, data, n = _case(name)
    want = chip_smoke.collective_bytes(step, n, data.shape[0] // n,
                                       data.shape[1])
    members = [r for r in ranks[name] if r["member"]]
    assert len(members) == n
    for r in members:
        assert r["bytes"] == want, (r["name"], r["bytes"], want)


def test_profiled_case_splits_the_host_time(ranks):
    """On the CPU the profiled calls have no device activity; the host
    split and the profiled windows are there, and the outputs still
    match the unprofiled case."""
    for r, plain in zip(ranks[PROFILED], ranks["allreduce"]):
        p = r["profile"]
        assert set(p["host_ms"]) == {"barrier", "step", "synchronize"}
        assert all(v >= 0 for v in p["host_ms"].values())
        assert p["window_ms"] > 0
        assert p["device_ops"] == [] and p["busy_share"] is None
        assert len(p["idle_gaps"]) == 1  # one timed call, idle throughout
        np.testing.assert_array_equal(r["outputs"][0], plain["outputs"][0])
        assert "profile" not in plain


def test_trace_summary_matches_device_ops_to_their_launch():
    """The device's clock in a trace may run behind the host's: an op
    counts for the window its launch lies in, and the device timeline is
    moved forward until no op starts before its launch."""
    def x(cat, name, ts, dur, corr=None):
        return {"cat": cat, "name": name, "ts": ts, "dur": dur,
                **({"args": {"correlation": corr}} if corr else {})}

    events = [x("user_annotation", STEP_CALL, 1000.0, 1000.0),
              x("cuda_runtime", "cudaLaunchKernel", 1010.0, 5.0, 7),
              x("kernel", "inside", 620.0, 100.0, 7),
              x("cuda_runtime", "cudaLaunchKernel", 3010.0, 5.0, 8),
              x("kernel", "after", 2620.0, 20.0, 8)]
    s = trace_summary(events, STEP_CALL, 1)
    assert s["clock_shift_ms"] == pytest.approx(0.39)
    assert s["device_ops_per"] == 1
    assert s["device_ops"] == [{"name": "inside", "count": 1.0,
                                "ms": pytest.approx(0.1)}]
    assert s["busy_share"] == pytest.approx(0.1)
    assert s["idle_gaps"][0]["ms"] == pytest.approx(0.89)
    assert s["idle_gaps"][0]["at_ms"] == pytest.approx(0.11)


def test_ranks_ran_on_the_cpu_with_gloo(ranks):
    for per_rank in ranks.values():
        for r in per_rank:
            if r["member"]:
                assert (r["device"], r["is_cuda"], r["backend"]) == (
                    "cpu", False, "gloo")
                assert r["ms"] is not None and r["ms"] >= 0
                assert r["b1_launches"] == 0  # the plain version on the CPU


def test_dryrun_multichip_matches_jax():
    import jax
    from brpc_tpu.parallel import collective_echo as jce

    got = dryrun_multichip(N, device="cpu", backend="gloo")
    payloads = dryrun_payloads(N)
    mesh = jax.sharding.Mesh(jax.devices("cpu")[:N], ("peers",))
    echo = np.asarray(jce.make_parallel_echo_step(mesh)(payloads))
    check, _, total = jce.make_partition_echo_step(mesh)(payloads)
    np.testing.assert_array_equal(got["outputs"], echo)
    np.testing.assert_array_equal(got["outputs"], payloads)
    np.testing.assert_array_equal(got["checksums"], np.asarray(check))
    assert got["total"] == np.asarray(total)
    assert got["backend"] == "gloo"
    assert got["devices"] == ["cpu"] * N
    assert got["cuda_tensors"] == [False] * N


def test_dryrun_multichip_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(N)


def test_nccl_is_not_the_default_with_more_ranks_than_gpus(monkeypatch):
    """NCCL cannot put two ranks on one GPU, and nothing switches to gloo
    on its own: the call raises before building or starting anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def no_build():
        raise AssertionError("built before the world was planned")

    monkeypatch.setattr(native, "build", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    with pytest.raises(ValueError, match="backend='gloo'"):
        world.plan(N)
    with pytest.raises(ValueError, match="backend='gloo'"):
        dryrun_multichip(N)
    assert world.plan(N, backend="gloo")[0] == "gloo"
    assert world.plan(1) == ("nccl", [torch.device("cuda", 0)])


def test_parallel_echo_takes_one_request_a_rank():
    step = make_parallel_echo_step()
    with pytest.raises(ValueError, match="one request a rank"):
        step(words_from_numpy(np.zeros((2, 4), np.uint32), "cpu"))


def test_world_runs_only_the_ports_functions():
    with pytest.raises(ValueError, match="brpc_tpu_torch"):
        world.run(2, "os:getcwd", device="cpu")


def test_a_failing_rank_fails_the_world_with_its_traceback():
    bad = [{"name": "bad", "step": "no_such_step",
            "data": np.zeros((2, 4), np.uint32)}]
    with pytest.raises(RuntimeError, match="KeyError: 'no_such_step'"):
        world.run(2, RUN_CASES, (bad,), device="cpu")
    assert multiprocessing.active_children() == []


def test_a_world_past_its_deadline_is_killed(monkeypatch):
    monkeypatch.setattr(world, "DEADLINE_S", 0.2)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="every rank is killed"):
        world.run(2, RUN_CASES, ([],), device="cpu")
    assert time.monotonic() - t0 < 30
    assert multiprocessing.active_children() == []


@pytest.mark.cuda
def test_mesh_on_card():
    """Two gloo ranks on cuda:0 with B1 held against its plain version in
    each rank, and a one-rank NCCL world running all five steps."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device found")
    _build.build()
    rng = np.random.default_rng(7)
    gloo_cases = {
        "partition": rng.integers(0, 2**32, (8, 65536), dtype=np.uint32),
        "parallel_echo": rng.integers(0, 2**32, (2, 4096), dtype=np.uint32),
        "alltoall": rng.integers(0, 2**32, (2, 4096), dtype=np.uint32),
    }
    nccl_cases = {step: rng.integers(0, 2**32, (2 if step == "partition"
                                                else 1, 8192), dtype=np.uint32)
                  for step in CALLS}
    for n, backend, cases in ((2, "gloo", gloo_cases), (1, "nccl", nccl_cases)):
        results = world.run(
            n, RUN_CASES, ([{"name": s, "step": s, "data": d}
                            for s, d in cases.items()],),
            backend=backend, device="cuda")
        for i, (step, data) in enumerate(cases.items()):
            per_rank = [r[i] for r in results]
            for r in per_rank:
                assert r["is_cuda"] and r["device"] == "cuda:0"
                assert r["backend"] == backend
                assert r["calls"] == CALLS[step]
                assert r["bytes"] == chip_smoke.collective_bytes(
                    step, n, data.shape[0] // n, data.shape[1])
            want = _numpy_answer(step, data, n)
            got = _joined(per_rank)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            if step == "partition":
                for r in per_rank:
                    assert r["b1_launches"] >= 1 and r["b1_vs_plain"] == 0
                assert {int(t) for t in got[2]} == {
                    int(want[0].astype(np.int64).sum()) & 0xFFFFFFFF}
