"""The byte models and bound arithmetic of chip_smoke.py, on the CPU.

`chip_smoke.py` holds every measured time of the port against a bound:
the device path and the gloo mesh steps against the card's host link,
the NCCL mesh steps against HBM. The models below are the bytes each
path must move, written from its shapes and what it computes; these
tests hold them to numbers worked out by hand (1 MiB of words a rank,
32 x 1 MiB partitions for the partition step) and to what the code
itself counts. `tests/test_torch_mesh.py` holds the collective bytes
that the ranks count to the same model.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

import chip_smoke as cs

REPO = Path(__file__).resolve().parent.parent
MIB = 1 << 20
WORDS = cs.MESH_WORDS
ROWS = dict(cs.MESH_STEPS)

# (step, n) -> (bytes in, bytes out) a rank hands its collectives a call.
COLLECTIVE = {
    ("parallel_echo", 1): (2 * MIB, 2 * MIB),
    ("parallel_echo", 4): (5 * MIB, 5 * MIB),
    ("parallel_echo", 8): (9 * MIB, 9 * MIB),
    ("allreduce", 1): (MIB, MIB), ("allreduce", 4): (MIB, MIB),
    ("allreduce", 8): (MIB, MIB),
    ("allgather", 1): (MIB, MIB), ("allgather", 4): (MIB, 4 * MIB),
    ("allgather", 8): (MIB, 8 * MIB),
    ("alltoall", 1): (MIB, MIB), ("alltoall", 4): (MIB, MIB),
    ("alltoall", 8): (MIB, MIB),
    ("partition", 1): (4, 4), ("partition", 4): (4, 4),
    ("partition", 8): (4, 4),
}

# (step, n) -> a rank's device-memory bytes a call.
B1_SHARD = 32 * MIB + 32 * 4 + 4  # B1 reads 32 MiB, writes 32 words; the total
HBM = {
    ("parallel_echo", 1): 6 * MIB,  # all-gather 1+1, mask 1+1, reduce-scatter 1+1
    ("parallel_echo", 4): 18 * MIB,  # 1+4, 4+4, 4+1
    ("parallel_echo", 8): 34 * MIB,  # 1+8, 8+8, 8+1
    ("allreduce", 1): 2 * MIB,  # the clone; one rank's all-reduce moves nothing
    ("allreduce", 4): 4 * MIB, ("allreduce", 8): 4 * MIB,
    ("allgather", 1): 2 * MIB, ("allgather", 4): 5 * MIB,
    ("allgather", 8): 9 * MIB,
    ("alltoall", 1): 2 * MIB, ("alltoall", 4): 2 * MIB,
    ("alltoall", 8): 2 * MIB,
    ("partition", 1): B1_SHARD, ("partition", 4): B1_SHARD + 8,
    ("partition", 8): B1_SHARD + 8,
}

# Link rates in GB/s: each direction alone, and both directions at once.
LINK = {"d2h_gbps": 50.0, "h2d_gbps": 40.0, "duplex_gbps": 60.0}


@pytest.mark.parametrize("step,n", sorted(COLLECTIVE))
def test_collective_bytes_at_1_4_8_ranks(step, n):
    got = cs.collective_bytes(step, n, ROWS[step], WORDS)
    assert (got["in"], got["out"]) == COLLECTIVE[step, n]


@pytest.mark.parametrize("step,n", sorted(HBM))
def test_hbm_bytes_at_1_4_8_ranks(step, n):
    assert cs.hbm_bytes(step, n, ROWS[step], WORDS) == HBM[step, n]


def test_unknown_step_has_no_model():
    with pytest.raises(ValueError, match="unknown mesh step"):
        cs.collective_bytes("broadcast", 8, 1, WORDS)


@pytest.mark.parametrize("step", sorted(ROWS))
def test_gloo_bound_is_eight_ranks_on_one_host_link(step):
    """gloo with 8 ranks on one card: each input crosses device->host and
    each output host->device, 8 times over, on the card's one link; the
    partition step adds B1's time."""
    b_in, b_out = COLLECTIVE[step, 8]
    model, ms, by = cs.mesh_bound(step, "gloo", 8, ROWS[step], WORDS,
                                  LINK, b1_ms=0.023)
    assert by == "host_link"
    assert (model["d2h"], model["h2d"]) == (8 * b_in, 8 * b_out)
    want = max(8 * b_in / 50e9, 8 * b_out / 40e9,
               8 * (b_in + b_out) / 60e9) * 1e3
    if step == "partition":
        want += 0.023
    assert ms == pytest.approx(want, rel=1e-12)


def test_gloo_parallel_echo_bound_by_hand():
    # 72 MiB each way: 144 MiB at the 60 GB/s of both directions at once
    # takes longer than 72 MiB H2D alone at 40 GB/s.
    _, ms, _ = cs.mesh_bound("parallel_echo", "gloo", 8, 1, WORDS, LINK)
    assert ms == pytest.approx(144 * MIB / 60e9 * 1e3, rel=1e-12)


# The host link as one card measured it: each direction alone, both at
# once (GB/s); `*_concurrent` is each direction's rate while both run.
H100_LINK = {"h2d_gbps": 51.48, "d2h_gbps": 54.89, "duplex_gbps": 64.72,
             "h2d_gbps_concurrent": 40.74, "d2h_gbps_concurrent": 32.36}


def test_gloo_allgather_bound_holds_for_one_sided_copies():
    """The 8 ranks' all-gather moves 8 MiB D2H and 64 MiB H2D. Its bound
    is the H2D bytes at the H2D rate alone: no order of the copies is
    faster, not even the two one after the other, which the rates of
    both directions at once would price too high."""
    model, ms, _ = cs.mesh_bound("allgather", "gloo", 8, 1, WORDS, H100_LINK)
    assert (model["d2h"], model["h2d"]) == (8 * MIB, 64 * MIB)
    assert ms == pytest.approx(64 * MIB / 51.48e9 * 1e3, rel=1e-12)
    one_after_other = (8 * MIB / 54.89e9 + 64 * MIB / 51.48e9) * 1e3
    at_concurrent_rates = max(8 * MIB / 32.36e9, 64 * MIB / 40.74e9) * 1e3
    assert ms <= one_after_other < at_concurrent_rates


def test_device_path_bound_is_both_directions_at_once():
    """The device path moves its pass's bytes each way: the duplex rate
    binds."""
    _, payload = cs.device_path_bytes(cs.DP_PAYLOAD_MB, cs.DP_CHUNK_KB)
    ms = cs.host_link_ms(payload, payload, H100_LINK)
    assert ms == pytest.approx(2 * payload / 64.72e9 * 1e3, rel=1e-12)


@pytest.mark.parametrize("step", sorted(ROWS))
def test_nccl_bound_is_hbm_bytes(step):
    model, ms, by = cs.mesh_bound(step, "nccl", 1, ROWS[step], WORDS)
    assert by == "hbm" and model == {"hbm": HBM[step, 1]}
    assert ms == pytest.approx(HBM[step, 1] / 3.35e12 * 1e3, rel=1e-12)


def test_host_link_ms_is_the_slower_direction():
    """The slower direction alone, unless all the bytes at the rate of
    both directions at once take longer."""
    assert cs.host_link_ms(50e6, 0, LINK) == pytest.approx(1.0)
    assert cs.host_link_ms(0, 80e6, LINK) == pytest.approx(2.0)
    assert cs.host_link_ms(50e6, 40e6, LINK) == pytest.approx(1.5)


def test_share_is_bound_over_measured():
    assert cs.share(0.5, 2.0) == 0.25
    assert cs.share(2.0, 2.0) == 1.0


@pytest.mark.parametrize("bound_ms,ms", [(2.5, 2.0), (0.0, 1.0), (1e-3, 0.0)])
def test_share_above_one_raises(bound_ms, ms):
    with pytest.raises(ValueError, match="model is wrong"):
        cs.share(bound_ms, ms)


@pytest.mark.parametrize("step,nccl1,nccl8,gloo8", [
    ("parallel_echo", 8, 8, 10), ("allreduce", 1, 2, 3),
    ("allgather", 1, 1, 2), ("alltoall", 1, 1, 2), ("partition", 7, 8, 9)])
def test_launches_per_call(step, nccl1, nccl8, gloo8):
    """One NCCL rank runs an in-place all-reduce as the identity (no
    launch) and the other collectives as one copy each."""
    assert cs.launches_per_call(step, "nccl", 1) == nccl1
    assert cs.launches_per_call(step, "nccl", 8) == nccl8
    assert cs.launches_per_call(step, "gloo", 8) == gloo8


@pytest.mark.parametrize("payload_mb,chunk_kb,want", [
    (256, 1020, (257, 257 * 1044480)),  # the main path: 1020 KiB = 255 pages
    (4, 508, (8, 8 * 520192)),
    (1, 2048, (1, 2 * MIB)),  # one chunk, larger than the payload asked for
])
def test_device_path_bytes(payload_mb, chunk_kb, want):
    assert cs.device_path_bytes(payload_mb, chunk_kb) == want


def test_device_path_count_equals_runs_own():
    """`device_path.run` counts 2 x payload bytes x reps; its diag says
    which payload a pass moved. It runs in a subprocess: a test worker
    may hold the JAX package's libtpurpc, the port loads its own."""
    code = (
        "import json\n"
        "from brpc_tpu_torch import device_path\n"
        "diag = {}\n"
        "rec = device_path.run(payload_mb=2, reps=2, ring_depth=2, "
        "chunk_kb=508, device='cpu', diag=diag)\n"
        "print(json.dumps({'diag': diag, 'ok': rec['device_path_ok'], "
        "'chunk': rec['device_path_chunk_bytes']}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    chunks, payload = cs.device_path_bytes(2, 508)
    assert out["ok"] is True
    assert (out["diag"]["chunks"], out["diag"]["payload_bytes"]) == (
        chunks, payload)
    assert out["chunk"] * chunks == payload
