"""The port's device path with its host passes on worker threads
(brpc_tpu_torch.device_path, the ring path of `_ChunkPipeline`), on the
CPU, at 4 MiB a pass in 508 KiB chunks.

Workers stage and frame each chunk and verify its returned crc32c; the
caller keeps the ring's acquires and the enqueues, and folds every
chunk's results in chunk order. The port runs in a subprocess (its own
libtpurpc, as in test_torch_device_path.py), which writes what each
case gave to a directory; the test process holds it to
bench_torch.reference and to the JAX package's `_integrity_word`.
Every wait in the subprocess has a timeout.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from bench_torch import reference

REPO = Path(__file__).resolve().parent.parent
PAYLOAD_MB, CHUNK_KB, SEED = 4, 508, 2024
DEPTHS = (1, 2, 4)
CHUNK_BYTES = (CHUNK_KB << 10) & ~4095
CHUNKS = (PAYLOAD_MB << 20) // CHUNK_BYTES
CORRUPT_CHUNK = 2
FAILING = ("native.crc32c", "native.frame_in_place")

_SCRIPT = f"""
import json, sys, threading, time
from pathlib import Path
import numpy as np
import torch
from bench_torch import measure
from brpc_tpu_torch import device_path as dp, native

out = Path(sys.argv[1])
cpu = torch.device("cpu")
payload = np.random.default_rng({SEED}).integers(
    0, 2**32, {CHUNKS} * {CHUNK_BYTES} // 4, dtype=np.uint32)
chunks = list(payload.reshape({CHUNKS}, -1))
result, arrays = {{}}, {{}}


def pipeline(depth):
    ring = native.DeviceStagingRing(depth, {CHUNK_BYTES} + 1024)
    return ring, dp._ChunkPipeline(ring, chunks, cpu, depth, False)


def pipeline_threads():
    return sorted(t.name for t in threading.enumerate()
                  if t.name.startswith(dp.WORKER_NAME))


def outputs(pipe):
    return {{"ok": pipe.ok, "words": pipe.dev_checks,
             "crcs": pipe.returned_crcs}}


# run() at each ring depth, over its timed passes.
for depth in {DEPTHS}:
    diag = {{}}
    rec = dp.run(payload_mb={PAYLOAD_MB}, reps=4, ring_depth=depth,
                 chunk_kb={CHUNK_KB}, device="cpu", diag=diag, payload=payload)
    result[f"run_d{{depth}}"] = {{
        "ok": rec["device_path_ok"], "words": diag["integrity_words"],
        "crcs": diag["returned_crc32c"]}}
    arrays[f"last_d{{depth}}"] = np.asarray(diag["returned_last_chunk"],
                                            dtype=np.uint32)
result["threads_after_runs"] = pipeline_threads()

# Which thread makes each timed call, and whether a call comes after
# run() returned.
ring, pipe = pipeline(4)
calls, caller = {{}}, threading.get_ident()
with measure.timed_calls(measure.split_parts(dp, native), calls):
    pipe.run(1)
    made = sum(len(v) for part in calls.values() for v in part.values())
    time.sleep(0.2)
    later = sum(len(v) for part in calls.values() for v in part.values())
names = {{t.ident: t.name for t in threading.enumerate()}}
result["timed_threads"] = {{
    part: sorted("caller" if tid == caller else names.get(tid, "gone")
                 for tid in by_tid)
    for part, by_tid in calls.items()}}
result["calls_after_run"] = later - made
# Nothing in flight: every slot of the ring is free at once, and a
# second run(1) gives the same words.
free = [ring.acquire(timeout_us=100_000) for _ in range(ring.depth)]
for slot in free:
    ring.complete(slot)
result["free_slots"] = free
pipe.run(1)
result["two_runs"] = outputs(pipe)
pipe.close()
ring.close()

# The order of each thread's verify crc32c and ring completes.
events = []
real_complete, real_crc = native.DeviceStagingRing.complete, native.crc32c


def logged_complete(self, slot):
    events.append((threading.current_thread().name, "complete"))
    return real_complete(self, slot)


def logged_crc32c(data, init=0):
    crc = real_crc(data, init)
    events.append((threading.current_thread().name, "crc32c"))
    return crc


native.DeviceStagingRing.complete, native.crc32c = logged_complete, logged_crc32c
ring, pipe = pipeline(4)
pipe.run(2)
native.DeviceStagingRing.complete, native.crc32c = real_complete, real_crc
result["ordered"] = {{
    name: [e for t, e in events if t == name] for name in {{t for t, _ in events}}}}
pipe.close()
ring.close()

# A returned chunk corrupted on its way back.
real_touch, seen = dp._touch_kernel, [0]


def corrupt(x):
    y, word = real_touch(x)
    seen[0] += 1
    if seen[0] == {CORRUPT_CHUNK} + 1:
        flipped = x.numpy().copy()
        flipped[7] ^= 1
        y = torch.from_numpy(flipped)
    return y, word


dp._touch_kernel = corrupt
ring, pipe = pipeline(4)
pipe.run(1)
dp._touch_kernel = real_touch
pipe.run(1)
result["corrupt"] = outputs(pipe)
pipe.close()
ring.close()


# A pass that raises on a worker.
class Boom(RuntimeError):
    pass


for name in {FAILING}:
    attr = name.split(".")[1]
    real, raised = getattr(native, attr), []

    def failing(*args, _real=real, **kw):
        if not raised:
            raised.append((Boom(f"{{name}} failed"), time.monotonic(),
                           threading.current_thread().name))
            raise raised[0][0]
        return _real(*args, **kw)

    setattr(native, attr, failing)
    ring, pipe = pipeline(4)
    try:
        pipe.run(2)
        caught = None
    except Exception as e:
        caught, caught_at = e, time.monotonic()
    setattr(native, attr, real)
    case = {{"raised_on": raised[0][2] if raised else None,
             "caught": type(caught).__name__,
             "same": bool(raised) and caught is raised[0][0],
             "aborted": ring.aborted,
             "threads_before_close": len(pipeline_threads())}}
    if caught is not None and raised:
        case["raise_to_caller_s"] = caught_at - raised[0][1]
    pipe.close()
    case["threads_after_close"] = pipeline_threads()
    ring.close()
    result[f"fail_{{attr}}"] = case

# More workers than this host's cores, switching threads every
# microsecond, each verify taking a random time so the workers finish
# out of order; 12 slots, so a slot's next chunk is another chunk.
real_count, real_crc, real_interval = (dp._worker_count, native.crc32c,
                                       sys.getswitchinterval())
rng, rng_lock = np.random.default_rng(5), threading.Lock()


def slow_crc32c(data, init=0):
    with rng_lock:
        hold = float(rng.uniform(0, 0.002))
    time.sleep(hold)
    return real_crc(data, init)


dp._worker_count = lambda depth: 16
native.crc32c = slow_crc32c
sys.setswitchinterval(1e-6)
try:
    ring, pipe = pipeline(12)
    pipe.run(3)
    result["stress"] = dict(outputs(pipe), workers=len(pipeline_threads()))
    pipe.close()
    ring.close()
finally:
    sys.setswitchinterval(real_interval)
    dp._worker_count, native.crc32c = real_count, real_crc
result["threads_at_end"] = pipeline_threads()

np.savez(out / "arrays.npz", **arrays)
(out / "result.json").write_text(json.dumps(result))
"""


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    out = tmp_path_factory.mktemp("device_path_threads")
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(out)], cwd=REPO,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads((out / "result.json").read_text())
    with np.load(out / "arrays.npz") as arrays:
        result.update({k: arrays[k] for k in arrays.files})
    return result


@pytest.fixture(scope="module")
def want():
    """The references' values a chunk of one pass over the seeded
    payload: integrity words, crc32c and the last chunk."""
    payload = np.random.default_rng(SEED).integers(
        0, 2**32, CHUNKS * CHUNK_BYTES // 4, dtype=np.uint32)
    rows = payload.reshape(CHUNKS, -1)
    return {"words": reference.integrity_words(rows).tolist(),
            "crcs": reference.crc32c_rows(rows).tolist(), "rows": rows}


def _passes(values, per_pass):
    """`values`, a value a chunk over whole passes, as one list a pass."""
    assert values and len(values) % len(per_pass) == 0
    n = len(per_pass)
    return [values[i:i + n] for i in range(0, len(values), n)]


@pytest.mark.parametrize("depth", DEPTHS)
def test_run_matches_the_references_and_jax_in_chunk_order(port, want, depth):
    import jax.numpy as jnp

    from brpc_tpu.device_path import _integrity_word

    got = port[f"run_d{depth}"]
    assert got["ok"] is True
    jax_words = [int(_integrity_word(jnp.asarray(r))) for r in want["rows"]]
    assert jax_words == want["words"]
    passes = _passes(got["words"], want["words"])
    assert len(passes) >= 2
    assert passes == [want["words"]] * len(passes)
    assert _passes(got["crcs"], want["crcs"]) == [want["crcs"]] * len(passes)
    np.testing.assert_array_equal(port[f"last_d{depth}"], want["rows"][-1])


def test_workers_run_the_three_passes_and_the_caller_the_enqueues(port):
    threads = port["timed_threads"]
    for part in ("np.copyto", "native.frame_in_place", "native.crc32c"):
        assert threads[part], part
        assert "caller" not in threads[part], part
        assert all(t.startswith("device-path-worker-") for t in threads[part])
    for part in ("H2D enqueue (_h2d)", "integrity_word (B2 launch)",
                 "DeviceStagingRing.acquire"):
        assert threads[part] == ["caller"], part


def test_run_leaves_nothing_in_flight(port, want):
    assert port["calls_after_run"] == 0
    assert port["free_slots"] == [0, 1, 2, 3]
    got = port["two_runs"]
    assert got["ok"] is True
    assert got["words"] == want["words"] * 2
    assert got["crcs"] == want["crcs"] * 2


def test_a_slot_completes_only_after_its_bytes_are_verified(port):
    """On each thread, every complete of a slot comes right after the
    crc32c of its returned bytes, so no later chunk can reach the slot's
    buffers before they are verified."""
    ordered = port["ordered"]
    assert sum(e.count("complete") for e in ordered.values()) == 2 * CHUNKS
    for name, seq in ordered.items():
        assert name.startswith("device-path-worker-")
        assert seq == ["crc32c", "complete"] * (len(seq) // 2), name


def test_a_corrupted_returned_chunk_makes_ok_false(port, want):
    got = port["corrupt"]
    assert got["ok"] is False  # and it stays so over the next pass
    wrong = [i for i, (a, b) in enumerate(zip(got["crcs"], want["crcs"] * 2))
             if a != b]
    assert wrong == [CORRUPT_CHUNK]
    assert got["words"] == want["words"] * 2


@pytest.mark.parametrize("name", FAILING)
def test_a_worker_error_reaches_the_caller_and_close_stops_the_workers(
        port, name):
    case = port[f"fail_{name.split('.')[1]}"]
    assert case["raised_on"].startswith("device-path-worker-")
    assert case["caught"] == "Boom" and case["same"]
    assert case["raise_to_caller_s"] < 1.0
    assert case["aborted"]
    assert case["threads_before_close"] >= 1
    assert case["threads_after_close"] == []


def test_many_workers_finishing_out_of_order_fold_in_chunk_order(port, want):
    got = port["stress"]
    assert got["workers"] == 16
    assert got["ok"] is True
    assert got["words"] == want["words"] * 3
    assert got["crcs"] == want["crcs"] * 3


def test_run_and_close_leave_no_worker_behind(port):
    assert port["threads_after_runs"] == []
    assert port["threads_at_end"] == []


@pytest.mark.cuda
@pytest.mark.parametrize("depth", DEPTHS)
def test_threaded_ring_on_card_matches_the_references(want, depth):
    """The ring path on the card (driver enqueues, workers, in-order
    fold) at each depth, held to the references chunk by chunk."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device found")
    from brpc_tpu_torch import device_path

    diag = {}
    rec = device_path.run(payload_mb=PAYLOAD_MB, reps=4, ring_depth=depth,
                          chunk_kb=CHUNK_KB, diag=diag,
                          payload=want["rows"].reshape(-1))
    assert rec["device_path_ok"] is True
    assert rec["device_path_device"].startswith("cuda:")
    passes = _passes(diag["integrity_words"], want["words"])
    assert passes == [want["words"]] * len(passes)
    assert _passes(diag["returned_crc32c"], want["crcs"]) == \
        [want["crcs"]] * len(passes)
    np.testing.assert_array_equal(
        np.asarray(diag["returned_last_chunk"], dtype=np.uint32),
        want["rows"][-1])
