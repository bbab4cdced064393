"""Port parity: brpc_tpu_torch.infer_sched, the port's own copy of the
continuous micro-batching scheduler. The cases of
tests/test_infer_sched.py run against the port's copy, and the two
copies are held equal on `simulate()` and on seeded step-by-step
schedules with priorities, tenant caps and slow consumers."""
import numpy as np
import pytest

from brpc_tpu import infer_sched as ref
from brpc_tpu_torch import infer_sched as port
from brpc_tpu_torch.infer_sched import MicroBatchScheduler, Sequence, simulate


def test_continuous_membership():
    """Finished sequences leave and waiting ones join BETWEEN steps —
    no batch-boundary barrier."""
    sched = MicroBatchScheduler(max_batch=2)
    a = Sequence(key="a", total=1)
    b = Sequence(key="b", total=3)
    sched.admit(a)
    sched.admit(b)
    rep = sched.step()
    assert set(s.key for s in rep.batch) == {"a", "b"}
    for s in rep.batch:
        s.drained = s.granted
    # `a` finished; `c` admitted mid-flight joins the very next step.
    c = Sequence(key="c", total=2)
    sched.admit(c)
    rep = sched.step()
    assert set(s.key for s in rep.batch) == {"b", "c"}


def test_priority_and_tenant_cap():
    """Gold keeps its seat; one tenant can't own the whole batch."""
    sched = MicroBatchScheduler(max_batch=2, tenant_batch_cap=1)
    for i in range(3):
        sched.admit(Sequence(key="b%d" % i, total=8, tenant="bronze",
                             priority=1))
    sched.admit(Sequence(key="gold", total=8, tenant="gold", priority=7))
    rep = sched.step()
    keys = [s.key for s in rep.batch]
    assert keys[0] == "gold", keys
    assert len(keys) == 2, keys
    assert sum(1 for s in rep.batch if s.tenant == "bronze") == 1, keys


def test_stall_preemption_and_resume():
    """A consumer behind its grants loses its slot (no queue growth);
    it rejoins once drained. A resumed sequence regenerates from the
    client's floor."""
    sched = MicroBatchScheduler(max_batch=1)
    slow = Sequence(key="s", total=4)
    sched.admit(slow)
    rep = sched.step()
    assert rep.batch == [slow] and slow.granted == 1
    rep = sched.step()
    assert rep.batch == [] and rep.preempted == 1
    assert slow.granted == 1
    slow.drained = slow.granted
    rep = sched.step()
    assert rep.batch == [slow] and slow.granted == 2
    resumed = Sequence(key="r", total=10, resume_from=7)
    assert resumed.granted == 7 and resumed.drained == 7
    sched.admit(resumed)


def test_batched_beats_unbatched():
    batched = simulate(n_seqs=8, tokens_each=32, max_batch=8)
    serial = simulate(n_seqs=8, tokens_each=32, max_batch=8,
                      unbatched=True)
    assert batched["tokens"] == serial["tokens"] == 8 * 32
    assert batched["steps"] == 32
    assert serial["steps"] == 8 * 32
    assert batched["tokens_per_s"] >= 7 * serial["tokens_per_s"]


@pytest.mark.parametrize("n_seqs,tokens_each,max_batch,unbatched", [
    (8, 32, 8, False), (8, 32, 8, True), (3, 5, 2, False), (20, 7, 4, False),
    (13, 9, 5, True), (1, 1, 8, False), (0, 4, 8, False),
])
def test_simulate_matches_the_jax_packages_copy(n_seqs, tokens_each,
                                                max_batch, unbatched):
    assert simulate(n_seqs, tokens_each, max_batch, unbatched) == \
        ref.simulate(n_seqs, tokens_each, max_batch, unbatched)


def _schedule(mod, seed):
    """A seeded run of `mod`'s scheduler: mixed priorities and tenants, a
    tenant cap, late admissions and consumers that drain at random.
    Returns every step's batch keys and preemption count."""
    rng = np.random.default_rng(seed)
    sched = mod.MicroBatchScheduler(max_batch=4, tenant_batch_cap=2)
    trace, seqs = [], []
    for step in range(60):
        if step % 5 == 0:
            for _ in range(int(rng.integers(1, 4))):
                seq = mod.Sequence(
                    key=f"s{len(seqs)}", total=int(rng.integers(1, 9)),
                    tenant=f"t{int(rng.integers(0, 3))}",
                    priority=int(rng.integers(0, 8)),
                    resume_from=int(rng.integers(0, 2)))
                seqs.append(seq)
                sched.admit(seq)
        rep = sched.step()
        trace.append(([s.key for s in rep.batch], rep.preempted))
        for seq in seqs:
            if rng.random() < 0.7:
                seq.drained = seq.granted
    return trace, sched.steps, sched.tokens, sched.preempted


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_schedule_matches_the_jax_packages_copy(seed):
    assert _schedule(port, seed) == _schedule(ref, seed)
