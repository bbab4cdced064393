"""Continuous micro-batching scheduler: the pure-logic twin of
examples/infer_server.cc's BatchScheduler, the port's own copy of
brpc_tpu/infer_sched.py (it has no device work).

Same policy, no RPC stack: membership is recomputed BETWEEN device
steps (finished sequences leave, admitted ones join immediately — no
batch-boundary barriers), ordered priority-descending, with stalled
consumers preempted (a sequence whose sink hasn't drained its last
grant yields its slot instead of growing a queue) and an optional
per-tenant slot cap so one tenant can't own the whole batch.

`simulate()` predicts the batched vs unbatched tokens/s ratio of
bench.py's infer_scrape round. Tested in tests/test_torch_infer_sched.py
against the same cases as the JAX package's copy.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Sequence:
    """One admitted generation request."""

    key: str
    total: int                    # tokens to produce
    tenant: str = "default"
    priority: int = 4             # 0 = most sheddable .. 7 = protected
    granted: int = 0              # tokens the scheduler has granted
    drained: int = 0              # tokens the consumer has taken
    resume_from: int = 0          # client floor at (re)open

    def __post_init__(self) -> None:
        # Post-restart resume: regenerate from the client's floor.
        self.granted = max(self.granted, self.resume_from)
        self.drained = max(self.drained, self.resume_from)

    @property
    def done(self) -> bool:
        return self.granted >= self.total

    @property
    def stalled(self) -> bool:
        """Consumer behind its grants: no new slot until it catches up."""
        return self.granted > self.drained


@dataclass
class StepReport:
    """What one device step served."""

    batch: list = field(default_factory=list)  # sequences granted a token
    preempted: int = 0                         # stalled slot losses


class MicroBatchScheduler:
    """Continuous micro-batching: one token per member per step."""

    def __init__(self, max_batch: int = 8, tenant_batch_cap: int = 0,
                 unbatched: bool = False) -> None:
        self.max_batch = max_batch
        self.tenant_batch_cap = tenant_batch_cap
        self.unbatched = unbatched
        self.pool: list[Sequence] = []
        self.steps = 0
        self.tokens = 0
        self.preempted = 0

    def admit(self, seq: Sequence) -> None:
        """Join the pool; eligible for the very next step."""
        self.pool.append(seq)

    def form_batch(self) -> StepReport:
        """Membership for the next step (examples/infer_server.cc
        FormBatch): priority-descending stable order, stalled consumers
        preempted, per-tenant seats capped."""
        rep = StepReport()
        width = 1 if self.unbatched else self.max_batch
        seats: dict[str, int] = {}
        order = sorted(self.pool, key=lambda s: -s.priority)
        for seq in order:
            if len(rep.batch) >= width:
                break
            if seq.done:
                continue
            if seq.stalled:
                rep.preempted += 1
                continue
            if self.tenant_batch_cap > 0:
                held = seats.get(seq.tenant, 0)
                if held >= self.tenant_batch_cap:
                    continue
                seats[seq.tenant] = held + 1
            rep.batch.append(seq)
        return rep

    def step(self) -> StepReport:
        """One device step: grant one token to every batch member, then
        reap finished sequences — continuous, not batch-bounded."""
        rep = self.form_batch()
        for seq in rep.batch:
            seq.granted += 1
        self.steps += 1 if rep.batch else 0
        self.tokens += len(rep.batch)
        self.preempted += rep.preempted
        self.pool = [s for s in self.pool if not s.done]
        return rep


def simulate(n_seqs: int, tokens_each: int, max_batch: int = 8,
             unbatched: bool = False, step_us: int = 2000) -> dict:
    """Closed-form-ish throughput model for bench.py's infer_scrape:
    run n_seqs identical sequences to completion with an always-ready
    consumer; report steps, tokens and tokens/s at the given step cost.
    Batched serving amortizes the step across the batch width — the
    tokens/s ratio vs unbatched approaches min(n_seqs, max_batch)."""
    sched = MicroBatchScheduler(max_batch=max_batch, unbatched=unbatched)
    for i in range(n_seqs):
        sched.admit(Sequence(key=f"k{i}", total=tokens_each))
    while sched.pool:
        rep = sched.step()
        for seq in rep.batch:      # always-ready consumer
            seq.drained = seq.granted
    secs = sched.steps * step_us / 1e6
    return {
        "steps": sched.steps,
        "tokens": sched.tokens,
        "tokens_per_s": sched.tokens / secs if secs > 0 else 0.0,
    }
