"""Pipeline tick programs: deterministic per-stage slot sequences.

A copy of the JAX package's ``parallel/mpmd/schedule.py`` (pure Python):
the programs and their fingerprints are equal byte for byte, since the
fingerprint is the driver/worker version check.

A schedule here is not a runtime policy — it is a *value*: for a given
``(schedule, stage, num_stages, num_microbatches)`` the generator emits
the exact ordered slot sequence that stage will execute, before any
worker exists.  That buys three things the SPMD pipeline
(``parallel/pipeline.py``) gets implicitly from its lock-step ticks:

- **auditability** — :func:`audit_programs` replays the whole program
  set against the handoff dependency graph driver-side (a per-rank
  sequence diff, lifted to scheduled slots) and rejects any program
  set that would deadlock or drop a microbatch *before* dispatch;
- **determinism** — a stage's executed tick stream is comparable
  against its program byte-for-byte (:func:`program_fingerprint`), so a
  wedged stage's flight-recorder tail diffs against intent, not memory;
- **GPipe as data** — GPipe is literally the 1F1B generator with the
  warmup window widened to every microbatch, not a second code path.

Slot ops (``(op, microbatch)`` pairs):

======== ==============================================================
recv_act wait for the upstream stage's activation of microbatch m
fwd      run this stage's forward on microbatch m
send_act publish the activation of microbatch m downstream
recv_grad wait for the downstream stage's activation-grad of m
bwd      run this stage's backward on microbatch m (accumulates grads)
send_grad publish the activation-grad of m upstream
opt      apply the optimizer once, after every microbatch (mb = -1)
======== ==============================================================

Both schedules share the analytic bubble bound
``(S - 1) / (M + S - 1)`` — 1F1B's win over GPipe is the in-flight
activation window (``min(S - stage, M)`` live microbatches instead of
``M``), not the bubble.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

OP_RECV_ACT = "recv_act"
OP_FWD = "fwd"
OP_SEND_ACT = "send_act"
OP_RECV_GRAD = "recv_grad"
OP_BWD = "bwd"
OP_SEND_GRAD = "send_grad"
OP_OPT = "opt"

# ops that run device compute (the busy-time numerator of the measured
# bubble fraction; recv waits and mailbox IO are pipeline overhead)
COMPUTE_OPS = frozenset({OP_FWD, OP_BWD, OP_OPT})

SCHEDULES = ("1f1b", "gpipe")


class Slot(NamedTuple):
    op: str
    microbatch: int


class PipelineScheduleError(ValueError):
    """Typed refusal for an invalid or non-executable schedule: bad
    schedule name, out-of-range stage, or a program set whose handoffs
    cannot all be satisfied (:func:`audit_programs`)."""


def _check(schedule: str, num_stages: int, num_microbatches: int) -> None:
    if schedule not in SCHEDULES:
        raise PipelineScheduleError(
            f"unknown pipeline schedule {schedule!r}: expected one of "
            f"{SCHEDULES} (Trainer(pipeline_schedule=...))")
    if num_stages < 1:
        raise PipelineScheduleError(
            f"num_stages must be >= 1, got {num_stages}")
    if num_microbatches < 1:
        raise PipelineScheduleError(
            f"num_microbatches must be >= 1, got {num_microbatches}")


def stage_program(schedule: str, stage: int, num_stages: int,
                  num_microbatches: int) -> Tuple[Slot, ...]:
    """The ordered slot sequence stage ``stage`` executes for one
    optimizer step.

    1F1B: ``min(S - 1 - stage, M)`` warmup forwards, then strict
    one-forward-one-backward steady state, then the drain backwards.
    GPipe: every forward is warmup (all M forwards, then all M
    backwards) — the same expansion with the warmup window maxed out.
    """
    _check(schedule, num_stages, num_microbatches)
    if not 0 <= stage < num_stages:
        raise PipelineScheduleError(
            f"stage {stage} out of range for num_stages={num_stages}")
    m_total = num_microbatches
    warmup = m_total if schedule == "gpipe" \
        else min(num_stages - 1 - stage, m_total)
    first = stage == 0
    last = stage == num_stages - 1

    slots: List[Slot] = []

    def emit_fwd(m: int) -> None:
        if not first:
            slots.append(Slot(OP_RECV_ACT, m))
        slots.append(Slot(OP_FWD, m))
        if not last:
            slots.append(Slot(OP_SEND_ACT, m))

    def emit_bwd(m: int) -> None:
        if not last:
            slots.append(Slot(OP_RECV_GRAD, m))
        slots.append(Slot(OP_BWD, m))
        if not first:
            slots.append(Slot(OP_SEND_GRAD, m))

    fwd = bwd = 0
    for _ in range(warmup):
        emit_fwd(fwd)
        fwd += 1
    for _ in range(m_total - warmup):
        emit_fwd(fwd)
        fwd += 1
        emit_bwd(bwd)
        bwd += 1
    while bwd < m_total:
        emit_bwd(bwd)
        bwd += 1
    slots.append(Slot(OP_OPT, -1))
    return tuple(slots)


def build_programs(schedule: str, num_stages: int,
                   num_microbatches: int) -> Tuple[Tuple[Slot, ...], ...]:
    """Every stage's program, audited as a set before it is returned —
    a generator bug that would deadlock the actor groups surfaces here,
    driver-side, as a typed refusal naming the stuck slot."""
    programs = tuple(
        stage_program(schedule, s, num_stages, num_microbatches)
        for s in range(num_stages))
    diagnosis = audit_programs(programs)
    if diagnosis is not None:
        raise PipelineScheduleError(
            f"schedule {schedule!r} (S={num_stages}, M={num_microbatches}) "
            f"emitted a non-executable program set: {diagnosis}")
    return programs


def program_fingerprint(program: Sequence[Slot]) -> str:
    """Canonical string form of one stage's program — the compare key
    for executed-vs-scheduled tick diffing (tests, postmortems)."""
    return "|".join(f"{op}:{m}" for op, m in program)


def analytic_bubble_fraction(num_stages: int,
                             num_microbatches: int) -> float:
    """The idle fraction of a perfectly balanced pipeline step:
    ``(S - 1) / (M + S - 1)`` for both GPipe and 1F1B."""
    return (num_stages - 1) / float(num_microbatches + num_stages - 1)


def in_flight_activations(schedule: str, stage: int, num_stages: int,
                          num_microbatches: int) -> int:
    """Peak count of microbatch activations a stage holds live at once
    (the memory argument for 1F1B: ``min(S - stage, M)`` vs GPipe's
    ``M``)."""
    program = stage_program(schedule, stage, num_stages, num_microbatches)
    live = peak = 0
    for op, _ in program:
        if op == OP_FWD:
            live += 1
            peak = max(peak, live)
        elif op == OP_BWD:
            live -= 1
    return peak


# --------------------------------------------------------------------- #
# Cross-stage handoff audit (the sanitizer's sequence diff, for slots)   #
# --------------------------------------------------------------------- #
def audit_programs(programs: Sequence[Sequence[Slot]]
                   ) -> Optional[Dict[str, object]]:
    """Replay a program set against the handoff dependency graph.

    Every ``recv_act(m)`` at stage s must be satisfiable by a
    ``send_act(m)`` stage s-1 can reach, and every ``recv_grad(m)`` by a
    ``send_grad(m)`` from s+1 — executed as an event-driven simulation
    (each stage advances greedily; a round with zero progress and
    unfinished programs is a deadlock).  Returns ``None`` when every
    stage runs to completion, else a diagnosis naming each stuck
    stage's blocked slot and the handoff it waited for.
    """
    num_stages = len(programs)
    produced: set = set()  # ("act"|"grad", src_stage, microbatch)
    ptr = [0] * num_stages
    progressed = True
    while progressed:
        progressed = False
        for s in range(num_stages):
            program = programs[s]
            while ptr[s] < len(program):
                op, m = program[ptr[s]]
                if op == OP_RECV_ACT and ("act", s - 1, m) not in produced:
                    break
                if op == OP_RECV_GRAD and ("grad", s + 1, m) not in produced:
                    break
                if op == OP_SEND_ACT:
                    produced.add(("act", s, m))
                elif op == OP_SEND_GRAD:
                    produced.add(("grad", s, m))
                ptr[s] += 1
                progressed = True
    stuck = {s: ptr[s] for s in range(num_stages)
             if ptr[s] < len(programs[s])}
    if not stuck:
        return None
    per_stage = {}
    for s, i in stuck.items():
        op, m = programs[s][i]
        waiting = (("act", s - 1, m) if op == OP_RECV_ACT
                   else ("grad", s + 1, m) if op == OP_RECV_GRAD
                   else None)
        per_stage[str(s)] = {"blocked_at": i, "op": op, "microbatch": m,
                             "waiting_for": waiting}
    return {"deadlocked_stages": sorted(stuck),
            "per_stage": per_stage}
