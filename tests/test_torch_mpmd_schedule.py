"""The port's MPMD tick programs (``parallel/mpmd/schedule.py``) against
the JAX package's: every stage program and fingerprint equal byte for
byte (the driver/worker version check), and the JAX package's schedule
tests (tests/test_mpmd_schedule.py) run on the port's copy.  Pure
schedule math: no processes, no tensors."""

import pytest

from ray_lightning_accelerators_tpu.parallel.mpmd import schedule as jax_sched
from ray_lightning_accelerators_tpu_torch.parallel.mpmd import (
    schedule as sched)
from ray_lightning_accelerators_tpu_torch.parallel.mpmd.schedule import (
    OP_BWD, OP_FWD, OP_OPT, OP_RECV_ACT, OP_RECV_GRAD, OP_SEND_ACT,
    OP_SEND_GRAD, PipelineScheduleError, Slot, analytic_bubble_fraction,
    audit_programs, build_programs, in_flight_activations,
    program_fingerprint, stage_program)

pytestmark = pytest.mark.pipeline_mpmd


def _ops(program):
    return [s.op for s in program]


def _compute_slots(program, op):
    return [s.microbatch for s in program if s.op == op]


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
@pytest.mark.parametrize("num_stages", [2, 3, 4])
def test_programs_and_fingerprints_equal_the_jax_package(schedule,
                                                         num_stages):
    assert sched.SCHEDULES == jax_sched.SCHEDULES
    for m in range(1, 9):
        ours = build_programs(schedule, num_stages, m)
        theirs = jax_sched.build_programs(schedule, num_stages, m)
        for s in range(num_stages):
            assert [tuple(x) for x in ours[s]] == \
                [tuple(x) for x in theirs[s]], (schedule, num_stages, m, s)
            assert program_fingerprint(ours[s]) == \
                jax_sched.program_fingerprint(theirs[s])
            assert in_flight_activations(schedule, s, num_stages, m) == \
                jax_sched.in_flight_activations(schedule, s, num_stages, m)
        assert analytic_bubble_fraction(num_stages, m) == \
            jax_sched.analytic_bubble_fraction(num_stages, m)


class TestStageProgram:
    def test_first_stage_1f1b_two_stages(self):
        prog = stage_program("1f1b", 0, 2, 4)
        assert _compute_slots(prog, OP_FWD) == [0, 1, 2, 3]
        assert _compute_slots(prog, OP_BWD) == [0, 1, 2, 3]
        assert prog[-1] == Slot(OP_OPT, -1)
        assert _compute_slots(prog, OP_SEND_ACT) == [0, 1, 2, 3]
        assert _compute_slots(prog, OP_RECV_GRAD) == [0, 1, 2, 3]
        assert OP_RECV_ACT not in _ops(prog)
        assert OP_SEND_GRAD not in _ops(prog)

    def test_last_stage_interleaves_immediately(self):
        prog = stage_program("1f1b", 1, 2, 4)
        compute = [s for s in prog if s.op in (OP_FWD, OP_BWD)]
        assert [(s.op, s.microbatch) for s in compute[:4]] == [
            (OP_FWD, 0), (OP_BWD, 0), (OP_FWD, 1), (OP_BWD, 1)]
        assert OP_SEND_ACT not in _ops(prog)
        assert OP_RECV_GRAD not in _ops(prog)

    def test_gpipe_runs_all_forwards_first(self):
        prog = stage_program("gpipe", 0, 2, 4)
        ops = [s.op for s in prog if s.op in (OP_FWD, OP_BWD)]
        assert ops == [OP_FWD] * 4 + [OP_BWD] * 4

    def test_1f1b_warmup_depth_scales_with_distance_to_last(self):
        prog = stage_program("1f1b", 0, 4, 8)
        ops = [s.op for s in prog if s.op in (OP_FWD, OP_BWD)]
        assert ops[:3] == [OP_FWD] * 3
        assert ops[3:7] == [OP_FWD, OP_BWD, OP_FWD, OP_BWD]

    def test_every_stage_ends_with_opt(self):
        for sch in sched.SCHEDULES:
            for stage in range(3):
                prog = stage_program(sch, stage, 3, 6)
                assert prog[-1] == Slot(OP_OPT, -1)

    def test_unknown_schedule_refused(self):
        with pytest.raises(PipelineScheduleError, match="schedule"):
            stage_program("interleaved", 0, 2, 4)

    def test_bad_shape_refused(self):
        with pytest.raises(PipelineScheduleError):
            stage_program("1f1b", 2, 2, 4)  # stage out of range
        with pytest.raises(PipelineScheduleError):
            stage_program("1f1b", 0, 2, 0)  # no microbatches


class TestAuditAndFingerprint:
    def test_build_programs_audits_clean(self):
        for sch in sched.SCHEDULES:
            progs = build_programs(sch, 4, 8)
            assert audit_programs(progs) is None

    def test_audit_flags_deadlock(self):
        progs = list(build_programs("1f1b", 2, 4))
        # stage 1's first recv waits for a microbatch no one sends:
        # stage 1 blocks at slot 0, stage 0 starves on grads
        progs[1] = [Slot(OP_RECV_ACT, 7) if s == Slot(OP_RECV_ACT, 0)
                    else s for s in progs[1]]
        diag = audit_programs(progs)
        assert diag is not None
        assert diag["deadlocked_stages"] == [0, 1]
        blocked = diag["per_stage"]["1"]
        assert blocked["op"] == OP_RECV_ACT
        assert blocked["waiting_for"] == ("act", 0, 7)
        assert diag == jax_sched.audit_programs(progs)

    def test_fingerprint_deterministic_and_distinct(self):
        a = program_fingerprint(stage_program("1f1b", 0, 2, 4))
        b = program_fingerprint(stage_program("1f1b", 0, 2, 4))
        c = program_fingerprint(stage_program("gpipe", 0, 2, 4))
        assert a == b
        assert a != c


class TestBubbleMath:
    def test_analytic_fraction(self):
        assert analytic_bubble_fraction(1, 4) == 0.0
        assert analytic_bubble_fraction(2, 4) == pytest.approx(1 / 5)
        assert analytic_bubble_fraction(4, 8) == pytest.approx(3 / 11)

    def test_more_microbatches_shrink_the_bubble(self):
        fracs = [analytic_bubble_fraction(4, m) for m in (4, 8, 16, 64)]
        assert fracs == sorted(fracs, reverse=True)
