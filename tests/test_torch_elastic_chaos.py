"""``ElasticRunner`` under injected faults (port of tests/test_chaos.py's
and tests/test_preemption.py's acceptance loops): the faults come from
``testing/chaos.py`` in each worker's env overlay, the bodies are light
checkpointing loops (tests/torch_boring.py).

- ``crash@rank1:step3``: rank 1 dies on its third dispatch, the retry
  completes from the checkpoint;
- ``hang@rank1:once``: the heartbeat freezes, the watchdog reaps rank 1
  (``WorkerWedged``, stale beat), every rank restarts and the retry
  resumes from the checkpoint rank 0 wrote;
- ``preempt@rank0:step2``: SIGTERM becomes a drain (the worker's notice),
  the body raises ``Preempted`` at its next step boundary, the runner
  resumes at that exact step without charging the failure budget; with
  ``max_preemptions=0`` the same drain is terminal and leaves
  ``run_report.json`` naming it;
- ``lost@rank1:step2``: rank 1's host never comes back, the pool shrinks
  to world 1 and the descent continues bit-equal to an uninterrupted
  one.

Heartbeats every 0.1 s, wedge timeouts of 1.5 s, pools of 2 workers,
every pool ended in ``finally``."""

import json
import os

import pytest

from ray_lightning_accelerators_tpu_torch.runtime.actors import ActorPool
from ray_lightning_accelerators_tpu_torch.runtime.elastic import (
    ElasticRunner)
from ray_lightning_accelerators_tpu_torch.runtime.watchdog import (
    WorkerWedged)
from ray_lightning_accelerators_tpu_torch.testing.chaos import (
    CHAOS_EXIT_CODE)
from tests.torch_boring import (ckpt_train_body, preempt_train_body,
                                world_train_body)

pytestmark = pytest.mark.chaos

HB = "0.1"


def _pool(**env):
    env = {"RLA_TPU_WORKER_HEARTBEAT_S": HB, **env}
    return ActorPool(2, env_per_worker=[dict(env), dict(env)])


def _state(ckpt):
    with open(os.path.join(ckpt, "state.json")) as f:
        return json.load(f)


def test_chaos_crash_at_step3_restarts_and_completes(tmp_path):
    ckpt = str(tmp_path)
    pool = _pool(RLA_TPU_CHAOS="crash@rank1:step3")
    failures, codes = [], []

    def on_failure(attempt, err):
        # the dead process before the runner's restart replaces it (the
        # error's text may be written before the exit code is reaped)
        failures.append(err)
        pool.workers[1]._proc.join(timeout=30)
        codes.append(pool.workers[1].exitcode)

    try:
        for total in (2, 4):  # dispatches 1 and 2 run clean
            for f in pool.execute_per_worker(
                    ckpt_train_body, [(r, ckpt, total) for r in range(2)]):
                f.result(timeout=120)
        runner = ElasticRunner(pool, max_failures=1, on_failure=on_failure)
        out = runner.run(ckpt_train_body,
                         args_per_worker=lambda a: [(r, ckpt, 6)
                                                    for r in range(2)])
        assert runner.attempts_used == 2
        (err,) = failures
        assert "worker 1 died" in str(err)
        assert codes == [CHAOS_EXIT_CODE]
        assert [r[0] for r in out] == [0, 1]
        assert _state(ckpt)["step"] == 6
    finally:
        pool.kill()


def test_chaos_hang_reaped_and_resumed_from_checkpoint(tmp_path):
    """``hang@rank1:once``: the watchdog classifies rank 1 wedged within
    the 1.5 s wedge timeout, its future fails with ``WorkerWedged``, every
    rank restarts and the retry starts from the step rank 0 saved."""
    ckpt = str(tmp_path / "ckpt")
    os.makedirs(ckpt)
    pool = _pool(RLA_TPU_CHAOS="hang@rank1:once",
                 RLA_TPU_CHAOS_NS=str(tmp_path / "ns"))
    failures = []
    try:
        runner = ElasticRunner(pool, max_failures=2, wedge_timeout_s=1.5,
                               watchdog_poll_s=0.1,
                               on_failure=lambda a, e: failures.append(e))
        out = runner.run(ckpt_train_body,
                         args_per_worker=lambda a: [(r, ckpt, 6)
                                                    for r in range(2)])
        assert runner.attempts_used == 2
        (err,) = failures
        assert isinstance(err, WorkerWedged) and err.rank == 1
        (reap,) = runner.wedge_events
        assert reap["rank"] == 1 and reap["state"] == "wedged"
        assert "stale" in reap["detail"]
        starts = {r[1] for r in out}
        assert len(starts) == 1 and starts.pop() >= 1
        assert _state(ckpt)["step"] == 6
    finally:
        pool.kill()


def test_chaos_preempt_resumes_at_the_exact_step(tmp_path):
    """``preempt@rank0:step2`` SIGTERMs rank 0 on its second dispatch;
    its notice (``RLA_TPU_PREEMPT_GRACE_S`` in its env) turns that into a
    drain at the body's first boundary, step 3; the runner resumes with
    no failure charged (``max_failures=0``) and the retry starts at step
    3.  A second run with ``max_preemptions=0`` hits the same drain and
    ends terminal, with ``run_report.json`` naming the ``Preempted``."""
    ckpt = str(tmp_path / "ckpt")
    os.makedirs(ckpt)
    pool = _pool(RLA_TPU_CHAOS="preempt@rank0:step2",
                 RLA_TPU_PREEMPT_GRACE_S="60")
    failures = []
    try:
        for f in pool.execute_per_worker(
                preempt_train_body, [(r, ckpt, 3) for r in range(2)]):
            f.result(timeout=120)
        runner = ElasticRunner(pool, max_failures=0,
                               on_failure=lambda a, e: failures.append(e))
        out = runner.run(preempt_train_body,
                         args_per_worker=lambda a: [(r, ckpt, 6)
                                                    for r in range(2)])
        assert failures == []
        assert runner.attempts_used == 2
        (drain,) = runner.preempt_events
        assert drain.step == 3
        assert drain.info["source"].startswith("signal-")
        by_rank = {r[0]: r for r in out}
        assert by_rank[0][1] == 3
        assert 3 <= by_rank[1][1] <= 6
        assert _state(ckpt)["step"] == 6
        assert runner.goodput.snapshot()["preemptions"] == 1

        # the retried processes' dispatch 2: the same drain, now terminal
        reports = str(tmp_path / "reports")
        runner = ElasticRunner(pool, max_failures=0, max_preemptions=0,
                               report_dir=reports)
        with pytest.raises(RuntimeError, match="max_preemptions"):
            runner.run(preempt_train_body,
                       args_per_worker=lambda a: [(r, ckpt, 9)
                                                  for r in range(2)])
        with open(os.path.join(reports, "run_report.json")) as f:
            rep = json.load(f)
        assert rep["error"]["type"] == "Preempted"
        assert rep["extra"]["attempts_used"] == 1
    finally:
        pool.kill()


def test_chaos_lost_rank_scales_down_and_resumes(tmp_path):
    """``lost@rank1:step2``: rank 1 dies with a marker its respawn dies
    on; the probe finds it gone, the pool shrinks to rank 0, the retry
    runs at world 1, and the descent goes on: steps 0-2 at world 2,
    3-5 at world 1, the final weight bit-equal to an uninterrupted run."""
    ns = str(tmp_path / "ns")
    ckpt = str(tmp_path / "ckpt")
    os.makedirs(ckpt)
    pool = _pool(RLA_TPU_CHAOS="lost@rank1:step2", RLA_TPU_CHAOS_NS=ns)
    try:
        for f in pool.execute_per_worker(
                world_train_body, [(r, 2, ckpt, 3) for r in range(2)]):
            f.result(timeout=120)
        runner = ElasticRunner(pool, max_failures=2, allow_shrink=True,
                               min_workers=1, probe_timeout_s=60.0)
        out = runner.run(world_train_body,
                         args_per_worker=lambda a, world: [
                             (r, world, ckpt, 6) for r in range(world)])
        assert runner.shrink_events == [
            {"dropped": [1], "world_size": 1, "attempt": 2}]
        assert len(pool) == 1 and pool.workers[0].rank == 0
        assert [r[1] for r in out] == [1]
        final = _state(ckpt)
        assert final["step"] == 6
        assert final["worlds"] == [2, 2, 2, 1, 1, 1]
        w = 1.0
        for _ in range(6):
            w = w - 0.1 * (2.0 * w)
        assert final["w"] == w
        assert any(n.endswith(".lost") for n in os.listdir(ns))
    finally:
        pool.kill()
