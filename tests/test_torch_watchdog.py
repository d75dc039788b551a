"""The port's liveness layer on spawned workers (port of tests/
test_watchdog.py, tests/test_chaos.py's live injection and the pool
half of tests/test_fault_tolerance.py): the heartbeat channel of a live
worker, the busy marker, the watchdog's dead / wedged / slow / ok
classification with its reap and ``WorkerWedged``, the boot grace, a
fresh channel after a restart; the pool's ``watch``,
``find_lost(classify=)``, ``drop``, ``revive`` and ``add_worker``;
chaos's crash and malformed spec in the dispatch loop (its hang:
tests/test_torch_elastic_chaos.py); and a typed exception across the
pipe.

Heartbeats beat every 0.1 s, wedge timeouts are 1.5 s or more (JAX's
0.6 s / 0.05 s flake under six xdist workers), pools hold 2 workers at
most and every worker is ended in ``finally``.  Chaos specs reach the
workers through their env overlay only."""

import os
import time

import pytest

from ray_lightning_accelerators_tpu_torch.runtime.actors import (ActorPool,
                                                                 RemoteError,
                                                                 Worker)
from ray_lightning_accelerators_tpu_torch.runtime.guardian import (
    NumericAnomaly)
from ray_lightning_accelerators_tpu_torch.runtime.watchdog import (
    STATE_DEAD, STATE_OK, STATE_SLOW, Watchdog, WorkerWedged)
from ray_lightning_accelerators_tpu_torch.testing.chaos import (
    CHAOS_EXIT_CODE, LOST_EXIT_CODE)
from ray_lightning_accelerators_tpu_torch.parallel.mpmd import driver
from ray_lightning_accelerators_tpu_torch.parallel.mpmd.handoff import (
    PipelineHandoffTimeout)
from tests.torch_boring import (anomaly_same_step_body, crash,
                                handoff_timeout_body, ok, sleep_forever,
                                sleep_s)

HB = 0.1
WEDGE = 1.5


@pytest.fixture(scope="module")
def worker():
    w = Worker(0, heartbeat_s=HB)
    try:
        yield w
    finally:
        w.kill()


def _wait(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def test_heartbeat_stamps_counts_and_busy_marker(worker):
    assert worker.execute(ok, 21).result(timeout=60) == 42
    snap = worker.heartbeat.snapshot()
    assert snap["started"] and snap["dispatches"] == 1
    assert snap["busy_s"] is None  # idle between dispatches
    fut = worker.execute(sleep_s, 0.6)
    assert _wait(lambda: worker.heartbeat.snapshot()["busy_s"] is not None
                 and worker.heartbeat.snapshot()["dispatches"] == 2)
    assert fut.result(timeout=60) == 0.6


def test_typed_exception_crosses_the_pipe(worker):
    """A registered type comes home typed with its fields; anything else
    as RemoteError."""
    with pytest.raises(NumericAnomaly) as ei:
        worker.execute(anomaly_same_step_body, 0).result(timeout=60)
    assert ei.value.step == 7 and ei.value.blame == "data"
    assert ei.value.remote_typed
    with pytest.raises(RemoteError, match="ZeroDivisionError"):
        worker.execute(divmod, 1, 0).result(timeout=60)
    # the MPMD driver's classifiers take the typed form as they took the
    # RemoteError: the timeout names its sender stage, not the waiter
    with pytest.raises(PipelineHandoffTimeout) as ei:
        worker.execute(handoff_timeout_body, 1).result(timeout=60)
    exc = ei.value
    assert driver._typed(exc) is exc
    assert driver._type_name(exc) == "PipelineHandoffTimeout"
    runner = driver.PipelineRunner.__new__(driver.PipelineRunner)
    runner.num_lanes, runner.fsdp, runner.num_stages = 1, 1, 2
    assert runner._attribute([(0, exc)]) == (1, 0, exc)


def test_watchdog_reaps_a_hung_dispatch_then_restart_is_fresh(worker):
    fut = worker.execute(sleep_forever)
    wd = Watchdog([worker], wedge_timeout_s=10.0, dispatch_deadline_s=WEDGE,
                  poll_s=HB).start()
    try:
        with pytest.raises(WorkerWedged) as ei:
            fut.result(timeout=60)
        assert ei.value.rank == 0
        assert "deadline" in ei.value.diagnosis["detail"]
        assert ei.value.diagnosis["busy_s"] > WEDGE
        assert len(wd.reaped) == 1
        assert wd.reaped[0]["error"] == "worker wedged"
        assert wd.wait_for_state(0, STATE_DEAD, timeout=30)
    finally:
        wd.stop()
    old = worker.heartbeat
    worker.restart()
    assert worker.heartbeat is not old  # a fresh channel per generation
    assert worker.execute(ok, 3).result(timeout=60) == 6
    snap = worker.heartbeat.snapshot()
    assert snap["started"] and snap["dispatches"] == 1


def test_slow_straggler_is_never_reaped(worker):
    fut = worker.execute(sleep_s, 1.0)
    wd = Watchdog([worker], wedge_timeout_s=60.0, dispatch_deadline_s=60.0,
                  slow_after_s=0.2, poll_s=0.05).start()
    try:
        assert wd.wait_for_state(0, STATE_SLOW, timeout=30)
        assert fut.result(timeout=60) == 1.0
        assert wd.wait_for_state(0, STATE_OK, timeout=30)
        assert wd.reaped == []
    finally:
        wd.stop()


def test_dead_worker_classified_and_restarted(worker):
    with pytest.raises(RuntimeError, match="died"):
        worker.execute(crash, 3).result(timeout=60)
    worker._proc.join(timeout=30)
    assert worker.exitcode == 3
    state, info = Watchdog([worker], wedge_timeout_s=5.0,
                           auto_reap=False).classify(worker)
    assert state == STATE_DEAD and "exitcode" in info["detail"]


def _env(**kw):
    return {"RLA_TPU_WORKER_HEARTBEAT_S": str(HB), **kw}


@pytest.mark.chaos
def test_pool_watch_find_lost_drop_revive_and_grow(tmp_path):
    """``lost@rank1:step2:once`` kills rank 1 for good (its respawn dies at
    boot): ``find_lost(classify=True)`` calls it gone, ``drop`` keeps
    rank 0's identity, ``revive`` fails while the marker stands and
    succeeds once it is cleared; ``add_worker`` takes the next rank."""
    ns = str(tmp_path / "ns")
    env = _env(RLA_TPU_CHAOS="lost@rank1:step2:once", RLA_TPU_CHAOS_NS=ns)
    pool = ActorPool(2, env_per_worker=[dict(env), dict(env)])
    wd = None
    try:
        assert [f.result(timeout=60) for f in pool.execute_all(ok)] == [2, 2]
        wd = pool.watch(wedge_timeout_s=30.0, poll_s=0.05)
        assert wd.poll_once() == {0: STATE_OK, 1: STATE_OK}
        with pytest.raises(RuntimeError, match="died"):
            pool.workers[1].execute(ok).result(timeout=60)
        pool.workers[1]._proc.join(timeout=30)
        assert pool.workers[1].exitcode == LOST_EXIT_CODE
        assert pool.health_check() == [True, False]
        verdict = pool.find_lost(timeout_s=60.0, classify=True)
        assert verdict == {"gone": [1], "revived": []}
        assert pool.drop([1]) == [1]
        assert [w.rank for w in pool.workers] == [0]
        assert wd.poll_once() == {0: STATE_OK}  # dropped: unsupervised
        assert pool.dropped_ranks() == [1]
        assert pool.revive(1, probe_timeout_s=60.0) is None  # still gone
        for name in os.listdir(ns):
            if name.endswith(".lost"):
                os.remove(os.path.join(ns, name))
        assert pool.revive(1, probe_timeout_s=60.0) is not None
        assert [w.rank for w in pool.workers] == [0, 1]
        assert pool.dropped_ranks() == []
        assert pool.find_lost(timeout_s=60.0) == []
        grown = pool.add_worker(env=_env())
        assert grown.rank == 2 and grown.execute(ok, 4).result(timeout=60) == 8
        assert wd.poll_once() == {0: STATE_OK, 1: STATE_OK, 2: STATE_OK}
    finally:
        if wd is not None:
            wd.stop()
        pool.kill()


@pytest.mark.chaos
def test_boot_grace_then_chaos_crash_and_bad_spec_on_the_future():
    """A fresh worker spends seconds importing before its first beat: a
    1.5 s wedge timeout watching it from its spawn must not reap it while
    it boots.  ``crash@rank0:step2`` then ends it on its second dispatch;
    a malformed spec fails the first dispatch's future visibly."""
    w = Worker(0, env=_env(RLA_TPU_CHAOS="crash@rank0:step2"))
    bad = Worker(0, env=_env(RLA_TPU_CHAOS="explode@rank0"))
    wd = Watchdog([w], wedge_timeout_s=WEDGE, poll_s=0.05).start()
    try:
        assert w.execute(ok, 21).result(timeout=120) == 42  # dispatch 1
        assert wd.reaped == []
        wd.stop()
        with pytest.raises(RuntimeError, match="died"):
            w.execute(ok).result(timeout=60)  # dispatch 2: crash
        w._proc.join(timeout=30)
        assert w.exitcode == CHAOS_EXIT_CODE
        with pytest.raises(RemoteError, match="chaos fault"):
            bad.execute(ok).result(timeout=60)
    finally:
        wd.stop()
        w.kill()
        bad.kill()
