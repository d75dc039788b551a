"""``ElasticRunner`` of the port (``runtime/elastic.py``) with the JAX
tests' own assertions and light bodies (port of tests/
test_fault_tolerance.py's runner tests, tests/test_watchdog.py's wedge
loop, tests/test_preemption.py's argument checks and tests/
test_guardian.py:327-468's rewind tests):

- a crashing rank is retried until it succeeds; past ``max_failures``
  the run gives up; a hung rank is reaped (``dispatch_deadline_s``) and
  retried as a crash;
- a ``NumericAnomaly`` arrives typed and rewinds without charging the
  failure budget; a data-blamed step that trips again after its
  quarantine is terminal; ``max_rewinds`` is terminal past its budget;
  an SDC verdict naming a rank demotes it through the shrink path;
- ``args_per_worker`` gets the world size only through a required
  second positional parameter, and a mis-sized one is a configuration
  error; ``resize_in_memory`` is taken (its loop runs in
  tests/test_torch_resize.py).

One module pool of 2 workers serves the tests (every retry restarts its
ranks), ended in ``finally``; the SDC test shrinks it, so it runs last."""

import pytest

from ray_lightning_accelerators_tpu_torch.runtime.actors import ActorPool
from ray_lightning_accelerators_tpu_torch.runtime.elastic import (
    ElasticRunner)
from ray_lightning_accelerators_tpu_torch.runtime.watchdog import (
    WorkerWedged)
from tests.torch_boring import (anomaly_once_body, anomaly_roaming_body,
                                anomaly_same_step_body, flaky,
                                hang_on_first_attempt, sdc_once_body,
                                world_train_body)

pytestmark = pytest.mark.guardian


@pytest.fixture(scope="module")
def module_pool():
    p = ActorPool(2, env_per_worker=[
        {"RLA_TPU_WORKER_HEARTBEAT_S": "0.1"} for _ in range(2)])
    try:
        yield p
    finally:
        p.kill()


@pytest.fixture
def pool(module_pool):
    """The module pool with every rank alive (a test that ended in a
    crash leaves a dead rank)."""
    module_pool.restart_dead()
    return module_pool


def test_runner_recovers_and_returns(pool):
    """Rank 1 crashes on the first attempt (JAX's test: the first two);
    the retry returns every rank's result."""
    failures = []
    runner = ElasticRunner(pool, max_failures=3,
                           on_failure=lambda a, e: failures.append(a))
    out = runner.run(flaky, args_per_worker=lambda attempt: [
        (attempt, r, 1) for r in range(2)])
    assert out == [(1, 0), (1, 1)]
    assert runner.attempts_used == 2
    assert failures == [0]
    snap = runner.goodput.snapshot()
    assert snap["attempts"] == 2 and snap["seconds"]["restart"] > 0


def test_runner_gives_up(pool):
    runner = ElasticRunner(pool, max_failures=1)
    with pytest.raises(RuntimeError, match="after 2 attempts"):
        runner.run(flaky, args_per_worker=lambda a: [(a, r, 99)
                                                     for r in range(2)])


def test_runner_recovers_from_a_wedged_rank(pool):
    """Wedge -> WorkerWedged -> restart_all -> a clean retry."""
    failures = []
    runner = ElasticRunner(pool, max_failures=2, dispatch_deadline_s=1.5,
                           watchdog_poll_s=0.1,
                           on_failure=lambda a, e: failures.append(e))
    out = runner.run(hang_on_first_attempt,
                     args_per_worker=lambda a: [(a, r) for r in range(2)])
    assert out == [(1, 0), (1, 1)]
    assert runner.attempts_used == 2
    assert len(failures) == 1 and isinstance(failures[0], WorkerWedged)
    assert runner.wedge_events and runner.wedge_events[0]["rank"] == 1
    assert runner.goodput.snapshot()["seconds"]["wedge_wait"] > 0


def test_runner_rewind_does_not_charge_failure_budget(pool):
    """A tripped guard is a rewind: with ``max_failures=0`` a one-shot
    anomaly still resumes, its postmortem typed across the pipe."""
    charged = []
    runner = ElasticRunner(pool, max_failures=0,
                           on_failure=lambda a, e: charged.append(e))
    out = runner.run(anomaly_once_body, args_per_worker=lambda a: [(a,)] * 2)
    assert out == ["ok", "ok"]
    assert runner.attempts_used == 2
    assert charged == []
    (ev,) = runner.anomaly_events
    assert ev["blame"] == "data" and ev["step"] == 5


def test_runner_same_data_step_twice_is_terminal(pool):
    runner = ElasticRunner(pool, max_failures=0, max_rewinds=5)
    with pytest.raises(RuntimeError, match="recurred after its data window"):
        runner.run(anomaly_same_step_body,
                   args_per_worker=lambda a: [(a,)] * 2)
    assert runner.attempts_used == 2


def test_runner_max_rewinds_is_terminal(pool, monkeypatch):
    """The budget comes from ``RLA_TPU_GUARD_MAX_REWINDS`` when the
    runner is given none (1 here; JAX's test: 2, three attempts)."""
    monkeypatch.setenv("RLA_TPU_GUARD_MAX_REWINDS", "1")
    runner = ElasticRunner(pool, max_failures=0)
    assert runner.max_rewinds == 1
    with pytest.raises(RuntimeError,
                       match=r"tripped the numeric guard 2 times"):
        runner.run(anomaly_roaming_body,
                   args_per_worker=lambda a: [(a,)] * 2)
    assert runner.attempts_used == 2
    assert len(runner.anomaly_events) == 2


class _StubPool:
    workers = [None, None]

    def __len__(self):
        return 2


def test_build_args_arity_and_sizing():
    runner = ElasticRunner(_StubPool(), max_failures=0)
    assert runner._build_args(lambda a, **kw: [(a,), (a,)], 0) == \
        [(0,), (0,)]
    assert runner._build_args(lambda a, *, log=None: [(a,), (a,)], 1) == \
        [(1,), (1,)]
    assert runner._build_args(lambda a, tag="x": [(a, tag), (a, tag)],
                              3) == [(3, "x"), (3, "x")]
    assert runner._build_args(lambda a, world: [(a, world)] * world, 2) == \
        [(2, 2), (2, 2)]
    with pytest.raises(ValueError, match="argument tuples"):
        runner.run(world_train_body, args_per_worker=lambda a, world: [
            (r, world, "/tmp", 1) for r in range(3)])
    # the live resize is ported: the runner takes the flag and starts
    # with no grow recorded (tests/test_torch_resize.py runs its loop)
    live = ElasticRunner(_StubPool(), resize_in_memory=True)
    assert live.resize_in_memory is True and live.grow_events == []


def test_runner_sdc_demotes_the_named_rank(pool):
    """An SDC verdict naming rank 1 drops it through the shrink path: the
    retry runs at world 1 without it, floored by ``min_workers``,
    charging no failure (JAX's test has 3 ranks; pools here hold 2)."""
    runner = ElasticRunner(pool, max_failures=0, allow_shrink=True,
                           min_workers=1, probe_timeout_s=60.0)
    out = runner.run(sdc_once_body, args_per_worker=lambda a, world: [
        (a, r) for r in range(world)])
    assert out == [("ok", 0)]
    (shrink,) = runner.shrink_events
    assert shrink["dropped"] == [1] and shrink["blame"] == "sdc"
    assert [w.rank for w in pool.workers] == [0]
