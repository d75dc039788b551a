"""The port's actor runtime (``runtime/actors.py``, ``queue.py``,
``bootstrap.py``): the port of tests/test_runtime.py:40-160 on spawned
workers, plus a 2-rank gloo world.

JAX's ``test_closures_ship_via_cloudpickle`` is not ported: the card's
machine has no cloudpickle, so the port ships work with the standard
``pickle``, and a closure is refused at ``execute`` instead
(``test_closures_are_refused``).  Every wait here is bounded."""

import functools
import os
import pickle
import time

import numpy as np
import pytest

from ray_lightning_accelerators_tpu_torch.runtime import session
from ray_lightning_accelerators_tpu_torch.runtime.actors import (ActorPool,
                                                                 RemoteError)
from ray_lightning_accelerators_tpu_torch.runtime.bootstrap import (
    DistributedWorld, launch_distributed)
from ray_lightning_accelerators_tpu_torch.runtime.queue import (
    TrampolineQueue, process_results)

WAIT = 60


def _sq(x):
    return x * x


def _getenv(k):
    return os.environ.get(k)


def _boom():
    raise ValueError("worker exploded")


def _pid():
    return os.getpid()


def _echo_big(arr):
    return arr * 2


def test_large_payloads_do_not_deadlock():
    """Requests and results far beyond the pipe buffer (~64 KiB) flow
    while earlier results are still in flight."""
    big = np.ones(1_000_000, dtype=np.float32)  # ~4 MB each way
    with ActorPool(1) as pool:
        w = pool.workers[0]
        futs = [w.execute(_echo_big, big) for _ in range(4)]
        for f in futs:
            np.testing.assert_array_equal(f.result(timeout=WAIT), big * 2)


def test_pool_executes_in_parallel_processes():
    with ActorPool(2) as pool:
        pids = [f.result(timeout=WAIT) for f in pool.execute_all(_pid)]
    assert len(set(pids)) == 2
    assert all(p != os.getpid() for p in pids)


def test_execute_returns_results_in_order():
    with ActorPool(1) as pool:
        futs = [pool.workers[0].execute(_sq, i) for i in range(5)]
        assert [f.result(timeout=WAIT) for f in futs] == [0, 1, 4, 9, 16]


def test_env_propagation_prefork_and_rpc():
    with ActorPool(2, env_per_worker=[{"RLA_T": "a"},
                                      {"RLA_T": "b"}]) as pool:
        vals = [f.result(timeout=WAIT)
                for f in pool.execute_all(_getenv, "RLA_T")]
        assert vals == ["a", "b"]
        pool.set_env_vars({"RLA_T2": "77"})
        vals = [f.result(timeout=WAIT)
                for f in pool.execute_all(_getenv, "RLA_T2")]
        assert vals == ["77", "77"]
    assert os.environ.get("RLA_T") is None  # the driver's env is untouched


def test_remote_exception_carries_traceback():
    with ActorPool(1) as pool:
        fut = pool.workers[0].execute(_boom)
        with pytest.raises(RemoteError, match="worker exploded") as info:
            fut.result(timeout=WAIT)
    assert info.value.remote_type == "ValueError"
    assert "_boom" in info.value.remote_traceback


def test_closures_are_refused():
    """Work ships by the standard pickle: a closure fails at the call,
    in this process, and a module-level function goes through."""
    factor = 7
    with ActorPool(1) as pool:
        with pytest.raises((AttributeError, pickle.PicklingError),
                           match="local object"):
            pool.workers[0].execute(lambda x: x * factor, 6)
        fut = pool.workers[0].execute(functools.partial(_sq), 6)
        assert fut.result(timeout=WAIT) == 36


def test_local_ranks_census():
    with ActorPool(3) as pool:
        assert pool.local_ranks() == [0, 1, 2]  # one node -> 0, 1, 2
        assert pool.health_check() == [True, True, True]


def test_workers_dead_after_shutdown():
    pool = ActorPool(2)
    procs = [w._proc for w in pool.workers]
    pool.shutdown()
    for p in procs:
        p.join(timeout=10)
    assert not any(p.is_alive() for p in procs)
    assert pool.health_check() == [False, False]


SEEN = []


def _record(item):
    SEEN.append((item, time.monotonic()))


def _put_then_work(rank):
    session.put_queue(functools.partial(_record, rank))
    time.sleep(1.0)
    return session.get_actor_rank()


def test_queue_pump_runs_during_a_run():
    """Ranks' put_queue callables run in the driver while the ranks still
    work (before their results arrive), and a driver-side put is drained
    too."""
    SEEN.clear()
    q = TrampolineQueue()
    q.put((-1, functools.partial(_record, "driver")))
    with DistributedWorld(2, devices=["cpu", "cpu"], timeout_s=WAIT) as w:
        t0 = time.monotonic()
        assert w.run(_put_then_work, queue=q) == [0, 1]
        t_end = time.monotonic()
    assert sorted(str(item) for item, _ in SEEN) == ["0", "1", "driver"]
    # each rank slept 1 s after its put: the pump ran its callable first
    assert all(t0 <= t <= t_end - 0.5 for _, t in SEEN)


def test_process_results_pumps_a_pool_channel():
    q = TrampolineQueue()
    SEEN.clear()
    with ActorPool(1) as pool:
        futs = pool.execute_all(time.sleep, 0.3)
        q.put((0, functools.partial(_record, "mid")))
        process_results(futs, q, deadline_s=WAIT, channel=pool.channel)
    assert [item for item, _ in SEEN] == ["mid"]


def _allreduce(rank):
    import torch
    import torch.distributed as dist
    t = torch.arange(4.0) + rank
    dist.all_reduce(t)
    return dist.get_backend(), dist.get_world_size(), t.tolist(), os.getpid()


def test_two_rank_gloo_allreduce_and_world_reuse():
    """A 2-rank gloo world sums across the processes, and a second run
    reuses the same processes and group."""
    with DistributedWorld(2, devices=["cpu", "cpu"], timeout_s=WAIT) as w:
        first = w.run(_allreduce, deadline_s=WAIT)
        second = w.run(_allreduce, deadline_s=WAIT)
        procs = [wk._proc for wk in w.pool.workers]
    want = [1.0, 3.0, 5.0, 7.0]
    assert [r[:3] for r in first] == [("gloo", 2, want)] * 2
    assert [r[3] for r in first] == [r[3] for r in second]
    assert not any(p.is_alive() for p in procs)
    assert launch_distributed(_allreduce, 2, devices=["cpu", "cpu"],
                              deadline_s=WAIT)[0][2] == want


def _die(rank):
    if rank == 1:
        os._exit(3)
    import torch
    import torch.distributed as dist
    dist.all_reduce(torch.ones(1))  # rank 0 waits on the dead rank
    return rank


def test_dead_rank_fails_the_run_fast():
    """A rank that dies fails the run typed at once (not at the collective
    timeout) and the world kills its other ranks.  Whichever is seen
    first fails the run: the dead rank's pipe closing, or its peer's
    collective losing the connection."""
    w = DistributedWorld(2, devices=["cpu", "cpu"], timeout_s=WAIT)
    procs = [wk._proc for wk in w.pool.workers]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError,
                       match="worker 1 died|by peer"):
        w.run(_die, deadline_s=WAIT)
    assert time.monotonic() - t0 < 20
    assert not w.alive()
    assert not any(p.is_alive() for p in procs)


def test_a_rank_without_its_card_fails_typed():
    """A CUDA rank on a machine without a card raises in the rendezvous;
    it never moves to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RemoteError, match="no CUDA device"):
        DistributedWorld(1, devices=["cuda:0"], timeout_s=WAIT)
