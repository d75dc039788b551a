"""The runtime pieces under the port's MPMD runner: ``Worker.restart`` /
``ActorPool.restart_all`` (same rank and env, the old futures failed,
the dead processes' shm segments unlinked),
the call-site deref of top-level ObjectRef arguments, the flight
recorder's rank-keyed spill read back by ``Worker.telemetry_tail``, the
run report's error block and ``NumericAnomaly.for_trip(stage=)``, each
against the JAX package's behaviour where it has one."""

import json
import os
import time

import numpy as np
import pytest

from ray_lightning_accelerators_tpu.runtime.guardian import (
    NumericAnomaly as JaxNumericAnomaly)
from ray_lightning_accelerators_tpu_torch.parallel.mpmd.driver import (
    PipelineStageFailed)
from ray_lightning_accelerators_tpu_torch.runtime import object_store
from ray_lightning_accelerators_tpu_torch.runtime.actors import ActorPool
from ray_lightning_accelerators_tpu_torch.runtime.guardian import (
    NumericAnomaly)
from ray_lightning_accelerators_tpu_torch.telemetry import recorder
from ray_lightning_accelerators_tpu_torch.telemetry import registry

pytestmark = pytest.mark.pipeline_mpmd


def test_restart_all_keeps_rank_and_env_and_fails_old_futures():
    """``restart_all`` respawns each worker with its rank and env and
    fails what the old processes owed.  A worker ended by ``os._exit``
    (rank 0) or by the restart's signal (rank 1, hung) skips its store's
    exit handler: the segments each still owned are unlinked, the new
    processes' own stay live, and ``kill`` unlinks those."""
    big = np.zeros(64 * 1024, dtype=np.float32)  # past the inline bound
    with ActorPool(2, env_per_worker=[{"RLA_T": "a"},
                                      {"RLA_T": "b"}]) as pool:
        for f in pool.execute_all(object_store.put, big):
            f.result(timeout=60)
        pids = [w.pid for w in pool.workers]
        assert all(object_store.segments_of(pid) for pid in pids)
        with pytest.raises(RuntimeError, match="worker 0 died"):
            pool.workers[0].execute(os._exit, 17).result(timeout=60)
        hung = pool.workers[1].execute(time.sleep, 60)
        assert pool.restart_all() == [0, 1]
        with pytest.raises(RuntimeError, match="worker 1 died"):
            hung.result(timeout=30)
        assert [object_store.segments_of(pid) for pid in pids] == [[], []]
        new = [f.result(timeout=60) for f in pool.execute_all(os.getpid)]
        assert all(a != b for a, b in zip(pids, new))
        envs = [f.result(timeout=60)
                for f in pool.execute_all(os.getenv, "RLA_T")]
        assert envs == ["a", "b"]
        assert pool.health_check() == [True, True]
        for f in pool.execute_all(object_store.put, big):
            f.result(timeout=60)
        assert all(object_store.segments_of(pid) for pid in new)
        pool.kill()
        assert [object_store.segments_of(pid) for pid in new] == [[], []]


def test_top_level_object_refs_resolve_at_the_call_site():
    arr = np.arange(64 * 1024, dtype=np.float32)
    ref = object_store.put(arr)
    try:
        with ActorPool(1) as pool:
            got = pool.workers[0].execute(np.sum, ref).result(timeout=60)
            # a nested ref is the callee's business, as in Ray
            kept = pool.workers[0].execute(type, [ref]).result(timeout=60)
    finally:
        object_store.global_store().delete(ref)
    assert got == pytest.approx(float(arr.sum()))
    assert kept is list


def test_worker_spill_is_rank_keyed_and_read_after_death(tmp_path):
    # every emit spills (the dispatch events bracket the emitted tick)
    env = {recorder.DIR_ENV: str(tmp_path), recorder.TRACE_ENV: "abc123",
           recorder.SPILL_S_ENV: "0"}
    with ActorPool(2, env_per_worker=[env, env]) as pool:
        for f in pool.execute_all(recorder.emit, "pipeline_tick"):
            f.result(timeout=60)
        pool.workers[1].kill()
        tails = registry.gather_worker_tails(pool.workers)
    assert sorted(os.listdir(tmp_path)) == ["rank0.events.json",
                                            "rank1.events.json"]
    assert sorted(tails) == ["0", "1"]
    for rank, snap in tails.items():
        assert snap["rank"] == int(rank) and snap["trace_id"] == "abc123"
        assert [e["kind"] for e in snap["events"]] == [
            "dispatch_begin", "pipeline_tick", "dispatch_end"]
        assert recorder.tail_events(snap, 1)[0]["trace"] == "abc123"


def test_run_report_error_block(tmp_path):
    err = PipelineStageFailed("stage 1 exhausted its failure budget",
                              stage=1, rank=1, budget_used=[0, 2])
    path = registry.write_run_report(str(tmp_path), error=err,
                                     trace_id="t1",
                                     rank_events={"0": [{"kind": "x"}]},
                                     extra={"pipeline": {"replays": 1}})
    report = json.load(open(path))
    assert os.path.basename(path) == "run_report.json"
    assert report["trace_id"] == "t1"
    assert report["error"] == {
        "type": "PipelineStageFailed",
        "message": "stage 1 exhausted its failure budget", "rank": 1,
        "diagnosis": {"stage": 1, "rank": 1, "budget_used": [0, 2]}}
    assert report["ranks"]["0"] == {"events": [{"kind": "x"}]}
    assert "driver" in report["ranks"]
    assert report["extra"] == {"pipeline": {"replays": 1}}


def test_numeric_anomaly_names_its_stage_as_the_jax_package():
    kw = dict(step=3, blame="unknown", flags={"loss_nonfinite": True},
              stage=1, detail="loss=nan grad_norm=1.0")
    ours = NumericAnomaly.for_trip(**kw)
    theirs = JaxNumericAnomaly.for_trip(**kw)
    assert str(ours) == str(theirs)
    assert ours.diagnosis == theirs.diagnosis
    assert ours.stage == 1 and ours.diagnosis["stage"] == 1
