"""The PyTorch port's replica tier (serve/replicas.py): ``ServeReplicas``
over 2 replicas forked from the port's forkserver, each building its
engine on the CPU (the kernels' plain versions) from the JAX package's
weights (a numpy tree, carried by ``utils/weights.py params_from_jax``
in the worker: ``tests/torch_boring.py jax_weights_engine``).

Every response is held to the JAX package's greedy ``GPT.generate()`` on
the same weights, token for token (f32 on both sides, exact), through
the JAX tests' faults: a wedged replica requeued
(tests/test_serve.py:173), a killed replica revived by the breaker with
its portfile republished (tests/test_serve_resilience.py:479), brownout
at the watermark (:542), the acceptance loop of a crash, a hang, a
scale-up and a drain (:583, fewer waves), the prefill/decode lanes with
their handoffs released and a decode crash during a handoff
(tests/test_prefix_affinity.py:339, :444), and long prompts through a
crash (tests/test_long_context_serve.py:310).  ``scripts/rla_top.py``
(stdlib only) renders the tier from the port's ``/statusz``
(test_serve_resilience.py:425, test_prefix_affinity.py:584).

Config: the JAX tests' ``_REPLICA_CFG`` (2 layers, d 32, vocab 61).
Workers cap their torch threads at 2; every future and join is bounded."""

import functools
import importlib.util
import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

import jax

from ray_lightning_accelerators_tpu.models.transformer import (
    GPT as JaxGPT, TransformerConfig as JaxConfig)
from ray_lightning_accelerators_tpu_torch.runtime import object_store
from ray_lightning_accelerators_tpu_torch.serve import (BrownoutShed,
                                                        ControllerConfig,
                                                        QueueFull,
                                                        ServeReplicas,
                                                        SloPolicy)
from ray_lightning_accelerators_tpu_torch.serve.controller import (
    LANE_DECODE, LANE_PREFILL)
from ray_lightning_accelerators_tpu_torch.telemetry import live
from ray_lightning_accelerators_tpu_torch.telemetry import recorder

from . import torch_boring

pytestmark = [pytest.mark.serve, pytest.mark.serve_resilience]

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 120

# tests/test_serve_resilience.py:449
_REPLICA_CFG = dict(vocab_size=61, d_model=32, n_heads=2, d_ff=64,
                    n_layers=2, max_seq_len=48)
# tests/test_long_context_serve.py:284
_CHAOS_CFG = dict(_REPLICA_CFG, max_seq_len=128)


@pytest.fixture(autouse=True)
def _fresh_live_plane():
    for mod in (live, recorder):
        mod._reset_for_tests()
    yield
    for mod in (live, recorder):
        mod._reset_for_tests()


@functools.lru_cache(maxsize=None)
def _weights(max_seq_len=48, seed=0):
    model = JaxGPT(JaxConfig(**dict(_REPLICA_CFG, max_seq_len=max_seq_len)))
    params = model.init_params(jax.random.PRNGKey(seed))
    return model, params, jax.device_get(params)


def _ref(model, params, prompt, max_new):
    return np.asarray(model.generate(
        params, np.asarray(prompt, np.int32)[None, :],
        max_new_tokens=max_new))[0]


def _factory(cfg, np_params, **engine):
    """The replicas' engine factory: a partial of a module-level function
    (it pickles by name with the standard pickle)."""
    return functools.partial(torch_boring.jax_weights_engine, cfg,
                             np_params, **dict(dict(max_slots=4,
                                                    queue_depth=64),
                                               **engine))


def _wait(pred, timeout=WAIT, every=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(every)
    return pred()


def _rla_top():
    spec = importlib.util.spec_from_file_location(
        "rla_top", os.path.join(_ROOT, "scripts", "rla_top.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read().decode()


def _pids(group):
    """The replicas' pids (a scale-up spawning right now has none yet)."""
    return {w.rank: w.pid for w in list(group.pool.workers)
            if w.pid is not None}


def _no_segments(pids):
    """No shm segment of any of these (ended) replica processes is left."""
    return all(object_store.segments_of(p) == [] for p in pids)


def test_closure_factory_is_refused_by_name():
    def make():
        return None
    with pytest.raises(TypeError, match="engine_factory.*module-level"):
        ServeReplicas(make, num_replicas=1)
    with pytest.raises(TypeError, match="engine_factory"):
        ServeReplicas(lambda: None, num_replicas=1)


def test_mixed_wave_token_identical_on_the_live_plane(tmp_path,
                                                      monkeypatch):
    """2 replicas answer a mixed wave (prompts sharing a 16-token prefix
    among them) token-identical to JAX ``generate()``; with
    ``RLA_TPU_METRICS_PORT`` set the tier is ``replicas<N>`` on the
    driver's /metrics and its controller on /statusz, which rla_top
    renders; ``shutdown`` takes both off.  The replicas were forked
    without CUDA initialised."""
    monkeypatch.setenv("RLA_TPU_METRICS_PORT", "0")
    model, params, np_params = _weights()
    rng = np.random.default_rng(7)
    system = rng.integers(0, 61, 16).astype(np.int32)
    pairs = []
    for i in range(8):
        # two prompt lengths a side: few shapes for the JAX reference
        tail = rng.integers(0, 61, 4 + 4 * (i % 4 // 2)).astype(np.int32)
        p = np.concatenate([system, tail]) if i % 2 == 0 else tail
        pairs.append((p, 4))
    refs = [_ref(model, params, p, k) for p, k in pairs]
    group = ServeReplicas(_factory(_REPLICA_CFG, np_params), num_replicas=2,
                          chunk_size=2)
    try:
        cuda = [f.result(timeout=WAIT) for f in group.pool.execute_all(
            torch_boring.cuda_initialized)]
        assert cuda == [False, False]
        # the first prefix-sharing prompt alone, so the rest find its
        # prefix resident on an idle replica
        np.testing.assert_array_equal(
            group.submit(*pairs[0]).result(timeout=WAIT), refs[0])
        handles = [group.submit(p, k) for p, k in pairs[1:]]
        for ref, h in zip(refs[1:], handles):
            np.testing.assert_array_equal(h.result(timeout=WAIT), ref)
        srv = live.get_server()
        label = group._live_label
        assert label.startswith("replicas")
        status = json.loads(_get(srv.url + "/statusz"))
        text = _get(srv.url + "/metrics")
        rc = status["replica_controller"]
        assert set(rc["replicas"]) == {"0", "1"}
        assert sum(r["completed_chunks"] for r in rc["replicas"].values()) \
            >= 4
        assert f'rla_tpu_serve_completed_total{{rank="{label}"}} 8' in text
        assert "rla_tpu_serve_replica_count 2" in text
        out = _rla_top().render(status)
        assert "serve tier: queue 0/256" in out
        assert "lane" in out and "pfx-hit" in out
        assert "affinity ring: vnodes 32" in out
        rows = {ln.split()[0]: ln for ln in out.splitlines()
                if ln[:2] in ("0 ", "1 ")}
        assert set(rows) == {"0", "1"}
        assert all("ok" in r and "decode" in r for r in rows.values())
        snap = group.stats()
        assert snap["submitted"] == snap["completed"] == 8
        assert snap["failed"] == snap["cancelled"] == 0
        # routes that found the shared prefix resident (the replica
        # holding it may be at its in-flight cap for later ones)
        assert snap["prefix_route_hits"] >= 1
        assert snap["lane_decode_replicas"] == 2.0
        assert all(r["compile_count"] == 0
                   for r in snap["controller"]["replicas"].values())
        st0 = group.replica_stats(0)
        assert st0["completed"] + group.replica_stats(1)["completed"] == 8
    finally:
        group.shutdown()
    status = json.loads(_get(srv.url + "/statusz"))
    assert "replica_controller" not in status
    assert label not in status.get("serve_engines", [])


@pytest.mark.chaos
def test_wedged_replica_requeues_inflight_no_loss_no_dup():
    """tests/test_serve.py:173: a hang in replica rank 1's first serve
    chunk (worker dispatch 2) freezes its heartbeat; the watchdog reaps
    it, its requests re-queue and complete on replica 0, each exactly
    once and token-identical."""
    model, params, np_params = _weights(32)
    cfg = dict(_REPLICA_CFG, max_seq_len=32)
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, 61, int(rng.integers(3, 7))).astype(np.int32),
             int(rng.integers(3, 6))) for _ in range(6)]
    refs = [_ref(model, params, p, n) for p, n in reqs]
    hb = {"RLA_TPU_WORKER_HEARTBEAT_S": "0.1"}
    envs = [dict(hb), dict(hb, RLA_TPU_CHAOS="hang@rank1:step2")]
    group = ServeReplicas(_factory(cfg, np_params, queue_depth=32),
                          num_replicas=2, chunk_size=2, wedge_timeout_s=1.5,
                          env_per_worker=envs,
                          controller=ControllerConfig(hedge=False))
    try:
        resps = [group.submit(p, n) for p, n in reqs]
        outs = [r.result(timeout=180) for r in resps]
        snap = group.stats()
    finally:
        group.shutdown()
    for out, ref in zip(outs, refs):
        np.testing.assert_array_equal(out, ref)
    assert snap["submitted"] == 6 and snap["completed"] == 6
    assert snap["failed"] == 0
    assert snap["requeued"] >= 1 and snap["wedge_events"] >= 1
    assert 1 in snap["replicas_down"]


def test_auto_revive_republishes_portfile_and_heartbeat(tmp_path):
    """tests/test_serve_resilience.py:479: a killed replica's circuit
    opens at routing, the breaker restarts it, and the revived generation
    republishes its portfile (new pid) and heartbeat and serves the
    queued request."""
    model, params, np_params = _weights()
    tdir = str(tmp_path / "telemetry")
    env = {"RLA_TPU_WORKER_HEARTBEAT_S": "0.1",
           "RLA_TPU_TELEMETRY_DIR": tdir, "RLA_TPU_METRICS_PORT": "0"}
    group = ServeReplicas(
        _factory(_REPLICA_CFG, np_params), num_replicas=1, chunk_size=2,
        env_per_worker=[env],
        controller=ControllerConfig(revive_backoff_s=0.1,
                                    revive_backoff_cap_s=0.5, poll_s=0.05))
    try:
        out = group.submit(np.asarray([1, 2, 3], np.int32), 3)
        np.testing.assert_array_equal(out.result(timeout=WAIT),
                                      _ref(model, params, [1, 2, 3], 3))
        portfile = os.path.join(tdir, "rank0.port.json")
        assert _wait(lambda: os.path.exists(portfile), 30)
        with open(portfile) as f:
            pid_before = json.load(f)["pid"]
        w = group._worker(0)
        w.kill()
        assert not w.is_alive
        resp = group.submit(np.asarray([4, 5], np.int32), 3)
        np.testing.assert_array_equal(resp.result(timeout=WAIT),
                                      _ref(model, params, [4, 5], 3))
        snap = group.stats()
        assert snap["revived"] >= 1
        assert snap["controller"]["replicas"]["0"]["revivals"] >= 1
        assert _wait(lambda: json.load(open(portfile))["pid"] != pid_before,
                     30)
        rec = json.load(open(portfile))
        assert rec["pid"] == w.pid and rec["port"]
        live_snap = live.scrape_rank(0, env=env)
        assert live_snap and live_snap["rank"] == "0"
        beat = w.heartbeat.snapshot()
        assert beat["started"] and beat["beat_age_s"] < 5.0
    finally:
        group.shutdown()


@pytest.mark.chaos
def test_brownout_sheds_typed_at_watermark():
    """tests/test_serve_resilience.py:542: a replica slowed by chaos and
    no scale-up headroom: the tier sheds typed ``BrownoutShed`` at the
    watermark instead of queueing to the hard cap."""
    _, _, np_params = _weights()
    env = {"RLA_TPU_WORKER_HEARTBEAT_S": "0.2",
           "RLA_TPU_CHAOS": "slow@replica0:2.0"}
    group = ServeReplicas(
        _factory(_REPLICA_CFG, np_params), num_replicas=1, chunk_size=1,
        queue_depth=4, env_per_worker=[env],
        controller=ControllerConfig(brownout_frac=0.5, hedge=False,
                                    poll_s=0.05))
    try:
        shed = None
        for i in range(12):
            try:
                group.submit(np.asarray([1 + i % 7], np.int32), 2)
            except BrownoutShed as e:
                shed = e
                break
            time.sleep(0.02)
        assert shed is not None, "tier never shed at the watermark"
        assert isinstance(shed, QueueFull)
        assert shed.watermark == 2 and shed.depth >= 2
        snap = group.metrics.snapshot()
        assert snap["brownout_shed"] >= 1 and snap["rejected"] >= 1
    finally:
        group.shutdown()
    # everything admitted is accounted for: served or cancelled typed
    snap = group.metrics.snapshot()
    assert snap["completed"] + snap["cancelled"] + snap["failed"] == \
        snap["submitted"]


def _compile_counts(group):
    rows = group.stats()["controller"]["replicas"]
    return {r: row["compile_count"] for r, row in rows.items()
            if row["compile_count"] is not None}


@pytest.mark.chaos
def test_acceptance_chaos_kill_hang_scale_and_drain(tmp_path):
    """tests/test_serve_resilience.py:583 at fewer waves: crash@replica0
    and hang@replica1 (once each) under mixed load; every request is
    answered exactly once and token-identical, both replicas revive
    through the breaker, the forced SLO burn (a 0.1 ms TTFT target)
    scales the tier up, and it drains back once idle; compile counts stay
    flat (0: the port builds nothing on the CPU)."""
    model, params, np_params = _weights()
    ns = str(tmp_path / "chaos-ns")
    hb = {"RLA_TPU_WORKER_HEARTBEAT_S": "0.1", "RLA_TPU_SLO_WINDOW_S": "3"}
    envs = [dict(hb, RLA_TPU_CHAOS="crash@replica0:chunk2:once",
                 RLA_TPU_CHAOS_NS=ns),
            dict(hb, RLA_TPU_CHAOS="hang@replica1:chunk2:once",
                 RLA_TPU_CHAOS_NS=ns)]
    cfg = ControllerConfig(
        max_retries=4, retry_backoff_s=0.01, retry_backoff_cap_s=0.1,
        revive_backoff_s=0.2, revive_backoff_cap_s=1.0,
        max_replicas=3, min_replicas=2, scale_up_burn=1.0,
        occupancy_high=0.95, scale_sustain_s=0.4, idle_sustain_s=3.0,
        burn_stale_s=2.0, hedge_age_s=5.0, poll_s=0.05)
    rng = np.random.default_rng(11)
    refs = {}

    def drive_checked(n):
        pairs = [(rng.integers(0, 61, int(rng.choice([4, 8, 12])))
                  .astype(np.int32), int(rng.choice([3, 4])))
                 for _ in range(n)]
        want = [_ref(model, params, p, k) for p, k in pairs]
        handles = [group.submit(p, k) for p, k in pairs]
        for ref, h in zip(want, handles):
            np.testing.assert_array_equal(h.result(timeout=WAIT), ref)

    stop_feed = threading.Event()
    group = ServeReplicas(
        _factory(_REPLICA_CFG, np_params,
                 slo=SloPolicy(ttft_target_s=1e-4)),
        num_replicas=2, chunk_size=2, heartbeat_s=0.1, wedge_timeout_s=1.2,
        queue_depth=64, env_per_worker=envs, controller=cfg,
        scale_env=dict(hb))
    pids = set(_pids(group).values())
    feed_thread = None
    try:
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            drive_checked(4)
            pids |= set(_pids(group).values())
            if group.metrics.snapshot()["revived"] >= 2:
                break
        snap = group.stats()
        rows = snap["controller"]["replicas"]
        assert snap["revived"] >= 2, snap["controller"]
        assert snap["wedge_events"] >= 1 and snap["requeued"] >= 1
        assert rows["0"]["infra_failures"] >= 1
        assert rows["1"]["infra_failures"] >= 1
        assert rows["0"]["revivals"] >= 1 and rows["1"]["revivals"] >= 1

        feed_p = rng.integers(0, 61, 8).astype(np.int32)
        refs["feed"] = _ref(model, params, feed_p, 3)
        feed_handles = []

        def feeder():
            while not stop_feed.is_set():
                try:
                    feed_handles.append(group.submit(feed_p, 3))
                except QueueFull:
                    pass
                except Exception:
                    return
                time.sleep(0.15)

        feed_thread = threading.Thread(target=feeder, daemon=True)
        feed_thread.start()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline \
                and group.metrics.snapshot()["scale_ups"] < 1:
            drive_checked(6)
        assert group.metrics.snapshot()["scale_ups"] >= 1, \
            group.stats()["controller"]
        assert len(group.pool) == 3
        assert group.stats()["controller"]["max_burn"] >= 1.0
        # warm until every replica's count is in and flat (an idle gap
        # under load can drain the scaled replica and a wave grow it
        # back), then pin one more wave at no new build
        prev, stable = None, False
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            drive_checked(6)
            pids |= set(_pids(group).values())
            counts = _compile_counts(group)
            if prev is not None and counts == prev and len(counts) == 3:
                stable = True
                break
            prev = counts
        assert stable, f"compile counts never settled: {prev}"
        drive_checked(6)
        assert _compile_counts(group) == prev
        assert set(prev.values()) == {0}

        stop_feed.set()
        feed_thread.join(timeout=10)
        for h in feed_handles:
            np.testing.assert_array_equal(h.result(timeout=WAIT),
                                          refs["feed"])
        assert _wait(lambda: len(group.pool) == 2, 60), \
            group.stats()["controller"]
        snap = group.stats()
        assert snap["scale_downs"] >= 1
        assert sorted(w.rank for w in group.pool.workers) == [0, 1]
        assert snap["failed"] == 0 and snap["cancelled"] == 0
        assert snap["completed"] == snap["submitted"]
    finally:
        stop_feed.set()
        if feed_thread is not None:
            feed_thread.join(timeout=10)
        group.shutdown()
    assert _no_segments(pids)


def _lane_group(np_params, envs, **cfg):
    return ServeReplicas(
        _factory(_REPLICA_CFG, np_params, block_len=8, slo=None),
        num_replicas=2, chunk_size=2, heartbeat_s=0.1, wedge_timeout_s=1.2,
        queue_depth=64, env_per_worker=envs, affinity_block_len=8,
        controller=ControllerConfig(
            hedge=False, prefill_replicas=1, handoff_min_blocks=1,
            max_retries=4, retry_backoff_s=0.01, retry_backoff_cap_s=0.1,
            revive_backoff_s=0.2, revive_backoff_cap_s=1.0, poll_s=0.05,
            **cfg))


def test_lanes_handoff_token_identity_release_and_rla_top(monkeypatch):
    """tests/test_prefix_affinity.py:339 over the tier: with one prefill
    and one decode replica every request prefills on the prefill lane and
    decodes from its handed-off KV blocks, token-identical; the prefill
    replica's export holds are all released (its pool drains to 0) and
    rla_top renders the lane and prefix columns from /statusz
    (test_prefix_affinity.py:584)."""
    monkeypatch.setenv("RLA_TPU_METRICS_PORT", "0")
    model, params, np_params = _weights()
    rng = np.random.default_rng(5)
    system = rng.integers(1, 60, 16).astype(np.int32)
    pairs = [(np.concatenate([system, rng.integers(
        1, 60, int(rng.integers(1, 9))).astype(np.int32)]),
        int(rng.integers(3, 6))) for _ in range(6)]
    refs = [_ref(model, params, p, m) for p, m in pairs]
    hb = {"RLA_TPU_WORKER_HEARTBEAT_S": "0.1"}
    group = _lane_group(np_params, [dict(hb), dict(hb)])
    pids = set(_pids(group).values())
    try:
        handles = [group.submit(p, m) for p, m in pairs]
        for ref, h in zip(refs, handles):
            np.testing.assert_array_equal(h.result(timeout=WAIT), ref)
        snap = group.stats()
        assert snap["kv_handoffs"] == len(pairs)
        assert snap["kv_handoff_bytes"] > 0
        assert snap["prefix_route_hits"] >= 1
        assert snap["completed"] == snap["submitted"] == len(pairs)
        rows = snap["controller"]["replicas"]
        assert rows["0"]["lane"] == LANE_PREFILL
        assert rows["1"]["lane"] == LANE_DECODE
        # every export hold released: both pools drain (a prefill the
        # full prefill replica could not take spills to the decode one)
        assert _wait(lambda: all(group.replica_stats(r)["block_pool_used"]
                                 == 0 for r in (0, 1)), 30)
        assert sum(group.replica_stats(r)["kv_handoffs"]
                   for r in (0, 1)) == len(pairs)
        status = json.loads(_get(live.get_server().url + "/statusz"))
        out = _rla_top().render(status)
        assert "lane" in out and "pfx-hit" in out
        lines = out.splitlines()
        assert "prefill" in next(ln for ln in lines if ln.startswith("0 "))
        assert "decode" in next(ln for ln in lines if ln.startswith("1 "))
    finally:
        group.shutdown()
    assert _no_segments(pids)


@pytest.mark.chaos
def test_lanes_survive_decode_crash_during_handoff(tmp_path):
    """tests/test_prefix_affinity.py:444: the decode replica crashes on
    its first chunk, a KV import in flight; the stranded requests requeue
    and re-prefill (no loss, no duplicate), the breaker revives it, every
    response stays token-identical, and no shm segment is left."""
    model, params, np_params = _weights()
    ns = str(tmp_path / "chaos-ns")
    hb = {"RLA_TPU_WORKER_HEARTBEAT_S": "0.1"}
    envs = [dict(hb), dict(hb, RLA_TPU_CHAOS="crash@replica1:chunk1:once",
                           RLA_TPU_CHAOS_NS=ns)]
    rng = np.random.default_rng(13)
    group = _lane_group(np_params, envs)
    pids = set(_pids(group).values())
    try:
        deadline = time.monotonic() + 90
        healed = False
        while time.monotonic() < deadline:
            pairs = [(rng.integers(1, 60, int(s)).astype(np.int32), int(m))
                     for s, m in zip(rng.integers(16, 25, 4),
                                     rng.integers(3, 6, 4))]
            refs = [_ref(model, params, p, m) for p, m in pairs]
            handles = [group.submit(p, m) for p, m in pairs]
            for ref, h in zip(refs, handles):
                np.testing.assert_array_equal(h.result(timeout=WAIT), ref)
            pids |= set(_pids(group).values())
            snap = group.metrics.snapshot()
            if snap["requeued"] >= 1 and snap["revived"] >= 1:
                healed = True
                break
        assert healed, group.stats()["controller"]
        snap = group.stats()
        rows = snap["controller"]["replicas"]
        assert rows["1"]["infra_failures"] >= 1
        assert rows["0"]["lane"] == LANE_PREFILL
        assert rows["1"]["lane"] == LANE_DECODE
        assert snap["kv_handoffs"] >= 1 and snap["kv_handoff_bytes"] > 0
        assert snap["failed"] == 0 and snap["cancelled"] == 0
        assert snap["completed"] == snap["submitted"]
    finally:
        group.shutdown()
    assert _no_segments(pids)


@pytest.mark.chaos
def test_tier_survives_replica_crash_with_long_prompts(tmp_path):
    """tests/test_long_context_serve.py:310: every prompt streams in
    chunks (70-100 tokens, block 8); replica 1 crashes once on its first
    chunk, the stranded streaming prefills requeue and re-prefill exactly
    once on the survivor, token-identical."""
    model, params, np_params = _weights(128)
    ns = str(tmp_path / "chaos-ns")
    hb = {"RLA_TPU_WORKER_HEARTBEAT_S": "0.1"}
    envs = [dict(hb), dict(hb, RLA_TPU_CHAOS="crash@replica1:chunk1:once",
                           RLA_TPU_CHAOS_NS=ns)]
    cfg = ControllerConfig(hedge=False, max_retries=4, retry_backoff_s=0.01,
                           retry_backoff_cap_s=0.1, revive_backoff_s=0.2,
                           revive_backoff_cap_s=1.0, poll_s=0.05)
    rng = np.random.default_rng(31)
    group = ServeReplicas(
        _factory(_CHAOS_CFG, np_params, block_len=8, slo=None),
        num_replicas=2, chunk_size=2, heartbeat_s=0.1, wedge_timeout_s=1.2,
        queue_depth=64, env_per_worker=envs, controller=cfg)
    try:
        deadline = time.monotonic() + 90
        healed = False
        while time.monotonic() < deadline:
            pairs = [(rng.integers(1, 60, int(s)).astype(np.int32), int(m))
                     for s, m in zip(rng.integers(70, 101, 4),
                                     rng.integers(3, 6, 4))]
            refs = [_ref(model, params, p, m) for p, m in pairs]
            handles = [group.submit(p, m) for p, m in pairs]
            for ref, h in zip(refs, handles):
                np.testing.assert_array_equal(h.result(timeout=WAIT), ref)
            if group.metrics.snapshot()["requeued"] >= 1:
                healed = True
                break
        assert healed, group.stats()["controller"]
        snap = group.stats()
        assert snap["controller"]["replicas"]["1"]["infra_failures"] >= 1
        assert snap["failed"] == 0 and snap["cancelled"] == 0
        assert snap["completed"] == snap["submitted"]
    finally:
        group.shutdown()
