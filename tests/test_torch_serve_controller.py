"""The PyTorch port's serve-tier controller (serve/controller.py), its
admission requeue lane (serve/batcher.py) and the tier's metrics
(serve/metrics.py), held in lock-step with the JAX package's.

Each test runs one scenario of the JAX package's own tests
(tests/test_serve_resilience.py, tests/test_prefix_affinity.py,
tests/test_analysis.py) twice: over the JAX package's classes and over
the port's, on the same fake replica group (the JAX tests' ``_FakeGroup``,
copied here), with injected ``now=`` clocks and ``random`` seeded alike
before each run (the backoff's half-jitter draws from it).  The scenario
keeps the JAX test's own assertions and records what it observed --
routes, states, snapshots (the ``open_for_s`` countdown, a time.monotonic
reading, excluded), ``lane_gauges``, ``should_shed`` tuples, hedge and
revive counts, ring owners, Prometheus families -- and the two records
must be equal exactly.  No processes, no device."""

import json
import os
import random
import time

import numpy as np
import pytest

import ray_lightning_accelerators_tpu.serve.batcher as jax_batcher
import ray_lightning_accelerators_tpu.serve.controller as jax_controller
import ray_lightning_accelerators_tpu.serve.metrics as jax_metrics
import ray_lightning_accelerators_tpu_torch.serve.batcher as port_batcher
import ray_lightning_accelerators_tpu_torch.serve.controller as \
    port_controller
import ray_lightning_accelerators_tpu_torch.serve.metrics as port_metrics
from ray_lightning_accelerators_tpu.telemetry import live as jax_live
from ray_lightning_accelerators_tpu.telemetry import registry as jax_registry
from ray_lightning_accelerators_tpu_torch.telemetry import live as port_live
from ray_lightning_accelerators_tpu_torch.telemetry import (
    registry as port_registry)

from .utils import assert_prometheus_exposition

pytestmark = [pytest.mark.serve]


class _NS:
    """One package's serve classes, under the names the scenarios use."""

    def __init__(self, batcher, controller, metrics, live, registry):
        self.batcher, self.controller = batcher, controller
        self.ServeMetrics = metrics.ServeMetrics
        self.ReplicaController = controller.ReplicaController
        self.ControllerConfig = controller.ControllerConfig
        self.PrefixAffinityRing = controller.PrefixAffinityRing
        self.AdmissionController = batcher.AdmissionController
        self.live, self.registry = live, registry


JAX = _NS(jax_batcher, jax_controller, jax_metrics, jax_live, jax_registry)
PORT = _NS(port_batcher, port_controller, port_metrics, port_live,
           port_registry)


def _both(scenario, seed=0):
    """Run ``scenario`` over both packages (``random`` seeded alike) and
    hold the port's record to the JAX package's."""
    out = {}
    for name, ns in (("jax", JAX), ("port", PORT)):
        random.seed(seed)
        out[name] = scenario(ns)
    assert out["port"] == out["jax"]
    return out["port"]


# --------------------------------------------------------------------- #
# The fake replica group (tests/test_serve_resilience.py:150-205)        #
# --------------------------------------------------------------------- #
class _FakeWorker:
    def __init__(self, rank, alive=True):
        self.rank = rank
        self.is_alive = alive


class _FakePool:
    def __init__(self, n):
        self.workers = [_FakeWorker(r) for r in range(n)]


class _FakeBatcher:
    def __init__(self):
        self.depth = 0


class _FakeGroup:
    queue_depth = 16

    def __init__(self, ns, n=3):
        self.pool = _FakePool(n)
        self.batcher = _FakeBatcher()
        self.metrics = ns.ServeMetrics()
        self.watchdog = None
        self.dispatched = []
        self.revive_results = []  # None = ok, exc = raise
        self.revived = []
        self.retired = []

    def _worker(self, rank):
        for w in self.pool.workers:
            if w.rank == rank:
                return w
        return None

    def _dispatch(self, rank, chunk, hedge_of=None):
        self.dispatched.append((rank, list(chunk), hedge_of))

    def _revive_replica(self, rank):
        outcome = (self.revive_results.pop(0)
                   if self.revive_results else None)
        if outcome is not None:
            raise outcome
        self.revived.append(rank)
        return {}

    def _add_replica(self):
        rank = max(w.rank for w in self.pool.workers) + 1
        self.pool.workers.append(_FakeWorker(rank))
        return rank

    def _retire_replica(self, rank):
        self.retired.append(rank)
        self.pool.workers = [w for w in self.pool.workers
                             if w.rank != rank]


def _fake_item(ns):
    req = ns.batcher.ServeRequest(0, np.asarray([1], np.int32), 2,
                                  time.monotonic())
    return req, ns.batcher.ServeResponse(req)


def _snap(ctrl):
    """The controller snapshot without its clock readings."""
    snap = ctrl.snapshot()
    for row in snap["replicas"].values():
        row.pop("open_for_s")
    return snap


def _counters(metrics):
    snap = metrics.snapshot()
    return {k: snap[k] for k in metrics._COUNTERS}


def _keys(ns, n, block_len):
    return ns.batcher.chain_prefix_keys(np.arange(n, dtype=np.int32),
                                        block_len)


# --------------------------------------------------------------------- #
# The shared backoff (tests/test_serve_resilience.py:33)                 #
# --------------------------------------------------------------------- #
def test_backoff_shared_with_elastic_and_sequence_pinned():
    from ray_lightning_accelerators_tpu.utils.backoff import (
        backoff_delay_s as jax_backoff)
    from ray_lightning_accelerators_tpu_torch.runtime.elastic import (
        backoff_delay_s as elastic_backoff)
    from ray_lightning_accelerators_tpu_torch.utils.backoff import (
        backoff_delay_s)
    assert elastic_backoff is backoff_delay_s
    assert port_controller.backoff_delay_s is backoff_delay_s
    for args, kw, want in (((1, 2.0), {"rng": lambda: 0.0}, 1.0),
                           ((1, 2.0), {"rng": lambda: 1.0}, 2.0),
                           ((3, 2.0), {"rng": lambda: 1.0}, 8.0),
                           ((10, 2.0), {"cap_s": 6.0, "rng": lambda: 1.0},
                            6.0),
                           ((5, 0.0), {}, 0.0), ((0, 2.0), {}, 0.0)):
        assert backoff_delay_s(*args, **kw) == want == jax_backoff(
            *args, **kw)
    seq = [backoff_delay_s(a, 0.5, cap_s=4.0, rng=lambda: 0.25)
           for a in range(1, 8)]
    assert seq == [jax_backoff(a, 0.5, cap_s=4.0, rng=lambda: 0.25)
                   for a in range(1, 8)]
    assert seq == [0.3125, 0.625, 1.25, 2.5, 2.5, 2.5, 2.5]


# --------------------------------------------------------------------- #
# The requeue lane (tests/test_serve_resilience.py:61, :88)              #
# --------------------------------------------------------------------- #
def test_requeue_lane_orders_before_new_admissions_multi_failure():
    def scenario(ns):
        ctl = ns.AdmissionController(queue_depth=16)
        subs = [ctl.submit(np.asarray([i + 1], np.int32), 2)
                for i in range(5)]
        a, b, c, d = (ctl.pop() for _ in range(4))
        assert a[1] is subs[0] and d[1] is subs[3]
        assert ctl.requeue(*a) and ctl.requeue(*b)
        assert ctl.requeue(*c) and ctl.requeue(*d)
        order = [ctl.pop()[0].request_id for _ in range(5)]
        assert order == [a[0].request_id, b[0].request_id,
                         c[0].request_id, d[0].request_id,
                         subs[4].request.request_id]
        f = ctl.submit(np.asarray([9], np.int32), 2)
        assert ctl.requeue(a[0], a[1])
        again = ctl.pop()[0].request_id
        assert again == a[0].request_id and a[0].requeues == 2
        assert ctl.pop()[1] is f
        # the flow-control put-back keeps FIFO order and counts nothing
        g = ctl.submit(np.asarray([3], np.int32), 2)
        item = ctl.pop()
        ctl.push_front(item)
        assert item[0].requeues == 0 and ctl.pop()[1] is g
        # closed admission refuses a requeue typed
        ctl.shutdown()
        assert ctl.closed
        assert not ctl.requeue(*item)
        with pytest.raises(ns.batcher.ServeCancelled):
            item[1].result(timeout=1)
        return order, again, a[0].requeues, ctl.depth

    _both(scenario)


def test_requeue_backoff_holds_lane_without_losing_position():
    def scenario(ns):
        ctl = ns.AdmissionController(queue_depth=8)
        r1 = ctl.submit(np.asarray([1], np.int32), 2)
        item = ctl.pop()
        r2 = ctl.submit(np.asarray([2], np.int32), 2)
        assert ctl.requeue(item[0], item[1], delay_s=0.15)
        assert item[0].not_before > time.monotonic()
        held = ctl.pop()
        assert held is None and ctl.depth == 2
        deadline = time.monotonic() + 2.0
        got = None
        while got is None and time.monotonic() < deadline:
            got = ctl.pop()
            if got is None:
                time.sleep(0.01)
        assert got is not None and got[1] is r1
        assert ctl.pop()[1] is r2
        return held, got[0].requeues, ctl.depth

    _both(scenario)


# --------------------------------------------------------------------- #
# Controller units (tests/test_serve_resilience.py:209-420)              #
# --------------------------------------------------------------------- #
def test_routing_skips_unhealthy_and_weights_inflight():
    def scenario(ns):
        rec = []
        g = _FakeGroup(ns, 3)
        ctrl = ns.ReplicaController(g, ns.ControllerConfig(
            max_inflight_chunks=2))
        ctrl.on_dispatch(0, [_fake_item(ns), _fake_item(ns)])
        rec.append(ctrl.route())
        assert rec[-1] in (1, 2)
        ctrl.on_dispatch(1, [_fake_item(ns)])
        rec.append(ctrl.route())
        assert rec[-1] == 2
        ctrl._replicas[2].state = ns.controller.STATE_SLOW
        rec.append(ctrl.route())
        assert rec[-1] == 1
        ctrl._replicas[1].state = ns.controller.STATE_OPEN
        ctrl.on_dispatch(0, [_fake_item(ns)])
        rec.append(ctrl.route())
        assert rec[-1] == 2
        ctrl._replicas[2].state = ns.controller.STATE_DRAINING
        rec.append(ctrl.route())
        assert rec[-1] is None
        ctrl._replicas[2].state = ns.controller.STATE_OK
        g._worker(2).is_alive = False
        rec.append(ctrl.route())
        assert rec[-1] is None
        assert ctrl._replicas[2].state == ns.controller.STATE_OPEN
        assert 2 in ctrl.down_ranks()
        rec += [ctrl.states(), ctrl.down_ranks(), _snap(ctrl),
                ctrl.lane_gauges()]
        return rec

    _both(scenario)


def test_circuit_breaker_opens_backs_off_and_half_open_probes():
    def scenario(ns):
        rec = []
        g = _FakeGroup(ns, 2)
        ctrl = ns.ReplicaController(g, ns.ControllerConfig(
            revive_backoff_s=0.2, revive_backoff_cap_s=2.0,
            breaker_window_s=5.0, breaker_failures=2))
        cid = ctrl.on_dispatch(1, [_fake_item(ns)])
        cid2 = ctrl.on_dispatch(1, [_fake_item(ns)])
        ctrl.note_infra_failure(1, cid, RuntimeError("worker died"))
        ctrl.note_infra_failure(1, cid2, RuntimeError("worker died"))
        r = ctrl._replicas[1]
        assert len(r.failures) == 1 and r.inflight_chunks == 0
        assert r.state == ns.controller.STATE_OPEN
        assert r.open_until > time.monotonic()
        rec.append(ctrl.maybe_revive(now=time.monotonic()))
        assert rec[-1] == 0 and not g.revived
        r.open_until = time.monotonic() - 0.01
        rec.append(ctrl.maybe_revive())
        assert rec[-1] == 1 and g.revived == [1]
        assert r.state == ns.controller.STATE_OK and r.revivals == 1
        assert g.metrics.snapshot()["revived"] == 1
        cid = ctrl.on_dispatch(1, [_fake_item(ns)])
        ctrl.note_infra_failure(1, cid, RuntimeError("worker died"))
        assert r.state == ns.controller.STATE_OPEN and len(r.failures) == 2
        assert r.open_until - time.monotonic() >= 0.18
        rec.append(ctrl._reopen_attempt_locked(r))
        g.revive_results = [RuntimeError("still dead")]
        r.open_until = time.monotonic() - 0.01
        rec.append(ctrl.maybe_revive())
        assert rec[-1] == 0
        assert r.state == ns.controller.STATE_OPEN
        assert r.revive_attempts == 1 and r.open_until > time.monotonic()
        rec.append(ctrl._reopen_attempt_locked(r))
        # manual revive outside the breaker
        ctrl.note_revived(1)
        rec += [g.revived, ctrl.states(), _snap(ctrl),
                _counters(g.metrics)]
        return rec

    _both(scenario)


def test_hedge_fires_once_per_chunk_to_healthy_replica():
    def scenario(ns):
        rec = []
        g = _FakeGroup(ns, 2)
        ctrl = ns.ReplicaController(g, ns.ControllerConfig(hedge_age_s=0.05))
        items = [_fake_item(ns), _fake_item(ns)]
        cid = ctrl.on_dispatch(0, items)
        ctrl._replicas[0].state = ns.controller.STATE_SLOW
        ctrl._replicas[0].chunks[cid].t_dispatch -= 1.0
        rec.append(ctrl.maybe_hedge())
        assert rec[-1] == 1 and len(g.dispatched) == 1
        rank, hedged, hedge_of = g.dispatched[0]
        assert rank == 1 and hedge_of == (0, cid)
        assert [id(r) for r, _ in hedged] == [id(r) for r, _ in items]
        assert g.metrics.snapshot()["hedged"] == 1
        assert ctrl._replicas[0].hedges == 1
        rec.append(ctrl.maybe_hedge())
        assert rec[-1] == 0
        ctrl.note_success(0, cid)
        cid2 = ctrl.on_dispatch(0, items)
        ctrl._replicas[0].chunks[cid2].t_dispatch -= 1.0
        items[0][1]._complete(np.asarray([1, 2], np.int32))
        items[1][1]._complete(np.asarray([1, 2], np.int32))
        rec.append(ctrl.maybe_hedge())
        assert rec[-1] == 0
        assert not ctrl._replicas[0].chunks[cid2].hedged
        ctrl.note_success(0, cid2)
        cid3 = ctrl.on_dispatch(0, [_fake_item(ns)])
        ctrl._replicas[0].chunks[cid3].t_dispatch -= 1.0
        ctrl._replicas[1].state = ns.controller.STATE_OPEN
        rec.append(ctrl.maybe_hedge())
        assert rec[-1] == 0
        assert not ctrl._replicas[0].chunks[cid3].hedged
        rec += [[(r, len(c), h) for r, c, h in g.dispatched], _snap(ctrl),
                _counters(g.metrics)]
        return rec

    _both(scenario)


def test_autoscale_up_on_burn_and_graceful_drain_on_idle():
    def scenario(ns):
        rec = []
        g = _FakeGroup(ns, 2)
        ctrl = ns.ReplicaController(g, ns.ControllerConfig(
            max_replicas=3, min_replicas=2, scale_up_burn=1.0,
            scale_sustain_s=0.2, idle_sustain_s=0.2, burn_stale_s=30.0))
        t0 = time.monotonic()
        ctrl._replicas[0].slo_burn = 2.0
        ctrl._replicas[0].burn_updated = t0
        ctrl.autoscale(now=t0)
        rec.append(len(g.pool.workers))
        assert rec[-1] == 2
        ctrl.autoscale(now=t0 + 0.3)
        rec.append(len(g.pool.workers))
        assert rec[-1] == 3 and ctrl._replicas[2].scaled
        assert g.metrics.snapshot()["scale_ups"] == 1
        ctrl._replicas[0].burn_updated = t0 + 0.3
        ctrl.autoscale(now=t0 + 0.4)
        ctrl.autoscale(now=t0 + 0.7)
        rec.append(len(g.pool.workers))
        assert rec[-1] == 3
        rec.append(_snap(ctrl))
        ctrl._replicas[0].slo_burn = 0.0
        t1 = t0 + 1.0
        ctrl.autoscale(now=t1)
        ctrl.autoscale(now=t1 + 0.3)
        assert g.retired == [2] and 2 not in ctrl._replicas
        assert g.metrics.snapshot()["scale_downs"] == 1
        ctrl.autoscale(now=t1 + 1.0)
        ctrl.autoscale(now=t1 + 2.0)
        assert sorted(ctrl._replicas) == [0, 1]
        assert all(r.state != ns.controller.STATE_DRAINING
                   for r in ctrl._replicas.values())
        rec += [g.retired, ctrl.states(), _snap(ctrl), ctrl.lane_gauges(),
                _counters(g.metrics)]
        return rec

    _both(scenario)


def test_stale_burn_reads_as_zero():
    def scenario(ns):
        g = _FakeGroup(ns, 2)
        ctrl = ns.ReplicaController(g, ns.ControllerConfig(burn_stale_s=0.5))
        now = time.monotonic()
        ctrl._replicas[0].slo_burn = 5.0
        ctrl._replicas[0].burn_updated = now
        fresh, stale = (ctrl._overload_signals(now),
                        ctrl._overload_signals(now + 1.0))
        assert fresh[0] == 5.0 and stale[0] == 0.0
        return fresh, stale

    _both(scenario)


def test_brownout_decision_and_typed_shape():
    def scenario(ns):
        g = _FakeGroup(ns, 2)
        ctrl = ns.ReplicaController(g, ns.ControllerConfig(
            brownout_frac=0.5, max_replicas=None))
        rec = []
        g.batcher.depth = 7
        rec.append(ctrl.should_shed())
        assert rec[-1] is None
        g.batcher.depth = 8
        shed = ctrl.should_shed()
        rec.append(shed)
        assert shed == (8, 8, 16)
        ctrl2 = ns.ReplicaController(g, ns.ControllerConfig(
            brownout_frac=0.5, max_replicas=4))
        rec.append(ctrl2.should_shed())
        assert rec[-1] is None
        exc = ns.batcher.BrownoutShed(*shed)
        assert isinstance(exc, ns.batcher.QueueFull)
        assert "brownout" in str(exc) and "watermark" in str(exc)
        rec += [str(exc), exc.depth, exc.watermark, exc.limit,
                _snap(ctrl)["brownout_watermark"]]
        return rec

    _both(scenario)


def _prom_families(text):
    """The replica tier's sample lines of a Prometheus text."""
    return sorted(line for line in text.splitlines()
                  if line.startswith(("rla_tpu_serve_replica",
                                      "rla_tpu_serve_tier")))


def test_controller_snapshot_statusz_and_prometheus_family():
    def scenario(ns):
        g = _FakeGroup(ns, 2)
        ctrl = ns.ReplicaController(g, ns.ControllerConfig())
        cid = ctrl.on_dispatch(0, [_fake_item(ns)])
        ctrl.note_success(0, cid, {"decode_step_s": {"p99_s": 0.012},
                                   "slo_burn_rate": 1.5,
                                   "compile_count": 4})
        snap = _snap(ctrl)
        assert set(snap["replicas"]) == {"0", "1"}
        row = snap["replicas"]["0"]
        assert row["state"] == "ok" and row["dispatched_chunks"] == 1
        assert row["p99_step_ms"] == 12.0 and row["slo_burn"] == 1.5
        assert snap["brownout_watermark"] == 14
        json.dumps(snap)
        src = ns.live.LiveSources()
        src.bind_replica_controller(ctrl)
        statusz = src.statusz()
        assert statusz["replica_controller"]["replicas"]["0"][
            "completed_chunks"] == 1
        reg = src.build_registry()
        assert reg.to_json()["replica_controller"]["max_burn"] == 1.5
        text = reg.prometheus_text()
        assert_prometheus_exposition(text)
        assert 'rla_tpu_serve_replica_state{replica="0",state="ok"} 1' \
            in text
        assert 'rla_tpu_serve_replica_dispatched_chunks_total' \
               '{replica="0"} 1' in text
        assert "rla_tpu_serve_replica_count 2" in text
        assert "rla_tpu_serve_tier_queue_depth 0" in text
        families = _prom_families(text)
        src.bind_replica_controller(None)
        assert "replica_controller" not in src.statusz()
        ctrl2 = ns.ReplicaController(_FakeGroup(ns, 1), ns.ControllerConfig())
        src.bind_replica_controller(ctrl)
        src.bind_replica_controller(ctrl2)
        src.unbind_replica_controller(ctrl)
        assert set(src.statusz()["replica_controller"]["replicas"]) == {"0"}
        src.unbind_replica_controller(ctrl2)
        assert "replica_controller" not in src.statusz()
        return snap, families

    _both(scenario)


# --------------------------------------------------------------------- #
# Prefix affinity (tests/test_prefix_affinity.py:58-337)                 #
# --------------------------------------------------------------------- #
def test_chain_prefix_keys_commit_to_the_whole_prefix():
    def scenario(ns):
        ck = ns.batcher.chain_prefix_keys
        p = np.arange(20, dtype=np.int32)
        keys = ck(p, 8)
        assert len(keys) == 2 and keys == ck(p, 8)
        assert ck(p, 8, limit=1) == keys[:1] and ck(p[:7], 8) == []
        q = p.copy()
        q[10] += 1
        keys_q = ck(q, 8)
        assert keys_q[0] == keys[0] and keys_q[1] != keys[1]
        r = p.copy()
        r[0] += 1
        keys_r = ck(r, 8)
        assert keys_r[0] != keys[0] and keys_r[1] != keys[1]
        assert ck(list(range(20)), 8) == keys
        assert ck(np.arange(20, dtype=np.int64), 8) == keys
        return keys, keys_q, keys_r

    _both(scenario)


def test_affinity_ring_ownership_residency_and_forgetting():
    def scenario(ns):
        rec = []
        ring = ns.PrefixAffinityRing(vnodes=4, residency_cap=3)
        for r in (0, 1, 2):
            ring.add_rank(r)
        ring2 = ns.PrefixAffinityRing(vnodes=4, residency_cap=3)
        for r in (0, 1, 2):
            ring2.add_rank(r)
        owners = {k: ring.owner_among(k, (0, 1, 2))
                  for k in ("alpha", "beta", "gamma", "delta")}
        assert owners == {k: ring2.owner_among(k, (0, 1, 2))
                          for k in owners}
        # ownership key for key over many keys and allowed sets
        many = {f"k{i}": [ring.owner_among(f"k{i}", allowed)
                          for allowed in ((0, 1, 2), (0, 1), (1, 2), (2,))]
                for i in range(64)}
        rec += [owners, many, ring._ring]
        k, own = next(iter(owners.items()))
        fallback = ring.owner_among(k, tuple({0, 1, 2} - {own}))
        assert fallback is not None and fallback != own
        assert ring.owner_among(k, ()) is None
        ring.note(0, ["a", "b", "c"])
        runs = [ring.resident_run(0, ["a", "b", "c"]),
                ring.resident_run(0, ["a", "x", "c"]),
                ring.resident_run(0, ["x", "a"]),
                ring.resident_run(1, ["a"])]
        assert runs == [3, 1, 0, 0]
        ring.note(0, ["d"])
        assert ring.resident_run(0, ["a"]) == 0
        assert ring.resident_run(0, ["b"]) == 1
        ring.clear_rank(0)
        assert ring.resident_run(0, ["b"]) == 0
        assert ring.owner_among(k, (own,)) == own
        ring.remove_rank(own)
        assert ring.owner_among(k, (0, 1, 2)) != own
        json.dumps(ring.state())
        assert ring.state()["vnodes"] == 4
        rec += [fallback, runs, ring.state()]
        return rec

    _both(scenario)


def test_route_affinity_hits_misses_and_health_override():
    def scenario(ns):
        rec = []
        g = _FakeGroup(ns, 3)
        ctrl = ns.ReplicaController(g, ns.ControllerConfig(affinity_vnodes=8))
        keys = _keys(ns, 32, 8)
        owner = ctrl.affinity.owner_among(keys[0], (0, 1, 2))
        first = ctrl.route(prefix_keys=keys)
        assert first == owner
        assert g.metrics.snapshot()["prefix_route_misses"] == 1
        ctrl.on_dispatch(first, [_fake_item(ns)])
        assert ctrl.route(prefix_keys=keys) == first
        assert g.metrics.snapshot()["prefix_route_hits"] == 1
        rows = ctrl.snapshot()["replicas"]
        assert rows[str(first)]["prefix_hits"] == 1
        assert rows[str(first)]["prefix_misses"] == 1
        assert rows[str(first)]["prefix_hit_rate"] == 0.5
        ctrl._replicas[first].state = ns.controller.STATE_OPEN
        moved = ctrl.route(prefix_keys=keys)
        assert moved is not None and moved != first
        assert g.metrics.snapshot()["prefix_route_misses"] == 2
        assert ctrl.route(prefix_keys=keys) == moved
        assert g.metrics.snapshot()["prefix_route_hits"] == 2
        snap = _snap(ctrl)
        assert snap["affinity"]["enabled"] is True
        assert snap["affinity"]["ranks"] == [0, 1, 2]
        assert snap["config"]["affinity"] is True
        json.dumps(snap)
        g2 = _FakeGroup(ns, 2)
        ctrl2 = ns.ReplicaController(g2, ns.ControllerConfig(affinity=False))
        r2 = [ctrl2.route(prefix_keys=keys), ctrl2.route()]
        assert None not in r2
        snap2 = g2.metrics.snapshot()
        assert snap2["prefix_route_hits"] == 0
        assert snap2["prefix_route_misses"] == 0
        rec += [owner, first, moved, snap, r2, _counters(g.metrics)]
        return rec

    _both(scenario)


def test_breaker_open_clears_residency_so_reroutes_stick():
    def scenario(ns):
        g = _FakeGroup(ns, 2)
        ctrl = ns.ReplicaController(g, ns.ControllerConfig())
        keys = _keys(ns, 16, 8)
        home = ctrl.route(prefix_keys=keys)
        assert ctrl.affinity.resident_run(home, keys) == len(keys)
        cid = ctrl.on_dispatch(home, [_fake_item(ns)])
        g._worker(home).is_alive = False
        ctrl.note_infra_failure(home, cid, RuntimeError("worker died"))
        assert ctrl._replicas[home].state == ns.controller.STATE_OPEN
        assert ctrl.affinity.resident_run(home, keys) == 0
        return home, _snap(ctrl)

    _both(scenario)


def test_hedge_counts_as_deliberate_prefix_miss():
    def scenario(ns):
        g = _FakeGroup(ns, 2)
        ctrl = ns.ReplicaController(g, ns.ControllerConfig(hedge_age_s=0.05))
        cid = ctrl.on_dispatch(0, [_fake_item(ns)])
        ctrl._replicas[0].state = ns.controller.STATE_SLOW
        ctrl._replicas[0].chunks[cid].t_dispatch -= 1.0
        fired = ctrl.maybe_hedge()
        assert fired == 1
        rank, _, hedge_of = g.dispatched[0]
        assert rank == 1 and hedge_of == (0, cid)
        assert ctrl._replicas[1].prefix_misses == 1
        assert g.metrics.snapshot()["prefix_route_misses"] == 1
        ctrl.note_success(0, cid)
        return fired, _snap(ctrl), _counters(g.metrics)

    _both(scenario)


def test_lane_assignment_filter_and_spill():
    def scenario(ns):
        lanes = ns.controller
        g = _FakeGroup(ns, 3)
        ctrl = ns.ReplicaController(g, ns.ControllerConfig(prefill_replicas=1))
        rows = ctrl.snapshot()["replicas"]
        assert rows["0"]["lane"] == lanes.LANE_PREFILL
        assert rows["1"]["lane"] == rows["2"]["lane"] == lanes.LANE_DECODE
        routes = [ctrl.route(lane=lanes.LANE_PREFILL),
                  ctrl.route(lane=lanes.LANE_DECODE)]
        assert routes[0] == 0 and routes[1] in (1, 2)
        ctrl._replicas[1].state = lanes.STATE_OPEN
        ctrl._replicas[2].state = lanes.STATE_OPEN
        routes.append(ctrl.route(lane=lanes.LANE_DECODE))
        assert routes[-1] == 0
        ctrl.on_dispatch(0, [_fake_item(ns), _fake_item(ns)])
        gauges = ctrl.lane_gauges()
        assert gauges == {"lane_prefill_replicas": 1.0,
                          "lane_decode_replicas": 2.0,
                          "lane_prefill_inflight": 2.0,
                          "lane_decode_inflight": 0.0}
        ctrl2 = ns.ReplicaController(_FakeGroup(ns, 2), ns.ControllerConfig())
        g2 = ctrl2.lane_gauges()
        assert g2["lane_decode_replicas"] == 2.0
        assert g2["lane_prefill_replicas"] == 0.0
        return routes, gauges, g2, _snap(ctrl)

    _both(scenario)


def test_note_import_moves_residency_without_counting_a_route():
    def scenario(ns):
        g = _FakeGroup(ns, 2)
        ctrl = ns.ReplicaController(g, ns.ControllerConfig())
        keys = _keys(ns, 24, 8)
        before = _counters(g.metrics)
        ctrl.note_import(1, keys)
        assert ctrl.affinity.resident_run(1, keys) == len(keys)
        after = _counters(g.metrics)
        assert after == before
        routed = ctrl.route(prefix_keys=keys)
        assert routed == 1
        assert g.metrics.snapshot()["prefix_route_hits"] == 1
        return routed, _snap(ctrl), _counters(g.metrics)

    _both(scenario)


# --------------------------------------------------------------------- #
# Metrics (tests/test_prefix_affinity.py:513, :544)                      #
# --------------------------------------------------------------------- #
def test_counters_equal_the_jax_packages_in_order():
    assert port_metrics.ServeMetrics._COUNTERS == \
        jax_metrics.ServeMetrics._COUNTERS
    assert port_metrics.ServeMetrics.LANE_GAUGES == \
        jax_metrics.ServeMetrics.LANE_GAUGES
    m = port_metrics.ServeMetrics()
    assert m.describe().splitlines()[0] == \
        jax_metrics.ServeMetrics().describe().splitlines()[0]


def test_metrics_lane_gauges_and_reset_audit():
    def scenario(ns):
        m = ns.ServeMetrics()
        for c in ("prefix_route_hits", "prefix_route_misses",
                  "kv_handoffs"):
            m.inc(c)
        m.inc("kv_handoff_bytes", 4096)
        lanes = {"lane_prefill_replicas": 1, "lane_decode_replicas": 2,
                 "lane_prefill_inflight": 0, "lane_decode_inflight": 3}
        m.bind_lanes(lambda: dict(lanes))
        snap = m.snapshot()
        assert snap["prefix_route_hits"] == 1
        assert snap["kv_handoff_bytes"] == 4096
        assert snap["lane_decode_inflight"] == 3
        first = {k: snap[k] for k in list(m._COUNTERS) + list(lanes)}
        m.reset()
        snap = m.snapshot()
        for c in m._COUNTERS:
            assert snap[c] == 0, c
        assert snap["lane_prefill_replicas"] == 1
        m2 = ns.ServeMetrics()
        m2.bind_lanes(lambda: (m2.inc("hedged"),
                               {"lane_prefill_replicas": 0})[1])
        snap2 = m2.snapshot()
        assert snap2["lane_prefill_replicas"] == 0
        return first, sorted(snap), snap2["hedged"]

    _both(scenario)


def test_prometheus_typing_for_prefix_and_lane_families():
    def scenario(ns):
        m = ns.ServeMetrics()
        m.inc("prefix_route_hits", 3)
        m.inc("kv_handoffs", 2)
        m.inc("kv_handoff_bytes", 8192)
        m.bind_lanes(lambda: {"lane_prefill_replicas": 1,
                              "lane_decode_replicas": 2,
                              "lane_prefill_inflight": 0,
                              "lane_decode_inflight": 1})
        g = _FakeGroup(ns, 2)
        ctrl = ns.ReplicaController(g, ns.ControllerConfig(prefill_replicas=1))
        keys = _keys(ns, 16, 8)
        home = ctrl.route(prefix_keys=keys)
        ctrl.route(prefix_keys=keys)
        reg = ns.registry.MetricsRegistry()
        reg.add_serve(m, rank=0)
        reg.add_replica_controller(ctrl)
        text = reg.prometheus_text()
        assert_prometheus_exposition(text)
        assert 'rla_tpu_serve_prefix_route_hits_total{rank="0"} 3' in text
        assert 'rla_tpu_serve_kv_handoffs_total{rank="0"} 2' in text
        assert 'rla_tpu_serve_kv_handoff_bytes_total{rank="0"} 8192' in text
        assert 'rla_tpu_serve_lane_decode_replicas{rank="0"} 2' in text
        assert "rla_tpu_serve_lane_decode_replicas_total" not in text
        assert (f'rla_tpu_serve_replica_prefix_hits_total'
                f'{{replica="{home}"}} 1') in text
        assert (f'rla_tpu_serve_replica_prefix_hit_rate'
                f'{{replica="{home}"}} 0.5') in text
        assert 'rla_tpu_serve_replica_lane{replica="0",lane="prefill"} 1' \
            in text
        assert 'rla_tpu_serve_replica_lane{replica="1",lane="decode"} 1' \
            in text
        # every rla_tpu_serve_* line but the throughput-window ones
        serve = sorted(line for line in text.splitlines()
                       if line.startswith("rla_tpu_serve_")
                       and "busy_s" not in line)
        return home, serve

    _both(scenario)


# --------------------------------------------------------------------- #
# Failure triage (tests/test_analysis.py:352) and the config knobs       #
# --------------------------------------------------------------------- #
def test_replica_failure_triage_with_typed_rebuilds():
    from ray_lightning_accelerators_tpu.runtime.wire import (
        rebuild_remote as jax_rebuild)
    from ray_lightning_accelerators_tpu.serve.replicas import (
        _is_application_failure as jax_triage)
    from ray_lightning_accelerators_tpu_torch.runtime.actors import (
        RemoteError)
    from ray_lightning_accelerators_tpu_torch.runtime.watchdog import (
        WorkerWedged)
    from ray_lightning_accelerators_tpu_torch.runtime.wire import (
        rebuild_remote)
    from ray_lightning_accelerators_tpu_torch.serve.replicas import (
        _is_application_failure)

    cases = [RemoteError("ValueError", "x", "tb"),
             rebuild_remote("ObjectStoreError", "stale ref", "tb"),
             WorkerWedged.for_rank(1, {"detail": "stuck"}),
             rebuild_remote("WorkerWedged", "wedged", "tb"),
             RuntimeError("worker 1 died")]
    got = [bool(_is_application_failure(e)) for e in cases]
    assert got == [True, True, False, False, False]
    from ray_lightning_accelerators_tpu.runtime.actors import (
        RemoteError as JaxRemoteError)
    from ray_lightning_accelerators_tpu.runtime.watchdog import (
        WorkerWedged as JaxWedged)
    jax_cases = [JaxRemoteError("ValueError", "x", "tb"),
                 jax_rebuild("ObjectStoreError", "stale ref", "tb"),
                 JaxWedged.for_rank(1, {"detail": "stuck"}),
                 jax_rebuild("WorkerWedged", "wedged", "tb"),
                 RuntimeError("worker 1 died")]
    assert got == [bool(jax_triage(e)) for e in jax_cases]


_CONTROLLER_KNOBS = {
    "RLA_TPU_SERVE_MAX_RETRIES": "5",
    "RLA_TPU_SERVE_RETRY_BACKOFF_S": "0.03",
    "RLA_TPU_SERVE_RETRY_BACKOFF_CAP_S": "2.5",
    "RLA_TPU_SERVE_HEDGE": "0",
    "RLA_TPU_SERVE_SLOW_P99_S": "0.25",
    "RLA_TPU_SERVE_BREAKER_FAILURES": "4",
    "RLA_TPU_SERVE_BREAKER_WINDOW_S": "12",
    "RLA_TPU_SERVE_REVIVE_BACKOFF_S": "0.3",
    "RLA_TPU_SERVE_REVIVE_BACKOFF_CAP_S": "9",
    "RLA_TPU_SERVE_MAX_REPLICAS": "6",
    "RLA_TPU_SERVE_SCALE_UP_BURN": "1.5",
    "RLA_TPU_SERVE_BROWNOUT_FRAC": "0.75",
    "RLA_TPU_SERVE_AFFINITY": "false",
    "RLA_TPU_SERVE_AFFINITY_VNODES": "16",
    "RLA_TPU_SERVE_AFFINITY_RESIDENCY": "128",
    "RLA_TPU_SERVE_PREFILL_REPLICAS": "1",
    "RLA_TPU_SERVE_HANDOFF_MIN_BLOCKS": "3",
}


@pytest.mark.parametrize("overlay", [{}, _CONTROLLER_KNOBS,
                                     {"RLA_TPU_SERVE_MAX_RETRIES": "x",
                                      "RLA_TPU_SERVE_HEDGE": "maybe"}],
                         ids=["defaults", "all-seventeen", "malformed"])
def test_controller_config_from_env_matches_jax(overlay, monkeypatch):
    import dataclasses

    from ray_lightning_accelerators_tpu.analysis import knobs as jax_knobs
    from ray_lightning_accelerators_tpu_torch.analysis import knobs
    assert len(_CONTROLLER_KNOBS) == 17
    for name in _CONTROLLER_KNOBS:
        monkeypatch.delenv(name, raising=False)
        # registered in the port with the JAX package's default and help
        assert (knobs.KNOBS[name].default, knobs.KNOBS[name].help) == (
            jax_knobs.KNOBS[name].default, jax_knobs.KNOBS[name].help)
    for name, value in overlay.items():
        monkeypatch.setenv(name, value)
    port = port_controller.ControllerConfig.from_env(poll_s=0.05)
    jax = jax_controller.ControllerConfig.from_env(poll_s=0.05)
    assert dataclasses.asdict(port) == dataclasses.asdict(jax)
    with pytest.raises(TypeError, match="unknown ControllerConfig"):
        port_controller.ControllerConfig.from_env(no_such_field=1)
