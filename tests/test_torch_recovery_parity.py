"""The recovery layer's pure parts against the JAX package's, on the same
inputs, with no worker processes:

- ``parse_chaos`` on every spec of tests/test_chaos.py and
  tests/test_preemption.py (and the stage, replica, numeric and rejoin
  forms): the faults equal field by field, the same malformed specs
  raise ``ValueError`` in both; matching and claim tokens;
- ``backoff_delay_s`` over one seeded jitter sequence;
- ``stall_record`` of the same exceptions;
- the ``Preempted`` / ``WorkerWedged`` / ``NumericAnomaly`` messages: a
  message made by one package rebuilds in the other with the same
  fields; ``rebuild_remote`` types what the port registers;
- ``GoodputLedger`` fractions over the same sequence of phases (the
  clocks stubbed);
- the numeric faults: the port's eager ``apply_numeric`` against JAX's
  ``apply_traced_numeric`` on the same gradients (bitwise);
- the heartbeat channel's semantics and the recovery knobs' defaults."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_accelerators_tpu.analysis import knobs as jknobs
from ray_lightning_accelerators_tpu.runtime import guardian as jg
from ray_lightning_accelerators_tpu.runtime import preemption as jp
from ray_lightning_accelerators_tpu.runtime import watchdog as jw
from ray_lightning_accelerators_tpu.telemetry import perf as jperf
from ray_lightning_accelerators_tpu.testing import chaos as jc
from ray_lightning_accelerators_tpu.utils import backoff as jb
from ray_lightning_accelerators_tpu_torch.analysis import knobs as tknobs
from ray_lightning_accelerators_tpu_torch.runtime import guardian as tg
from ray_lightning_accelerators_tpu_torch.runtime import preemption as tp
from ray_lightning_accelerators_tpu_torch.runtime import watchdog as tw
from ray_lightning_accelerators_tpu_torch.runtime import wire
from ray_lightning_accelerators_tpu_torch.runtime.actors import RemoteError
from ray_lightning_accelerators_tpu_torch.telemetry import perf as tperf
from ray_lightning_accelerators_tpu_torch.testing import chaos as tc
from ray_lightning_accelerators_tpu_torch.utils import backoff as tb

# every spec of the JAX chaos and preemption tests, and the other forms
SPECS = [
    "crash@rank1:step3,hang@rank0,slow@all:2.5",
    "hang@rank1:once", "slow@rank2:1.5:step2", "crash@rank1:step3",
    "hang@rank0", "slow@all:0.5", "crash@rank0:once", "hang@all:once",
    "crash@rank0:step2", "slow@all:1.0", "lost@rank1,preempt@rank0:step2",
    "lost@rank0", "preempt@rank0:step2", "lost@rank1:step2",
    "preempt@rank0", "hang@stage1:step2:once", "crash@stage0",
    "crash@replica0:chunk2,hang@replica1:chunk3:once,slow@replica0:1.5",
    "nanloss@rank0:step3,gradspike@rank1:step5", "badbatch@step5",
    "bitflip@rank1:step4", "badbatch@all:step3", "nanloss@all",
    "rejoin@rank1:step3", "lost@rank1:step2,rejoin@rank1:step2", "",
    " crash@rank0 , ,slow@rank1:0.25",
]
MALFORMED = [
    "explode@rank0", "crash@node1", "slow@all", "crash@rank0:2.5",
    "hang@rank0:stepx", "crash", "preempt@replica0", "lost@replica1",
    "crash@replica0:step2", "crash@rank0:chunk2", "badbatch@step0",
    "badbatch@step3:once", "badbatch@rank1:step3", "nanloss@stage1:step2",
    "crash@rank0:step0", "crash@replica0:chunk0", "@rank0", "crash@",
]


def _fields(f):
    return (f.kind, f.rank, f.step, f.delay_s, f.once, f.layer, f.stage)


@pytest.mark.parametrize("spec", SPECS)
def test_parse_chaos_equals_jax_field_by_field(spec):
    theirs, ours = jc.parse_chaos(spec), tc.parse_chaos(spec)
    assert [_fields(f) for f in ours] == [_fields(f) for f in theirs]
    for a, b in zip(ours, theirs):
        for rank in range(3):
            assert a.token(rank) == b.token(rank)
            for step in range(1, 5):
                assert a.matches(rank, step) == b.matches(rank, step)


@pytest.mark.parametrize("spec", MALFORMED)
def test_malformed_specs_raise_in_both(spec):
    with pytest.raises(ValueError) as theirs:
        jc.parse_chaos(spec)
    with pytest.raises(ValueError) as ours:
        tc.parse_chaos(spec)
    assert str(ours.value) == str(theirs.value)


def test_injector_claims_and_namespace_rule(tmp_path):
    with pytest.raises(ValueError, match="RLA_TPU_CHAOS_NS"):
        tc.ChaosInjector(tc.parse_chaos("hang@rank1:once"), rank=1)
    with pytest.raises(ValueError, match="RLA_TPU_CHAOS_NS"):
        tc.ChaosInjector(tc.parse_chaos("lost@rank0"), rank=0)
    faults = tc.parse_chaos("crash@rank0:once")
    inj = tc.ChaosInjector(faults, rank=0, ns_dir=str(tmp_path))
    assert inj._claim_once(faults[0]) and not inj._claim_once(faults[0])
    other = tc.ChaosInjector(tc.parse_chaos("hang@all:once"), rank=1,
                             ns_dir=str(tmp_path))
    assert other._claim_once(other.faults[0])
    # stage faults arm only in their own stage group
    spec = tc.parse_chaos("hang@stage1:step2")
    assert tc.ChaosInjector(spec, rank=0, stage=1).faults
    assert not tc.ChaosInjector(spec, rank=0, stage=0).faults
    # the numeric and replica layers never arm in the dispatch loop
    assert not tc.ChaosInjector(
        tc.parse_chaos("badbatch@step3,crash@replica0"), rank=0).faults


def test_backoff_same_seeded_sequence():
    for cap, base in ((60.0, 2.0), (6.0, 2.0), (60.0, 0.5), (1.0, 0.0)):
        r1, r2 = random.Random(7), random.Random(7)
        ours = [tb.backoff_delay_s(a, base, cap, rng=r1.random)
                for a in range(0, 12)]
        theirs = [jb.backoff_delay_s(a, base, cap, rng=r2.random)
                  for a in range(0, 12)]
        assert ours == theirs
    assert tb.backoff_delay_s(1, 2.0, rng=lambda: 0.0) == 1.0
    assert tb.backoff_delay_s(3, 2.0, rng=lambda: 1.0) == 8.0
    assert tb.backoff_delay_s(10, 2.0, cap_s=6.0, rng=lambda: 1.0) == 6.0


def _stall_cases(pkg_w, pkg_p):
    return [
        pkg_w.WorkerWedged.for_rank(1, {"detail": "dispatch busy 9s > "
                                        "deadline", "busy_s": 9.0}),
        TimeoutError("5 of 8 futures unresolved"),
        pkg_p.Preempted.at_step(4, "/c/preempt-step4.ckpt", "signal-15"),
        RuntimeError("worker 1 died (exitcode=43)" + "x" * 900),
    ]


def test_stall_record_equals_jax():
    for ours, theirs in zip(_stall_cases(tw, tp), _stall_cases(jw, jp)):
        for stage in ("fit", "test"):
            assert tw.stall_record(ours, stage) == \
                jw.stall_record(theirs, stage)
    rec = tw.stall_record(_stall_cases(tw, tp)[0], "fit")
    assert rec["error"] == "worker wedged" and rec["stall_busy_s"] == 9.0


def test_wire_messages_rebuild_across_packages():
    pairs = [
        (tp.Preempted, jp.Preempted, lambda m: m.at_step(
            7, "/ckpts/preempt-step7.ckpt", source="signal-15"),
         ("step", "ckpt_path", "info")),
        (tw.WorkerWedged, jw.WorkerWedged, lambda m: m.for_rank(3, {
            "detail": "heartbeat stale 1.20s > wedge timeout 1.00s",
            "beat_age_s": 1.2, "busy_s": None, "dispatches": 4}),
         ("rank", "diagnosis")),
        (tg.NumericAnomaly, jg.NumericAnomaly, lambda m: m.for_trip(
            step=5, blame="data", flags={"loss_nonfinite": True},
            epoch=0, batch_idx=5, suspect_rank=None),
         ("step", "blame", "suspect_rank", "epoch", "batch_idx",
          "diagnosis")),
    ]
    for ours_cls, theirs_cls, make, fields in pairs:
        ours, theirs = make(ours_cls), make(theirs_cls)
        assert str(ours) == str(theirs)
        for made, rebuild in ((ours, theirs_cls), (theirs, ours_cls)):
            back = rebuild.from_message(str(made))
            for f in fields:
                assert getattr(back, f) == getattr(made, f), f
        # through the port's pipe: typed, its fields intact
        typed = wire.rebuild_remote(ours_cls.__name__, str(theirs), "tb")
        assert isinstance(typed, ours_cls) and typed.remote_typed
        for f in fields:
            assert getattr(typed, f) == getattr(theirs, f), f
    relayed = RemoteError("Preempted", str(tp.Preempted.at_step(2)), "tb")
    assert tp.is_preemption(relayed) and tp.as_preempted(relayed).step == 2
    assert not tp.is_preemption(RuntimeError("worker 1 died"))
    other = wire.rebuild_remote("ValueError", "boom", "tb")
    assert isinstance(other, RemoteError) and other.remote_type == "ValueError"
    # the SPMD sanitizer's mismatch crosses typed, as in the JAX package
    assert "CollectiveMismatch" in wire.WIRE_EXCEPTION_NAMES
    assert set(wire._rebuilders()) == wire.WIRE_EXCEPTION_NAMES


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("rerun", [False, True])
def test_goodput_fractions_equal_jax(monkeypatch, rerun):
    """The same phases on both ledgers, their clocks stubbed: every
    snapshot field equal (a reused ledger's second run included)."""
    snaps = []
    for mod in (tperf, jperf):
        clock = _Clock()
        monkeypatch.setattr(mod.time, "monotonic", clock)
        g = mod.GoodputLedger()
        for _ in range(2 if rerun else 1):
            g.run_begin()
            g.note_attempt()
            clock.t += 3.0
            g.account("productive", 2.5)
            with g.measure("restart"):
                clock.t += 1.25
            g.note_attempt()
            g.account("wedge_wait", 0.75)
            g.note_preemption()
            g.absorb_timeline({"phases": {"compute": {"total_s": 1.0},
                                          "ckpt": {"total_s": 0.5}},
                               "between_step_phases": {
                                   "compile": {"total_s": 0.25}}})
            g.absorb_profiler({"stats": {"fit/train_step": {"total": 0.5},
                                         "drain": {"total": 0.125}}})
            g.absorb_events([{"kind": "preempt_drain", "ts": 1.0},
                             {"kind": "emergency_checkpoint", "ts": 1.5}])
            clock.t += 4.0
            g.run_end()
        snaps.append(g.snapshot())
        monkeypatch.undo()
    assert snaps[0] == snaps[1]
    assert snaps[0]["goodput_fraction"] == round(4.0 / 8.25, 4)


def _grads():
    rng = np.random.default_rng(3)
    return [rng.standard_normal((4, 3)).astype(np.float32),
            rng.standard_normal((3,)).astype(np.float32)]


@pytest.mark.parametrize("spec", ["nanloss@rank0:step3",
                                  "gradspike@all:step3",
                                  "bitflip@rank0:step3", "badbatch@step3"])
@pytest.mark.parametrize("step", [1, 2])
def test_numeric_faults_equal_jax(spec, step):
    """On the global gradients (the port's exact path, JAX's ``grads``)
    the eager fault is bitwise the traced one, at and off its step."""
    (jf,), (tf,) = jc.parse_chaos(spec), tc.parse_chaos(spec)
    g = _grads()
    jm, jgr, _ = jc.apply_traced_numeric(
        jf, jnp.asarray(step), {"train_loss": jnp.float32(0.5)},
        grads=[jnp.asarray(a) for a in g])
    tm = {"train_loss": torch.tensor(0.5)}
    tgr = [torch.from_numpy(a.copy()) for a in g]
    tc.apply_numeric(tf, step, tm, tgr)
    np.testing.assert_array_equal(np.asarray(tm["train_loss"]),
                                  np.asarray(jm["train_loss"]))
    for a, b in zip(tgr, jgr):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_poison_batch_equals_jax():
    batch = {"x": np.ones((2, 3), np.float32), "y": np.arange(2)}
    ours, theirs = tc.poison_batch(batch), jc.poison_batch(batch)
    np.testing.assert_array_equal(ours["x"], theirs["x"])
    np.testing.assert_array_equal(ours["y"], theirs["y"])
    assert np.isnan(ours["x"][0, 0]) and not np.isnan(batch["x"]).any()
    t = tc.poison_batch((torch.ones(3), torch.arange(3)))
    assert torch.isnan(t[0][0]) and t[1].dtype == torch.int64


def test_heartbeat_channel_semantics():
    ch = tw.HeartbeatChannel()
    snap = ch.snapshot()
    assert snap["busy_s"] is None and snap["dispatches"] == 0
    assert not snap["started"]
    ch.stamp()
    assert ch.snapshot()["started"]
    ch.begin_dispatch()
    snap = ch.snapshot()
    assert snap["dispatches"] == 1 and snap["busy_s"] is not None
    ch.end_dispatch()
    snap = ch.snapshot()
    assert snap["busy_s"] is None and snap["beat_age_s"] < 5.0


def test_recovery_knobs_registered_with_jax_defaults():
    for name in ("RLA_TPU_WORKER_HEARTBEAT_S", "RLA_TPU_WEDGE_TIMEOUT_S",
                 "RLA_TPU_PREEMPT_GRACE_S",
                 "RLA_TPU_PREEMPT_CONSENSUS_EVERY", "RLA_TPU_CHAOS",
                 "RLA_TPU_CHAOS_NS", "RLA_TPU_ELASTIC_BACKOFF_S",
                 "RLA_TPU_ELASTIC_BACKOFF_CAP_S", "RLA_TPU_PIPELINE_STAGE",
                 "RLA_TPU_GUARD_MAX_REWINDS"):
        assert tknobs.KNOBS[name].default == jknobs.KNOBS[name].default, name
    env = {"RLA_TPU_PREEMPT_GRACE_S": "soon"}
    assert tknobs.get_float("RLA_TPU_PREEMPT_GRACE_S", None, env=env,
                            malformed=30.0) == 30.0
