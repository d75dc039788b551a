"""The numeric guardian's training half in the port against the JAX
package's (``runtime/guardian.py``):

- the guard arithmetic: ``update`` over scripted sequences (warm-up, a
  NaN loss, a NaN gradient norm, a spike, an update ratio, a lone and a
  global bad replica) and ``per_replica_bad``, to 1e-6 relative;
- the quarantine ledger, the rewind anchor and the prune protection;
- fits: a NaN row at a known batch raises the same ``NumericAnomaly``
  (step, epoch, batch, blame, flags) as the JAX ``Trainer`` and writes
  the same ledger, and a second fit on the same root skips that batch to
  the JAX second fit's parameters (1e-5); a finite spike after
  ``GuardConfig(warmup_steps=2)`` gets JAX's verdict; a guarded fit is
  bitwise the unguarded one, its guard vector JAX's to 1e-5;
- 2 gloo ranks, plain data parallelism and ``grad_compression="int8"``:
  both ranks raise the same anomaly within the world's timeout, as the
  JAX Trainer on a 2-device mesh (the poisoned row is row 0 of a batch,
  which both packages give to replica / rank 0);
- the port ``Trainer()``'s defaults are the JAX ``Trainer``'s.

The JAX side runs on the CPU devices tests/conftest.py provides."""

import functools
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_accelerators_tpu import RayTPUAccelerator as JaxRayTPU
from ray_lightning_accelerators_tpu import Trainer as JaxTrainer
from ray_lightning_accelerators_tpu.data.loader import (
    ArrayDataset as JaxArrayDataset, DataLoader as JaxDataLoader)
from ray_lightning_accelerators_tpu.runtime import guardian as jg
from ray_lightning_accelerators_tpu_torch import (DataLoader,
                                                  ModelCheckpoint, Trainer)
from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
from ray_lightning_accelerators_tpu_torch.runtime import bootstrap
from ray_lightning_accelerators_tpu_torch.runtime import guardian as tg
from ray_lightning_accelerators_tpu_torch.runtime.bootstrap import (
    DistributedWorld)
from ray_lightning_accelerators_tpu_torch.utils import checkpoint as ckpt_lib

from .torch_boring import BoringModel, guard_trip_body
from .utils import BoringModel as JaxBoring

pytestmark = pytest.mark.guardian


def _close(port, ref, rtol):
    np.testing.assert_allclose(np.asarray(port.detach().cpu().numpy()
                                          if isinstance(port, torch.Tensor)
                                          else port),
                               np.asarray(ref), rtol=rtol, atol=1e-30)


# --------------------------------------------------------------------- #
# The guard arithmetic                                                  #
# --------------------------------------------------------------------- #
NAN = float("nan")
# (step, loss, gnorm, ratio, rank_bad) after a healthy warm-up
SEQUENCES = {
    "warmup_then_spike": [(0, 1.0, 2.0, 0.1, None), (1, 1.0, 2.5, 0.1, None),
                          (2, 0.9, 3.0, 0.2, None), (3, 0.9, 50.0, 0.1, None),
                          (4, NAN, 1.0, 0.1, None)],
    "nan_loss": [(0, 1.0, 2.0, 0.1, None), (1, NAN, 2.0, 0.1, None),
                 (2, 1.0, 2.0, 0.1, None)],
    "nan_gnorm": [(0, 1.0, 2.0, 0.1, None), (1, 1.0, NAN, NAN, None)],
    "update_ratio": [(0, 1.0, 2.0, 0.1, None), (1, 1.0, 2.0, 0.2, None),
                     (2, 1.0, 2.1, 0.7, None)],
    "spike_below_floor": [(0, 1.0, 1e-6, 0.1, None),
                          (1, 1.0, 1e-6, 0.1, None),
                          (2, 1.0, 5e-4, 0.1, None)],
    "lone_replica": [(0, 1.0, 2.0, 0.1, [0.0, 0.0, 0.0, 0.0]),
                     (1, NAN, NAN, 0.1, [0.0, 0.0, 1.0, 0.0])],
    "global_replica": [(0, 1.0, 2.0, 0.1, [0.0, 0.0]),
                       (1, NAN, NAN, 0.1, [1.0, 1.0])],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_update_matches_jax(name):
    """Each step's carried vector and metric row, the port's against
    JAX's ``update`` at rtol 1e-6 (the EMA's f32 products are the only
    non-exact values)."""
    cfg_j = jg.GuardConfig(warmup_steps=2, ema_decay=0.5)
    cfg_t = tg.GuardConfig(warmup_steps=2, ema_decay=0.5)
    gj = jnp.asarray(jg.fresh_state())
    gt = tg.fresh_state()
    _close(gt, gj, 0)
    for step, loss, gnorm, ratio, bad in SEQUENCES[name]:
        gj, mj = jg.update(cfg_j, gj, step, loss, gnorm, ratio,
                           None if bad is None else jnp.asarray(bad))
        gt, mt = tg.update(cfg_t, gt, step, loss, gnorm, ratio,
                           None if bad is None else torch.tensor(bad))
        assert gt.shape == (tg.GUARD_WIDTH,) and mt.shape == (
            tg.METRIC_WIDTH,)
        _close(gt, gj, 1e-6)
        _close(mt, mj, 1e-6)
    assert float(gt[tg.I_TRIPPED]) == (0.0 if name == "spike_below_floor"
                                       else 1.0)


@pytest.mark.parametrize("case", ["clean", "nan", "outlier", "two_even"])
def test_per_replica_bad_matches_jax(case):
    rng = np.random.default_rng(3)
    w = rng.normal(size=(4, 8)).astype(np.float32)
    b = rng.normal(size=(4, 3)).astype(np.float32)
    if case == "nan":
        w[2, 0] = np.nan
    elif case == "outlier":
        b[1] *= 1e6  # finite, 1e6 x the replica median norm
    elif case == "two_even":
        w, b = w[:2], b[:2] * np.float32(30.0)
    ref = jg.per_replica_bad({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                             10.0)
    got = tg.per_replica_bad({"w": torch.from_numpy(w),
                              "b": torch.from_numpy(b)}, 10.0)
    _close(got, ref, 0)


def test_numeric_anomaly_round_trips_through_its_message():
    e = tg.NumericAnomaly.for_trip(5, tg.BLAME_DATA,
                                   flags={"loss_nonfinite": True},
                                   suspect_rank=None, epoch=1, batch_idx=3)
    j = jg.NumericAnomaly.for_trip(5, jg.BLAME_DATA,
                                   flags={"loss_nonfinite": True},
                                   epoch=1, batch_idx=3)
    assert str(e) == str(j)
    back = tg.NumericAnomaly.from_message(str(e))
    assert (back.step, back.blame, back.epoch, back.batch_idx) == (
        5, "data", 1, 3)


# --------------------------------------------------------------------- #
# The quarantine ledger                                                 #
# --------------------------------------------------------------------- #
def test_ledger_round_trip_anchor_and_protected_paths(tmp_path):
    """The same operations on the port's and JAX's ledgers give the same
    documents; ``protected_paths`` finds the anchor at the root and one
    directory down; releasing it keeps the entries."""
    docs = []
    for lib, root in ((tg, tmp_path / "port"), (jg, tmp_path / "jax")):
        root = str(root)
        assert lib.load_quarantine(root) == {"entries": [], "anchor": None}
        lib.add_quarantine(root, 0, 3, 11, anchor="/ck/a.ckpt")
        lib.add_quarantine(root, 0, 3, 11)
        lib.add_quarantine(root, 1, 5, 21)
        docs.append(lib.load_quarantine(root))
        assert lib.skip_set(root, 0) == {3} and lib.skip_set(root, 2) == set()
        assert lib.protected_paths(root) == ["/ck/a.ckpt"]
        assert lib.protected_paths(os.path.join(root, "checkpoints")) == [
            "/ck/a.ckpt"]
        lib.release_anchor(root)
        doc = lib.load_quarantine(root)
        assert doc["anchor"] is None and len(doc["entries"]) == 2
    assert docs[0] == docs[1]
    # a torn newest checkpoint is never the anchor
    ck = tmp_path / "port" / "ck"
    ck.mkdir()
    a, b = ck / "epoch=0.ckpt", ck / "epoch=1.ckpt"
    ckpt_lib.atomic_save({"global_step": 8}, str(a))
    ckpt_lib.atomic_save({"global_step": 16}, str(b))
    os.utime(a, (1, 1))
    os.utime(b, (2, 2))
    g = tg.Guardian(tg.GuardConfig(), str(tmp_path / "port"))
    assert g._rewind_anchor() == str(b)
    b.write_bytes(b.read_bytes()[:4])
    os.utime(b, (2, 2))
    assert g._rewind_anchor() == str(a)


def test_prune_keeps_the_anchor_while_pinned(tmp_path):
    ck = tmp_path / "checkpoints"
    ck.mkdir()
    paths = []
    for i in range(3):
        p = ck / f"epoch={i}.ckpt"
        ckpt_lib.atomic_save({"global_step": 8 * (i + 1)}, str(p))
        os.utime(p, (i + 1, i + 1))
        paths.append(p)
    tg.add_quarantine(str(tmp_path), 0, 2, 5, anchor=str(paths[0]))
    mc = ModelCheckpoint(monitor=None, keep_last_k=1)
    mc.dirpath = str(ck)
    mc._prune()
    assert paths[0].exists() and not paths[1].exists() and paths[2].exists()
    tg.release_anchor(str(tmp_path))
    mc._prune()
    assert not paths[0].exists()


# --------------------------------------------------------------------- #
# Fits against the JAX Trainer                                          #
# --------------------------------------------------------------------- #
def _data(rows=64, seed=0):
    return np.random.default_rng(seed).normal(
        size=(rows, 32)).astype(np.float32)


@pytest.fixture(scope="module")
def init():
    return jax.device_get(JaxBoring().init_params(jax.random.PRNGKey(0)))


def _jax_fit(init, root, data, guard="auto", accelerator=None, **kw):
    m = JaxBoring()
    m.params = jax.tree.map(jnp.asarray, init)
    kw.setdefault("max_epochs", 1)
    t = JaxTrainer(precision="f32", seed=0, guard=guard,
                   enable_checkpointing=False, log_every_n_steps=1,
                   default_root_dir=str(root), accelerator=accelerator,
                   **kw)
    t.fit(m, JaxDataLoader(JaxArrayDataset(data), batch_size=8))
    return t, m


def _port_fit(init, root, data, guard="auto", **kw):
    m = BoringModel()
    m.params = {k: {n: torch.tensor(np.asarray(v)) for n, v in
                    leaf.items()} for k, leaf in init.items()}
    kw.setdefault("max_epochs", 1)
    t = Trainer(device="cpu", precision="f32", seed=0, guard=guard,
                enable_checkpointing=False, log_every_n_steps=1,
                default_root_dir=str(root), **kw)
    t.fit(m, DataLoader(ArrayDataset(data), batch_size=8))
    return t, m


def _fields(e):
    return (e.step, e.epoch, e.batch_idx, e.blame, e.suspect_rank,
            {k: v for k, v in e.diagnosis["flags"].items()
             if isinstance(v, bool)})


def test_nan_row_trips_quarantines_and_skips_as_jax(tmp_path, init):
    """Row 17 (batch 2) is NaN: both packages raise at step 2, epoch 0,
    batch 2, blame "data", write the same ledger, and a second fit on the
    same root skips batch 2: 7 steps, the parameters JAX's (1e-5)."""
    data = _data()
    data[17, 4] = np.nan
    errs = []
    for fit, root in ((_jax_fit, tmp_path / "jax"),
                      (_port_fit, tmp_path / "port")):
        with pytest.raises((jg.NumericAnomaly, tg.NumericAnomaly)) as ei:
            fit(init, root, data)
        errs.append(ei.value)
    assert isinstance(errs[1], tg.NumericAnomaly)
    assert _fields(errs[1]) == _fields(errs[0])
    assert _fields(errs[1])[:4] == (2, 0, 2, "data")
    assert tg.load_quarantine(str(tmp_path / "port")) == \
        jg.load_quarantine(str(tmp_path / "jax"))
    jt, jm = _jax_fit(init, tmp_path / "jax", data)
    tt, tm = _port_fit(init, tmp_path / "port", data)
    assert tt.global_step == jt.global_step == 7
    for name in ("kernel", "bias"):
        _close(tm.params["layer"][name], jm.params["layer"][name], 1e-5)
    doc = tg.load_quarantine(str(tmp_path / "port"))
    assert len(doc["entries"]) == 1 and doc["anchor"] is None


def test_finite_spike_after_warmup_gets_jax_verdict(tmp_path, init):
    """Batch 5 scaled by 1e4 (finite): past ``warmup_steps=2`` the norm
    spikes; both packages trip at the same step with the same flags and
    blame (the replay reproduces nothing non-finite: "sdc")."""
    data = _data()
    data[40:48] *= np.float32(1e4)
    with pytest.raises(jg.NumericAnomaly) as ej:
        _jax_fit(init, tmp_path / "jax", data,
                 guard=jg.GuardConfig(warmup_steps=2))
    with pytest.raises(tg.NumericAnomaly) as et:
        _port_fit(init, tmp_path / "port", data,
                  guard=tg.GuardConfig(warmup_steps=2))
    assert _fields(et.value) == _fields(ej.value)
    assert et.value.step == 5 and et.value.diagnosis["flags"]["spike"]


def test_guarded_fit_is_bitwise_unguarded_and_its_vector_jaxs(tmp_path,
                                                              init):
    data = _data()
    tg_, mg = _port_fit(init, tmp_path / "g", data, max_epochs=3)
    tn, mn = _port_fit(init, tmp_path / "n", data, guard=None,
                       max_epochs=3)
    assert tn._state.guard_ema is None
    assert [r["train_loss"] for r in tg_.logger.history] == \
        [r["train_loss"] for r in tn.logger.history]
    for name in ("kernel", "bias"):
        assert torch.equal(mg.params["layer"][name],
                           mn.params["layer"][name])
    jt, _ = _jax_fit(init, tmp_path / "j", data, max_epochs=3)
    _close(tg_._state.guard_ema, jax.device_get(jt._state.guard_ema), 1e-5)
    assert float(tg_._state.guard_ema[tg.I_COUNT]) == 24.0


def test_port_trainer_defaults_are_the_jax_trainers():
    want = ("guard", "prefetch_batches", "cache_dataset_on_device")
    port = inspect.signature(Trainer.__init__).parameters
    ref = inspect.signature(JaxTrainer.__init__).parameters
    assert {k: port[k].default for k in want} == \
        {k: ref[k].default for k in want} == {
            "guard": "auto", "prefetch_batches": 2,
            "cache_dataset_on_device": "auto"}
    t = Trainer(device="cpu")
    assert isinstance(t.guard, tg.GuardConfig) and t.prefetch_batches == 2


# --------------------------------------------------------------------- #
# Two gloo ranks                                                        #
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def world():
    saved = bootstrap.DEFAULT_TIMEOUT_S
    bootstrap.DEFAULT_TIMEOUT_S = 60.0
    w = DistributedWorld(2, devices=["cpu", "cpu"], timeout_s=60.0)
    try:
        yield w
    finally:
        w.shutdown()
        bootstrap.DEFAULT_TIMEOUT_S = saved


@pytest.mark.parametrize("compression", [None, "int8"])
def test_two_ranks_raise_the_same_anomaly_as_jax(world, init, tmp_path,
                                                 compression):
    """Row 0 of batch 3 is NaN: under plain data parallelism the loss and
    norm go non-finite on every rank and the batch evidence, OR-ed over
    the ranks, blames the data (only rank 0 holds the row); under int8
    compression the gathered per-rank health finds rank 0 alone bad: SDC
    naming rank 0, as the JAX Trainer on a 2-device mesh, whose replica 0
    holds the row.  Both ranks return the same verdict within the
    world's 60 s timeout."""
    data = _data()
    data[24, 7] = np.nan
    init_np = jax.tree.map(np.asarray, init)
    results = world.run(functools.partial(
        guard_trip_body, data=data, init=init_np,
        root=str(tmp_path / "port"), compression=compression),
        deadline_s=120.0)
    assert results[0] == results[1]
    kw = {"grad_compression": compression} if compression else {}
    with pytest.raises(jg.NumericAnomaly) as ej:
        _jax_fit(init, tmp_path / "jax", data,
                 accelerator=JaxRayTPU(num_workers=2), **kw)
    step, epoch, batch_idx, blame, suspect, flags = _fields(ej.value)
    assert results[0] == {"step": step, "epoch": epoch,
                          "batch_idx": batch_idx, "blame": blame,
                          "suspect_rank": suspect, "flags": flags}
    assert (step, blame, suspect) == ((3, "data", None) if compression is
                                      None else (3, "sdc", 0))
    # rank 0 alone wrote the ledger (data blame only)
    doc = tg.load_quarantine(str(tmp_path / "port"))
    assert doc["entries"] == ([{"epoch": 0, "batch_idx": 3, "step": 3}]
                              if compression is None else [])

