"""The port's sharded checkpoints (utils/sharded_checkpoint.py): the JAX
package's tests/test_sharded_checkpoint.py on the port (round trip in
both sharded formats, resume, eviction of directories, restore into
another world's layouts, an unknown format refused), plus the integrity
record catching a truncated shard file, and the pickle format over a
2-rank FSDP fit gathering the whole state (per-rank buffers stacked as
the JAX package's ``[n, ...]``).  The on-disk format is the port's own:
plain ``torch.save`` files and a JSON manifest, not orbax."""

import os

import numpy as np
import pytest
import torch

from ray_lightning_accelerators_tpu_torch import (ModelCheckpoint,
                                                  RayTPUAccelerator, Trainer)
from ray_lightning_accelerators_tpu_torch.runtime import bootstrap
from ray_lightning_accelerators_tpu_torch.utils import checkpoint as ckpt_lib
from ray_lightning_accelerators_tpu_torch.utils import (
    sharded_checkpoint as sc)

from .torch_boring import BoringModel, WideModel, boring_loaders


def _fit(tmp_path, fmt, max_epochs=2, **ckpt_kwargs):
    train, val = boring_loaders()
    model = BoringModel()
    cb = ModelCheckpoint(monitor=None, **ckpt_kwargs)
    trainer = Trainer(device="cpu", max_epochs=max_epochs, precision="f32",
                      seed=0, checkpoint_format=fmt, callbacks=[cb],
                      default_root_dir=str(tmp_path))
    trainer.fit(model, train, val)
    return trainer, model, cb


@pytest.mark.parametrize("fmt", ["sharded", "sharded-async"])
def test_roundtrip(tmp_path, fmt):
    trainer, model, cb = _fit(tmp_path, fmt)
    sc.wait_until_finished()
    best = cb.best_model_path
    assert sc.is_sharded_checkpoint(best), best
    loaded = BoringModel.load_from_checkpoint(best)
    for k in ("kernel", "bias"):
        np.testing.assert_array_equal(loaded.params["layer"][k].numpy(),
                                      model.params["layer"][k].numpy())
    # module-level hooks round-trip through meta.json
    assert loaded.val_epoch == model.val_epoch
    assert sc.verify_checkpoint(best) == (True, "ok")
    meta = sc.read_metadata(best)
    assert meta["global_step"] == trainer.global_step
    assert meta["world"] == {"dp": 1, "fsdp": 1, "processes": 1}


def test_resume_continues(tmp_path):
    trainer, model, cb = _fit(tmp_path, "sharded", max_epochs=2)
    latest = ckpt_lib.latest_checkpoint(str(tmp_path))
    assert latest is not None and sc.is_sharded_checkpoint(latest)

    train, val = boring_loaders()
    model2 = BoringModel()
    trainer2 = Trainer(device="cpu", max_epochs=4, precision="f32", seed=0,
                       checkpoint_format="sharded",
                       enable_checkpointing=False,
                       default_root_dir=str(tmp_path / "resume"))
    trainer2.fit(model2, train, val, ckpt_path=latest)
    # resumed from epoch 2, ran epochs 3 and 4
    assert trainer2.global_step == trainer.global_step * 2
    assert trainer2.epochs_completed == 4


def test_eviction_removes_directories(tmp_path):
    trainer, model, cb = _fit(tmp_path, "sharded", max_epochs=4,
                              save_top_k=1)
    ckpt_dir = os.path.join(str(tmp_path), "checkpoints")
    entries = [e for e in os.listdir(ckpt_dir)
               if sc.is_sharded_checkpoint(os.path.join(ckpt_dir, e))]
    assert len(entries) == 1, entries
    assert os.path.join(ckpt_dir, entries[0]) == cb.best_model_path


def test_restore_with_layouts(tmp_path):
    """Global shapes in the manifest let another world restore its parts:
    a tree saved whole comes back as rank r's slices of 2."""
    path = str(tmp_path / "direct")
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "b": torch.ones(8)}
    sc.save_sharded(path, tree, {"epoch": 1})
    for rank in range(2):
        out = sc.restore_sharded(path, layouts={"w": 0, "b": 0}, rank=rank,
                                 world=2)
        np.testing.assert_array_equal(out["w"].numpy(),
                                      tree["w"][4 * rank:4 * rank + 4])
        np.testing.assert_array_equal(out["b"].numpy(), np.ones(4))
    whole = sc.restore_sharded(path)
    np.testing.assert_array_equal(whole["w"].numpy(), tree["w"].numpy())
    meta = sc.read_metadata(path)
    assert meta["epoch"] == 1
    assert meta[sc.INTEGRITY_KEY]["algo"] == "sha256"
    assert sc.verify_checkpoint(path) == (True, "ok")


def test_unknown_format_rejected():
    with pytest.raises(ValueError, match="checkpoint_format"):
        Trainer(device="cpu", checkpoint_format="msgpack")


def test_verify_catches_a_truncated_shard_file(tmp_path):
    """A shard file cut short fails its recorded size; one rewritten in
    place fails its digest; ``latest_checkpoint`` walks back to the older
    save that still verifies."""
    _fit(tmp_path, "sharded", max_epochs=2, save_top_k=2)
    saves = ckpt_lib.list_checkpoints(str(tmp_path))
    assert len(saves) == 2
    newest, older = saves
    shard = os.path.join(newest, sc.STATE_DIR, sc.rank_file(0))
    size = os.path.getsize(shard)
    with open(shard, "r+b") as f:
        f.truncate(size - 16)
    ok, why = sc.verify_checkpoint(newest)
    assert not ok and "truncated" in why, why
    assert ckpt_lib.verify_checkpoint(newest)[0] is False
    assert ckpt_lib.latest_checkpoint(str(tmp_path)) == older
    other = os.path.join(older, sc.STATE_DIR, sc.rank_file(0))
    with open(other, "r+b") as f:
        data = bytearray(f.read())
        data[-20] ^= 0xFF
        f.seek(0)
        f.write(data)
    ok, why = sc.verify_checkpoint(older)
    assert not ok and "digest mismatch" in why, why


def test_prune_verifies_own_saves_from_the_cache(tmp_path, monkeypatch):
    """``prune_checkpoints`` accepts a sharded checkpoint this process
    saved, unchanged since, without re-hashing it (the JAX package's
    retention does the same); a plain ``verify_checkpoint`` hashes, and
    a resized shard file misses the cache and fails its digest pass."""
    _fit(tmp_path, "sharded", max_epochs=2, save_top_k=2)
    newest, older = ckpt_lib.list_checkpoints(str(tmp_path))
    hashed = []
    real = sc._tree_digests
    monkeypatch.setattr(sc, "_tree_digests",
                        lambda p: hashed.append(p) or real(p))
    assert ckpt_lib.prune_checkpoints(str(tmp_path), 1) == [older]
    assert hashed == [] and not os.path.exists(older)
    assert sc.verify_checkpoint(newest) == (True, "ok")
    assert hashed == [os.path.abspath(newest)]
    shard = os.path.join(newest, sc.STATE_DIR, sc.rank_file(0))
    with open(shard, "ab") as f:
        f.write(b"\0" * 8)
    ok, why = ckpt_lib.verify_checkpoint(newest, use_cache=True)
    assert not ok and "resized" in why, why


def test_pickle_under_fsdp_holds_the_whole_state(tmp_path, monkeypatch):
    """``checkpoint_format="pickle"`` over 2 FSDP ranks with int8
    compression and accumulation: rank 0's file holds whole params and
    moments (gathered from the slices) and the per-rank buffers stacked
    ``[2, ...]``, and it resumes on one rank with them reset."""
    monkeypatch.setattr(bootstrap, "DEFAULT_TIMEOUT_S", 60.0)
    cb = ModelCheckpoint(monitor=None)
    t = Trainer(device="cpu", max_epochs=1, precision="f32", seed=0,
                limit_train_batches=4, callbacks=[cb],
                accelerator=RayTPUAccelerator(2, use_fsdp=True),
                grad_compression="int8", accumulate_grad_batches=2,
                default_root_dir=str(tmp_path))
    model = WideModel()
    t.fit(model, boring_loaders(batch_size=8)[0])
    t.shutdown_workers()
    assert t.rank_report["state_shapes"]["params/layer/kernel"] == [128, 256]
    payload = ckpt_lib.read_checkpoint(cb.best_model_path)
    st = payload["state"]
    assert st["params"]["layer"]["kernel"].shape == (256, 256)
    np.testing.assert_array_equal(st["params"]["layer"]["kernel"],
                                  model.params["layer"]["kernel"].numpy())
    assert st["residual"]["layer"]["kernel"].shape == (2, 128 * 256)
    assert st["grad_accum"]["layer"]["kernel"].shape == (256, 256)
    assert payload["world"]["dp"] == 2
    t1 = Trainer(device="cpu", max_epochs=2, precision="f32", seed=0,
                 limit_train_batches=4, grad_compression="int8",
                 accumulate_grad_batches=2, enable_checkpointing=False,
                 default_root_dir=str(tmp_path / "one"))
    resumed = WideModel()
    t1.fit(resumed, boring_loaders(batch_size=8)[0],
           ckpt_path=cb.best_model_path)
    assert t1.global_step == 8
    assert t1._state.residual["layer"]["kernel"].shape == (256 * 256,)
