"""The port's preemption drain (``runtime/preemption.py``, the Trainer's
drain) against the JAX package's (port of tests/test_preemption.py's
notice and Trainer tests):

- SIGTERM with a handler installed raises the notice and writes the
  flag file a second process reads;
- an in-process port ``Trainer`` and the JAX ``Trainer`` on the same tiny
  GPT, weights and batches, the notice raised after step 3: both drain
  at step 3 into ``preempt-step3.ckpt`` and raise ``Preempted``;
  ``fit(ckpt_path="last")`` resumes at step 3 and both end on the same
  params (1e-5 relative L2);
- a flag file left by an earlier drain does not drain a fresh fit;
- 2 gloo ranks, the notice on rank 1 alone: the ranks agree
  (``consensus_requested``, every 2 steps here) and both drain at step
  4, after the emergency checkpoint;
- the restart and kill of a worker whose SIGTERM is a drain notice go
  to SIGKILL at once (well under the 10 s join) and leave no flag.

The JAX side runs on the CPU devices tests/conftest.py provides."""

import functools
import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_accelerators_tpu import Accelerator, MeshConfig
from ray_lightning_accelerators_tpu import Callback as JaxCallback
from ray_lightning_accelerators_tpu import Trainer as JaxTrainer
from ray_lightning_accelerators_tpu.data.loader import (
    ArrayDataset as JaxArrayDataset, DataLoader as JaxDataLoader)
from ray_lightning_accelerators_tpu.models.transformer import (
    GPT as JaxGPT, TransformerConfig as JaxConfig)
from ray_lightning_accelerators_tpu.runtime import preemption as jp
from ray_lightning_accelerators_tpu_torch import (DataLoader, Preempted,
                                                  Trainer)
from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
from ray_lightning_accelerators_tpu_torch.models.transformer import (
    GPT, TransformerConfig)
from ray_lightning_accelerators_tpu_torch.runtime import bootstrap
from ray_lightning_accelerators_tpu_torch.runtime import preemption as tp
from ray_lightning_accelerators_tpu_torch.runtime.actors import Worker
from ray_lightning_accelerators_tpu_torch.runtime.bootstrap import (
    DistributedWorld)
from ray_lightning_accelerators_tpu_torch.utils import checkpoint as ckpt_lib
from ray_lightning_accelerators_tpu_torch.utils.weights import (
    params_from_jax)

from .torch_boring import (NoticeAt, attach_flag_dir, drain_body, ok,
                           sleep_forever)
from .utils import BoringModel as JaxBoring

pytestmark = pytest.mark.preempt

VOCAB, SEQ = 128, 32
CFG = dict(vocab_size=VOCAB, d_model=128, n_heads=2, d_ff=256, n_layers=2,
           max_seq_len=SEQ, loss_chunk_rows=100)


@pytest.fixture
def grace(monkeypatch):
    monkeypatch.setenv(tp.PREEMPT_GRACE_ENV, "60")
    yield
    for notice in (tp.get_notice(), jp.get_notice()):
        notice.clear()
        notice.uninstall()


def test_sigterm_sets_notice_and_flag_file(tmp_path, grace):
    notice = tp.get_notice()
    assert notice.install(flag_dir=str(tmp_path))
    notice.busy = True  # mid-dispatch: the handler drains, never exits
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert notice.requested()
        assert notice.source.startswith("signal-")
        assert os.path.exists(os.path.join(str(tmp_path), tp.FLAG_FILENAME))
        assert notice.remaining_s() <= 60.0
        other = tp.PreemptionNotice()
        other.attach_flag_dir(str(tmp_path))
        assert other.requested() and other.source == "flag-file"
    finally:
        notice.busy = False


def _tokens(n, seed=0):
    starts = np.random.default_rng(seed).integers(0, VOCAB, n)
    return ((starts[:, None] + np.arange(SEQ)[None]) % VOCAB).astype(np.int32)


class _JaxNoticeAt(JaxCallback):
    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        if trainer.global_step == 3:
            jp.get_notice().request_local("test-notice")


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.detach().numpy()
                               if isinstance(tree, torch.Tensor) else tree)}


def test_trainer_drain_and_resume_match_jax(tmp_path, grace):
    """Notice after step 3 of 6 (one epoch of 6 batches of 4): both
    Trainers write ``preempt-step3.ckpt`` and raise ``Preempted`` with
    step 3; a fresh ``fit(ckpt_path="last")`` on each resumes at step 3
    and runs steps 4-6 (the epoch replays from its first batch in both).
    f32; the final params within 1e-5 relative L2 per leaf."""
    jax_init = jax.device_get(JaxGPT(JaxConfig(**CFG)).init_params(
        jax.random.PRNGKey(0)))
    data = _tokens(24, seed=3)
    common = dict(max_steps=6, precision="f32", seed=0, guard=None,
                  prefetch_batches=0, cache_dataset_on_device=False,
                  log_every_n_steps=1)

    def jax_fit(root, ckpt_path=None, callbacks=()):
        m = JaxGPT(JaxConfig(**CFG), lr=3e-3)
        m.params = jax.tree.map(jnp.asarray, jax_init)
        t = JaxTrainer(accelerator=Accelerator(MeshConfig(data=1)),
                       default_root_dir=root, callbacks=list(callbacks),
                       **common)
        t.fit(m, JaxDataLoader(JaxArrayDataset(data), batch_size=4,
                               use_native=False), ckpt_path=ckpt_path)
        return t, m

    def port_fit(root, ckpt_path=None, callbacks=()):
        m = GPT(TransformerConfig(**CFG), device="cpu", lr=3e-3)
        m.params = params_from_jax(jax_init, device="cpu")
        t = Trainer(device="cpu", default_root_dir=root,
                    callbacks=list(callbacks), **common)
        t.fit(m, DataLoader(ArrayDataset(data), batch_size=4),
              ckpt_path=ckpt_path)
        return t, m

    out = {}
    for name, fit, cb, notice in (
            ("jax", jax_fit, _JaxNoticeAt(), jp.get_notice()),
            ("port", port_fit, NoticeAt(3), tp.get_notice())):
        root = str(tmp_path / name)
        with pytest.raises((Preempted, jp.Preempted)) as ei:
            fit(root, callbacks=[cb])
        assert ei.value.step == 3
        assert os.path.basename(ei.value.ckpt_path) == "preempt-step3.ckpt"
        assert os.path.abspath(ckpt_lib.latest_checkpoint(root)) == \
            os.path.abspath(ei.value.ckpt_path)
        notice.clear()
        t, m = fit(root, ckpt_path="last")
        assert t.global_step == 6
        out[name] = m.params
    assert isinstance(ei.value, Preempted)
    jp_, tp_ = _flat(jax.tree.map(np.asarray, out["jax"])), _flat(
        out["port"])
    assert jp_.keys() == tp_.keys()
    for name in jp_:
        assert _rel_l2(tp_[name], jp_[name]) <= 1e-5, name


def test_stale_flag_file_does_not_redrain_a_fresh_fit(tmp_path, grace):
    flag = tmp_path / tp.FLAG_FILENAME
    flag.write_text('{"source": "previous-drain"}')
    m = GPT(TransformerConfig(**CFG), device="cpu")
    t = Trainer(device="cpu", precision="f32", max_steps=2,
                default_root_dir=str(tmp_path), prefetch_batches=0,
                enable_checkpointing=False)
    t.fit(m, DataLoader(ArrayDataset(_tokens(8)), batch_size=4))
    assert t.global_step == 2
    assert not flag.exists()


def test_two_ranks_agree_on_the_drain(tmp_path, grace, monkeypatch):
    """Rank 1 alone sees the notice after step 3; with the consensus every
    2 steps both ranks drain at step 4, after rank 0's emergency
    checkpoint, and the world raises the typed ``Preempted``."""
    monkeypatch.setenv(tp.PREEMPT_CONSENSUS_EVERY_ENV, "2")
    data = np.random.default_rng(0).normal(size=(64, 32)).astype(np.float32)
    init = jax.tree.map(np.asarray, jax.device_get(
        JaxBoring().init_params(jax.random.PRNGKey(0))))
    saved = bootstrap.DEFAULT_TIMEOUT_S
    bootstrap.DEFAULT_TIMEOUT_S = 60.0
    world = DistributedWorld(2, devices=["cpu", "cpu"], timeout_s=60.0)
    try:
        results = world.run(functools.partial(
            drain_body, data=data, init=init, root=str(tmp_path)),
            deadline_s=120.0)
    finally:
        world.shutdown()
        bootstrap.DEFAULT_TIMEOUT_S = saved
    assert [r["step"] for r in results] == [4, 4]
    assert results[0]["ckpt_path"] == results[1]["ckpt_path"]
    path = results[0]["ckpt_path"]
    assert path.endswith("preempt-step4.ckpt") and os.path.exists(path)
    assert ckpt_lib.read_checkpoint(path)["global_step"] == 4
    assert results[1]["source"] == "test-notice"


def test_restart_of_a_notice_worker_is_fast_and_leaves_no_flag(tmp_path):
    """With ``RLA_TPU_PREEMPT_GRACE_S`` in its env a worker takes SIGTERM
    as a drain notice; ``restart`` and ``kill`` of a busy one send
    SIGKILL at once: no 10 s join, no flag file in the directory the
    worker's notice writes to."""
    flag_dir = str(tmp_path)
    w = Worker(0, env={"RLA_TPU_PREEMPT_GRACE_S": "30",
                       "RLA_TPU_WORKER_HEARTBEAT_S": "0.1"})
    try:
        assert w._sigterm_is_notice
        assert w.execute(attach_flag_dir, flag_dir).result(timeout=60)
        for end in ("restart", "kill"):
            w.execute(sleep_forever)
            deadline = time.monotonic() + 30
            while w.heartbeat.snapshot()["busy_s"] is None:
                assert time.monotonic() < deadline
                time.sleep(0.02)
            t0 = time.monotonic()
            getattr(w, end)()
            assert time.monotonic() - t0 < 3.0, end
            if end == "restart":
                assert w.execute(ok, 1).result(timeout=60) == 2
                assert w.execute(attach_flag_dir, flag_dir).result(
                    timeout=60)
        w._proc.join(timeout=10)
        assert w.exitcode == -signal.SIGKILL  # killed, not drained
        assert not os.path.exists(os.path.join(flag_dir, tp.FLAG_FILENAME))
    finally:
        w.kill()
