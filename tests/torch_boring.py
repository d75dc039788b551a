"""Fixtures of the port's data-parallel tests, in a module that imports
no JAX: spawned ranks import it to unpickle the models, callbacks and
queue callables the tests ship them.  Port of tests/utils.py's
BoringModel, LinearClassifier, BlobsDataModule and helpers."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ray_lightning_accelerators_tpu_torch import (Callback, DataLoader,
                                                  DataModule,
                                                  ModelCheckpoint,
                                                  TorchModule, Trainer,
                                                  get_actor_rank, put_queue)
from ray_lightning_accelerators_tpu_torch.core.optim import SGD, AdamW
from ray_lightning_accelerators_tpu_torch.data.loader import (
    ArrayDataset, IterableDataset, RandomDataset)


class BoringModel(TorchModule):
    """One linear layer whose loss moves the weights, a constant
    val_loss of 1.0, and a val_epoch counter kept in checkpoints."""

    def __init__(self, device="cpu"):
        super().__init__(device=device)
        self.val_epoch = 0

    def init_params(self, seed=0):
        g = torch.Generator().manual_seed(seed)
        return {"layer": {"kernel": torch.randn(32, 2, generator=g) * 0.5,
                          "bias": torch.zeros(2)}}

    def forward(self, params, x):
        x = torch.as_tensor(x, dtype=torch.float32)
        return x @ params["layer"]["kernel"] + params["layer"]["bias"]

    def training_step(self, params, batch, generator):
        loss = torch.mean((self.forward(params, batch) - 1.0) ** 2)
        return loss, {"loss": loss}

    def validation_step(self, params, batch):
        self.forward(params, batch)
        return {"val_loss": torch.tensor(1.0)}

    def test_step(self, params, batch):
        return {"y": torch.mean((self.forward(params, batch) - 1.0) ** 2)}

    def on_validation_epoch_end(self):
        self.val_epoch += 1

    def configure_optimizers(self):
        return SGD(0.1)

    def on_save_checkpoint(self, checkpoint):
        checkpoint["val_epoch"] = self.val_epoch

    def on_load_checkpoint(self, checkpoint):
        self.val_epoch = checkpoint.get("val_epoch", self.val_epoch)


def boring_loaders(batch_size: int = 8):
    return (DataLoader(RandomDataset(32, 64), batch_size=batch_size,
                       shuffle=True),
            DataLoader(RandomDataset(32, 64), batch_size=batch_size))


class BlobsDataModule(DataModule):
    """Linearly separable 4-class blobs."""

    def __init__(self, n: int = 512, dim: int = 32, classes: int = 4,
                 batch_size: int = 16, seed: int = 0):
        rng = np.random.default_rng(seed)
        centers = rng.standard_normal((classes, dim)).astype(np.float32) * 4
        y = rng.integers(0, classes, size=n)
        x = centers[y] + rng.standard_normal((n, dim)).astype(np.float32)
        split = int(n * 0.75)
        self._train = (x[:split], y[:split].astype(np.int64))
        self._test = (x[split:], y[split:].astype(np.int64))
        self.batch_size = batch_size

    def train_dataloader(self):
        return DataLoader(ArrayDataset(*self._train),
                          batch_size=self.batch_size, shuffle=True)

    def val_dataloader(self):
        return DataLoader(ArrayDataset(*self._test),
                          batch_size=self.batch_size)

    def test_dataloader(self):
        return DataLoader(ArrayDataset(*self._test),
                          batch_size=self.batch_size, drop_last=False)


class LinearClassifier(TorchModule):
    def __init__(self, dim: int = 32, classes: int = 4, lr: float = 0.05,
                 device="cpu"):
        super().__init__(device=device)
        self.save_hyperparameters(dim=dim, classes=classes, lr=lr)
        self.dim, self.classes, self.lr = dim, classes, lr

    def init_params(self, seed=0):
        g = torch.Generator().manual_seed(seed)
        return {"w": torch.randn(self.dim, self.classes, generator=g) * 0.01,
                "b": torch.zeros(self.classes)}

    def forward(self, params, x):
        return torch.as_tensor(x) @ params["w"] + params["b"]

    def _loss(self, params, batch):
        x, y = batch
        logits = self.forward(params, x)
        loss = torch.nn.functional.cross_entropy(logits, y.long())
        return loss, torch.mean((logits.argmax(-1) == y).float())

    def training_step(self, params, batch, generator):
        loss, acc = self._loss(params, batch)
        return loss, {"loss": loss, "acc": acc}

    def validation_step(self, params, batch):
        loss, acc = self._loss(params, batch)
        return {"val_loss": loss, "val_accuracy": acc}

    def predict_step(self, params, batch):
        x = batch[0] if isinstance(batch, (tuple, list)) else batch
        return self.forward(params, x)

    def configure_optimizers(self):
        return AdamW(self.lr, weight_decay=0.0)


def get_trainer(dir, accelerator, max_epochs: int = 1,
                limit_train_batches: int = 10, limit_val_batches: int = 10,
                callbacks=None, **kwargs) -> Trainer:
    callbacks = list(callbacks or [])
    if not any(isinstance(c, ModelCheckpoint) for c in callbacks):
        callbacks.append(ModelCheckpoint(monitor="val_loss"))
    return Trainer(device="cpu", default_root_dir=str(dir),
                   max_epochs=max_epochs,
                   limit_train_batches=limit_train_batches,
                   limit_val_batches=limit_val_batches,
                   accelerator=accelerator, callbacks=callbacks,
                   precision="f32", seed=0, **kwargs)


def _abs_sums(params):
    return np.array([float(params["layer"][k].abs().sum())
                     for k in ("bias", "kernel")])


def train_test(trainer, model, train_loader=None, val_loader=None):
    """The weights the driver's module holds after fit moved."""
    if train_loader is None:
        train_loader, val_loader = boring_loaders()
    initial = _abs_sums(model.init_params(trainer.seed))
    trainer.fit(model, train_loader, val_loader)
    assert model.params is not None, "trainer failed"
    assert np.linalg.norm(initial - _abs_sums(model.params)) > 0.1, \
        "model unchanged post-training"


def load_test(trainer, model, cls=BoringModel):
    """The best checkpoint round trip."""
    train_loader, val_loader = boring_loaders()
    trainer.fit(model, train_loader, val_loader)
    best = trainer.checkpoint_callback.best_model_path
    assert best, "no best_model_path recorded"
    trained = cls.load_from_checkpoint(best)
    assert trained is not None and trained.params is not None


def predict_test(trainer, model, dm):
    """Accuracy >= 0.5 on held-out blobs with the driver's weights."""
    trainer.fit(model, datamodule=dm)
    dm.setup("test")
    correct = total = 0
    for x, y in dm.test_dataloader():
        y_hat = model.forward(model.params, torch.from_numpy(x)).cpu()
        correct += int((y_hat.argmax(-1).numpy() == y).sum())
        total += len(y)
    assert correct / total >= 0.5, f"accuracy {correct / total}"


# ------------------------------------------------------------------ #
# Reporting from inside the ranks through put_queue                   #
# ------------------------------------------------------------------ #
REPORTS: list = []


def record(item) -> None:
    """Runs in the driver: a rank's report."""
    REPORTS.append(item)


def report_hook() -> None:
    """An accelerator's init_hook: each rank reports that it ran it."""
    put_queue(functools.partial(record, ("init_hook", get_actor_rank())))


class SamplerProbe(Callback):
    """Sends each rank's injected samplers home at fit start."""

    def on_fit_start(self, trainer, module):
        val = trainer._val_loader
        put_queue(functools.partial(record, {
            "rank": get_actor_rank(),
            "train": _sampler_fields(trainer.train_dataloader.sampler),
            "val": _sampler_fields(val.sampler),
            "rows": next(iter(trainer.train_dataloader)).shape[0]}))


def _sampler_fields(s):
    return {"shuffle": s.shuffle, "num_replicas": s.num_replicas,
            "rank": s.rank}


class CountingStream(IterableDataset):
    """A ragged stream: ``n`` rows of 32 features, row i filled with i."""

    def __init__(self, n: int):
        self.n = n

    def __iter__(self):
        for i in range(self.n):
            yield np.full(32, i, np.float32)


# ------------------------------------------------------------------ #
# Rank bodies of the gradient-exchange tests (tests/test_torch_       #
# exchange.py): one rank's side of each collective                    #
# ------------------------------------------------------------------ #
def exchange_body(rank: int, mode, grads, residuals, layouts=None,
                  steps: int = 1, min_compress_size: int = 2048):
    """``steps`` exchanges of this rank's rows of the stacked ``grads``
    (``{name: [n, ...]}``) with its rows of ``residuals``: a leaf whose
    ``layouts`` entry names a dim takes the FSDP reduce-scatter into its
    owner (quantized when large, exact below the threshold), any other
    the replicated exchange.  Returns each step's outputs, the final
    residuals and the exchange's record."""
    from ray_lightning_accelerators_tpu_torch.parallel import \
        collectives as C
    cfg = C.ExchangeConfig(mode=mode, min_compress_size=min_compress_size)
    ex = C.GradExchange(torch.device("cpu"))
    res = {k: torch.from_numpy(np.array(v[rank]))
           for k, v in residuals.items()}
    outs = []
    for _ in range(steps):
        out = {}
        for k in sorted(grads):
            g = torch.from_numpy(np.array(grads[k][rank]))
            d = (layouts or {}).get(k)
            if C._leaf_regime(g, d, cfg) == "rs":
                out[k], res[k] = ex.exchange_rs_leaf(g, res[k], d, cfg)
            elif d is not None:
                (out[k],) = ex.reduce_scatter_mean([(g, d)])
            else:
                out[k], res[k] = ex.exchange_leaf(g, res[k], cfg)
        outs.append({k: v.numpy() for k, v in out.items()})
    return {"outs": outs, "res": {k: v.numpy() for k, v in res.items()},
            "stats": ex.stats()}


def gather_body(rank: int, shards, dim: int, wire_dtype=None):
    """The whole leaves rebuilt from every rank's ``shards[name][rank]``
    slice of ``dim``."""
    from ray_lightning_accelerators_tpu_torch.parallel import \
        collectives as C
    ex = C.GradExchange(torch.device("cpu"))
    names = sorted(shards)
    fulls = ex.gather_params(
        [(torch.from_numpy(np.array(shards[k][rank])), dim) for k in names],
        wire_dtype=wire_dtype)
    return {k: f.numpy() for k, f in zip(names, fulls)}


class WideModel(BoringModel):
    """tests/test_accelerators.py's WideModel: one 256x256 layer (large
    enough for the FSDP heuristic) over inputs zero-padded to 256."""

    def init_params(self, seed=0):
        g = torch.Generator().manual_seed(seed)
        return {"layer": {"kernel": torch.randn(256, 256, generator=g) * 0.05,
                          "bias": torch.zeros(256)}}

    def forward(self, params, x):
        x = torch.as_tensor(x, dtype=torch.float32)
        x = torch.cat([x, x.new_zeros(x.shape[0], 224)], -1)
        return x @ params["layer"]["kernel"] + params["layer"]["bias"]

    def training_step(self, params, batch, generator):
        return torch.mean((self.forward(params, batch) - 1.0) ** 2)


def run_code(code: str, rank: int) -> None:
    """``exec`` ``code`` in a rank (a world's ``run`` body): plants or
    removes a patch in the persistent worker processes."""
    exec(code, {})


# ------------------------------------------------------------------ #
# Rank bodies of the model-axes tests (tests/test_torch_seq_parallel.  #
# py, test_torch_expert_parallel.py): one rank's part of a function    #
# over a RankMesh                                                      #
# ------------------------------------------------------------------ #
def _leaf(a, grad=True):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def seq_attention_body(rank: int, mode, causal, q, k, v, g, shape):
    """``ring_attention_sharded`` / ``ulysses_attention_sharded`` over
    the GLOBAL ``q``, ``k``, ``v`` on this rank's mesh, and the
    gradients of ``sum(out * g)`` (``g`` global; each rank weighs its own
    chunk)."""
    from ray_lightning_accelerators_tpu_torch.parallel import (
        collectives as C, mesh as M, ring_attention as R, ulysses as U)
    mesh = M.build_rank_mesh(shape)
    C.MODEL_COMMS.reset()
    t = {"q": _leaf(q), "k": _leaf(k), "v": _leaf(v)}
    fn = (R.ring_attention_sharded if mode == "ring"
          else U.ulysses_attention_sharded)
    out = fn(t["q"], t["k"], t["v"], mesh, causal=causal)
    (out * R.seq_chunk(torch.from_numpy(np.array(g)), mesh)).sum() \
        .backward()
    return {"seq": mesh.coord("sequence"), "batch": mesh.batch_rank,
            "out": out.detach().numpy(),
            **{f"d{n}": x.grad.numpy() for n, x in t.items()},
            "comms": C.MODEL_COMMS.stats()}


def moe_seq_body(rank: int, x, params, g, shape, top_k, capacity_factor):
    """``moe_mlp`` on this rank's chunk of ``x`` over its mesh: the
    output chunk, the aux loss and the gradients of ``sum(y * g) +
    aux`` (``x``'s chunk, each param's partial)."""
    from ray_lightning_accelerators_tpu_torch.ops import moe
    from ray_lightning_accelerators_tpu_torch.parallel import mesh as M
    from ray_lightning_accelerators_tpu_torch.parallel.ring_attention \
        import seq_chunk
    mesh = M.build_rank_mesh(shape)
    xl = seq_chunk(torch.from_numpy(np.array(x)), mesh, 1).clone() \
        .requires_grad_(True)
    p = {k: _leaf(v) for k, v in params.items()}
    y, aux = moe.moe_mlp(xl, p, top_k=top_k,
                         capacity_factor=capacity_factor,
                         compute_dtype=torch.float32, mesh=mesh)
    gl = seq_chunk(torch.from_numpy(np.array(g)), mesh, 1)
    ((y * gl).sum() + aux).backward()
    return {"seq": mesh.coord("sequence"), "y": y.detach().numpy(),
            "aux": float(aux), "dx": xl.grad.numpy(),
            **{f"d{k}": v.grad.numpy() for k, v in p.items()}}


def vocab_loss_body(rank: int, logits, targets, shape, label_smoothing,
                    z_loss):
    """``vocab_parallel_cross_entropy`` on this rank's vocabulary slice of
    the global ``logits``: the sums and the slice's gradient of the loss
    sum."""
    from ray_lightning_accelerators_tpu_torch.ops.losses import (
        vocab_parallel_cross_entropy)
    from ray_lightning_accelerators_tpu_torch.parallel import mesh as M
    mesh = M.build_rank_mesh(shape)
    t, n = mesh.coord("tensor"), mesh.size("tensor")
    vl = logits.shape[1] // n
    lg = _leaf(logits[:, t * vl:(t + 1) * vl])
    ls, cs, cnt = vocab_parallel_cross_entropy(
        lg, torch.from_numpy(np.array(targets)).long(), mesh,
        label_smoothing=label_smoothing, z_loss=z_loss)
    ls.backward()
    return {"tensor": t, "loss": float(ls), "correct": float(cs),
            "n": float(cnt), "grad": lg.grad.numpy()}


def dp_fit_body(rank: int):
    """``Trainer.fit`` of the ``BoringModel`` inside a rank with no
    accelerator (as chip_smoke's 9b): the world is data parallel, one
    averaged exchange a step."""
    model = BoringModel()
    t = Trainer(device="cpu", max_steps=2, enable_checkpointing=False,
                precision="f32")
    t.fit(model, boring_loaders(batch_size=4)[0])
    return {"all_reduces": t._exchange.all_reduces,
            "mesh": dict(t._rank_mesh.shape),
            "batch_rank": t._rank_mesh.batch_rank,
            "kernel": model.params["layer"]["kernel"].numpy()}


def _tanh_stage(layers, x):
    """A stage of ``tanh(x @ w + b)`` layers (tests/test_pipeline.py's
    ``_stage_fn``): ``layers`` holds the stage's ``w [l, d, d]`` and
    ``b [l, d]``."""
    for i in range(layers["w"].shape[0]):
        x = torch.tanh(x @ layers["w"][i] + layers["b"][i])
    return x


def pipeline_body(rank: int, params, x, shape, microbatches,
                  device="cpu"):
    """``pipeline_apply`` of the ``tanh`` stack over this rank's mesh:
    each rank holds its stage's contiguous layers of the GLOBAL
    ``params``; returns the output and the gradients of ``sum(out**2)``
    for the stage's layers (on the host)."""
    from ray_lightning_accelerators_tpu_torch.parallel import (
        collectives as C, mesh as M, pipeline as P)
    mesh = M.build_rank_mesh(shape)
    C.MODEL_COMMS.reset()
    s, n = mesh.coord("pipeline"), mesh.size("pipeline")
    per = params["w"].shape[0] // n
    local = {k: torch.from_numpy(np.array(v[s * per:(s + 1) * per])).to(
        device).requires_grad_(True) for k, v in params.items()}
    out = P.pipeline_apply(_tanh_stage, local, torch.from_numpy(
        np.array(x)).to(device), mesh, microbatches)
    (out ** 2).sum().backward()
    return {"stage": s, "out": out.detach().cpu().numpy(),
            **{f"d{k}": v.grad.cpu().numpy() for k, v in local.items()},
            "comms": C.MODEL_COMMS.stats()}


def int8_scale_body(rank: int, w, shape, device="cpu"):
    """The int8 training product's quantization of this rank's rows of
    the GLOBAL ``w [K, N]`` (K split over the tensor axis, as the MLP's
    ``wo``): its int8 rows and the scales every rank shares (on the
    host)."""
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        _channel_quant)
    from ray_lightning_accelerators_tpu_torch.parallel import mesh as M
    mesh = M.build_rank_mesh(shape)
    t, n = mesh.coord("tensor"), mesh.size("tensor")
    k = w.shape[0] // n
    q8, scale, _ = _channel_quant(torch.from_numpy(np.array(
        w[t * k:(t + 1) * k])).to(device), mesh.group("tensor"))
    return {"tensor": t, "q8": q8.cpu().numpy(),
            "scale": scale.cpu().numpy()}
