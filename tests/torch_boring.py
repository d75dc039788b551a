"""Fixtures of the port's data-parallel tests, in a module that imports
no JAX: spawned ranks import it to unpickle the models, callbacks and
queue callables the tests ship them.  Port of tests/utils.py's
BoringModel, LinearClassifier, BlobsDataModule and helpers."""

from __future__ import annotations

import functools
import os
import time

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


class PipelineBoringModel(TorchModule):
    """BoringModel stretched to a depth-4 tanh MLP cut into contiguous
    pipeline stages: the MPMD parity and fault fixture
    (tests/test_torch_mpmd_*; port of tests/utils.py's).

    ``weights`` (a tree of numpy arrays or tensors, e.g. the JAX model's
    ``init_params(PRNGKey(0))``) makes ``init_params`` return them;
    without, the layers are drawn from a ``torch.Generator`` seeded with
    ``seed``.  The stage hooks slice the layer dict by global layer
    index, so the same params train identically in one process
    (``training_step``) and through the PipelineRunner."""

    DEPTH = 4

    def __init__(self, dim: int = 8, hidden: int = 16, lr: float = 0.1,
                 weights=None, device="cpu"):
        super().__init__(device=device)
        self.dim, self.hidden, self.lr = dim, hidden, lr
        self.weights = weights

    def init_params(self, seed=0):
        if self.weights is not None:
            return {name: {k: torch.as_tensor(np.array(v)).to(self.device)
                           for k, v in layer.items()}
                    for name, layer in self.weights.items()}
        g = torch.Generator().manual_seed(int(seed))
        sizes = [self.dim] + [self.hidden] * (self.DEPTH - 1) + [self.dim]
        return {f"l{i}": {
            "w": (torch.randn(sizes[i], sizes[i + 1], generator=g)
                  * 0.3).to(self.device),
            "b": torch.zeros(sizes[i + 1], device=self.device)}
            for i in range(self.DEPTH)}

    @staticmethod
    def _layer_indices(layers):
        return sorted(int(name[1:]) for name in layers)

    def _apply(self, layers, x):
        for i in self._layer_indices(layers):
            p = layers[f"l{i}"]
            x = torch.tanh(x @ p["w"] + p["b"])
        return x

    def forward(self, params, x):
        return self._apply(params, torch.as_tensor(x).to(self.device))

    def training_step(self, params, batch, generator=None):
        loss = torch.mean((self.forward(params, batch) - 1.0) ** 2)
        return loss, {"loss": loss}

    def configure_optimizers(self):
        return SGD(self.lr)

    def pipeline_stage_params(self, params, stage, num_stages):
        if self.DEPTH % num_stages:
            raise ValueError(
                f"{self.DEPTH} layers do not divide into "
                f"{num_stages} stages")
        per = self.DEPTH // num_stages
        return {f"l{i}": params[f"l{i}"]
                for i in range(stage * per, (stage + 1) * per)}

    def pipeline_stage_forward(self, stage_params, x, stage, num_stages):
        return self._apply(stage_params, x)

    def pipeline_loss(self, y, batch):
        loss = torch.mean((y - 1.0) ** 2)
        return loss, {"loss": loss}


class FaultyPipelineModel(PipelineBoringModel):
    """PipelineBoringModel whose stage hook faults at one stage and
    optimizer step: ``fault="crash"`` ends the worker process
    (``os._exit``), ``"hang"`` sleeps ``hang_s``.  With ``claim_dir``
    the fault fires once (the first worker to create the claim file
    there); without, on every attempt of that step."""

    def __init__(self, fault: str, stage: int, step: int, claim_dir=None,
                 hang_s: float = 600.0, **kwargs):
        super().__init__(**kwargs)
        self.fault, self.fault_stage, self.fault_step = fault, stage, step
        self.claim_dir, self.hang_s = claim_dir, hang_s

    def _claim(self) -> bool:
        if self.claim_dir is None:
            return True
        try:
            os.close(os.open(os.path.join(self.claim_dir, "fault.claim"),
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY))
            return True
        except FileExistsError:
            return False

    def pipeline_stage_forward(self, stage_params, x, stage, num_stages):
        from ray_lightning_accelerators_tpu_torch.parallel.mpmd import (
            stage as stage_lib)
        if stage == self.fault_stage \
                and stage_lib.current_step() == self.fault_step \
                and self._claim():
            if self.fault == "crash":
                os._exit(17)
            time.sleep(self.hang_s)
        return super().pipeline_stage_forward(stage_params, x, stage,
                                              num_stages)


# ------------------------------------------------------------------ #
# Tune: trainables of process trials (sent by name to the trial        #
# subprocess) and what the ranks of a trial's fit unpickle             #
# ------------------------------------------------------------------ #
def two_threads() -> None:
    """An accelerator's init_hook: two torch threads a rank."""
    torch.set_num_threads(2)


def report_pid(config):
    from ray_lightning_accelerators_tpu_torch import tune
    tune.report(loss=config["x"] ** 2, pid=float(os.getpid()))
    return "done"


def crash_or_report(config):
    from ray_lightning_accelerators_tpu_torch import tune
    if config["x"] > 1.5:
        os._exit(7)  # a hard crash: no exception, no cleanup
    tune.report(loss=config["x"])


def trainer_trial(config):
    """A fit in the trial's subprocess, reporting and checkpointing every
    epoch through the queue."""
    from ray_lightning_accelerators_tpu_torch import (
        TuneReportCheckpointCallback)
    torch.set_num_threads(2)
    trainer = Trainer(max_epochs=2, device="cpu", precision="f32", seed=0,
                      enable_checkpointing=False,
                      callbacks=[TuneReportCheckpointCallback(
                          {"loss": "val_loss"})],
                      default_root_dir=config["root"])
    trainer.fit(LinearClassifier(lr=config["lr"]),
                datamodule=BlobsDataModule(n=128, batch_size=16))


def loopy_trial(config):
    """Up to 12 reports, polling the scheduler's decision after each (a
    process trial's report is a synchronous query, so the next poll sees
    the decision for that report)."""
    from ray_lightning_accelerators_tpu_torch import tune
    for _ in range(12):
        tune.report(loss=config["loss"])
        if tune.trial_should_stop():
            return "stopped"
    return "completed"


class ScoredModel(BoringModel):
    """BoringModel logging a constant, config-set ``score``, so a
    scheduler's decisions on it are deterministic."""

    def __init__(self, score: float = 0.0, device="cpu"):
        super().__init__(device=device)
        self._score = float(score)

    def training_step(self, params, batch, generator):
        loss, metrics = super().training_step(params, batch, generator)
        return loss, dict(metrics, score=torch.tensor(self._score))


def nested_fit_trial(config):
    """A process trial whose fit runs over spawned ranks
    (``config["accelerator"]``: "ray" for ``RayAccelerator(1)``,
    "horovod" for ``HorovodRayAccelerator(2, 1)``): reports reach the
    tune driver through two query hops (rank -> this trial's world ->
    the driver), and a STOP comes back the same way to end the fit at
    that epoch boundary.  Returns the epochs completed."""
    from ray_lightning_accelerators_tpu_torch import (HorovodRayAccelerator,
                                                      RayAccelerator,
                                                      TuneReportCallback)
    torch.set_num_threads(2)
    acc = (RayAccelerator(1, init_hook=two_threads)
           if config["accelerator"] == "ray"
           else HorovodRayAccelerator(num_hosts=2, num_slots=1,
                                      init_hook=two_threads))
    x = np.random.default_rng(0).normal(size=(32, 32)).astype("float32")
    trainer = Trainer(max_epochs=6, device="cpu", precision="f32", seed=0,
                      enable_checkpointing=False, accelerator=acc,
                      callbacks=[TuneReportCallback({"score": "score"},
                                                    on="train_epoch_end")],
                      default_root_dir=config["root"])
    trainer.fit(ScoredModel(config["score"]),
                DataLoader(ArrayDataset(x), batch_size=8))
    return trainer.epochs_completed


def guard_trip_body(rank: int, data, init, root: str, compression=None,
                    cache=False):
    """A guarded ``Trainer.fit`` of the ``BoringModel`` inside a rank with
    no accelerator (a data-parallel world), on ``data`` (a planted NaN
    row trips the guard): what the trip said on this rank, or the fit's
    step count and this rank's kernel when nothing tripped."""
    from ray_lightning_accelerators_tpu_torch.runtime.guardian import (
        NumericAnomaly)
    model = BoringModel()
    model.params = {k: {n: torch.as_tensor(v) for n, v in leaf.items()}
                    for k, leaf in init.items()}
    t = Trainer(device="cpu", max_epochs=1, precision="f32", seed=0,
                enable_checkpointing=False, log_every_n_steps=1,
                default_root_dir=root, grad_compression=compression,
                cache_dataset_on_device=cache)
    try:
        t.fit(model, DataLoader(ArrayDataset(data), batch_size=8))
    except NumericAnomaly as e:
        return {"step": e.step, "epoch": e.epoch, "batch_idx": e.batch_idx,
                "blame": e.blame, "suspect_rank": e.suspect_rank,
                "flags": {k: v for k, v in e.diagnosis["flags"].items()
                          if isinstance(v, bool)}}
    return {"global_step": t.global_step,
            "kernel": model.params["layer"]["kernel"].numpy()}


# ------------------------------------------------------------------ #
# The recovery layer: light bodies of the watchdog, chaos, preemption  #
# and ElasticRunner tests (the JAX tests' own, on the port's runtime)  #
# ------------------------------------------------------------------ #
def ok(x=1):
    return x * 2


def crash(code=3):
    os._exit(code)


def sleep_forever():
    time.sleep(10_000)


def sleep_s(s):
    time.sleep(s)
    return s


def flaky(attempt, rank, blowup_attempts):
    """Rank 1 crashes during the first ``blowup_attempts`` attempts."""
    if rank == 1 and attempt < blowup_attempts:
        os._exit(17)
    return (attempt, rank)


def hang_on_first_attempt(attempt, rank):
    if attempt == 0 and rank == 1:
        time.sleep(10_000)
    return (attempt, rank)


def _write_json(path, doc):
    import json
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)  # atomic: a kill mid-write cannot tear it


def _read_json(path, default):
    import json
    if not os.path.exists(path):
        return default
    with open(path) as f:
        return json.load(f)


def ckpt_train_body(rank, ckpt_dir, total_steps):
    """Rank 0 saves its progress every step; every rank resumes from the
    saved step (``fit(ckpt_path="last")`` in miniature)."""
    path = os.path.join(ckpt_dir, "state.json")
    start = _read_json(path, {"step": 0})["step"]
    for step in range(start, total_steps):
        if rank == 0:
            _write_json(path, {"step": step + 1})
    return (rank, start, total_steps)


def preempt_train_body(rank, ckpt_dir, total_steps):
    """``ckpt_train_body`` that honours the drain: at every step boundary
    a raised notice saves the step and raises ``Preempted``."""
    from ray_lightning_accelerators_tpu_torch.runtime import preemption
    notice = preemption.get_notice()
    path = os.path.join(ckpt_dir, "state.json")
    start = _read_json(path, {"step": 0})["step"]
    for step in range(start, total_steps):
        if notice.requested():
            if rank == 0:
                _write_json(path, {"step": step})
            raise preemption.Preempted.at_step(step, path,
                                               source=notice.source)
        if rank == 0:
            _write_json(path, {"step": step + 1})
    return (rank, start, total_steps)


def world_train_body(logical_rank, world, ckpt_dir, total_steps):
    """A world-size-aware descent of L = w^2 with a barrier of files at
    every step: a missing peer stalls the step as a torn collective
    would, until the pool shrinks to the barrier's width."""
    path = os.path.join(ckpt_dir, "state.json")
    bdir = os.path.join(ckpt_dir, "barrier")
    os.makedirs(bdir, exist_ok=True)
    state = _read_json(path, {"step": 0, "w": 1.0, "worlds": []})
    w = state["w"]
    for step in range(state["step"], total_steps):
        open(os.path.join(bdir, f"s{step}.r{logical_rank}"), "w").close()
        deadline = time.monotonic() + 60.0
        while not all(os.path.exists(os.path.join(bdir, f"s{step}.r{r}"))
                      for r in range(world)):
            if time.monotonic() > deadline:
                raise RuntimeError(f"step {step} barrier lost a peer "
                                   f"(world={world})")
            time.sleep(0.02)
        w = w - 0.1 * (2.0 * w)  # dL/dw of L = w^2
        state = {"step": step + 1, "w": w,
                 "worlds": state["worlds"] + [world]}
        if logical_rank == 0:
            _write_json(path, state)
    return (logical_rank, world, state["step"], w)


def anomaly_once_body(attempt):
    if attempt == 0:
        from ray_lightning_accelerators_tpu_torch.runtime.guardian import (
            NumericAnomaly)
        raise NumericAnomaly.for_trip(step=5, blame="data", epoch=0,
                                      batch_idx=5)
    return "ok"


def anomaly_same_step_body(attempt):
    from ray_lightning_accelerators_tpu_torch.runtime.guardian import (
        NumericAnomaly)
    raise NumericAnomaly.for_trip(step=7, blame="data", epoch=0,
                                  batch_idx=7)


def anomaly_roaming_body(attempt):
    from ray_lightning_accelerators_tpu_torch.runtime.guardian import (
        NumericAnomaly)
    raise NumericAnomaly.for_trip(step=100 + attempt, blame="unknown")


def sdc_once_body(attempt, rank):
    if attempt == 0 and rank == 0:
        from ray_lightning_accelerators_tpu_torch.runtime.guardian import (
            NumericAnomaly)
        raise NumericAnomaly.for_trip(step=9, blame="sdc", suspect_rank=1)
    return ("ok", rank)


def badbatch_fit_body(coord, rank, root, data, init):
    """One attempt of a guarded 2-rank fit of the ``BoringModel`` (gloo,
    CPU): every attempt forms its group on ``coord``, fits 2 epochs with
    ``ckpt_path="last"`` (the quarantine ledger in ``root`` is shared by
    the attempts) and returns rank 0's step count, last loss and
    weights."""
    import torch.distributed as dist

    from ray_lightning_accelerators_tpu_torch.runtime.bootstrap import (
        initialize_worker)
    initialize_worker(coord, 2, rank, "cpu", "gloo", timeout_s=60.0)
    try:
        model = BoringModel()
        model.params = {k: {n: torch.as_tensor(v) for n, v in leaf.items()}
                        for k, leaf in init.items()}
        t = Trainer(device="cpu", max_epochs=2, precision="f32", seed=0,
                    default_root_dir=root, log_every_n_steps=1,
                    enable_checkpointing=False, prefetch_batches=0)
        t.fit(model, DataLoader(ArrayDataset(data), batch_size=8),
              ckpt_path="last")
        return (t.global_step, float(t.callback_metrics["train_loss"]),
                {k: {n: v.detach().numpy() for n, v in leaf.items()}
                 for k, leaf in model.params.items()})
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def attach_flag_dir(path):
    """In a worker: carry its preemption notice's flag file in ``path``;
    whether the notice handler is installed."""
    from ray_lightning_accelerators_tpu_torch.runtime import preemption
    notice = preemption.get_notice()
    notice.attach_flag_dir(path)
    return notice._installed


class NoticeAt(Callback):
    """Raises this process's preemption notice after global step
    ``step`` (on ``rank`` only, when given)."""

    def __init__(self, step, rank=None):
        self.step, self.rank = step, rank

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        from ray_lightning_accelerators_tpu_torch.runtime import preemption
        if trainer.global_step == self.step and \
                self.rank in (None, trainer.global_rank):
            preemption.get_notice().request_local("test-notice")


def drain_body(rank: int, data, init, root: str):
    """A 2-rank fit whose notice is raised on rank 1 alone after step 3:
    the ranks agree on the drain (``consensus_requested``) and both
    raise ``Preempted`` at the same step after the emergency
    checkpoint."""
    from ray_lightning_accelerators_tpu_torch.runtime import preemption
    model = BoringModel()
    model.params = {k: {n: torch.as_tensor(v) for n, v in leaf.items()}
                    for k, leaf in init.items()}
    t = Trainer(device="cpu", max_epochs=1, precision="f32", seed=0,
                default_root_dir=root, prefetch_batches=0,
                callbacks=[NoticeAt(3, rank=1)])
    try:
        t.fit(model, DataLoader(ArrayDataset(data), batch_size=8))
    except preemption.Preempted as e:
        return {"step": e.step, "ckpt_path": e.ckpt_path,
                "source": e.info.get("source")}
    finally:
        preemption.get_notice().clear()
    return {"global_step": t.global_step}


def handoff_timeout_body(src):
    """Raise a stage's handoff timeout naming ``src`` as the sender."""
    from ray_lightning_accelerators_tpu_torch.parallel.mpmd.handoff import (
        PipelineHandoffTimeout)
    raise PipelineHandoffTimeout.for_wait(
        stage=0, kind="grad", src=src, microbatch=2, lane=0, step=3,
        timeout_s=2.0)


# ------------------------------------------------------------------ #
# Host agents and the live resize (tests/test_torch_agent*.py,        #
# tests/test_torch_resize.py)                                         #
# ------------------------------------------------------------------ #
class AdamBoringModel(BoringModel):
    """BoringModel under Adam: optimizer moments that ZeRO-1 slices, so
    a resize moves bytes."""

    def configure_optimizers(self):
        return AdamW(0.1, weight_decay=0.0)


def env_value(key):
    return os.environ.get(key)


def raise_value_error(msg):
    raise ValueError(msg)


def pid_and_rank():
    from ray_lightning_accelerators_tpu_torch.runtime.session import (
        session_exists)
    return os.getpid(), session_exists()


def hang_frozen():
    """Freeze this worker's heartbeat, then hang: a wedge."""
    from ray_lightning_accelerators_tpu_torch.runtime.actors import (
        freeze_current_heartbeat)
    freeze_current_heartbeat()
    time.sleep(10_000)


def write_launch_env(path):
    """A script body for ``cli launch``: what the script saw."""
    import json
    import sys
    with open(path, "w") as f:
        json.dump({"agents": os.environ.get("RLA_TPU_AGENTS"),
                   "argv": sys.argv}, f)


def mem_world_body(logical_rank, world, wire_dir, total_steps):
    """tests/test_resize.py's ``_mem_world_body``: a full-batch descent
    that keeps its state in process memory across dispatches (the
    stand-in for a trainer's live state under ``resize_in_memory``).  A
    fresh process has none and joins from ``livestate.json``, which the
    survivors publish at dispatch entry (the in-memory redistribution's
    analog, not a checkpoint); a barrier of files keyed by (step, world)
    stalls a step whose peer is missing, as a torn collective would."""
    import builtins
    import json

    live = os.path.join(wire_dir, "livestate.json")
    bdir = os.path.join(wire_dir, "barrier")
    os.makedirs(bdir, exist_ok=True)
    state = getattr(builtins, "_rla_mem_state", None)
    resumed = "mem"
    if state is None:
        if os.path.exists(live):
            with open(live) as f:
                state = json.load(f)
            resumed = "wire"
        else:
            state = {"step": 0, "w": 1.0, "worlds": []}
            resumed = "fresh"
    if logical_rank == 0:
        _write_json(live, state)
    hiccup = os.path.join(wire_dir, "hiccup.flag")
    for step in range(state["step"], total_steps):
        open(os.path.join(bdir, f"s{step}.w{world}.r{logical_rank}"),
             "w").close()
        # JAX's body waits 15 s: a peer that is alive reaches the
        # barrier well inside 6 s, so the lost peer costs less
        deadline = time.monotonic() + 6.0
        while not all(os.path.exists(
                os.path.join(bdir, f"s{step}.w{world}.r{r}"))
                for r in range(world)):
            if time.monotonic() > deadline:
                raise RuntimeError(f"step {step} barrier lost a peer "
                                   f"(world={world})")
            time.sleep(0.02)
        w = state["w"]
        state = {"step": step + 1, "w": w - 0.1 * (2.0 * w),
                 "worlds": state["worlds"] + [world]}
        builtins._rla_mem_state = state
        if world == 1 and not os.path.exists(hiccup):
            # an engineered failure after the shrink: one more retry,
            # during which the rejoining host grows the world back
            open(hiccup, "w").close()
            raise RuntimeError("post-shrink hiccup")
    return (logical_rank, resumed, world, state["step"], state["w"],
            state["worlds"])


def ckpt_fallback_body(logical_rank, world, ckpt_dir, total_steps):
    """tests/test_resize.py's ``_ckpt_fallback_body``: state kept in
    memory like ``mem_world_body``, and the checkpoint chain kept current
    as the fallback when no process survives."""
    import builtins

    path = os.path.join(ckpt_dir, "state.json")
    state = getattr(builtins, "_rla_ckpt_mem", None)
    resumed = "mem"
    if state is None:
        if os.path.exists(path):
            state = _read_json(path, None)
            resumed = "ckpt"
        else:
            state = {"step": 0, "w": 1.0}
            resumed = "fresh"
    for step in range(state["step"], total_steps):
        state = {"step": step + 1,
                 "w": state["w"] - 0.1 * (2.0 * state["w"])}
        builtins._rla_ckpt_mem = state
        if logical_rank == 0:
            _write_json(path, state)
    return (logical_rank, resumed, state["step"], state["w"])


class CrashMidFit(Callback):
    """tests/test_fault_tolerance.py's CrashMidFit: on the first attempt
    rank 1 dies at the end of epoch 1 (two epochs ran, a ``save_last``
    checkpoint exists)."""

    def __init__(self, attempt, rank):
        self.attempt, self.rank = attempt, rank

    def on_train_epoch_end(self, trainer, module):
        if self.attempt == 0 and self.rank == 1 \
                and trainer.current_epoch == 1:
            os._exit(23)


def elastic_fit_body(coord, attempt, rank, root):
    """tests/test_fault_tolerance.py's ``_elastic_fit_body``: a world of 2
    formed at ``coord`` fits 3 epochs of the BoringModel, resuming from
    the last checkpoint; rank 1 dies at the end of epoch 1 on the first
    attempt.  The loader's 16 rows are the global batch (8 a rank, the
    JAX test's per-process batch): 4 steps an epoch."""
    import torch.distributed as dist

    from ray_lightning_accelerators_tpu_torch.runtime import bootstrap
    if dist.is_initialized():
        dist.destroy_process_group()
    bootstrap.initialize_worker(coord, 2, rank, "cpu", "gloo",
                                timeout_s=60.0)
    x = np.random.default_rng(0).normal(size=(64, 32)).astype("float32")
    trainer = Trainer(device="cpu", max_epochs=3, precision="f32", seed=0,
                      default_root_dir=root,
                      callbacks=[ModelCheckpoint(monitor=None,
                                                 save_last=True),
                                 CrashMidFit(attempt, rank)])
    model = BoringModel()
    trainer.fit(model, DataLoader(ArrayDataset(x), batch_size=16),
                ckpt_path="last")
    leaf = model.params["layer"]["kernel"].double()
    out = (rank, trainer.current_epoch, trainer.global_step,
           float(leaf.sum()))
    dist.destroy_process_group()
    return out


# ------------------------------------------------------------------ #
# The live plane's tests (tests/test_torch_live.py)                    #
# ------------------------------------------------------------------ #
def emit_steps(n):
    """Emit ``n`` train_step events in this worker's recorder."""
    from ray_lightning_accelerators_tpu_torch.telemetry import emit
    for i in range(n):
        emit("train_step", step=i)
    return n


class SlowSteps(Callback):
    """Sleeps ``s`` seconds after each training batch, so a fit lasts
    long enough to be scraped while it steps."""

    def __init__(self, s: float):
        self.s = s

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        time.sleep(self.s)


def cuda_initialized() -> bool:
    """In a worker: whether CUDA is initialised in this process (a worker
    forked from the preloaded forkserver must start without it)."""
    return bool(torch.cuda.is_initialized())


def jax_weights_engine(config, np_params, **engine_kwargs):
    """A replica's engine factory for the CPU tests (it pickles by name):
    an unstarted ``ServeEngine`` over the GPT of ``config`` on the CPU
    with the JAX package's weights (a numpy tree), this process's torch
    threads capped at 2."""
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    from ray_lightning_accelerators_tpu_torch.serve import ServeEngine
    from ray_lightning_accelerators_tpu_torch.utils.weights import (
        params_from_jax)
    torch.set_num_threads(2)
    model = GPT(TransformerConfig(**config), device="cpu")
    return ServeEngine(model, params_from_jax(np_params, device="cpu"),
                       **engine_kwargs)


# ------------------------------------------------------------------ #
# Rank bodies of the SPMD sanitizer tests (tests/test_torch_spmd_     #
# safety.py); the sanitizer was installed at worker boot from the     #
# env overlay (RLA_TPU_SPMD_SANITIZER + RLA_TPU_TELEMETRY_DIR)        #
# ------------------------------------------------------------------ #
def raise_collective_mismatch():
    from ray_lightning_accelerators_tpu_torch.testing.spmd_sanitizer import (
        CollectiveMismatch)
    raise CollectiveMismatch.from_divergence({
        "first_divergence": 2,
        "per_rank": {"rank0": {"op": "all_reduce", "axes": ["data"],
                               "shape": [8], "dtype": "float32",
                               "site": "parallel/collectives.py:200"},
                     "rank1": None},
        "lengths": {"rank0": 3, "rank1": 2}})


def solo_world_collectives(rank: int, divergent_rank: int) -> float:
    """Each worker in a gloo world of its own (one rank, an in-process
    store): an all_reduce, and on ``divergent_rank`` one more -- the
    injected drift the sanitizer exists to catch, in a world where the
    extra call cannot block."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        t = torch.ones(4)
        dist.all_reduce(t)
        if rank == divergent_rank:  # the rank-divergent collective
            dist.all_reduce(t)
        return float(t[0])
    finally:
        dist.destroy_process_group()


def batch_mean_body(rank: int) -> list:
    """A ``GradExchange`` mean over the batch group of a data=2 mesh in
    a formed world: every rank issues the same sequence."""
    from ray_lightning_accelerators_tpu_torch.parallel import (
        collectives as C, mesh as M)
    torch.set_num_threads(1)
    mesh = M.build_rank_mesh({M.DATA_AXIS: 2})
    ex = C.GradExchange(torch.device("cpu"), mesh)
    out = ex.mean([torch.full((3,), float(rank)), torch.ones(2)])
    return [t.tolist() for t in out]


def divergent_then_block(rank: int, coordinator: str) -> int:
    """A world of 2 over ``coordinator``: one all_reduce on both ranks,
    then rank 1 issues one more, which blocks (rank 0 never joins) --
    the hang a rank-divergent collective causes."""
    import datetime

    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    t = torch.ones(4)
    dist.all_reduce(t)
    if rank == 1:
        dist.all_reduce(t)
    return rank


# ------------------------------------------------------------------ #
# The scan gather (tests/test_torch_scan_gather.py)                   #
# ------------------------------------------------------------------ #
SCANNED_LAYERS, SCANNED_DIM, SCANNED_CLASSES = 3, 64, 4


def scanned_mlp_init(seed: int = 0) -> dict:
    """``ScannedMLP``'s weights as numpy (the JAX test module's too)."""
    rng = np.random.default_rng(seed)
    n, d, c = SCANNED_LAYERS, SCANNED_DIM, SCANNED_CLASSES
    return {"layers": {
        "w": (rng.standard_normal((n, d, d)) * 0.15).astype(np.float32),
        "s": (1.0 + 0.1 * rng.standard_normal((n, d))).astype(np.float32)},
        "head": (rng.standard_normal((d, c)) * 0.2).astype(np.float32)}


def scanned_data(n: int = 128, seed: int = 0):
    """(x [n, 64] f32, y [n] int32): classes from a fixed projection."""
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((n, SCANNED_DIM)).astype(np.float32)
    proj = rng.standard_normal((SCANNED_DIM, SCANNED_CLASSES))
    return x, np.argmax(x @ proj, axis=1).astype(np.int32)


class ScannedMLP(TorchModule):
    """A stack of tanh layers run a layer at a time, declared as a scanned
    subtree (the GPT's pattern): ``layers.w [3, 64, 64]``, ``layers.s
    [3, 64]``, ``head [64, 4]``, Adam 1e-2.  Each layer takes the scan
    gather's hook (``current_layer_gather``) at its top, prefetching the
    next layer."""

    def __init__(self, device="cpu"):
        super().__init__(device=device)

    def init_params(self, seed=0):
        init = scanned_mlp_init(seed)
        return {"layers": {k: torch.from_numpy(v)
                           for k, v in init["layers"].items()},
                "head": torch.from_numpy(init["head"])}

    def scanned_param_subtrees(self):
        return ("layers",)

    def forward(self, params, x):
        from ray_lightning_accelerators_tpu_torch.parallel import \
            collectives as C
        gather = C.current_layer_gather("layers")
        h = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        layers = [{"s": s, "w": w} for s, w in zip(
            params["layers"]["s"].unbind(0), params["layers"]["w"].unbind(0))]
        for i, lp in enumerate(layers):
            if gather is not None:
                lp = gather(lp, prefetch=layers[i + 1]
                            if i + 1 < len(layers) else None)
            h = torch.tanh((h @ lp["w"]) * lp["s"])
        return h @ params["head"]

    def training_step(self, params, batch, generator):
        x, y = batch
        loss = torch.nn.functional.cross_entropy(
            self.forward(params, x),
            torch.as_tensor(y, device=self.device).long())
        return loss, {"loss": loss}

    def configure_optimizers(self):
        return AdamW(1e-2, weight_decay=0.0)


def scan_gather_body(rank: int, shape, params, layouts, x, y) -> dict:
    """The scan gather at the function level on this rank's mesh:
    ``build_scan_param_gather``'s prelude over this rank's slices of
    ``params`` (``layouts``: each leaf's split dim or None), the hook on
    layer 1 alone, then ``ScannedMLP``'s loss on this rank's contiguous
    block of rows under ``layer_gather_scope`` and its gradients finished
    by ``build_scan_local_grads``."""
    from ray_lightning_accelerators_tpu_torch.parallel import (
        collectives as C, mesh as M)
    torch.set_num_threads(2)
    mesh = M.build_rank_mesh(shape)
    ex = C.GradExchange(torch.device("cpu"), mesh)
    scanned = ("layers",)
    prelude, hooks = C.build_scan_param_gather(ex, layouts, scanned)
    finish = C.build_scan_local_grads(ex, layouts, scanned)

    def part(a, d):
        t = torch.from_numpy(np.array(a))
        if d is None:
            return t
        k = t.shape[d] // ex.nf
        return t.narrow(d, ex.frank * k, k)

    local = C.tree_like(params, [
        part(a, d).clone().requires_grad_(True)
        for a, d in zip(C._flat(params), C._flat(layouts))])
    view = prelude(local)
    one = hooks["layers"]({"s": view["layers"]["s"][1],
                           "w": view["layers"]["w"][1]})
    rows = len(x) // ex.world
    block = slice(ex.rank * rows, (ex.rank + 1) * rows)
    leaves = C._flat(view)
    with C.layer_gather_scope(hooks):
        loss, _ = ScannedMLP().training_step(view, (x[block], y[block]),
                                             None)
    grads = finish(list(torch.autograd.grad(loss, leaves)))
    return {"gathered": one["w"].detach().numpy(),
            "loss": float(loss.detach()),
            "grads": [g.detach().numpy() for g in grads],
            "kinds": list(finish.kinds),
            "layer_collectives": dict(ex.layer_counts),
            "coords": {"data": mesh.coord(M.DATA_AXIS),
                       "fsdp": mesh.coord(M.FSDP_AXIS)}}


class BuildCounts(Callback):
    """Sends home each rank's count of kernel and library builds at the
    end of every training step (``compile_count``)."""

    def __init__(self):
        self.counts = []

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        from ray_lightning_accelerators_tpu_torch.analysis.compile_guard \
            import compile_count
        self.counts.append(compile_count())

    def on_fit_end(self, trainer, module):
        put_queue(functools.partial(record, ("builds", get_actor_rank(),
                                             list(self.counts))))


def live_run_keys(rank: int) -> list:
    """The run keys whose live state this rank keeps (a world's ``run``
    body)."""
    from ray_lightning_accelerators_tpu_torch.core import trainer as T
    return sorted(T._LIVE_RUNS)
