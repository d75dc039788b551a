"""Port parity for the mixture-of-experts GPT (``ops/moe.py`` and the MoE
paths of ``models/transformer.py`` in the PyTorch port) on the CPU, where
the port takes its kernels' plain versions.  The same seeded numpy inputs
and JAX-initialised weights (``params_from_jax``) go through both
packages: routing, the MoE MLP, the GPT's loss and gradients with the aux
loss, a 10-step ``Trainer.fit``, ``generate()``, the paged engine with a
prompt streamed in chunks (MoE capacity then comes from each chunk's
length), and ``quantize_weights`` on an MoE tree with the int8 engine.
Everything is float32; each tolerance is stated beside its check."""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_lightning_accelerators_tpu import Accelerator, MeshConfig
from ray_lightning_accelerators_tpu import Trainer as JaxTrainer
from ray_lightning_accelerators_tpu.core.callbacks import (
    Callback as JaxCallback)
from ray_lightning_accelerators_tpu.data.loader import (
    ArrayDataset as JaxArrayDataset, DataLoader as JaxDataLoader)
from ray_lightning_accelerators_tpu.models.transformer import (
    GPT as JaxGPT, TransformerConfig as JaxConfig)
from ray_lightning_accelerators_tpu.ops import moe as jax_moe
from ray_lightning_accelerators_tpu.serve import ServeEngine as JaxEngine
from ray_lightning_accelerators_tpu_torch import (Callback, DataLoader,
                                                  Trainer)
from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
from ray_lightning_accelerators_tpu_torch.models.transformer import (
    GPT, TransformerConfig)
from ray_lightning_accelerators_tpu_torch.ops import moe
from ray_lightning_accelerators_tpu_torch.serve import ServeEngine
from ray_lightning_accelerators_tpu_torch.utils.weights import (
    params_from_jax)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

VOCAB, SEQ = 128, 32
# 2 layers, d 64, 4 experts of d_ff 128, top-2 at the JAX default
# capacity factor 1.25 (so tokens are dropped)
CFG = dict(vocab_size=VOCAB, d_model=64, n_heads=2, d_ff=128, n_layers=2,
           max_seq_len=SEQ, num_experts=4, moe_top_k=2, loss_chunk_rows=40)
# XLA's exp and PyTorch's differ in the last bit on ~9% of f32 inputs, so
# the router probabilities (and the gates renormalised from them) may
# differ by a few ulps (measured <= 4): combine to 1e-6 absolute on
# weights <= 1.  Which token takes which slot does not depend on that.
COMBINE_ATOL = 1e-6


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _tokens(n, seed=0):
    starts = np.random.default_rng(seed).integers(0, VOCAB, n)
    return ((starts[:, None] + np.arange(SEQ)[None]) % VOCAB).astype(np.int32)


@pytest.fixture(scope="module")
def jax_init():
    return jax.device_get(JaxGPT(JaxConfig(**CFG)).init_params(
        jax.random.PRNGKey(0)))


# ---------------------------------------------------------------------- #
# ops/moe.py                                                              #
# ---------------------------------------------------------------------- #
def _capacity_overflow_logits():
    # tests/test_moe.py:36: every token wants expert 0, which holds 2
    lg = np.zeros((1, 8, 4), np.float32)
    lg[..., 0] = 10.0
    return lg


@pytest.mark.parametrize("case", ["top1", "top2", "top2_tight",
                                  "capacity_overflow"])
def test_top_k_routing_matches_jax(case):
    """Dispatch bitwise, combine to COMBINE_ATOL, aux to 1e-6 against the
    JAX ``top_k_routing`` on the same logits."""
    rng = np.random.default_rng(0)
    top_k, cap, logits = {
        "top1": (1, 16, rng.normal(size=(2, 16, 4))),
        "top2": (2, 16, rng.normal(size=(2, 16, 4))),
        "top2_tight": (2, 7, rng.normal(size=(3, 33, 8))),
        "capacity_overflow": (1, 2, _capacity_overflow_logits()),
    }[case]
    logits = logits.astype(np.float32)
    jd, jc, ja = jax_moe.top_k_routing(jnp.asarray(logits), top_k, cap)
    td, tc, ta = moe.top_k_routing(torch.from_numpy(logits), top_k, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=COMBINE_ATOL)
    assert float(ta) == pytest.approx(float(ja), abs=1e-6)
    kept = td.numpy().sum((1, 3))          # tokens each expert took
    assert kept.max() <= cap
    if case == "capacity_overflow":
        assert kept[0, 0] == 2 and kept[0, 1:].sum() == 0
    if case == "top2":                      # ample: every token twice
        np.testing.assert_array_equal(td.numpy().sum((2, 3)), 2.0)


def test_top_k_exceeding_experts_raises():
    with pytest.raises(ValueError, match="top_k"):
        moe.top_k_routing(torch.zeros(1, 4, 2), top_k=4, capacity=4)


@pytest.mark.parametrize("args", [(64, 4, 2, 1.0), (1, 8, 1, 1.0),
                                  (8, 4, 2, 1.25), (33, 8, 2, 1.25),
                                  (1024, 8, 2, 1.25)])
def test_expert_capacity_matches_jax(args):
    assert moe.expert_capacity(*args) == jax_moe.expert_capacity(*args)


def _moe_params(e, d=32, f=64):
    return jax.device_get(jax_moe.init_moe_params(jax.random.PRNGKey(3), d,
                                                  f, e))


def test_moe_single_expert_equals_dense_mlp():
    """E=1, k=1, ample capacity: the MoE MLP is the dense GELU MLP (the
    gate is a softmax over one expert, exactly 1); against the JAX MoE
    MLP too.  f32, summation order only: 1e-5."""
    p = _moe_params(1)
    x = np.random.default_rng(1).standard_normal((2, 8, 32)).astype(
        np.float32)
    tp = params_from_jax(p, device="cpu")
    y, _ = moe.moe_mlp(torch.from_numpy(x), tp, top_k=1,
                       capacity_factor=8.0, compute_dtype=torch.float32)
    up = torch.nn.functional.gelu(torch.from_numpy(x) @ tp["wi"][0],
                                  approximate="tanh")
    np.testing.assert_allclose(y.numpy(), (up @ tp["wo"][0]).numpy(),
                               atol=1e-5, rtol=1e-4)
    jy, _ = jax_moe.moe_mlp(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                            top_k=1, capacity_factor=8.0,
                            compute_dtype=jnp.float32)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)


@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
def test_moe_mlp_matches_jax(capacity_factor):
    """Output and aux of ``moe_mlp`` (4 experts, top-2) against the JAX
    one on the same input and expert weights, f32: 1e-5 absolute on the
    output, 1e-6 on aux.  At 1.25 tokens are dropped, at 8.0 none."""
    p = _moe_params(4)
    x = np.random.default_rng(2).standard_normal((2, 16, 32)).astype(
        np.float32)
    kw = dict(top_k=2, capacity_factor=capacity_factor)
    jy, ja = jax_moe.moe_mlp(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                             compute_dtype=jnp.float32, **kw)
    ty, ta = moe.moe_mlp(torch.from_numpy(x), params_from_jax(
        p, device="cpu"), compute_dtype=torch.float32, **kw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    assert float(ta) == pytest.approx(float(ja), abs=1e-6)


def test_moe_mlp_over_a_one_rank_mesh_is_the_plain_layer():
    """``moe_mlp(mesh=)`` on a single process's mesh (every axis 1, no
    groups) is the layer without one, bit for bit (the expert and
    sequence axes run over ranks: tests/test_torch_expert_parallel.py)."""
    from ray_lightning_accelerators_tpu_torch.parallel.mesh import (
        local_mesh)
    p = params_from_jax(_moe_params(4), device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 8, 32)).astype(np.float32))
    kw = dict(top_k=2, capacity_factor=1.0, compute_dtype=torch.float32)
    y, aux = moe.moe_mlp(x, p, **kw)
    ym, auxm = moe.moe_mlp(x, p, mesh=local_mesh(), **kw)
    assert torch.equal(y, ym) and torch.equal(aux, auxm)


# ---------------------------------------------------------------------- #
# the MoE GPT                                                              #
# ---------------------------------------------------------------------- #
def test_moe_init_params_shapes_and_scales():
    m = GPT(TransformerConfig(**CFG), device="cpu")
    p = m.init_params(0)["layers"]["mlp"]
    L, d, f, e = CFG["n_layers"], CFG["d_model"], CFG["d_ff"], \
        CFG["num_experts"]
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "router": (L, d, e), "wi": (L, e, d, f), "wo": (L, e, f, d)}
    assert abs(p["wi"].std().item() - d ** -0.5) < 0.01
    assert abs(p["wo"].std().item() - f ** -0.5) < 0.01


def test_moe_gpt_loss_aux_and_grads_match_jax(jax_init):
    """``training_step`` of the MoE GPT: the loss with
    ``moe_aux_weight * aux`` added, ``moe_aux_loss`` and the gradient of
    every leaf (router included) against the JAX GPT on the same weights
    and tokens.  f32 through 2 layers: loss and aux 1e-5 relative, each
    gradient leaf 1e-4 relative L2."""
    toks = _tokens(4, seed=3)
    jm = JaxGPT(JaxConfig(**CFG))
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jm.training_step(p, jnp.asarray(toks),
                                   jax.random.PRNGKey(0)),
        has_aux=True)(jax.tree.map(jnp.asarray, jax_init))
    tm = GPT(TransformerConfig(**CFG), device="cpu")
    tp = params_from_jax(jax_init, device="cpu")
    leaves = {k: v.requires_grad_() for k, v in _flat(tp).items()}
    tl, tmet = tm.training_step(tp, torch.from_numpy(toks))
    grads = torch.autograd.grad(tl, list(leaves.values()))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tmet["moe_aux_loss"].item(),
                               float(jmet["moe_aux_loss"]), rtol=1e-5)
    assert tmet["moe_aux_loss"].item() > 0
    jflat = {k: np.asarray(v) for k, v in _flat(jax.device_get(jg)).items()}
    assert jflat.keys() == leaves.keys()
    for (name, _), g in zip(leaves.items(), grads):
        assert _rel_l2(g.numpy(), jflat[name]) <= 1e-4, name
    # the forward's aux is the sum over layers, here of two positive terms
    _, aux = tm.forward(tp, torch.from_numpy(toks), return_aux=True)
    assert aux.item() == pytest.approx(tmet["moe_aux_loss"].item())


class _JaxParamsAfterStep(JaxCallback):
    def __init__(self):
        self.params = []

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        self.params.append(jax.device_get(trainer._state.params))


class _ParamsAfterStep(Callback):
    def __init__(self):
        self.params = []

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        self.params.append({k: v.detach().clone() for k, v in
                            _flat(trainer._state.params).items()})


def _routing(monkeypatch, routing_module, forward):
    """Each MoE layer's (router logits, dispatch) from ``forward()``, read
    at ``routing_module.top_k_routing``."""
    seen = []
    orig = routing_module.top_k_routing

    def spy(logits, top_k, capacity):
        out = orig(logits, top_k, capacity)
        seen.append((_np(logits).copy(), _np(out[0]).copy()))
        return out

    monkeypatch.setattr(routing_module, "top_k_routing", spy)
    forward()
    monkeypatch.setattr(routing_module, "top_k_routing", orig)
    return seen


def _unflat(flat):
    tree = {}
    for name, v in flat.items():
        node = tree
        *path, leaf = name.strip("/").split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


# the router-logit gap at a flipped token below which the flip counts as a
# near-tie: the two runs' f32 logits drift apart by ~3e-5 by step 6 here
# (logits of magnitude ~3), so a gap below 1e-4 can order either way
NEAR_TIE = 1e-4


def test_moe_fit_trajectory_matches_jax_trainer(jax_init, tmp_path,
                                                monkeypatch):
    """10 optimizer steps (2 epochs of 5 shuffled batches of 4) of the
    4-expert GPT from the same weights, on the JAX Trainer (one device,
    f32, guard off) and the port's, as the dense 10-step parity in
    test_torch_training.py, ``moe_aux_loss`` reported.

    Top-2 routing turns f32 drift between XLA and PyTorch (the gates
    differ by a few ulps, COMBINE_ATOL) into a discrete difference when a
    token's router logits nearly tie: its argmax rounds then pick its
    experts in another order, so another token takes the last capacity
    slot.  So the loss and aux loss are held within 2e-4 relative at every
    step before the first step whose dispatch (both packages'
    ``top_k_routing`` on each run's own params before the step) differs,
    and that first difference must be a near-tie: a flipped token's gap
    between consecutive router logits below NEAR_TIE.  After it, the
    trajectories may part: the loss within 1e-3 relative (measured 2.3e-4
    at the flip, step 7 on an 8-core x86 CPU) and the final params within
    1e-2 relative L2 per leaf (measured 5.8e-3, /embed).  Without a flip
    every step holds 2e-4 and the final params 1e-3."""
    data = _tokens(20, seed=5)
    common = dict(max_epochs=2, precision="f32", log_every_n_steps=1,
                  gradient_clip_val=0.5, enable_checkpointing=False, seed=0)
    jm = JaxGPT(JaxConfig(**CFG), lr=3e-3)
    jm.params = jax.tree.map(jnp.asarray, jax_init)
    jrec = _JaxParamsAfterStep()
    jt = JaxTrainer(accelerator=Accelerator(MeshConfig(data=1)), guard=None,
                    prefetch_batches=0, cache_dataset_on_device=False,
                    default_root_dir=str(tmp_path / "jax"), callbacks=[jrec],
                    **common)
    jloader = JaxDataLoader(JaxArrayDataset(data), batch_size=4,
                            shuffle=True, use_native=False)
    jt.fit(jm, jloader)
    tm = GPT(TransformerConfig(**CFG), device="cpu", lr=3e-3)
    tm.params = params_from_jax(jax_init, device="cpu")
    trec = _ParamsAfterStep()
    tt = Trainer(device="cpu", default_root_dir=str(tmp_path / "port"),
                 callbacks=[trec], **common)
    tt.fit(tm, DataLoader(ArrayDataset(data), batch_size=4, shuffle=True))
    jh = [r for r in jt.logger.history if "train_loss" in r]
    th = [r for r in tt.logger.history if "train_loss" in r]
    assert [r["step"] for r in th] == [r["step"] for r in jh] == \
        list(range(1, 11))
    assert len(jrec.params) == len(trec.params) == 10

    batches = []
    for epoch in range(2):
        jloader.set_epoch(epoch)
        batches += list(jloader)
    j_before = [jax_init] + jrec.params[:-1]
    t_before = [_flat(params_from_jax(jax_init, device="cpu"))] + \
        trec.params[:-1]
    flip = None
    for k, batch in enumerate(batches):
        with jax.disable_jit():   # the layer scan runs eagerly
            jr = _routing(monkeypatch, jax_moe, lambda: jm.forward(
                jax.tree.map(jnp.asarray, j_before[k]), jnp.asarray(batch)))
        with torch.no_grad():
            tr = _routing(monkeypatch, moe, lambda: tm.forward(
                _unflat(t_before[k]), torch.from_numpy(batch)))
        assert len(jr) == len(tr) == CFG["n_layers"]
        moved = [(jl, tl) for (jl, jd), (tl, td) in zip(jr, tr)
                 if not np.array_equal(jd, td)]
        if moved:
            flip = k
            break
        a, b = th[k], jh[k]
        assert a["train_loss"] == pytest.approx(b["train_loss"], rel=2e-4)
        assert a["moe_aux_loss"] == pytest.approx(b["moe_aux_loss"],
                                                  rel=2e-4)
    assert "moe_aux_loss" in tt.callback_metrics
    assert th[-1]["train_loss"] < th[0]["train_loss"]
    if flip is not None:
        # the tokens whose ordered expert choice differs, and their gaps
        gaps = []
        for jl, tl in moved:
            order_j = np.argsort(-jl, -1, kind="stable")[..., :2]
            order_t = np.argsort(-tl, -1, kind="stable")[..., :2]
            top = -np.sort(-jl, -1)[..., :3]
            for idx in zip(*np.nonzero(np.any(order_j != order_t, -1))):
                gaps.append(float(np.min(-np.diff(top[idx]))))
        assert gaps and max(gaps) < NEAR_TIE, gaps
        for a, b in zip(th[flip:], jh[flip:]):
            assert a["train_loss"] == pytest.approx(b["train_loss"],
                                                    rel=1e-3)
            assert a["moe_aux_loss"] == pytest.approx(b["moe_aux_loss"],
                                                      rel=1e-3)
    jp = {k: np.asarray(v) for k, v in _flat(jax.device_get(jm.params)
                                             ).items()}
    tp = {k: _np(v) for k, v in _flat(tm.params).items()}
    assert jp.keys() == tp.keys()
    bound = 1e-3 if flip is None else 1e-2
    for name in jp:
        assert _rel_l2(tp[name], jp[name]) <= bound, name


def _pair(capacity_factor=1.25, seed=1):
    cfg = {**CFG, "moe_capacity_factor": capacity_factor}
    jm = JaxGPT(JaxConfig(**cfg))
    jp = jax.device_get(jm.init_params(jax.random.PRNGKey(seed)))
    return jm, jp, GPT(TransformerConfig(**cfg), device="cpu")


def test_moe_generate_matches_jax():
    """Greedy ``generate()`` tokens equal the JAX ``generate()``'s at
    capacity factor 8.0 (no token dropped, so prefill and the one-token
    decode steps route alike; tests/test_generation.py:83)."""
    jm, jp, tm = _pair(capacity_factor=8.0)
    prompt = np.random.default_rng(1).integers(0, VOCAB, (2, 8)).astype(
        np.int32)
    ref = np.asarray(jm.generate(jp, jnp.asarray(prompt), 10))
    got = tm.generate(params_from_jax(jp, device="cpu"),
                      torch.from_numpy(prompt), 10)
    np.testing.assert_array_equal(got.numpy(), ref)


def _serve(engine_cls, model, params, prompts):
    with engine_cls(model, params, max_slots=2, queue_depth=8,
                    block_len=4) as eng:
        resps = []
        for i, (p, n) in enumerate(prompts):
            resps.append(eng.submit(p, n))
            if i % 2 == 1:
                time.sleep(0.02)
        outs = [r.result(timeout=300) for r in resps]
    return outs, eng.stats()


@pytest.mark.parametrize("kind", ["dense", "q8"])
def test_moe_engine_tokens_match_jax_engine(monkeypatch, kind):
    """The paged engine's greedy tokens equal the JAX engine's on the
    same MoE weights (f32, or int8 weight-only), at capacity factor 1.25
    with RLA_TPU_SERVE_CHUNK_BLOCKS=2: the 21-token prompt streams in as
    8-token chunks, each routed on its own capacity (ceil(8 * 2 * 1.25 /
    4) = 5 a row), so the port must cut its chunks where the JAX engine
    does.  The quantum under decode (RLA_TPU_SERVE_CHUNK_MIN_BLOCKS) is 2
    blocks too: at its default of 1 a chunk that runs beside a decoding
    request is 4 tokens, so where the chunks fall, and with them the
    routing, would follow each engine's timing."""
    monkeypatch.setenv("RLA_TPU_SERVE_CHUNK_BLOCKS", "2")
    monkeypatch.setenv("RLA_TPU_SERVE_CHUNK_MIN_BLOCKS", "2")
    jm, jp, tm = _pair()
    if kind == "q8":
        jp = jax.device_get(JaxGPT.quantize_weights(jp))
    rng = np.random.default_rng(7)
    prompts = [(rng.integers(0, VOCAB, 21).astype(np.int32), 6),
               (rng.integers(0, VOCAB, 5).astype(np.int32), 8),
               (rng.integers(0, VOCAB, 9).astype(np.int32), 5)]
    jouts, jst = _serve(JaxEngine, jm, jp, prompts)
    touts, tst = _serve(ServeEngine, tm, params_from_jax(jp, device="cpu"),
                        prompts)
    for t, j, (p, n) in zip(touts, jouts, prompts):
        assert t.shape == (p.size + n,)
        np.testing.assert_array_equal(t, np.asarray(j))
    for st in (tst, jst):
        assert st["completed"] == len(prompts)
        assert st["prefill_chunks"] >= len(prompts) + 2
    assert tst["block_pool_used"] == 0


def test_moe_capacity_follows_the_chunk():
    """At capacity factor 1.25 the 21-token prompt's logits differ when it
    is fed whole and when it is fed in chunks of 8 (the budget is each
    chunk's), while at 8.0 (nothing dropped) they agree: the test above
    compares something that depends on where the chunks are cut."""
    for cf, same in ((1.25, False), (8.0, True)):
        _, jp, tm = _pair(capacity_factor=cf)
        tp = params_from_jax(jp, device="cpu")
        toks = torch.from_numpy(np.random.default_rng(7).integers(
            0, VOCAB, (1, 21)))
        whole = tm.forward(tp, toks)[0, -1]
        pool = tm.paged_cache_alloc(8, 4)
        table = torch.arange(1, 8)
        for s in range(0, 21, 8):
            lg, pool = tm.decode_chunk_paged(tp, pool, table,
                                             toks[:, s:s + 8], s)
        close = torch.allclose(lg[0, -1], whole, atol=1e-4)
        assert close == same, cf


def test_moe_quantize_weights_bitwise():
    """``quantize_weights`` on an MoE tree equals the JAX one bit for bit:
    expert leaves [L,E,d,f] get a scale [L,1,1,f] shared across experts,
    the router [L,d,E] a scale [L,1,E]."""
    _, jp, _ = _pair()
    jq = jax.device_get(JaxGPT.quantize_weights(jp))
    tq = GPT.quantize_weights(params_from_jax(jp, device="cpu"))
    mlp = tq["layers"]["mlp"]
    L, e, f = CFG["n_layers"], CFG["num_experts"], CFG["d_ff"]
    assert tuple(mlp["wi"]["scale"].shape) == (L, 1, 1, f)
    assert tuple(mlp["router"]["scale"].shape) == (L, 1, e)
    jflat, tflat = _flat(jq), _flat(tq)
    assert jflat.keys() == tflat.keys()
    for k in jflat:
        np.testing.assert_array_equal(_np(tflat[k]), np.asarray(jflat[k]))
