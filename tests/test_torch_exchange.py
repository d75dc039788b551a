"""The port's gradient exchange against the JAX package's
(parallel/collectives.py): the block quantizer bitwise, then the
replicated two-phase exchange (int8, bf16), the FSDP reduce-scatter into
the owner and the bf16 param all-gather between 2 gloo ranks, against
the JAX ``shard_map`` versions on a 2-device mesh with the same stacked
gradients and residuals; then the JAX package's own error-bound and
error-feedback tests (tests/test_collectives.py:68-128,
tests/test_fsdp_exchange.py:45-117) on the port's ranks.

One world of 2 CPU ranks serves the module; the rank bodies live in
tests/torch_boring.py (no JAX).  The world's rendezvous and collectives
fail after ``bootstrap.DEFAULT_TIMEOUT_S`` (60 s here)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ray_lightning_accelerators_tpu.parallel import collectives as JC
from ray_lightning_accelerators_tpu.parallel import mesh as jax_mesh
from ray_lightning_accelerators_tpu.parallel import sharding as jax_sharding
from ray_lightning_accelerators_tpu_torch.parallel import collectives as C
from ray_lightning_accelerators_tpu_torch.runtime import bootstrap
from ray_lightning_accelerators_tpu_torch.runtime.bootstrap import (
    DistributedWorld)

from . import torch_boring

pytestmark = pytest.mark.collectives
N = 2


@pytest.fixture(scope="module")
def world():
    saved = bootstrap.DEFAULT_TIMEOUT_S
    bootstrap.DEFAULT_TIMEOUT_S = 60.0
    w = DistributedWorld(N, devices=["cpu"] * N, timeout_s=60.0)
    try:
        yield w
    finally:
        w.shutdown()
        bootstrap.DEFAULT_TIMEOUT_S = saved


def _run(world, body, **kw):
    return world.run(functools.partial(body, **kw), deadline_s=120.0)


def _stacked(mesh, tree):
    lead = NamedSharding(mesh, P(jax_mesh.BATCH_AXES))
    return jax.tree.map(lambda a: jax.device_put(jnp.asarray(a), lead), tree)


def _dp_mesh():
    return jax_mesh.build_mesh(jax_mesh.MeshConfig(data=N),
                               devices=jax.devices()[:N])


def _fsdp_mesh():
    return jax_mesh.build_mesh(jax_mesh.MeshConfig(data=1, fsdp=N),
                               devices=jax.devices()[:N])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# --------------------------------------------------------------------- #
# The block quantizer                                                    #
# --------------------------------------------------------------------- #
def test_quantize_blocks_bitwise_with_jax():
    """q bitwise, scales to 1 ulp, on random blocks, an all-zero block
    (scale 1, q 0) and a block of exact .5 ties (maxabs 127 gives scale
    1.0: 2.5 -> 2, 3.5 -> 4, -0.5 -> -0, half to even as ``jnp.round``).
    The port divides ``maxabs / 127`` (as eager JAX does: equal scales);
    under ``jax.jit`` XLA multiplies by the reciprocal instead, which
    moves some scales by 1 ulp: 166 of 4000 blocks of random normals
    (4.15%, measured below; limit 20%), q still bitwise."""
    rng = np.random.default_rng(0)
    ties = np.array([127.0, 2.5, 3.5, -0.5, 0.5, -2.5, 1.5, -126.5] * 32,
                    np.float32)
    v = np.concatenate([rng.normal(size=4096).astype(np.float32),
                        np.zeros(256, np.float32), ties,
                        (rng.normal(size=256) * 1e-30).astype(np.float32)])
    jq, js = JC.quantize_blocks(jnp.asarray(v), 256)
    q, s = C.quantize_blocks(torch.from_numpy(v), 256)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.dtype == torch.int8 and s.shape == (len(v) // 256,)
    assert s[16].item() == 1.0 and not q[16].any()      # the zero block
    assert s[17].item() == 1.0 and q[17, :8].tolist() == \
        [127, 2, 4, 0, 0, -2, 2, -126]
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        C.dequantize_blocks(q, s).numpy(),
        np.asarray(JC.dequantize_blocks(jq, js)))
    jit_quantize = jax.jit(JC.quantize_blocks, static_argnums=1)
    jit_q, jit_s = jit_quantize(jnp.asarray(v), 256)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jit_q))
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(jit_s), maxulp=1)
    big = np.random.default_rng(0).normal(size=256 * 4000).astype(np.float32)
    q, s = C.quantize_blocks(torch.from_numpy(big), 256)
    jit_q, jit_s = jit_quantize(jnp.asarray(big), 256)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jit_q))
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(jit_s), maxulp=1)
    moved = int((s.numpy() != np.asarray(jit_s)).sum())
    assert 0 < moved <= 0.2 * 4000, moved


def test_exchange_config_validates_mode():
    with pytest.raises(ValueError, match="grad_compression"):
        C.ExchangeConfig(mode="int4")
    with pytest.raises(ValueError, match="block"):
        C.ExchangeConfig(mode="int8", block=0)


# --------------------------------------------------------------------- #
# The exchanges against JAX's shard_map bodies                           #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_dp_exchange_matches_jax(world, mode):
    """Mean gradients and new residuals of one replicated exchange, with
    nonzero incoming residuals: leaves of 32768 (compressed), 63063
    (padded to the ranks' blocks) and 7 (the exact mean) elements.
    XLA's jit multiplies by 1/127 where the port divides (scales 1 ulp
    apart on ~5% of blocks, test_quantize_blocks_bitwise_with_jax), so a
    dequantized value moves by up to ~1 ulp of its block's largest.
    Limits: 4 f32 ulps of the leaf's largest gradient, for the means and
    the residuals (measured: at most 2, on 4 of 32768 elements)."""
    rng = np.random.default_rng(1)
    shapes = {"w": (512, 64), "u": (1001, 63), "b": (7,)}
    grads = {k: rng.normal(size=(N,) + s).astype(np.float32)
             for k, s in shapes.items()}
    cfg = JC.ExchangeConfig(mode=mode)
    res = {k: (rng.normal(size=(N, int(np.prod(s)))) * 1e-3).astype(
        np.float32) if JC.compressible(grads[k][0], cfg)
        else np.zeros((N, 1), np.float32) for k, s in shapes.items()}
    mesh = _dp_mesh()
    jout, jres = jax.jit(JC.build_exchange(mesh, cfg))(
        _stacked(mesh, grads), _stacked(mesh, res))
    r0, r1 = _run(world, torch_boring.exchange_body, mode=mode,
                  grads=grads, residuals=res)
    for k in shapes:
        want = np.asarray(jout[k])
        tol = 4 * np.spacing(np.abs(grads[k]).max())
        for r in (r0, r1):
            np.testing.assert_allclose(r["outs"][0][k], want, rtol=0,
                                       atol=tol, err_msg=k)
        jr = np.asarray(jres[k])
        for rank, r in enumerate((r0, r1)):
            np.testing.assert_allclose(r["res"][k], jr[rank], rtol=0,
                                       atol=tol, err_msg=k)
    assert r0["stats"]["compressed_exchanges"] == 2
    assert r0["stats"]["collectives"]["all_to_all"] == \
        (4 if mode == "int8" else 2)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_fsdp_exchange_matches_jax(world, mode):
    """``build_fsdp_exchange`` on a data=1 x fsdp=2 mesh against the
    port's reduce-scatter into the owner: a sharded compressed leaf (dim
    0), a leaf the heuristic left replicated (two-phase exchange), a
    sharded leaf below the compression threshold (exact, sliced) and a
    small replicated one; the owned slices, rank for rank, and the
    shard-local residuals.  Limits as the replicated exchange's."""
    rng = np.random.default_rng(2)
    shapes = {"w": (1024, 64), "u": (1001, 63), "s": (4096, 1),
              "b": (7,)}
    params = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    mesh = _fsdp_mesh()
    cfg = JC.ExchangeConfig(mode=mode, min_compress_size=8192)
    psh = jax_sharding.infer_fsdp_shardings(params, mesh)
    layouts = {k: JC.fsdp_shard_dim(psh[k]) for k in shapes}
    assert layouts == {"w": 0, "u": None, "s": 0, "b": None}
    grads = {k: rng.normal(size=(N,) + s).astype(np.float32)
             for k, s in shapes.items()}
    res0 = JC.fsdp_residual_zeros(params, psh, cfg)
    res = {k: (rng.normal(size=np.shape(v)) * 1e-3).astype(np.float32)
           if np.shape(v)[1] > 1 else np.zeros(np.shape(v), np.float32)
           for k, v in res0.items()}
    jout, jres = jax.jit(JC.build_fsdp_exchange(mesh, cfg, psh))(
        _stacked(mesh, grads), _stacked(mesh, res))
    ranks = _run(world, torch_boring.exchange_body, mode=mode, grads=grads,
                 residuals=res, layouts=layouts, min_compress_size=8192)
    for k in shapes:
        want = np.asarray(jout[k])
        tol = 4 * np.spacing(np.abs(grads[k]).max())
        got = (np.concatenate([r["outs"][0][k] for r in ranks], axis=0)
               if layouts[k] is not None else ranks[0]["outs"][0][k])
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=k)
        jr = np.asarray(jres[k])
        for rank, r in enumerate(ranks):
            assert r["res"][k].shape == jr[rank].shape, k
            np.testing.assert_allclose(r["res"][k], jr[rank], rtol=0,
                                       atol=tol, err_msg=k)
    # the sharded compressed leaf's residual is the owned chunk only
    assert ranks[0]["res"]["w"].shape == ((1024 * 64) // N,)


def test_param_gather_matches_jax(world):
    """The compute view of fsdp-sharded params: bf16 on the wire, back in
    the param dtype (f32: bf16 round trips, bitwise JAX's); an int32 leaf
    crosses untouched."""
    rng = np.random.default_rng(4)
    params = {"w": rng.normal(size=(1024, 64)).astype(np.float32),
              "step": np.arange(8 * 1024, dtype=np.int32).reshape(1024, 8)}
    mesh = _fsdp_mesh()
    sh = {k: NamedSharding(mesh, P(jax_mesh.FSDP_AXIS, None))
          for k in params}
    pd = jax.tree.map(lambda a, s: jax.device_put(jnp.asarray(a), s),
                      params, sh)
    want = jax.jit(JC.build_param_gather(mesh, sh))(pd)
    shards = {k: np.stack(np.split(v, N, axis=0)) for k, v in params.items()}
    r0, r1 = _run(world, torch_boring.gather_body, shards=shards, dim=0,
                  wire_dtype=torch.bfloat16)
    for k in params:
        np.testing.assert_array_equal(r0[k], np.asarray(want[k]))
        np.testing.assert_array_equal(r1[k], r0[k])
    np.testing.assert_array_equal(r0["step"], params["step"])


# --------------------------------------------------------------------- #
# The JAX package's error bounds, on the port's ranks                    #
# --------------------------------------------------------------------- #
def test_int8_exchange_single_step_error_bound(world):
    """tests/test_collectives.py:68: within 1e-2 relative of the f32
    mean; the sub-threshold leaf exact; residuals only where
    compressed."""
    rng = np.random.default_rng(0)
    grads = {"w": rng.normal(size=(N, 512, 64)).astype(np.float32),
             "b": rng.normal(size=(N, 7)).astype(np.float32)}
    res = {"w": np.zeros((N, 512 * 64), np.float32),
           "b": np.zeros((N, 1), np.float32)}
    r0, _ = _run(world, torch_boring.exchange_body, mode="int8",
                 grads=grads, residuals=res)
    true = {k: v.mean(0) for k, v in grads.items()}
    for k in grads:
        assert _rel(r0["outs"][0][k], true[k]) < 1e-2, k
    np.testing.assert_allclose(r0["outs"][0]["b"], true["b"], rtol=1e-6)
    assert r0["res"]["w"].shape == (512 * 64,)
    assert r0["res"]["b"].shape == (1,) and r0["res"]["b"].max() == 0.0
    assert np.linalg.norm(r0["res"]["w"]) > 0.0


def test_error_feedback_reduces_bias_across_steps(world):
    """tests/test_collectives.py:98: feeding the residual back pulls the
    running mean of 4 exchanges toward the true mean (err4 < 0.75
    err1)."""
    rng = np.random.default_rng(1)
    grads = {"w": rng.normal(size=(N, 256, 64)).astype(np.float32)}
    res = {"w": np.zeros((N, 256 * 64), np.float32)}
    r0, _ = _run(world, torch_boring.exchange_body, mode="int8",
                 grads=grads, residuals=res, steps=4)
    true = grads["w"].mean(0)
    outs = [o["w"] for o in r0["outs"]]
    err1 = _rel(outs[0], true)
    err4 = _rel(np.mean(outs, 0), true)
    assert err4 < err1 * 0.75, (err1, err4)


def test_bf16_exchange_error_bound(world):
    rng = np.random.default_rng(2)
    grads = {"w": rng.normal(size=(N, 512, 64)).astype(np.float32)}
    res = {"w": np.zeros((N, 512 * 64), np.float32)}
    r0, _ = _run(world, torch_boring.exchange_body, mode="bf16",
                 grads=grads, residuals=res)
    assert _rel(r0["outs"][0]["w"], grads["w"].mean(0)) < 5e-3


def test_int8_fsdp_exchange_error_bound_and_shard_local_residuals(world):
    """tests/test_fsdp_exchange.py:45: the reduce-scatter within 1e-2 of
    the mean, the reduced gradient in the owner's slice, the residual 1/N
    (the padded owned chunk), a fallback leaf on the two-phase exchange
    with a whole residual, a small leaf exact with a placeholder."""
    rng = np.random.default_rng(0)
    shapes = {"w": (1024, 64), "u": (1001, 63), "b": (7,)}
    layouts = {"w": 0, "u": None, "b": None}
    cfg = C.ExchangeConfig(mode="int8")
    params = {k: torch.zeros(s) for k, s in shapes.items()}
    res0 = C.fsdp_residual_zeros(params, layouts, cfg, N)
    grads = {k: rng.normal(size=(N,) + s).astype(np.float32)
             for k, s in shapes.items()}
    res = {k: np.zeros((N,) + tuple(v.shape), np.float32)
           for k, v in res0.items()}
    r0, r1 = _run(world, torch_boring.exchange_body, mode="int8",
                  grads=grads, residuals=res, layouts=layouts)
    true = {k: v.mean(0) for k, v in grads.items()}
    w = np.concatenate([r0["outs"][0]["w"], r1["outs"][0]["w"]])
    assert r0["outs"][0]["w"].shape == (1024 // N, 64)
    assert _rel(w, true["w"]) < 1e-2
    assert _rel(r0["outs"][0]["u"], true["u"]) < 1e-2
    np.testing.assert_allclose(r0["outs"][0]["b"], true["b"], rtol=1e-6)
    assert r0["res"]["w"].shape == ((1024 * 64) // N,)
    assert np.linalg.norm(r0["res"]["w"]) > 0.0
    assert r0["res"]["u"].shape == (1001 * 63,)
    assert r0["res"]["b"].shape == (1,) and r0["res"]["b"].max() == 0.0


def test_bf16_fsdp_exchange_error_bound(world):
    rng = np.random.default_rng(2)
    grads = {"w": rng.normal(size=(N, 512, 64)).astype(np.float32)}
    res = {"w": np.zeros((N, (512 * 64) // N), np.float32)}
    r0, r1 = _run(world, torch_boring.exchange_body, mode="bf16",
                  grads=grads, residuals=res, layouts={"w": 0})
    w = np.concatenate([r0["outs"][0]["w"], r1["outs"][0]["w"]])
    assert _rel(w, grads["w"].mean(0)) < 5e-3
    # bf16 chunks need no block padding
    assert r0["res"]["w"].shape == ((512 * 64) // N,)


def test_wire_report_reduce_scatter_regime():
    """tests/test_fsdp_exchange.py:139, the port's layouts."""
    params = {"w": np.zeros((1024, 1024), np.float32),
              "b": np.zeros((64,), np.float32)}
    cfg = C.ExchangeConfig(mode="int8")
    rep = C.wire_bytes_per_step(params, 8, cfg,
                                param_shardings={"w": 0, "b": None})
    assert rep["regime"] == "reduce_scatter_all_gather"
    assert rep["fsdp"] == 8 and rep["reduce_scattered_leaves"] == 1
    assert 2.4 <= rep["compression_ratio"] <= 2.66
    rep_dp = C.wire_bytes_per_step(params, 8, cfg)
    assert rep_dp["regime"] == "allreduce"
    assert rep_dp["compressed_ratio"] >= 3.5
