"""Port parity for the kernel modules of the PyTorch port (ops/norms.py,
ops/quant.py): the same seeded numpy inputs go through the JAX package's
Pallas kernels in interpret mode and through the port, in f32 on the CPU.
The CUDA kernels themselves are held to their plain versions on the card
in tests/test_torch_cuda_kernels.py, which skips without one
(``chip_smoke.py`` does the same at the serve path's shapes)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_lightning_accelerators_tpu.ops import norms as jnorms
from ray_lightning_accelerators_tpu.ops import quant as jquant
from ray_lightning_accelerators_tpu_torch.ops import norms, quant

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# f32 on the CPU, both sides: the two frameworks sum in different orders,
# so results agree to a few f32 ulps of the operands' scale, not bitwise.
# Measured max |diff| <= 1e-6 at these sizes; 1e-5 leaves 10x headroom and
# is still ~1000x below any bf16 rounding step.
F32_ATOL = 1e-5
F32_RTOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


# --------------------------------------------------------------------- #
# rms_norm                                                              #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", [(16, 128), (3, 5, 128), (7, 96)])
def test_rms_norm_matches_interpret_kernel_and_reference(shape):
    rng = _rng(1)
    x = rng.standard_normal(shape).astype(np.float32) * 3.0
    s = rng.standard_normal(shape[-1]).astype(np.float32)
    got = norms.rms_norm(torch.from_numpy(x), torch.from_numpy(s)).numpy()
    ref = np.asarray(jnorms.rms_norm_reference(jnp.asarray(x),
                                               jnp.asarray(s)))
    interp = np.asarray(jnorms.rms_norm_interpret(jnp.asarray(x),
                                                  jnp.asarray(s)))
    np.testing.assert_allclose(got, ref, rtol=F32_RTOL, atol=F32_ATOL)
    np.testing.assert_allclose(got, interp, rtol=F32_RTOL, atol=F32_ATOL)
    assert got.shape == shape and got.dtype == np.float32


def test_rms_norm_bf16_keeps_dtype_and_rejects_bad_scale():
    x = torch.randn(4, 128, dtype=torch.bfloat16)
    out = norms.rms_norm(x, torch.ones(128))
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    with pytest.raises(ValueError, match="scale must have shape"):
        norms.rms_norm(x, torch.ones(64))


def test_cpu_path_counts_no_kernel_launch():
    before = (norms.rms_norm.launches, quant.int8_matmul.launches,
              quant.int8_matmul_nt.launches)
    norms.rms_norm(torch.ones(2, 8), torch.ones(8))
    quant.int8_matmul(torch.ones(2, 8), torch.ones(8, 4, dtype=torch.int8),
                      torch.ones(4))
    quant.int8_matmul_nt(torch.ones(2, 8), torch.ones(4, 8,
                                                      dtype=torch.int8))
    assert (norms.rms_norm.launches, quant.int8_matmul.launches,
            quant.int8_matmul_nt.launches) == before


# --------------------------------------------------------------------- #
# int8 matmuls                                                          #
# --------------------------------------------------------------------- #
def _q8_operands(m, k, n, seed=2):
    rng = _rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = (rng.random(n).astype(np.float32) + 0.1) / 127.0
    return x, wq, scale


@pytest.mark.parametrize("m,k,n", [(1, 128, 128), (16, 128, 256),
                                   (5, 256, 128)])
def test_int8_matmul_matches_interpret_kernel(m, k, n):
    x, wq, scale = _q8_operands(m, k, n)
    got = quant.int8_matmul(torch.from_numpy(x), torch.from_numpy(wq),
                            torch.from_numpy(scale)).numpy()
    ref = np.asarray(jquant.int8_matmul(jnp.asarray(x), jnp.asarray(wq),
                                        jnp.asarray(scale), interpret=True))
    np.testing.assert_allclose(got, ref, rtol=F32_RTOL, atol=F32_ATOL)
    assert got.shape == (m, n)


@pytest.mark.parametrize("m,k,n", [(1, 128, 256), (16, 128, 256),
                                   (3, 256, 128)])
def test_int8_matmul_nt_matches_interpret_kernel(m, k, n):
    x, wq, _ = _q8_operands(m, k, n)
    w_nt = np.ascontiguousarray(wq.T)                 # [N, K]
    got = quant.int8_matmul_nt(torch.from_numpy(x),
                               torch.from_numpy(w_nt)).numpy()
    ref = np.asarray(jquant.int8_matmul_nt(jnp.asarray(x),
                                           jnp.asarray(w_nt),
                                           interpret=True))
    # sums of up to 256 products of magnitude ~127*3: scale the f32
    # tolerance to the output's magnitude (relative, same ulp argument)
    np.testing.assert_allclose(got, ref, rtol=F32_RTOL,
                               atol=F32_ATOL * np.abs(ref).max())
    assert got.shape == (m, n)


@pytest.mark.parametrize("case", ["k_mismatch", "bad_scale",
                                  "nt_k_mismatch"])
def test_int8_matmul_typed_errors_match_jax(case):
    """Mismatched operands raise the same ValueError, word for word."""
    x, wq, scale = _q8_operands(4, 128, 128)
    if case == "k_mismatch":
        args = (x, wq[:64], scale)
        port, jax_fn = quant.int8_matmul, jquant.int8_matmul
        msg = "x contraction dim 128 != wq leading dim 64"
    elif case == "bad_scale":
        args = (x, wq, scale[:7])
        port, jax_fn = quant.int8_matmul, jquant.int8_matmul
        msg = "scale must be per-out-channel with shape"
    else:
        args = (x, np.ascontiguousarray(wq[:64].T))   # [N=128, K=64]
        port, jax_fn = quant.int8_matmul_nt, jquant.int8_matmul_nt
        msg = "x contraction dim 128 != wq trailing dim 64"
    with pytest.raises(ValueError, match=msg) as port_err:
        port(*(torch.from_numpy(a) for a in args))
    with pytest.raises(ValueError, match=msg) as jax_err:
        jax_fn(*(jnp.asarray(a) for a in args), interpret=True)
    assert str(port_err.value) == str(jax_err.value)


def test_int8_matmul_takes_shapes_the_tpu_tiling_declines():
    """The TPU kernels refuse K not a multiple of 32 or N not a multiple
    of 128 (quant.supported); the port takes every K/N and M >= 1."""
    x, wq, scale = _q8_operands(3, 40, 20)
    assert not jquant.supported(3, 40, 20)
    got = quant.int8_matmul(torch.from_numpy(x), torch.from_numpy(wq),
                            torch.from_numpy(scale)).numpy()
    ref = (x.astype(np.float64) @ wq.astype(np.float64)) * scale
    # f32 accumulation of 40 terms against a float64 reference
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="need m >= 1"):
        quant.int8_matmul(torch.zeros(0, 40), torch.from_numpy(wq),
                          torch.from_numpy(scale))


@pytest.mark.parametrize("m,k,n", [(16, 768, 768), (16, 3072, 768),
                                   (128, 768, 3072), (1, 40, 20)])
def test_split_plan_covers_k_without_empty_splits(m, k, n):
    splits, per = quant.split_plan(m, k, n)
    assert per % 64 == 0 and splits >= 1
    assert (splits - 1) * per < k <= splits * per


def test_wrappers_refuse_devices_without_a_kernel():
    """Only the CPU takes the plain version; any other non-CUDA device is
    refused typed instead of silently computing somewhere else."""
    x = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        norms.rms_norm(x, torch.empty(8, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        quant.int8_matmul(x, torch.empty(8, 4, dtype=torch.int8,
                                         device="meta"),
                          torch.empty(4, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        quant.int8_matmul_nt(x, torch.empty(4, 8, dtype=torch.int8,
                                            device="meta"))


def test_kernel_build_needs_nvcc_and_keys_on_sources(monkeypatch, tmp_path):
    from ray_lightning_accelerators_tpu_torch.ops import _build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.nvcc_path()
    # the library name carries a digest of the sources: an edit rebuilds
    src, hdr = tmp_path / "k.cu", tmp_path / "c.cuh"
    src.write_text("// a\n")
    hdr.write_text("// h\n")
    d1 = _build._digest(src, [hdr])
    hdr.write_text("// h2\n")
    d2 = _build._digest(src, [hdr])
    src.write_text("// b\n")
    assert len({d1, d2, _build._digest(src, [hdr])}) == 3
    # every source in the package's csrc/ is one library with C entries
    # declared in SIGNATURES
    stems = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert stems == ["norms", "quant"]
    text = " ".join(p.read_text() for p in _build.CSRC.glob("*.cu"))
    for name in _build.SIGNATURES:
        assert f'extern "C" int {name}(' in text
