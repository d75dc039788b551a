"""Port parity for the kernel modules of the PyTorch port (ops/norms.py,
ops/quant.py): the same seeded numpy inputs go through the JAX package's
Pallas kernels in interpret mode and through the port, in f32 (and, for
LayerNorm, bf16) on the CPU.
The CUDA kernels themselves are held to their plain versions on the card
in tests/test_torch_cuda_kernels.py, which skips without one
(``chip_smoke.py`` does the same at the serve path's shapes)."""

import numpy as np
import pytest
import torch

import jax
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


# --------------------------------------------------------------------- #
# layer_norm (K7)                                                       #
# --------------------------------------------------------------------- #
def _bf16_ulp(v):
    """One bf16 ulp at |v| (8 significant bits)."""
    mag = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _ln_operands(shape, seed=7):
    rng = _rng(seed)
    # a mean far from 0 against the spread: the two-pass variance keeps
    # its digits where E[x^2] - mu^2 would not
    x = (rng.standard_normal(shape) * 2.0 + 5.0).astype(np.float32)
    s = rng.standard_normal(shape[-1]).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    return x, s, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(16, 128), (3, 5, 256), (7, 200)])
def test_layer_norm_matches_interpret_kernel_and_reference(shape, dtype):
    """The port's layer_norm (its plain version on the CPU) against the
    TPU kernel in interpret mode and the JAX plain version, d 128, 256
    and a ragged 200.  f32: summation order only, 1e-5 absolute.  bf16
    inputs (the same f32 values rounded once on both sides): each output
    within one bf16 ulp of the JAX output (both compute in f32 and round
    once)."""
    x, s, b = _ln_operands(shape)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = norms.layer_norm(torch.from_numpy(x).to(tdt),
                           torch.from_numpy(s), torch.from_numpy(b))
    assert got.dtype == tdt and tuple(got.shape) == shape
    got = got.float().numpy()
    jx = jnp.asarray(x).astype(jdt)
    for fn in (jnorms.layer_norm_reference, jnorms.layer_norm_interpret):
        ref = np.asarray(fn(jx, jnp.asarray(s), jnp.asarray(b)).astype(
            jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, rtol=0, atol=F32_ATOL)
        else:
            assert np.all(np.abs(got - ref) <= _bf16_ulp(ref)), fn.__name__


def test_layer_norm_grads_match_jax():
    """dx, dscale and dbias of the port's layer_norm against the VJP of
    the JAX layer_norm (its custom VJP through the plain version), same
    seeded inputs and cotangent.  f32: 1e-5 absolute."""
    x, s, b = _ln_operands((4, 6, 128), seed=8)
    g = _rng(9).standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(jnorms.layer_norm, jnp.asarray(x), jnp.asarray(s),
                     jnp.asarray(b))
    jgrads = vjp(jnp.asarray(g))
    tx, ts, tb = (torch.from_numpy(a).requires_grad_() for a in (x, s, b))
    grads = torch.autograd.grad(norms.layer_norm(tx, ts, tb), (tx, ts, tb),
                                torch.from_numpy(g))
    for got, ref in zip(grads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-5)


def test_layer_norm_shape_errors_and_zero_rows():
    x = torch.randn(4, 128)
    with pytest.raises(ValueError, match="scale must have shape"):
        norms.layer_norm(x, torch.ones(64), torch.zeros(128))
    with pytest.raises(ValueError, match="bias must have shape"):
        norms.layer_norm(x, torch.ones(128), torch.zeros(1, 128))
    empty = norms.layer_norm(torch.zeros(0, 128), torch.ones(128),
                             torch.zeros(128))
    assert empty.shape == (0, 128)


@pytest.mark.parametrize("xdt,sdt,bdt,param_f32", [
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, 0),
    (torch.bfloat16, torch.float32, torch.float32, 1),
    (torch.bfloat16, torch.float32, torch.bfloat16, 1),
    (torch.float16, torch.bfloat16, torch.bfloat16, 1),
    (torch.float32, torch.float32, torch.float32, 1)])
def test_layer_norm_wrapper_passes_its_c_signature(monkeypatch, xdt, sdt,
                                                   bdt, param_f32):
    """What the K7 wrapper hands ``rla_layer_norm``, with the library and
    stream stubbed out (the kernel runs only on the card): the argument
    count and types ``_build.SIGNATURES`` declares, rows and d of the
    flattened input, the dtype code, scale and bias in one type (both
    x's, else both f32), and one counted launch."""
    from ray_lightning_accelerators_tpu_torch.ops import _build
    calls = []

    class FakeLibrary:
        def __getattr__(self, entry):
            return lambda *args: calls.append((entry, args)) or 0

    monkeypatch.setattr(_build, "library", lambda stem: FakeLibrary())
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(norms.layer_norm, "launches", 0)
    x = torch.zeros(3, 5, 200, dtype=xdt)
    out = norms._layer_norm_cuda(x, torch.ones(200, dtype=sdt),
                                 torch.zeros(200, dtype=bdt), 1e-6)
    assert out.shape == x.shape and out.dtype == xdt
    assert norms.layer_norm.launches == 1
    (entry, args), = calls
    sig = _build.SIGNATURES[entry]
    assert entry == "rla_layer_norm" and len(args) == len(sig)
    kinds = {_build._P: int, _build._I: int, _build._F: float}
    for i, (a, t) in enumerate(zip(args, sig)):
        assert isinstance(a, kinds[t]), (i, a, t)
    assert args[4:6] == (15, 200)
    assert args[7:9] == (_build.DTYPE_CODES[xdt], param_f32)


@pytest.mark.parametrize("xdt,sdt,scale_f32", [
    (torch.bfloat16, torch.bfloat16, 0),
    (torch.bfloat16, torch.float32, 1),
    (torch.float16, torch.bfloat16, 1),
    (torch.float16, torch.float16, 0),
    (torch.float32, torch.bfloat16, 1)])
def test_rms_norm_wrapper_passes_its_c_signature(monkeypatch, xdt, sdt,
                                                 scale_f32):
    """What the K1 wrapper hands ``rla_rms_norm``, with the library and
    stream stubbed out: the argument count and types ``SIGNATURES``
    declares, rows and d of the flattened input, eps, the dtype code, a
    scale in x's dtype or else f32, and one counted launch."""
    from ray_lightning_accelerators_tpu_torch.ops import _build
    calls = []

    class FakeLibrary:
        def __getattr__(self, entry):
            return lambda *args: calls.append((entry, args)) or 0

    monkeypatch.setattr(_build, "library", lambda stem: FakeLibrary())
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(norms.rms_norm, "launches", 0)
    x = torch.zeros(2, 7, 768, dtype=xdt)
    out = norms._rms_norm_cuda(x, torch.ones(768, dtype=sdt), 1e-5)
    assert out.shape == x.shape and out.dtype == xdt
    assert norms.rms_norm.launches == 1
    (entry, args), = calls
    sig = _build.SIGNATURES[entry]
    assert entry == "rla_rms_norm" and len(args) == len(sig)
    kinds = {_build._P: int, _build._I: int, _build._F: float}
    for i, (a, t) in enumerate(zip(args, sig)):
        assert isinstance(a, kinds[t]), (i, a, t)
    assert args[3:] == (14, 768, 1e-5, _build.DTYPE_CODES[xdt], scale_f32,
                        0)


@pytest.mark.parametrize("has_raw", [True, False])
def test_stream_reader_takes_the_raw_lookup_where_torch_has_it(monkeypatch,
                                                               has_raw):
    """``stream_of`` reads torch's private raw-stream lookup where the
    build has it and the public ``torch.cuda.current_stream`` otherwise,
    so a torch that renames the private one still launches."""
    from ray_lightning_accelerators_tpu_torch.ops import _build

    class FakeStream:
        cuda_stream = 0xBEEF

    class FakeC:
        if has_raw:
            @staticmethod
            def _cuda_getCurrentRawStream(index):
                return 0xF00D + index

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda index: FakeStream())
    read = _build._raw_stream_reader(FakeC)
    assert read(1) == (0xF00E if has_raw else 0xBEEF)
    assert (_build._current_raw_stream is
            getattr(torch._C, "_cuda_getCurrentRawStream",
                    _build._current_raw_stream))


def test_library_lookup_after_the_build_takes_no_lock(monkeypatch):
    """Once a library is loaded, ``library`` returns it without entering
    ``build_all`` (whose lock every kernel call would otherwise take)."""
    from ray_lightning_accelerators_tpu_torch.ops import _build
    loaded = object()
    monkeypatch.setattr(_build, "_libs", {"norms": loaded})

    def no_build():
        raise AssertionError("build_all entered after the build")

    monkeypatch.setattr(_build, "build_all", no_build)
    assert _build.library("norms") is loaded


def test_cpu_path_counts_no_kernel_launch():
    before = (norms.rms_norm.launches, norms.layer_norm.launches,
              quant.int8_matmul.launches, quant.int8_matmul_nt.launches)
    norms.rms_norm(torch.ones(2, 8), torch.ones(8))
    norms.layer_norm(torch.ones(2, 8), torch.ones(8), torch.zeros(8))
    quant.int8_matmul(torch.ones(2, 8), torch.ones(8, 4, dtype=torch.int8),
                      torch.ones(4))
    quant.int8_matmul_nt(torch.ones(2, 8), torch.ones(4, 8,
                                                      dtype=torch.int8))
    assert (norms.rms_norm.launches, norms.layer_norm.launches,
            quant.int8_matmul.launches,
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


@pytest.mark.parametrize("k,n,tile_cols", [
    (768, 768, 64), (3072, 768, 64), (768, 3072, 64), (40, 20, 64),
    (768, 50304, 64), (24600, 64, 64), (768, 3072, 128)])
def test_launch_plan_covers_k_without_empty_ranks(k, n, tile_cols):
    """The cluster (1-8 blocks) splits K in whole 32-k chunks, covers it,
    and leaves no rank empty; the plan takes no M."""
    cluster, per = quant.launch_plan(k, n, tile_cols)
    assert 1 <= cluster <= 8 and per % 32 == 0
    assert (cluster - 1) * per < k <= cluster * per


class _FakeQuantLibrary:
    """Stands in for the built ``quant`` library: records each entry's
    arguments and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        return lambda *args: self.calls.append((entry, args)) or 0


def _assert_c_types(entry, args):
    from ray_lightning_accelerators_tpu_torch.ops import _build
    sig = _build.SIGNATURES[entry]
    assert len(args) == len(sig)
    kinds = {_build._P: int, _build._I: int, _build._F: float}
    for i, (a, t) in enumerate(zip(args, sig)):
        assert isinstance(a, kinds[t]) and not isinstance(a, bool), (i, a, t)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_int8_matmul_wrapper_passes_its_c_signature(monkeypatch, dtype):
    """What the K5 wrapper hands ``rla_int8_matmul``, with the library and
    stream stubbed out: the argument count and types ``SIGNATURES``
    declares, M, K, N, the launch plan (the same at every M), the dtype
    code, and one counted launch a call."""
    from ray_lightning_accelerators_tpu_torch.ops import _build
    lib = _FakeQuantLibrary()
    monkeypatch.setattr(_build, "library", lambda stem: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(quant.int8_matmul, "launches", 0)
    k, n = 3072, 768
    for m in (1, 16, 400):
        out = quant._int8_matmul_cuda(
            torch.zeros(m, k, dtype=dtype),
            torch.zeros(k, n, dtype=torch.int8),
            torch.ones(n, dtype=torch.bfloat16))
        assert out.shape == (m, n) and out.dtype == dtype
    assert quant.int8_matmul.launches == 3
    # the f32 body's tiles are 128 columns wide, the tensor-core body's 64
    plan = quant.launch_plan(k, n, 128 if dtype == torch.float32 else 64)
    for m, (entry, args) in zip((1, 16, 400), lib.calls):
        assert entry == "rla_int8_matmul"
        _assert_c_types(entry, args)
        assert args[4:] == (m, k, n, *plan, _build.DTYPE_CODES[dtype], 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_int8_matmul_nt_wrapper_passes_its_c_signature(monkeypatch, dtype):
    """What the K6 wrapper hands ``rla_int8_matmul_nt`` (library and
    stream stubbed out): the declared argument count and types, M, K, N,
    the dtype code, and one counted launch."""
    from ray_lightning_accelerators_tpu_torch.ops import _build
    lib = _FakeQuantLibrary()
    monkeypatch.setattr(_build, "library", lambda stem: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(quant.int8_matmul_nt, "launches", 0)
    out = quant._int8_matmul_nt_cuda(torch.zeros(17, 768, dtype=dtype),
                                     torch.zeros(50304, 768,
                                                 dtype=torch.int8))
    assert out.shape == (17, 50304) and out.dtype == dtype
    assert quant.int8_matmul_nt.launches == 1
    (entry, args), = lib.calls
    assert entry == "rla_int8_matmul_nt"
    _assert_c_types(entry, args)
    assert args[3:] == (17, 768, 50304, _build.DTYPE_CODES[dtype], 0)


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
    assert stems == ["attention", "attention_bwd", "norms", "quant"]
    text = " ".join(p.read_text() for p in _build.CSRC.glob("*.cu"))
    for name in _build.SIGNATURES:
        assert f'extern "C" int {name}(' in text
