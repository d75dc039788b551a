"""The port's ``utils/torch_interop.py`` against the JAX package's (whose
own test is tests/test_torch_interop.py): a torch ``nn.Module``'s
state_dict imported into a parameter tree and exported back.  The JAX
package's tree holds numpy arrays, the port's tensors; the two must hold
the same values bit for bit."""

import numpy as np
import pytest
import torch

from ray_lightning_accelerators_tpu.utils import torch_interop as jti
from ray_lightning_accelerators_tpu_torch.models.mnist import (
    MNISTClassifier)
from ray_lightning_accelerators_tpu_torch.utils import torch_interop as ti


class _TorchMLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.net = torch.nn.Sequential(
            torch.nn.Linear(784, 32), torch.nn.ReLU(),
            torch.nn.Linear(32, 16), torch.nn.ReLU(),
            torch.nn.Linear(16, 10))

    def forward(self, x):
        return self.net(x)


def _mapping(lib):
    m = {}
    for i, layer in enumerate((0, 2, 4)):
        m.update(lib.linear_mapping(f"dense_{i}", f"net.{layer}"))
    return m


def _model():
    return MNISTClassifier({"layer_1": 32, "layer_2": 16}, device="cpu")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.fixture()
def torch_mlp():
    torch.manual_seed(0)
    return _TorchMLP().eval()


def test_import_matches_jax_and_the_forward(torch_mlp):
    model = _model()
    template = model.init_params(0)
    ours = ti.import_state_dict(template, torch_mlp.state_dict(),
                                _mapping(ti))
    np_template = {k: {n: a.numpy() for n, a in v.items()}
                   for k, v in template.items()}
    theirs = jti.import_state_dict(np_template, torch_mlp.state_dict(),
                                   _mapping(jti))
    a, b = dict(_leaves(ours)), dict(_leaves(theirs))
    assert a.keys() == b.keys()
    for name, t in a.items():
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), b[name])
    x = np.random.default_rng(0).normal(size=(4, 784)).astype(np.float32)
    with torch.no_grad():
        ref = torch_mlp(torch.from_numpy(x)).numpy()
    out = model.forward(ours, torch.from_numpy(x).reshape(4, 28, 28, 1))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5,
                               rtol=1e-5)


def test_export_round_trip_matches_jax(torch_mlp):
    template = _model().init_params(0)
    sd = torch_mlp.state_dict()
    params = ti.import_state_dict(template, sd, _mapping(ti))
    back = ti.export_state_dict(params, _mapping(ti))
    jback = jti.export_state_dict(
        jti.import_state_dict({k: {n: a.numpy() for n, a in v.items()}
                               for k, v in template.items()}, sd,
                              _mapping(jti)), _mapping(jti))
    assert back.keys() == sd.keys() == jback.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k])
        assert torch.equal(back[k], jback[k])
    fresh = _TorchMLP()
    fresh.load_state_dict(back)


def test_import_rejects_bad_mappings(torch_mlp):
    template = _model().init_params(0)
    sd = torch_mlp.state_dict()
    bad = dict(_mapping(ti))
    bad["dense_0/kernel"] = "net.0.weight"               # no transpose
    with pytest.raises(ValueError, match="transpose"):
        ti.import_state_dict(template, sd, bad)
    partial = {k: v for k, v in _mapping(ti).items() if "dense_2" not in k}
    with pytest.raises(ValueError, match="unmapped"):
        ti.import_state_dict(template, sd, partial)
    kept = ti.import_state_dict(template, sd, partial, strict=False)
    assert torch.equal(kept["dense_2"]["kernel"],
                       template["dense_2"]["kernel"])
    with pytest.raises(ValueError, match="not in template"):
        ti.import_state_dict(template, sd, {**_mapping(ti), "x/y": "z"})
    with pytest.raises(KeyError, match="missing.weight"):
        ti.import_state_dict(template, sd, {**_mapping(ti),
                                            "dense_0/bias": "missing.weight"})


def test_dtypes_and_numpy_round_trips():
    """A bf16 state_dict entry imports into a bf16 template leaf without a
    numpy detour; ``from_torch`` / ``to_torch`` round-trip f32, int32 and
    bf16 as the JAX package's do."""
    w = torch.randn(3, 5).to(torch.bfloat16)
    out = ti.import_state_dict({"k": torch.zeros(5, 3, dtype=torch.bfloat16)},
                               {"w": w}, {"k": ("w", ti.transpose)})
    assert out["k"].dtype == torch.bfloat16
    assert torch.equal(out["k"], w.T)
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        t = torch.arange(6, dtype=torch.float32).reshape(2, 3).to(dtype)
        arr = ti.from_torch(t.T)                   # non-contiguous too
        np.testing.assert_array_equal(
            arr.astype(np.float32), jti.from_torch(t.T).astype(np.float32))
        back = ti.to_torch(arr)
        assert back.dtype == dtype and torch.equal(back, t.T)
    assert ti.state_dict_to_tree({"a": torch.ones(2)})["a"].tolist() == [1, 1]
