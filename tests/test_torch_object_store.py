"""The port's runtime pieces under the KV handoff: the shared-memory
object store (``runtime/object_store.py`` over ``native/shm_store.cc``,
mirroring tests/test_object_store.py), ``parallel/redistribute.py``
``wave_schedule`` against the JAX package's, and ``GPT.paged_blocks_gather``
/ ``paged_blocks_scatter`` against the JAX model's on a seeded pool.  The
shm library is built with g++ at first use; all on the CPU."""

import pathlib
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_accelerators_tpu.models.transformer import GPT as JaxGPT
from ray_lightning_accelerators_tpu.parallel.redistribute import (
    wave_schedule as jax_wave_schedule)
from ray_lightning_accelerators_tpu_torch.models.transformer import GPT
from ray_lightning_accelerators_tpu_torch.parallel.redistribute import (
    wave_schedule)
from ray_lightning_accelerators_tpu_torch.runtime import object_store as osl
from ray_lightning_accelerators_tpu_torch.runtime.object_store import (
    ObjectRef, ObjectStore, ObjectStoreError)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _tree():
    rng = np.random.default_rng(0)
    return {
        "params": {"w": rng.standard_normal((256, 256), dtype=np.float32),
                   "b": rng.standard_normal(8, dtype=np.float32)},  # inline
        "t": torch.arange(300 * 300, dtype=torch.float32).reshape(300, 300),
        "small": torch.ones(4, dtype=torch.int32),                   # inline
        "seq": [np.full((128, 128), 2.0, np.float64), ("x", 3)],
        "step": 7,
        "tag": "hello",
    }


def test_roundtrip_mixed_tree():
    with ObjectStore() as store:
        tree = _tree()
        ref = store.put(tree)
        assert isinstance(ref, ObjectRef)
        # the three leaves of 64 KiB or more cross shm, the rest inline
        assert len(ref.segments) == 3
        assert ref.total_shm_bytes() == (256 * 256 * 4 + 300 * 300 * 4
                                         + 128 * 128 * 8)
        out = store.get(ref)
        np.testing.assert_array_equal(out["params"]["w"],
                                      tree["params"]["w"])
        np.testing.assert_array_equal(out["params"]["b"],
                                      tree["params"]["b"])
        # CPU torch tensors come back as numpy, small or large
        assert isinstance(out["t"], np.ndarray)
        np.testing.assert_array_equal(out["t"], tree["t"].numpy())
        np.testing.assert_array_equal(out["small"], [1, 1, 1, 1])
        np.testing.assert_array_equal(out["seq"][0], tree["seq"][0])
        assert out["seq"][1] == ("x", 3)
        assert out["step"] == 7 and out["tag"] == "hello"
        out["params"]["w"][0, 0] = 123.0  # copies are independent
        assert store.get(ref)["params"]["w"][0, 0] != 123.0


def test_zero_copy_views_are_readonly():
    with ObjectStore() as store:
        tree = _tree()
        ref = store.put(tree)
        out = store.get(ref, copy=False)
        np.testing.assert_array_equal(out["params"]["w"],
                                      tree["params"]["w"])
        with pytest.raises(ValueError):
            out["params"]["w"][0, 0] = 1.0
        store.release(ref)


def test_delete_then_get_raises_enoent():
    store = ObjectStore()
    ref = store.put({"w": np.zeros((512, 512), dtype=np.float32)})
    store.delete(ref)
    with pytest.raises(ObjectStoreError, match="does not exist") as ei:
        store.get(ref)
    assert ei.value.errno == 2  # ENOENT
    store.shutdown()


def test_shutdown_unlinks_segments():
    store = ObjectStore()
    ref = store.put({"w": np.ones((512, 512), dtype=np.float32)})
    store.shutdown()
    with pytest.raises(ObjectStoreError):
        ObjectStore().get(ref)


def test_total_shm_bytes_tracks_put_and_delete():
    with ObjectStore() as store:
        assert store.total_shm_bytes() == 0
        ref1 = store.put({"w": np.zeros((256, 256), dtype=np.float32)})
        ref2 = store.put({"w": torch.zeros((128, 128))})
        assert store.total_shm_bytes() == 256 * 256 * 4 + 128 * 128 * 4
        store.delete(ref1)
        assert store.total_shm_bytes() == 128 * 128 * 4
        store.delete(ref2)
        assert store.total_shm_bytes() == 0


def test_global_shm_bytes_reader_never_builds_a_store():
    before = osl._GLOBAL
    assert osl.global_shm_bytes() >= 0
    assert osl._GLOBAL is before


def test_release_unmaps_one_refs_views_only():
    with ObjectStore() as store:
        ref_a = store.put({"w": np.full((256, 256), 3.0, dtype=np.float32)})
        ref_b = store.put({"w": np.full((256, 256), 7.0, dtype=np.float32)})
        store.get(ref_a, copy=False)
        vb = store.get(ref_b, copy=False)
        store.release(ref_a)
        assert float(vb["w"][0, 0]) == 7.0          # b's view survives
        assert float(store.get(ref_a)["w"][0, 0]) == 3.0  # a re-maps
        store.release(ref_b)


def test_refuses_what_numpy_cannot_hold():
    with ObjectStore() as store:
        with pytest.raises(TypeError, match="bfloat16"):
            store.put({"w": torch.zeros(8, dtype=torch.bfloat16)})
        assert store.total_shm_bytes() == 0


_CHILD = """
import pickle, sys
from ray_lightning_accelerators_tpu_torch.runtime import object_store
ref = pickle.loads(sys.stdin.buffer.read())
out = object_store.resolve(ref)
print(float(out["w"].sum()), out["w"].shape, out["w"].dtype, out["tag"])
"""


def test_ref_resolves_in_a_spawned_child_process():
    """A ref pickled into a freshly spawned interpreter on the same host
    maps the parent's segment by name (the store's reason to exist)."""
    with ObjectStore() as store:
        big = np.arange(1024 * 256, dtype=np.float32).reshape(1024, 256)
        ref = store.put({"w": big, "tag": "parent"})
        proc = subprocess.run([sys.executable, "-c", _CHILD],
                              input=pickle.dumps(ref), cwd=str(REPO),
                              capture_output=True, timeout=120)
        assert proc.returncode == 0, proc.stderr.decode()
        assert proc.stdout.decode().split() == [
            str(float(big.sum())), "(1024,", "256)", "float32", "parent"]


# --------------------------------------------------------------------- #
# wave_schedule against the JAX package's                               #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed,n,max_bytes", [
    (0, 1, 100), (1, 7, 1000), (2, 33, 4096), (3, 64, 1 << 20),
    (4, 12, 50),  # every item past the bound: a wave each
])
def test_wave_schedule_matches_jax(seed, n, max_bytes):
    sizes = np.random.default_rng(seed).integers(1, 2 * max_bytes // 3 + 2,
                                                 n).tolist()
    if seed == 4:
        sizes = [max_bytes + 1 + s for s in sizes]
    got = wave_schedule(sizes, max_bytes)
    assert got == jax_wave_schedule(sizes, max_bytes)
    assert [i for w in got for i in w] == list(range(n))
    for w in got:
        assert len(w) == 1 or sum(sizes[i] for i in w) <= max_bytes


def test_wave_schedule_oversized_leaf_and_empty():
    assert wave_schedule([10, 500, 10, 10], 100) == \
        jax_wave_schedule([10, 500, 10, 10], 100) == [[0], [1], [2, 3]]
    assert wave_schedule([], 100) == jax_wave_schedule([], 100) == []


# --------------------------------------------------------------------- #
# paged_blocks_gather / paged_blocks_scatter against the JAX model's     #
# --------------------------------------------------------------------- #
def _pool(rng, dtype=np.float32):
    shape = (2, 6, 2, 4, 8)  # [L, n_blocks, kv_heads, block_len, D]
    return {"k": rng.standard_normal(shape).astype(dtype),
            "v": rng.standard_normal(shape).astype(dtype)}


def test_paged_blocks_gather_matches_jax():
    pool = _pool(np.random.default_rng(5))
    ids = np.asarray([3, 1, 5, 0, 0], np.int32)  # padded with block 0
    jk, jv = JaxGPT.paged_blocks_gather(
        {n: jnp.asarray(a) for n, a in pool.items()}, jnp.asarray(ids))
    tpool = {n: torch.from_numpy(a) for n, a in pool.items()}
    k, v = GPT.paged_blocks_gather(tpool, torch.from_numpy(ids))
    assert tuple(k.shape) == (2, 5, 2, 4, 8)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    k[:] = 0  # a copy: the pool keeps its bytes
    np.testing.assert_array_equal(tpool["k"].numpy(), pool["k"])


@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
def test_paged_blocks_scatter_matches_jax(pool_dtype):
    rng = np.random.default_rng(6)
    pool = _pool(rng)
    k = rng.standard_normal((2, 4, 2, 4, 8)).astype(np.float32)
    v = rng.standard_normal((2, 4, 2, 4, 8)).astype(np.float32)
    ids = np.asarray([4, 2, 0, 0], np.int32)  # pads hit the garbage block
    jdt = jnp.bfloat16 if pool_dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, pool_dtype)
    jout = JaxGPT.paged_blocks_scatter(
        {n: jnp.asarray(a, jdt) for n, a in pool.items()},
        jnp.asarray(ids), jnp.asarray(k), jnp.asarray(v))
    tpool = {n: torch.from_numpy(a).to(tdt) for n, a in pool.items()}
    out = GPT.paged_blocks_scatter(tpool, torch.from_numpy(ids),
                                   torch.from_numpy(k), torch.from_numpy(v))
    assert out is tpool and out["k"].dtype == tdt  # in place, pool dtype
    for n in ("k", "v"):
        got = out[n].float().numpy()
        want = np.asarray(jout[n].astype(jnp.float32))
        # every block but the garbage block 0 is exact
        np.testing.assert_array_equal(got[:, 1:], want[:, 1:])
