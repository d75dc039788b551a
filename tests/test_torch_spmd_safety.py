"""The port's SPMD safety layer (port of tests/test_spmd_safety.py): the
three static rules recast for PyTorch (process groups, rank divergence,
the sharding inventory), the collective sanitizer over the
``torch.distributed`` entry points and its typed ``CollectiveMismatch``
across both wire paths, the driver-side seams (the Trainer's fan-out,
``ElasticRunner``), the sharding audit, and the CLI's JSON and parse
cache.

Where the JAX package has the same function (``diff_sequences``,
``CollectiveMismatch``'s message and round trip), both get the same
inputs and must agree exactly.  Multi-process cases run gloo ranks on
the CPU, one thread each, every join bounded."""

import json
import os
import subprocess
import sys
import time
import types

import pytest
import torch

from ray_lightning_accelerators_tpu.testing import spmd_sanitizer as JS
from ray_lightning_accelerators_tpu_torch.analysis import lint as L
from ray_lightning_accelerators_tpu_torch.testing import spmd_sanitizer as S

from . import torch_boring

pytestmark = pytest.mark.spmd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "ray_lightning_accelerators_tpu_torch")
SCRIPTS = os.path.join(REPO, "scripts")
WAIT = 120

AXES = dict(spmd_axis_names=frozenset({"data", "fsdp", "tensor", "batch"}))


def _findings(sources, rule=None, **cfg_kw):
    cfg = L.LintConfig(**cfg_kw) if cfg_kw else L.LintConfig.for_tree(sources)
    out = L.run_lint(sources, cfg)
    if rule is not None:
        out = [f for f in out if f.rule == rule]
    return out


def _active(findings):
    return [f for f in findings if not f.suppressed]


@pytest.fixture(scope="module")
def tree_findings():
    return L.lint_path(PORT_DIR)


# --------------------------------------------------------------------- #
# rule: spmd-collective                                                 #
# --------------------------------------------------------------------- #
MESH_SRC = '''
DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
BATCH_AXES = (DATA_AXIS, FSDP_AXIS)
BATCH_GROUP = "batch"
'''

SPMD_POSITIVE = '''
import torch.distributed as dist

def bad_literal(x, mesh):
    dist.all_reduce(x, group=mesh.group("model"))   # undeclared axis

def bad_private_group(x):
    g = dist.new_group([0, 1])                      # a group of its own
    dist.all_reduce(x, group=g)

def bad_positional(x, cfg):
    dist.broadcast(x, 0, cfg.lookup())              # opaque group

def bad_groups_get(x, mesh):
    dist.all_gather_into_tensor(x, x, group=mesh.groups.get("replica"))
'''

SPMD_NEGATIVE = '''
import torch.distributed as dist
from . import collectives as coll
from .meshmod import BATCH_GROUP, FSDP_AXIS

def world(x):
    dist.all_reduce(x)                              # the world group
    dist.all_reduce(x, group=None)
    dist.barrier(group=dist.group.WORLD)

def declared(x, mesh):
    dist.all_reduce(x, group=mesh.group("data"))
    dist.all_reduce(x, group=mesh.group(FSDP_AXIS))
    dist.all_reduce(x, group=mesh.group(BATCH_GROUP))

def derived(x, mesh, axis):
    g = mesh.group(axis)                            # a parameter's axis
    group, members = mesh.group(FSDP_AXIS), mesh.members
    coll.ppermute(x, group, members)
    for a in (FSDP_AXIS, "data"):
        dist.all_reduce(x, group=mesh.group(a))
    return coll.all_reduce_value(x, [mesh.group(a) for a in ("data",)]
                                 ) + g

def param(x, group):
    dist.all_to_all_single(x, x, group=group)       # flows from callers

class Exchange:
    def __init__(self, mesh):
        self.group = mesh.group(BATCH_GROUP) if mesh else None

    def mean(self, x):
        dist.all_reduce(x, group=self.group)
'''


def test_spmd_collective_positives():
    found = _findings({"m.py": SPMD_POSITIVE}, rule="spmd-collective",
                      **AXES)
    active = _active(found)
    msgs = "\n".join(f.message for f in active)
    assert len(active) == 4, found
    assert "['model']" in msgs and "['replica']" in msgs
    assert msgs.count("does not resolve") == 2
    assert {f.line for f in active} == {5, 9, 12, 15}


def test_spmd_collective_negatives():
    found = _findings({"meshmod.py": MESH_SRC, "collectives.py": "",
                       "m.py": SPMD_NEGATIVE},
                      rule="spmd-collective", **AXES)
    assert _active(found) == [], found


def test_spmd_collective_helpers_of_the_collectives_module():
    src = ("from ..parallel import collectives as C\n"
           "def f(x, cfg):\n"
           "    return C.gather_dim(x, 0, cfg.group_for(x))\n")
    found = _active(_findings({"models/m.py": src,
                               "parallel/collectives.py": ""},
                              rule="spmd-collective", **AXES))
    assert len(found) == 1 and "gather_dim" in found[0].message


def test_spmd_collective_disabled_without_axis_registry():
    found = _findings({"m.py": SPMD_POSITIVE}, rule="spmd-collective")
    assert found == []


def test_spmd_collective_pragma():
    src = ("import torch.distributed as dist\n"
           "def f(x, mesh):\n"
           "    # graftlint: ok(spmd-collective) — test fixture group\n"
           "    dist.all_reduce(x, group=mesh.group('weird'))\n")
    found = _findings({"m.py": src}, rule="spmd-collective", **AXES)
    assert found and all(f.suppressed for f in found)


# --------------------------------------------------------------------- #
# rule: rank-divergence                                                 #
# --------------------------------------------------------------------- #
RANK_POSITIVE = '''
import os
import random
import numpy as np
import torch
import torch.distributed as dist
from .collectives import world_and_rank

def gated_collective(x):
    if dist.get_rank() == 0:                 # rank branch over all_reduce
        dist.all_reduce(x)

def gated_barrier():
    world, rank = world_and_rank()
    if rank != 0:                            # via world_and_rank's rank
        dist.barrier()

def gated_commit(state, save_sharded):
    if int(os.environ["RANK"]) == 0:
        save_sharded("/ckpt", state, {})     # collective commit, gated

class Trainer:
    def _fit_step(self, x):
        return x * random.random() + self._noise(x)

    def _noise(self, x):
        return np.random.rand() + torch.rand(3)  # reachable from the root
'''

RANK_NEGATIVE = '''
import numpy as np
import torch
import torch.distributed as dist

def size_gated(x):
    if dist.get_world_size() > 1:            # uniform across ranks
        dist.all_reduce(x)

def rank_gated_logging(metrics, log):
    if dist.get_rank() == 0:                 # host-local work only
        log.info("metrics: %s", metrics)

class Trainer:
    def _fit_step(self, x, seed):
        rng = np.random.default_rng(seed)    # seeded: fine
        g = torch.Generator().manual_seed(seed)
        return x + rng.random() + torch.rand(3, generator=g)
'''

RANK_CFG = dict(hot_roots={"m.py": ("Trainer._fit_step",)})


def test_rank_divergence_positives():
    found = _findings({"m.py": RANK_POSITIVE}, rule="rank-divergence",
                      **RANK_CFG)
    active = _active(found)
    msgs = "\n".join(f.message for f in active)
    assert "collective dist.all_reduce" in msgs
    assert "barrier 'barrier'" in msgs
    assert "checkpoint commit 'save_sharded'" in msgs
    assert "'random.random(...)'" in msgs
    assert "'np.random.rand(...)'" in msgs and "'torch.rand(...)'" in msgs
    assert len(active) == 6, found


def test_rank_divergence_flags_elif_arms():
    src = ("import torch.distributed as dist\n"
           "def f(x, flag):\n"
           "    if dist.get_rank() == 0:\n"
           "        pass\n"
           "    elif flag:\n"
           "        dist.all_reduce(x)\n"
           "def g(x):\n"
           "    if dist.get_rank() == 0:\n"
           "        pass\n"
           "    else:\n"
           "        dist.broadcast(x, 0)\n")
    found = _active(_findings({"m.py": src}, rule="rank-divergence"))
    assert len(found) == 2, found


def test_rank_divergence_negatives():
    found = _findings({"m.py": RANK_NEGATIVE}, rule="rank-divergence",
                      **RANK_CFG)
    assert _active(found) == [], found


def test_rank_divergence_pragma():
    src = ("import torch.distributed as dist\n"
           "def f(state, save_sharded):\n"
           "    # graftlint: ok(rank-divergence) — single-writer meta\n"
           "    if dist.get_rank() == 0:\n"
           "        save_sharded('/p', state, {})\n")
    found = _findings({"m.py": src}, rule="rank-divergence")
    assert found and all(f.suppressed for f in found)


# --------------------------------------------------------------------- #
# rule: sharding-inventory                                              #
# --------------------------------------------------------------------- #
SPEC_SRC = '''
from ..parallel import sharding
from ..parallel.sharding import logical_to_spec, spec_layout

def layouts(tree, rules, mesh):
    a = logical_to_spec(tree, rules)         # imported spelling
    b = sharding.spec_layout(a, mesh)        # dotted spelling
    return spec_layout(a, mesh), b
'''


def test_sharding_inventory_flags_uninventoried_modules():
    found = _findings({"models/thing.py": SPEC_SRC},
                      rule="sharding-inventory")
    active = _active(found)
    assert len(active) == 3, found
    assert all("uninventoried" in f.message for f in active)


def test_sharding_inventory_allows_inventoried_modules():
    for key in ("parallel/sharding.py", "core/trainer.py",
                "accelerators/base.py"):
        found = _findings({key: SPEC_SRC}, rule="sharding-inventory")
        assert found == [], (key, found)


def test_sharding_inventory_pragma():
    src = ("from ..parallel.sharding import spec_layout\n"
           "# graftlint: ok(sharding-inventory) — test fixture layout\n"
           "spec = spec_layout(('data',), None)\n")
    found = _findings({"serve/engine.py": src}, rule="sharding-inventory")
    assert found and all(f.suppressed for f in found)


# --------------------------------------------------------------------- #
# the real tree: the SPMD rules on, clean, and firing                   #
# --------------------------------------------------------------------- #
def test_tree_is_clean_with_spmd_rules_and_they_fire(tree_findings):
    for rule in ("spmd-collective", "rank-divergence",
                 "sharding-inventory"):
        assert [f for f in tree_findings
                if f.rule == rule and not f.suppressed] == [], rule
    # the group rule genuinely fires on this tree (a pragma'd call)
    assert any(f.rule == "spmd-collective" and f.suppressed
               for f in tree_findings)
    cfg = L.LintConfig.for_tree(
        {"parallel/mesh.py": open(os.path.join(
            PORT_DIR, "parallel", "mesh.py")).read()})
    assert cfg.spmd_axis_names == {"data", "fsdp", "pipeline", "expert",
                                   "sequence", "tensor", "batch"}


# --------------------------------------------------------------------- #
# CLI: JSON output + parse cache                                        #
# --------------------------------------------------------------------- #
def test_cli_format_json_on_tree():
    script = os.path.join(SCRIPTS, "torch_graftlint.py")
    proc = subprocess.run(
        [sys.executable, script, PORT_DIR, "--format", "json"],
        capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["schema"] == 1 and payload["active"] == 0
    assert payload["exit_code"] == 0 and payload["suppressed"] > 0
    rows = payload["findings"]
    assert rows and all(
        set(r) >= {"rule", "path", "line", "col", "message", "suppressed"}
        for r in rows)


def test_cli_format_json_nonzero_on_violation(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import os\nv = os.environ.get('RLA_TPU_OOPS')\n")
    script = os.path.join(SCRIPTS, "torch_graftlint.py")
    proc = subprocess.run(
        [sys.executable, script, str(bad), "--format", "json"],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    payload = json.loads(proc.stdout)
    assert payload["exit_code"] == 1
    assert any(r["rule"] == "knob-registry" for r in payload["findings"])
    proc = subprocess.run([sys.executable, script, "--format", "xml"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2


def test_parse_cache_is_mtime_keyed(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    target = pkg / "mod.py"
    target.write_text("import os\nx = os.environ.get('RLA_TPU_NOPE')\n")
    L.lint_path(str(pkg))
    path = str(target)
    assert path in L._MODULE_CACHE
    first = L._MODULE_CACHE[path][3]
    L.lint_path(str(pkg))
    assert L._MODULE_CACHE[path][3] is first  # a hit: the same object
    time.sleep(0.01)
    target.write_text("import os\nx = os.environ.get('PL_GLOBAL_SEED')\n")
    found = L.lint_path(str(pkg))
    assert L._MODULE_CACHE[path][3] is not first
    assert not any(f.rule == "knob-registry" for f in found)


# --------------------------------------------------------------------- #
# sanitizer: interception, sites, ring, spill                           #
# --------------------------------------------------------------------- #
@pytest.fixture
def solo_world(tmp_path, monkeypatch):
    """The sanitizer installed over a one-rank gloo world in this
    process (an in-process store), spilling under ``tmp_path``."""
    import torch.distributed as dist
    monkeypatch.setenv("RLA_TPU_TELEMETRY_DIR", str(tmp_path))
    san = S.install(rank=0)
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        yield san
    finally:
        dist.destroy_process_group()
        S.uninstall()


def test_sanitizer_records_each_eager_call(solo_world, tmp_path):
    import torch.distributed as dist

    from ray_lightning_accelerators_tpu_torch.parallel import (
        collectives as C, mesh as M)
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    for _ in range(2):  # eager: every call records, not one per trace
        dist.all_reduce(t)
    dist.broadcast(t, 0)
    out = torch.empty(2, 3)
    dist.all_gather_into_tensor(out, t)
    dist.barrier()
    ex = C.GradExchange(torch.device("cpu"), M.build_rank_mesh({}))
    ex.backend = "gloo"  # one rank: take the collective, not the copy
    line = sys._getframe().f_lineno + 1
    ex.all_reduce(torch.ones(5, dtype=torch.bfloat16))
    # the exchange's gather takes the newest name this torch has
    ex.all_gather(torch.empty(4), torch.ones(4))
    seq = solo_world.sequence()
    assert [e["op"] for e in seq[:6]] == [
        "all_reduce", "all_reduce", "broadcast", "all_gather_into_tensor",
        "barrier", "all_reduce"]
    assert seq[6]["op"] == C._new_api("all_gather_single",
                                      "all_gather_into_tensor").__name__
    seq = seq[:6]
    assert [e["i"] for e in seq] == list(range(6))
    first = seq[0]
    assert first["shape"] == [2, 3] and first["dtype"] == "float32"
    assert first["axes"] == [] and "test_torch_spmd_safety.py" in \
        first["site"]
    assert seq[4]["shape"] is None
    # the exchange's wrappers are skipped: the site is this test's line
    last = seq[-1]
    assert last["dtype"] == "bfloat16" and last["shape"] == [5]
    assert last["site"].endswith(f"test_torch_spmd_safety.py:{line}")
    # the spill landed rank-keyed, in JAX's snapshot format
    snaps = S.gather_sequences(str(tmp_path))
    assert set(snaps) == {"rank0"}
    assert set(snaps["rank0"]) == {"rank", "pid", "n", "capacity",
                                   "events"}
    assert snaps["rank0"]["events"][:6] == seq and snaps["rank0"]["n"] == 7
    from ray_lightning_accelerators_tpu_torch.telemetry import recorder as R
    assert "spmd_collective" in [e["kind"]
                                 for e in R.get_recorder().events()]


def test_sanitizer_p2pop_takes_the_wrapped_ops(solo_world):
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d
    assert getattr(dist.isend, "_rla_spmd_wrapped", False)
    op = dist.P2POp(dist.isend, torch.ones(2), 0)
    assert op.op is c10d.isend  # torch checks the op by identity
    assert isinstance(op, c10d.P2POp)


def test_sanitizer_spills_before_the_call_enters(tmp_path):
    """A rank that blocks in call k must leave call k on disk."""
    path = str(tmp_path / "rank1.collectives.json")
    san = S.SpmdSanitizer(capacity=8, rank=1, spill_path=path)
    seen = []

    def blocking(tensor, op=None, group=None, async_op=False):
        with open(path) as f:
            seen.append(json.load(f)["events"][-1]["op"])

    wrapped = S._make_wrapper("all_reduce", blocking, san)
    wrapped(torch.ones(3))
    assert seen == ["all_reduce"]


def test_sanitizer_uninstall_restores_torch_distributed():
    import torch.distributed as dist
    orig = dist.all_reduce
    S.install(S.SpmdSanitizer(capacity=4))
    assert getattr(dist.all_reduce, "_rla_spmd_wrapped", False)
    assert getattr(dist.P2POp, "_rla_spmd_wrapped", False)
    S.uninstall()
    assert dist.all_reduce is orig
    assert not getattr(dist.P2POp, "_rla_spmd_wrapped", False)
    assert S.get_sanitizer() is None
    S.uninstall()  # a second uninstall is a no-op


def test_sanitizer_reinstall_rebinds_ring_without_double_wrap():
    import torch.distributed as dist
    orig = dist.all_reduce
    try:
        a = S.install(S.SpmdSanitizer(capacity=8))
        b = S.install(S.SpmdSanitizer(capacity=8))
        assert S.get_sanitizer() is b
        # one wrapper layer only, over the original
        assert dist.all_reduce.__wrapped__ is orig
        b.record("all_reduce", ["data"])
        assert a.sequence() == [] and len(b.sequence()) == 1
    finally:
        S.uninstall()
    assert dist.all_reduce is orig


def test_sanitizer_ring_keeps_absolute_indices_as_jax():
    san, jsan = S.SpmdSanitizer(capacity=4), JS.SpmdSanitizer(capacity=4)
    for i in range(10):
        san.record("all_reduce", "data", site=f"m.py:{i}")
        jsan.record("all_reduce", "data", site=f"m.py:{i}")
    seq = san.sequence()
    assert [e["i"] for e in seq] == [6, 7, 8, 9]
    assert seq == jsan.sequence()
    snap, jsnap = san.snapshot(), jsan.snapshot()
    assert {k: v for k, v in snap.items() if k != "pid"} == \
        {k: v for k, v in jsnap.items() if k != "pid"}


def test_maybe_install_honors_knob(monkeypatch):
    monkeypatch.delenv(S.SANITIZER_ENV, raising=False)
    assert S.maybe_install_from_env() is None
    try:
        san = S.maybe_install_from_env(
            rank=3, env={S.SANITIZER_ENV: "1",
                         "RLA_TPU_SPMD_SEQ_EVENTS": "16"})
        assert san is not None and san.capacity == 16 and san.rank == 3
    finally:
        S.uninstall()


def test_group_axes_follow_the_mesh(monkeypatch):
    from ray_lightning_accelerators_tpu_torch.parallel import mesh as M
    g = object()
    monkeypatch.setitem(M._GROUPS["axes"], g, M.BATCH_AXES)
    monkeypatch.setitem(M._GROUPS, "world_axes", ("data",))
    assert M.group_axes(g) == ("data", "fsdp")
    assert M.group_axes(None) == ("data",)
    assert M.group_axes(object()) == ()
    assert S._group_axes(g) == ["data", "fsdp"]


# --------------------------------------------------------------------- #
# checker: diff + typed CollectiveMismatch, against the JAX package's   #
# --------------------------------------------------------------------- #
def _seq_snapshot(rank, ops, start=0):
    events = [{"i": start + j, "op": op, "axes": ["data"], "shape": [4],
               "dtype": "float32",
               "site": f"parallel/x.py:{10 + start + j}"}
              for j, op in enumerate(ops)]
    return {"rank": rank, "pid": 1, "n": start + len(ops),
            "capacity": 512, "events": events}


def _write_seq(tdir, rank, ops, start=0):
    os.makedirs(str(tdir), exist_ok=True)
    path = os.path.join(str(tdir), f"rank{rank}.collectives.json")
    with open(path, "w") as f:
        json.dump(_seq_snapshot(rank, ops, start), f)


_DIFF_CASES = {
    "identical": {"rank0": _seq_snapshot(0, ["all_reduce", "all_gather"]),
                  "rank1": _seq_snapshot(1, ["all_reduce", "all_gather"])},
    "divergent": {"rank0": _seq_snapshot(0, ["all_reduce", "all_gather"]),
                  "rank1": _seq_snapshot(1, ["all_reduce", "broadcast"])},
    "ends_early": {"rank0": _seq_snapshot(0, ["all_reduce", "barrier"]),
                   "rank1": _seq_snapshot(1, ["all_reduce"])},
    "driver_only_other": {"rank0": _seq_snapshot(0, ["all_reduce"]),
                          "driver": _seq_snapshot(None, [])},
    "ring_dropped": {"rank0": _seq_snapshot(0, ["broadcast"] * 4, start=6),
                     "rank1": _seq_snapshot(1, ["all_reduce"] * 6
                                            + ["broadcast"] * 4)},
    "ring_dropped_divergent": {
        "rank0": _seq_snapshot(0, ["broadcast"] * 4, start=6),
        "rank1": _seq_snapshot(1, ["all_reduce"] * 6 + ["broadcast"] * 3
                               + ["all_gather"])},
}


@pytest.mark.parametrize("case", sorted(_DIFF_CASES))
def test_diff_sequences_matches_jax(case):
    snaps = _DIFF_CASES[case]
    got = S.diff_sequences(snaps)
    assert got == JS.diff_sequences(snaps)
    if case in ("identical", "driver_only_other", "ring_dropped"):
        assert got is None
    else:
        assert got["first_divergence"] == (9 if "ring" in case else 1)
        assert got["ring_dropped"] == ("ring" in case)
    if case == "ends_early":
        assert got["per_rank"]["rank1"] is None


def test_mismatch_message_and_round_trip_match_jax():
    diag = S.diff_sequences(_DIFF_CASES["ends_early"])
    exc, jexc = (S.CollectiveMismatch.from_divergence(diag),
                 JS.CollectiveMismatch.from_divergence(diag))
    assert str(exc) == str(jexc)
    assert "rank rank1: <no call #1>" in str(exc)
    for text in (str(exc), str(jexc), "no marker here",
                 "broken | collectives={not json"):
        assert S.CollectiveMismatch.from_message(text).diagnosis == \
            JS.CollectiveMismatch.from_message(text).diagnosis
    assert S.CollectiveMismatch.from_message(str(jexc)).diagnosis == diag


def test_checker_raises_typed_mismatch(tmp_path):
    _write_seq(tmp_path, 0, ["all_reduce", "all_gather"])
    _write_seq(tmp_path, 1, ["all_reduce", "broadcast"])
    with pytest.raises(S.CollectiveMismatch) as ei:
        S.check_collective_sequences(str(tmp_path))
    exc = ei.value
    assert exc.diagnosis["first_divergence"] == 1
    assert "all_gather" in str(exc) and "broadcast" in str(exc)
    assert "parallel/x.py:11" in str(exc)  # the divergent call's site
    back = S.check_collective_sequences(str(tmp_path),
                                        raise_on_mismatch=False)
    assert isinstance(back, S.CollectiveMismatch)


def test_clear_spills_removes_only_sequence_files(tmp_path):
    _write_seq(tmp_path, 0, ["all_reduce"])
    _write_seq(tmp_path, 3, ["broadcast"])
    other = os.path.join(str(tmp_path), "rank0.events.json")
    with open(other, "w") as f:
        f.write("{}")
    with open(os.path.join(str(tmp_path), "rank5.collectives.json"),
              "w") as f:
        f.write("{torn")
    assert set(S.gather_sequences(str(tmp_path))) == {"rank0", "rank3"}
    S.clear_spills(str(tmp_path))
    assert S.gather_sequences(str(tmp_path)) == {}
    assert os.path.exists(other)  # flight-recorder spills untouched


def test_elastic_decodes_hangs_only(tmp_path, monkeypatch):
    from ray_lightning_accelerators_tpu_torch.runtime.elastic import (
        ElasticRunner)
    from ray_lightning_accelerators_tpu_torch.runtime.watchdog import (
        WorkerWedged)
    _write_seq(tmp_path, 0, ["all_reduce", "all_gather"])
    _write_seq(tmp_path, 1, ["all_reduce"])      # cut off mid-run
    monkeypatch.setenv(S.SANITIZER_ENV, "1")
    monkeypatch.setenv("RLA_TPU_TELEMETRY_DIR", str(tmp_path))
    runner = ElasticRunner(types.SimpleNamespace(workers=[]))
    assert runner._collective_mismatch(RuntimeError("worker died")) is None
    wedge = WorkerWedged.for_rank(1, {"detail": "stuck"})
    assert isinstance(runner._collective_mismatch(wedge),
                      S.CollectiveMismatch)
    assert isinstance(runner._collective_mismatch(TimeoutError("t")),
                      S.CollectiveMismatch)


def test_check_world_collectives_is_gated(tmp_path, monkeypatch):
    _write_seq(tmp_path, 0, ["all_reduce"])
    _write_seq(tmp_path, 1, ["broadcast"])
    monkeypatch.setenv("RLA_TPU_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.delenv(S.SANITIZER_ENV, raising=False)
    assert S.check_world_collectives() is None   # knob off: a no-op
    S.reset_world_collectives()                  # gated the same way
    assert len(S.gather_sequences(str(tmp_path))) == 2
    monkeypatch.setenv(S.SANITIZER_ENV, "1")
    with pytest.raises(S.CollectiveMismatch):
        S.check_world_collectives()
    S.reset_world_collectives()
    assert S.gather_sequences(str(tmp_path)) == {}


# --------------------------------------------------------------------- #
# wire: CollectiveMismatch crosses the local pipe AND the agent relay   #
# --------------------------------------------------------------------- #
def test_mismatch_rebuilds_typed_over_local_pipe():
    from ray_lightning_accelerators_tpu_torch.runtime.actors import (
        ActorPool)
    with ActorPool(1) as pool:
        fut = pool.execute_all(torch_boring.raise_collective_mismatch)[0]
        with pytest.raises(S.CollectiveMismatch) as ei:
            fut.result(timeout=WAIT)
    exc = ei.value
    assert exc.remote_typed  # rebuilt from the wire payload
    assert exc.diagnosis["first_divergence"] == 2
    assert exc.diagnosis["per_rank"]["rank1"] is None


def test_mismatch_rebuilds_typed_over_agent_relay():
    from ray_lightning_accelerators_tpu_torch.runtime.agent import (
        HostAgent, RemoteWorker)
    agent = HostAgent(port=0, bind="127.0.0.1")
    agent.serve_in_background()
    w = None
    try:
        w = RemoteWorker(f"127.0.0.1:{agent.port}", rank=0)
        with pytest.raises(S.CollectiveMismatch) as ei:
            w.execute(torch_boring.raise_collective_mismatch).result(
                timeout=WAIT)
        exc = ei.value
        assert exc.remote_typed
        assert exc.diagnosis["first_divergence"] == 2
        assert "collectives.py:200" in str(exc)
    finally:
        if w is not None:
            w.kill()
        agent.shutdown()


def test_wire_registry_roundtrips_every_name():
    from ray_lightning_accelerators_tpu.runtime import wire as jwire
    from ray_lightning_accelerators_tpu_torch.runtime import wire
    assert set(wire.WIRE_EXCEPTION_NAMES) == set(wire._rebuilders())
    assert wire.WIRE_EXCEPTION_NAMES == jwire.WIRE_EXCEPTION_NAMES
    for name in wire._rebuilders():
        sample = (S.CollectiveMismatch.from_divergence(
            {"first_divergence": 0, "per_rank": {}})
            if name == "CollectiveMismatch" else None)
        msg = str(sample) if sample is not None else f"{name}: boom"
        back = wire.rebuild_remote(name, msg, "tb")
        assert type(back).__name__ == name, (name, type(back))
        assert back.remote_typed


# --------------------------------------------------------------------- #
# fan-out: rank-divergent collectives over forked workers              #
# --------------------------------------------------------------------- #
def _sanitizer_env(tdir):
    return {"RLA_TPU_SPMD_SANITIZER": "1",
            "RLA_TPU_TELEMETRY_DIR": str(tdir)}


def test_fanout_divergence_caught_typed(tmp_path):
    """Two workers issue rank-dependent collective sequences (each in a
    world of its own, so the extra call cannot block); the driver's
    diff raises the typed mismatch naming the first divergent call."""
    from ray_lightning_accelerators_tpu_torch.runtime.actors import (
        ActorPool)
    env = _sanitizer_env(tmp_path)
    with ActorPool(2, env_per_worker=[dict(env), dict(env)]) as pool:
        futs = pool.execute_per_worker(torch_boring.solo_world_collectives,
                                       [(0, 1), (1, 1)])
        assert [f.result(timeout=WAIT) for f in futs] == [1.0, 1.0]
        assert set(S.gather_sequences(str(tmp_path))) == {"rank0", "rank1"}
        with pytest.raises(S.CollectiveMismatch) as ei:
            S.check_collective_sequences(str(tmp_path))
    diag = ei.value.diagnosis
    assert diag["first_divergence"] == 1
    assert diag["per_rank"]["rank0"] is None      # rank0 made no call 1
    assert diag["per_rank"]["rank1"]["op"] == "all_reduce"
    assert "torch_boring.py" in diag["per_rank"]["rank1"]["site"]
    assert diag["lengths"] == {"rank0": 1, "rank1": 2}


def test_formed_world_agrees_and_records_the_batch_axes(tmp_path,
                                                         monkeypatch):
    """A real 2-rank gloo world with the sanitizer on (the workers
    inherit the driver's environment): the exchange's mean records over
    the batch group's axes and the ranks agree."""
    from ray_lightning_accelerators_tpu_torch.runtime import bootstrap
    monkeypatch.setattr(bootstrap, "DEFAULT_TIMEOUT_S", 60.0)
    for k, v in _sanitizer_env(tmp_path).items():
        monkeypatch.setenv(k, v)
    world = bootstrap.DistributedWorld(2, devices=["cpu"] * 2,
                                       timeout_s=60.0)
    try:
        out = world.run(torch_boring.batch_mean_body, deadline_s=WAIT)
    finally:
        world.shutdown()
    assert out[0] == out[1] == [[0.5] * 3, [1.0] * 2]
    assert S.check_collective_sequences(str(tmp_path)) is None
    snaps = S.gather_sequences(str(tmp_path))
    assert set(snaps) == {"rank0", "rank1"}
    mean = [e for e in snaps["rank0"]["events"]
            if e["op"] == "all_reduce" and e["shape"] == [5]]
    assert mean and mean[-1]["axes"] == ["data", "fsdp"]
    # the first frame above the exchange's pass-through primitives
    assert "parallel/collectives.py" in mean[-1]["site"]


@pytest.mark.chaos
def test_elastic_wedge_decodes_to_collective_mismatch(tmp_path,
                                                      monkeypatch):
    """The acceptance loop: rank 1 of a formed 2-rank world issues one
    all_reduce more and blocks in it; the watchdog reaps the wedge and
    the ElasticRunner raises the typed mismatch after one attempt
    instead of retrying a deterministic divergence."""
    from ray_lightning_accelerators_tpu_torch.runtime.actors import (
        ActorPool)
    from ray_lightning_accelerators_tpu_torch.runtime.bootstrap import (
        pick_coordinator_address)
    from ray_lightning_accelerators_tpu_torch.runtime.elastic import (
        ElasticRunner)
    from ray_lightning_accelerators_tpu_torch.runtime.watchdog import (
        WorkerWedged)
    env = _sanitizer_env(tmp_path)
    env["RLA_TPU_WORKER_HEARTBEAT_S"] = "0.1"
    for k, v in _sanitizer_env(tmp_path).items():
        monkeypatch.setenv(k, v)
    pool = ActorPool(2, env_per_worker=[dict(env), dict(env)])
    try:
        runner = ElasticRunner(pool, max_failures=2,
                               dispatch_deadline_s=6.0,
                               watchdog_poll_s=0.1)
        coord = pick_coordinator_address()
        with pytest.raises(S.CollectiveMismatch) as ei:
            runner.run(torch_boring.divergent_then_block,
                       args_per_worker=lambda a: [(r, coord)
                                                  for r in range(2)])
        diag = ei.value.diagnosis
        assert diag["first_divergence"] == 1
        assert diag["per_rank"]["rank0"] is None
        assert diag["per_rank"]["rank1"]["op"] == "all_reduce"
        assert runner.attempts_used == 1  # terminal, not retried
        assert isinstance(ei.value.__cause__, (WorkerWedged, TimeoutError))
    finally:
        pool.kill()


# --------------------------------------------------------------------- #
# Trainer seam: the fan-out's failure decodes to the typed mismatch    #
# --------------------------------------------------------------------- #
class _SeqWorld:
    """A stand-in world whose 'ranks' write divergent spills during
    run() (after the seam's run-entry reset), then wedge or complete."""

    last_stall = ()

    def __init__(self, tdir, wedge=False):
        self.tdir = tdir
        self.wedge = wedge
        self.shut = False

    def run(self, body, queue=None, deadline_s=None):
        _write_seq(self.tdir, 0, ["all_reduce", "all_gather"])
        _write_seq(self.tdir, 1, ["all_reduce", "broadcast"])
        if self.wedge:
            from ray_lightning_accelerators_tpu_torch.runtime.watchdog import (
                WorkerWedged)
            raise WorkerWedged.for_rank(1, {"detail": "stopped making "
                                                      "progress"})
        return [{"ok": True}, {"ok": True}]

    def shutdown(self):
        self.shut = True


def _seam_trainer(tmp_path):
    from ray_lightning_accelerators_tpu_torch import Trainer
    return Trainer(device="cpu", max_steps=1, seed=0,
                   enable_checkpointing=False,
                   default_root_dir=str(tmp_path))


def test_trainer_wedge_decodes_to_mismatch(tmp_path, monkeypatch):
    tdir = tmp_path / "telemetry"
    _write_seq(tdir, 7, ["all_to_all"])  # a stale spill of an old run
    monkeypatch.setenv(S.SANITIZER_ENV, "1")
    monkeypatch.setenv("RLA_TPU_TELEMETRY_DIR", str(tdir))
    trainer = _seam_trainer(tmp_path)
    module = types.SimpleNamespace()
    from ray_lightning_accelerators_tpu_torch.runtime.watchdog import (
        WorkerWedged)
    with pytest.raises(S.CollectiveMismatch) as ei:
        trainer._run_in_world(_SeqWorld(tdir, wedge=True), module, None,
                              "kept")
    assert isinstance(ei.value.__cause__, WorkerWedged)
    diag = ei.value.diagnosis
    assert diag["per_rank"]["rank1"]["op"] == "broadcast"
    assert "rank7" not in diag["per_rank"]  # the stale spill was cleared
    assert module.params == "kept" and module.trainer is trainer
    assert trainer.last_stall_diagnosis is not None
    rep = json.load(open(os.path.join(str(tmp_path), "run_report.json")))
    assert rep["error"]["type"] == "CollectiveMismatch"


def test_trainer_completed_run_still_checked(tmp_path, monkeypatch):
    tdir = tmp_path / "telemetry"
    monkeypatch.setenv(S.SANITIZER_ENV, "1")
    monkeypatch.setenv("RLA_TPU_TELEMETRY_DIR", str(tdir))
    trainer = _seam_trainer(tmp_path)
    world = _SeqWorld(tdir)
    with pytest.raises(S.CollectiveMismatch):
        trainer._run_in_world(world, types.SimpleNamespace(), None, None)
    assert world.shut  # the live, poisoned world was ended
    # knob off: the same divergent spills are ignored (opt-in)
    monkeypatch.delenv(S.SANITIZER_ENV)
    out = _seam_trainer(tmp_path)._run_in_world(
        _SeqWorld(tdir), types.SimpleNamespace(), None, None)
    assert out == [{"ok": True}, {"ok": True}]


def test_trainer_crash_failures_are_not_decoded(tmp_path, monkeypatch):
    tdir = tmp_path / "telemetry"
    monkeypatch.setenv(S.SANITIZER_ENV, "1")
    monkeypatch.setenv("RLA_TPU_TELEMETRY_DIR", str(tdir))

    class _CrashWorld(_SeqWorld):
        def run(self, body, queue=None, deadline_s=None):
            _write_seq(self.tdir, 0, ["all_reduce", "all_gather"])
            _write_seq(self.tdir, 1, ["all_reduce"])   # cut off
            raise RuntimeError("worker 1 died")

    with pytest.raises(RuntimeError, match="worker 1 died"):
        _seam_trainer(tmp_path)._run_in_world(
            _CrashWorld(tdir), types.SimpleNamespace(), None, None)


# --------------------------------------------------------------------- #
# sharding audit                                                        #
# --------------------------------------------------------------------- #
def test_sharding_audit_inventory_covers_the_modules(tmp_path):
    out = tmp_path / "inv.json"
    script = os.path.join(SCRIPTS, "torch_sharding_audit.py")
    proc = subprocess.run(
        [sys.executable, script, "--out", str(out), "--quiet",
         "--skip-drift"], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    assert record["kind"] == "sharding_audit" and "value" not in record
    assert record["uninventoried"] is None
    inv = json.load(open(str(out)))
    assert inv["schema"] == 1
    for mod in ("parallel/collectives.py", "parallel/sharding.py",
                "parallel/ulysses.py", "parallel/ring_attention.py",
                "parallel/pipeline.py"):
        assert mod in inv["modules"] and not inv["modules"][mod].get(
            "missing"), mod
    assert inv["totals"]["spec_constructor_calls"] >= 2
    assert inv["totals"]["group_lookups"] > 5
    assert set(inv["axis_names"]) == {"data", "fsdp", "pipeline",
                                      "sequence", "tensor", "expert",
                                      "batch"}
    # the committed artifact stays in sync with the tree
    committed = os.path.join(PORT_DIR, "SHARDING_INVENTORY.json")
    assert json.load(open(committed))["totals"] == inv["totals"]


def test_sharding_audit_drift_exits_nonzero(monkeypatch):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_torch_audit_for_test",
        os.path.join(SCRIPTS, "torch_sharding_audit.py"))
    audit = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(audit)
    monkeypatch.setattr(audit, "drift_findings", lambda lint: [
        {"rule": "sharding-inventory", "path": "serve/engine.py",
         "line": 10, "col": 0, "suppressed": False,
         "message": "spec constructor in uninventoried module"}])
    assert audit.main(["--no-write", "--quiet"]) == 1
    monkeypatch.setattr(audit, "drift_findings", lambda lint: [])
    assert audit.main(["--no-write", "--quiet"]) == 0
