"""The port's graftlint and compile guard (port of tests/test_analysis.py):
the recast rules on fixture snippets (positive, negative and
pragma-suppressed per rule), the rules and engine parts ported as they
are held to the JAX package's on the same inputs (the pragma parser,
``Finding.format``, ``report`` / ``report_json``, the ``knob-registry``
and ``wire-exception`` findings), the knob registry against the JAX
package's (typed getters on the same env, default and kind of every
knob both hold), ``seed_everything``'s env read, the port's tree clean,
the CLI, and the build-count guard over a warm Trainer step and a warm
engine decode.  All CPU."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from ray_lightning_accelerators_tpu.analysis import knobs as jknobs
from ray_lightning_accelerators_tpu.analysis import lint as JL
from ray_lightning_accelerators_tpu_torch.analysis import knobs
from ray_lightning_accelerators_tpu_torch.analysis import lint as L
from ray_lightning_accelerators_tpu_torch.analysis.compile_guard import (
    CompileBudgetExceeded, assert_no_new_compiles, compile_count,
    compile_count_record, compile_guard)

pytestmark = pytest.mark.analysis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "ray_lightning_accelerators_tpu_torch")
CLI = os.path.join(REPO, "scripts", "torch_graftlint.py")


def _findings(sources, rule=None, **cfg_kw):
    cfg = L.LintConfig(**cfg_kw) if cfg_kw else L.LintConfig.for_tree(sources)
    out = L.run_lint(sources, cfg)
    if rule is not None:
        out = [f for f in out if f.rule == rule]
    return out


def _active(findings):
    return [f for f in findings if not f.suppressed]


def _rows(findings):
    return [(f.rule, f.path, f.line, f.col, f.message, f.suppressed)
            for f in findings]


# --------------------------------------------------------------------- #
# host-sync                                                             #
# --------------------------------------------------------------------- #
HOT_CFG = dict(hot_roots={"hot.py": ("Engine.run",)})

HOT_POSITIVE = '''
import numpy as np
import torch

class Engine:
    def run(self, x):
        y = torch.sum(x)
        a = float(y)                    # float on a device value
        b = y.item()                    # .item()
        c = y.tolist()                  # .tolist()
        d = y.cpu()                     # .cpu()
        e = np.asarray(y)               # host materialization
        torch.cuda.synchronize()        # the card
        self._done.synchronize()        # an event
        s = y.mean()
        f = int(s)                      # a value a tensor method made
        self.helper(y)
        return a, b, c, d, e, f

    def helper(self, y):
        return y.numpy()                # reachable via self.run -> helper
'''

HOT_NEGATIVE = '''
import numpy as np
import torch

class Engine:
    def run(self, xs):
        n = int(len(xs))                # a host int
        toks = np.zeros((4,), np.int32) # a host buffer
        return torch.as_tensor(toks).sum() + n

class Cold:
    def elsewhere(self, y):
        return float(torch.sum(y))      # not reachable from a hot root
'''


def test_host_sync_positives():
    found = _findings({"hot.py": HOT_POSITIVE}, rule="host-sync", **HOT_CFG)
    msgs = [f.message for f in _active(found)]
    assert len(msgs) == 9, found
    for what in ("'float(...)'", "'.item()'", "'.tolist()'", "'.cpu()'",
                 "'np.asarray'", "'torch.cuda.synchronize'",
                 "'.synchronize()'", "'int(...)'", "'.numpy()'"):
        assert any(m.startswith(what) for m in msgs), what
    assert any("Engine.helper" in m for m in msgs), \
        "reachability must follow self-method calls"
    assert all(f.path == "hot.py" for f in found)


def test_host_sync_negatives():
    found = _findings({"hot.py": HOT_NEGATIVE}, rule="host-sync", **HOT_CFG)
    assert _active(found) == [], found


def test_host_sync_pragma_suppression_requires_reason():
    src = (
        "import torch\n"
        "class Engine:\n"
        "    def run(self, x):\n"
        "        y = torch.sum(x)\n"
        "        return float(y)  # graftlint: ok(host-sync) — feed gate\n"
        "    def bad(self, x):\n"
        "        pass  # graftlint: ok(host-sync)\n")
    out = L.run_lint({"hot.py": src}, L.LintConfig(**HOT_CFG))
    hs = [f for f in out if f.rule == "host-sync"]
    assert len(hs) == 1 and hs[0].suppressed
    assert any(f.rule == "pragma" and not f.suppressed for f in out)


# --------------------------------------------------------------------- #
# rebuild (the port's counterpart of retrace)                           #
# --------------------------------------------------------------------- #
REBUILD_CFG = dict(hot_roots={"m.py": ("Engine.step",)})

REBUILD_POSITIVE = '''
import ctypes
import torch
from torch.utils import cpp_extension
from ..ops import _build

def per_item(paths):
    return [ctypes.CDLL(p) for p in paths]      # a load per iteration

def per_step(xs):
    for x in xs:
        f = torch.compile(lambda a: a + 1)      # a compile per iteration
        f(x)

class Engine:
    def step(self, x):
        _build.build_all()                      # a build per step
        return self._load()

    def _load(self):
        return cpp_extension.load("k", ["k.cu"])  # reachable from step
'''

REBUILD_NEGATIVE = '''
import ctypes
import torch
from ..ops import _build

_lib = ctypes.CDLL("libk.so")                   # once, at import
_fast = torch.compile(lambda a: a + 1)          # once, reused

class Engine:
    def step(self, x):
        lib = _build.library("norms")           # the cached accessor
        return _fast(x), lib

def warm():
    _build.build_all()                          # cold path, outside loops
'''


def test_rebuild_positives():
    found = _active(_findings({"m.py": REBUILD_POSITIVE}, rule="rebuild",
                              **REBUILD_CFG))
    msgs = "\n".join(f.message for f in found)
    assert len(found) == 4, found
    assert "'ctypes.CDLL(...)' inside a loop body" in msgs
    assert "'torch.compile(...)' inside a loop body" in msgs
    assert "'_build.build_all(...)' in hot path (Engine.step)" in msgs
    assert "'cpp_extension.load(...)' in hot path (Engine._load)" in msgs


def test_rebuild_negatives_and_builder_modules():
    found = _findings({"m.py": REBUILD_NEGATIVE}, rule="rebuild",
                      **REBUILD_CFG)
    assert _active(found) == [], found
    # the builders themselves are where a build belongs
    assert _findings({"ops/_build.py": REBUILD_POSITIVE},
                     rule="rebuild") == []


def test_rebuild_pragma():
    src = ("import ctypes\n"
           "def f(paths):\n"
           "    for p in paths:\n"
           "        # graftlint: ok(rebuild) — test fixture, cold path\n"
           "        ctypes.CDLL(p)\n")
    found = _findings({"m.py": src}, rule="rebuild")
    assert found and all(f.suppressed for f in found)


# --------------------------------------------------------------------- #
# graph-leak (the port's counterpart of tracer-leak)                    #
# --------------------------------------------------------------------- #
LEAK_CFG = dict(hot_roots={"m.py": ("Trainer._fit_step",)})

LEAK_POSITIVE = '''
import torch

_last = None

class Trainer:
    def _fit_step(self, batch):
        out = self.model(batch)
        loss = self._loss(out, batch)
        self.last_loss = loss                 # the graph kept on self
        self.history["out"] = out * 2         # a view of the forward
        self._keep(batch)
        return loss

    def _keep(self, batch):
        global _last
        _last = self.aux_loss(batch)          # smuggled out via a global
'''

LEAK_NEGATIVE = '''
import torch

class Trainer:
    def _fit_step(self, batch):
        loss = self.model.training_step(batch)
        self.last_loss = loss.detach()        # detached: no graph
        self.loss_value = float(loss)         # a host number
        with torch.no_grad():
            self.ema = self.model(batch)      # no graph under no_grad
        return loss

    def cold(self, batch):
        self.kept = self.model(batch)         # not a hot path
'''


def test_graph_leak():
    pos = _active(_findings({"m.py": LEAK_POSITIVE}, rule="graph-leak",
                            **LEAK_CFG))
    msgs = "\n".join(f.message for f in pos)
    assert len(pos) == 3, pos
    assert "'self.last_loss'" in msgs and "'self.history['out']'" in msgs
    assert "'_last'" in msgs and "Trainer._keep" in msgs
    neg = _findings({"m.py": LEAK_NEGATIVE}, rule="graph-leak", **LEAK_CFG)
    assert _active(neg) == [], neg


def test_graph_leak_pragma():
    src = ("class Trainer:\n"
           "    def _fit_step(self, batch):\n"
           "        # graftlint: ok(graph-leak) — test fixture keeps it\n"
           "        self.kept = self.model(batch)\n")
    found = _findings({"m.py": src}, rule="graph-leak", **LEAK_CFG)
    assert found and all(f.suppressed for f in found)


# --------------------------------------------------------------------- #
# knob-registry and wire-exception: the JAX package's rules, same      #
# findings on the same sources                                          #
# --------------------------------------------------------------------- #
KNOB_CFG = dict(knob_names=frozenset({"RLA_TPU_REGISTERED"}))

KNOB_POSITIVE = '''
import os
MY_ENV = "RLA_TPU_SECRET_KNOB"
raw = os.environ.get("RLA_TPU_SECRET_KNOB")    # raw read, literal
via_const = os.environ[MY_ENV]                 # raw read via constant
dyn = os.getenv(raw)                           # dynamic key
from ray_lightning_accelerators_tpu_torch.analysis import knobs
bad = knobs.get_int("RLA_TPU_UNREGISTERED", 1)  # getter, unregistered
'''

KNOB_NEGATIVE = '''
import os
from ray_lightning_accelerators_tpu_torch.analysis import knobs
seed = os.environ.get("PL_GLOBAL_SEED", "")    # non-RLA name: allowed
os.environ["RLA_TPU_REGISTERED"] = "1"         # write: exempt
ok = knobs.get_int("RLA_TPU_REGISTERED", 1)    # registered getter
'''

KNOB_IMPORTED = {
    "consts.py": 'GRACE_ENV = "RLA_TPU_PREEMPT_GRACE_S"\n',
    "user.py": ("import os\n"
                "from .consts import GRACE_ENV\n"
                "v = os.environ.get(GRACE_ENV)\n")}

WIRE_CFG = dict(wire_names=frozenset({"Registered"}),
                worker_modules=("worker.py",))

WIRE_SRC = '''
class Registered(RuntimeError):
    pass

class Unregistered(RuntimeError):
    pass

def dispatched():
    raise Registered("typed, rebuilds fine")

def also_dispatched(flag):
    if flag:
        raise ValueError("builtins stay generic on purpose")
    raise Unregistered("typed but NOT in the wire registry")
'''


@pytest.mark.parametrize("rule,sources,cfg", [
    ("knob-registry", {"m.py": KNOB_POSITIVE}, KNOB_CFG),
    ("knob-registry", {"m.py": KNOB_NEGATIVE}, KNOB_CFG),
    ("knob-registry", KNOB_IMPORTED, KNOB_CFG),
    ("wire-exception", {"worker.py": WIRE_SRC}, WIRE_CFG),
    ("wire-exception", {"driver.py": WIRE_SRC}, WIRE_CFG),
], ids=["knob-positive", "knob-negative", "knob-imported", "wire-worker",
        "wire-driver"])
def test_ported_rules_match_jax(rule, sources, cfg):
    ours = [f for f in L.run_lint(sources, L.LintConfig(**cfg))
            if f.rule == rule]
    theirs = [f for f in JL.run_lint(sources, JL.LintConfig(**cfg))
              if f.rule == rule]
    assert _rows(ours) == _rows(theirs)
    if "positive" in str(sources) or sources is KNOB_IMPORTED:
        assert ours


def test_knob_registry_findings_read_as_in_jax():
    msgs = "\n".join(f.message for f in _active(
        _findings({"m.py": KNOB_POSITIVE}, rule="knob-registry",
                  **KNOB_CFG)))
    assert msgs.count("raw environ read") == 2
    assert "dynamic key" in msgs and "RLA_TPU_UNREGISTERED" in msgs
    wire = _active(_findings({"worker.py": WIRE_SRC},
                             rule="wire-exception", **WIRE_CFG))
    assert len(wire) == 1 and "Unregistered" in wire[0].message


# --------------------------------------------------------------------- #
# the engine's surface against the JAX package's                        #
# --------------------------------------------------------------------- #
PRAGMA_LINES = [
    "x = 1  # graftlint: ok(host-sync) — feed gate",
    "y = 2  # graftlint: ok(host-sync, rebuild) - two rules",
    "z = 3  # graftlint: ok(knob-registry): colon reason",
    "w = 4  # graftlint: ok(host-sync)",
    "v = 5  # graftlint: ok()  —  ",
    "u = 6  # graftlint:ok(rank-divergence)–en dash",
    "t = 7  # not a pragma: ok(host-sync)",
    "",
]


def test_pragma_parser_matches_jax():
    assert L._parse_pragmas(PRAGMA_LINES) == JL._parse_pragmas(PRAGMA_LINES)
    pragmas, missing = L._parse_pragmas(PRAGMA_LINES)
    assert pragmas[2] == {"host-sync", "rebuild"} and missing == [4, 5]


def _sample_findings(mod):
    return [mod.Finding("host-sync", "serve/engine.py", 865, 20,
                        "'.item()' in hot path"),
            mod.Finding("knob-registry", "utils/seed.py", 29, 4,
                        "raw environ read", suppressed=True),
            mod.Finding("pragma", "core/trainer.py", 3, 0,
                        "graftlint pragma without a reason")]


def test_finding_format_and_reports_match_jax():
    ours, theirs = _sample_findings(L), _sample_findings(JL)
    assert [f.format() for f in ours] == [f.format() for f in theirs]
    for verbose in (False, True):
        assert L.report(ours, verbose) == JL.report(theirs, verbose)
    assert L.report_json(ours, target="pkg") == \
        JL.report_json(theirs, target="pkg")
    assert L.report_json([]) == JL.report_json([])
    assert L.report_json(ours)["exit_code"] == 1
    assert L.report([ours[1]])[1] == 0  # a suppressed finding passes


# --------------------------------------------------------------------- #
# the port's tree is clean (the enforcement test)                       #
# --------------------------------------------------------------------- #
def test_package_tree_has_no_unsuppressed_findings():
    findings = L.lint_path(PORT_DIR)
    active = _active(findings)
    assert active == [], "\n" + "\n".join(f.format() for f in active)
    # the pragmas that exist all carry reasons (an active 'pragma'
    # finding would show above), and the rules genuinely fire here
    assert {f.rule for f in findings if f.suppressed} >= {
        "host-sync", "spmd-collective"}


def test_single_file_target_keeps_package_context(tmp_path):
    pkg = tmp_path / "pkg"
    (pkg / "core").mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "core" / "__init__.py").write_text("")
    target = pkg / "core" / "trainer.py"
    target.write_text(
        "class Trainer:\n"
        "    def _fit_step(self, state, batch):\n"
        "        loss = self._step(state, batch)\n"
        "        return float(loss.item())\n")
    active = _active(L.lint_path(str(target)))
    assert any(f.rule == "host-sync" and f.path == "core/trainer.py"
               for f in active), active
    real = L.lint_path(os.path.join(PORT_DIR, "serve", "engine.py"))
    assert real and all(f.path == "serve/engine.py" for f in real)
    assert any(f.suppressed and f.rule == "host-sync" for f in real)
    assert _active(real) == []


def test_cli_exits_zero_on_tree():
    proc = subprocess.run([sys.executable, CLI, PORT_DIR, "--verbose"],
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "graftlint: 0 finding(s)" in proc.stdout
    assert "(suppressed)" in proc.stdout


def test_cli_exits_nonzero_on_violation(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import os\nv = os.environ.get('RLA_TPU_OOPS')\n")
    proc = subprocess.run([sys.executable, CLI, str(bad)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "knob-registry" in proc.stdout


# --------------------------------------------------------------------- #
# the knob registry against the JAX package's                           #
# --------------------------------------------------------------------- #
# the knobs naming TPU or JAX machinery, which the port never reads
JAX_ONLY_KNOBS = {"RLA_TPU_DISABLE_PALLAS", "RLA_TPU_DISABLE_Q8_KERNEL",
                  "RLA_TPU_FLASH_BLOCK_K", "RLA_TPU_FLASH_BLOCK_Q",
                  "RLA_TPU_WORKER_PLATFORM", "RLA_TPU_TEST_PLATFORM",
                  "RLA_TPU_BENCH_CHILD", "RLA_TPU_INSIDE_WORKER"}


def test_registry_holds_jax_knobs_but_the_tpu_ones():
    assert knobs.registered_names() == \
        jknobs.registered_names() - JAX_ONLY_KNOBS
    assert len(knobs.KNOBS) == 66
    for name, k in knobs.KNOBS.items():
        jk = jknobs.KNOBS[name]
        assert (k.name, k.kind, k.default, k.scope) == \
            (jk.name, jk.kind, jk.default, jk.scope), name
        assert k.help


@pytest.mark.parametrize("value", ["", "5", " 7 ", "x", "1.5", "true",
                                   "off", "maybe"])
def test_typed_getters_match_jax_on_the_same_env(value):
    for name in sorted(knobs.registered_names()):
        env = {name: value}
        for call in (
                lambda m: m.get_raw(name, env=env),
                lambda m: m.get_str(name, "dflt", env=env),
                lambda m: m.get_int(name, 3, env=env),
                lambda m: m.get_int(name, None, malformed=9, env=env),
                lambda m: m.get_float(name, 2.5, env=env),
                lambda m: m.get_float(name, None, malformed=1.0, env=env),
                lambda m: m.get_bool(name, True, env=env),
                lambda m: m.get_bool(name, False, env=env),
                lambda m: m.get_flag(name, env=env)):
            assert call(knobs) == call(jknobs), (name, value)


def test_knobs_env_overlay(monkeypatch):
    monkeypatch.setenv("RLA_TPU_WORKER_HEARTBEAT_S", "5.0")
    assert knobs.get_float("RLA_TPU_WORKER_HEARTBEAT_S", 1.0) == 5.0
    assert knobs.get_float("RLA_TPU_WORKER_HEARTBEAT_S", 1.0,
                           env={"RLA_TPU_WORKER_HEARTBEAT_S": "2.5"}) == 2.5
    # an overlay's empty value is an explicit unset: the default
    assert knobs.get_float("RLA_TPU_WORKER_HEARTBEAT_S", 1.0,
                           env={"RLA_TPU_WORKER_HEARTBEAT_S": ""}) == 1.0


def test_knobs_refuse_unregistered_and_bad_declarations():
    with pytest.raises(LookupError, match="not registered"):
        knobs.get_str("RLA_TPU_TOTALLY_NEW_KNOB")
    with pytest.raises(LookupError, match="not registered"):
        knobs.get_str("RLA_TPU_FLASH_BLOCK_Q")  # a JAX-only knob
    with pytest.raises(ValueError, match="duplicate"):
        knobs._register(knobs.Knob("RLA_TPU_GUARD", "bool", True, "x"))
    with pytest.raises(ValueError, match="unknown knob kind"):
        knobs._register(knobs.Knob("RLA_TPU_NEW", "list", None, "x"))


def test_every_port_rla_env_name_is_registered():
    import re
    unknown = set()
    for dirpath, dirnames, filenames in os.walk(PORT_DIR):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in filenames:
            if not fn.endswith(".py"):
                continue
            with open(os.path.join(dirpath, fn), encoding="utf-8") as f:
                for name in re.findall(r"RLA_TPU_[A-Z0-9_]+", f.read()):
                    if name not in knobs.KNOBS:
                        unknown.add((fn, name))
    assert unknown == set()
    # and the lint extracts the same registry from the declarations
    src = open(os.path.join(PORT_DIR, "analysis", "knobs.py")).read()
    assert L._knob_names_from_source(src) == knobs.registered_names()


# --------------------------------------------------------------------- #
# seed_everything reads the seed knob through the registry, as JAX's    #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("env", [
    {}, {"RLA_TPU_GLOBAL_SEED": ""}, {"RLA_TPU_GLOBAL_SEED": "7"},
    {"RLA_TPU_GLOBAL_SEED": " 7 "}, {"RLA_TPU_GLOBAL_SEED": "x"},
    {"PL_GLOBAL_SEED": "11"},
    {"RLA_TPU_GLOBAL_SEED": "", "PL_GLOBAL_SEED": "13"},
], ids=["unset", "empty", "7", "spaced-7", "malformed", "pl-alone",
        "empty-then-pl"])
def test_seed_everything_env_read_matches_jax(env, monkeypatch):
    from ray_lightning_accelerators_tpu.utils.seed import (
        seed_everything as jax_seed)
    from ray_lightning_accelerators_tpu_torch.utils.seed import (
        seed_everything)
    exported = []
    for fn in (seed_everything, jax_seed):
        for var in ("RLA_TPU_GLOBAL_SEED", "PL_GLOBAL_SEED"):
            monkeypatch.delenv(var, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        seed = fn()
        exported.append((seed, os.environ["RLA_TPU_GLOBAL_SEED"],
                         os.environ["PL_GLOBAL_SEED"]))
    assert exported[0] == exported[1]
    assert exported[0][1] == exported[0][2] == str(exported[0][0])


# --------------------------------------------------------------------- #
# compile guard                                                         #
# --------------------------------------------------------------------- #
def test_compile_guard_counts_and_budgets(monkeypatch):
    from ray_lightning_accelerators_tpu_torch.ops import _build
    builds = [0]
    real = _build.compile_stats
    monkeypatch.setattr(_build, "compile_stats",
                        lambda: (real()[0] + builds[0], real()[1]))
    with compile_guard() as g:
        builds[0] += 2  # two nvcc runs, as a cold first call makes
    assert g.new_compiles == 2
    with compile_guard(max_new_compiles=0, label="warm") as g:
        pass
    assert g.new_compiles == 0
    with pytest.raises(CompileBudgetExceeded, match=r"\[warm\]"):
        with assert_no_new_compiles(label="warm"):
            builds[0] += 1
    with compile_guard(max_new_compiles=1):
        builds[0] += 1  # within budget
    # an exception inside the block is never masked by the budget check
    with pytest.raises(RuntimeError, match="inner"):
        with compile_guard(max_new_compiles=0):
            builds[0] += 1
            raise RuntimeError("inner")
    start = compile_count()
    builds[0] += 3
    rec = compile_count_record("probe", window_start=start)
    assert rec == {"probe": "probe", "kind": "compile_count",
                   "total_backend_compiles": start + 3,
                   "measured_window_compiles": 3}
    assert "measured_window_compiles" not in compile_count_record("p")


def test_trainer_builds_nothing_after_its_first_step(tmp_path):
    """Zero builds over the steps after the first (the JAX package pins
    zero retraces after warmup)."""
    from ray_lightning_accelerators_tpu_torch import Callback, Trainer

    from .torch_boring import BoringModel, boring_loaders

    counts = []

    class BuildCounter(Callback):
        def on_train_batch_end(self, trainer, module, metrics, batch_idx):
            counts.append(compile_count())

    trainer = Trainer(device="cpu", default_root_dir=str(tmp_path),
                      max_steps=12, max_epochs=3, seed=0,
                      log_every_n_steps=4, callbacks=[BuildCounter()],
                      enable_checkpointing=False)
    train, _ = boring_loaders()
    trainer.fit(BoringModel(), train)
    assert len(counts) == 12
    assert counts[1:] == [counts[0]] * 11
    with assert_no_new_compiles(label="warm trainer"):
        trainer.fit(BoringModel(), train)


def test_warm_engine_decode_builds_nothing():
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    from ray_lightning_accelerators_tpu_torch.serve import ServeEngine
    torch.manual_seed(0)
    model = GPT(TransformerConfig(vocab_size=89, d_model=64, n_heads=2,
                                  d_ff=128, n_layers=2, max_seq_len=48),
                device="cpu")
    params = model.init_params(seed=3)
    rng = np.random.default_rng(11)
    reqs = [(rng.integers(0, 89, size=(int(rng.integers(3, 9)),))
             .astype(np.int32), int(rng.integers(4, 10)))
            for _ in range(6)]
    with ServeEngine(model, params, max_slots=3, queue_depth=32,
                     block_len=8) as eng:
        for r in [eng.submit(p, n) for p, n in reqs[:3]]:
            r.result(timeout=300)  # warm
        with compile_guard(max_new_compiles=0, label="serve-steady") as g:
            resps = []
            for i, (p, n) in enumerate(reqs):
                resps.append(eng.submit(p, n))
                if i % 2 == 1:
                    time.sleep(0.02)
            for r in resps:
                r.result(timeout=300)
    assert g.new_compiles == 0
    assert eng.stats()["completed"] == 9
