"""Rules the PyTorch port keeps: it imports neither JAX nor anything of
the JAX package, and its entry points run on the card unless the caller
asks for the CPU."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import ray_lightning_accelerators_tpu_torch as port

PORT_DIR = pathlib.Path(port.__file__).resolve().parent
REPO = PORT_DIR.parent


def test_port_imports_no_jax_in_a_fresh_process():
    script = (
        "import sys\n"
        "import ray_lightning_accelerators_tpu_torch\n"
        "from ray_lightning_accelerators_tpu_torch.serve import ServeEngine\n"
        "from ray_lightning_accelerators_tpu_torch.models import transformer\n"
        "from ray_lightning_accelerators_tpu_torch.ops import norms, quant\n"
        "from ray_lightning_accelerators_tpu_torch.utils import weights\n"
        "from ray_lightning_accelerators_tpu_torch.serve import slo\n"
        "from ray_lightning_accelerators_tpu_torch.serve import "
        "controller, replicas\n"
        "from ray_lightning_accelerators_tpu_torch.serve import ("
        "BrownoutShed, ControllerConfig, ReplicaController, "
        "ServeReplicas)\n"
        "from ray_lightning_accelerators_tpu_torch.runtime import "
        "object_store\n"
        "from ray_lightning_accelerators_tpu_torch.parallel import "
        "redistribute\n"
        "from ray_lightning_accelerators_tpu_torch.ops import moe\n"
        "from ray_lightning_accelerators_tpu_torch.utils import ema, "
        "torch_interop\n"
        "from ray_lightning_accelerators_tpu_torch.data import lm\n"
        "from ray_lightning_accelerators_tpu_torch.accelerators import "
        "base, tpu\n"
        "from ray_lightning_accelerators_tpu_torch.runtime import actors, "
        "bootstrap, net, session\n"
        "from ray_lightning_accelerators_tpu_torch.parallel import "
        "collectives, mesh, pipeline\n"
        "from ray_lightning_accelerators_tpu_torch.parallel import "
        "plan, sharding\n"
        "from ray_lightning_accelerators_tpu_torch.parallel import "
        "ring_attention, ulysses\n"
        "from ray_lightning_accelerators_tpu_torch import "
        "ring_attention_sharded, ulysses_attention_sharded\n"
        "from ray_lightning_accelerators_tpu_torch.utils import "
        "sharded_checkpoint\n"
        "from ray_lightning_accelerators_tpu_torch.parallel.mpmd import "
        "driver, handoff, schedule, stage\n"
        "from ray_lightning_accelerators_tpu_torch.telemetry import "
        "recorder, registry\n"
        "from ray_lightning_accelerators_tpu_torch.runtime import guardian\n"
        "from ray_lightning_accelerators_tpu_torch.runtime import agent, "
        "queue\n"
        "from ray_lightning_accelerators_tpu_torch.tune import callbacks, "
        "schedulers, search\n"
        "import ray_lightning_accelerators_tpu_torch.tune.run\n"
        "from ray_lightning_accelerators_tpu_torch.data import prefetch\n"
        "from ray_lightning_accelerators_tpu_torch.native import "
        "DataEngine\n"
        "from ray_lightning_accelerators_tpu_torch import tune, "
        "TuneReportCallback, TuneReportCheckpointCallback\n"
        "from ray_lightning_accelerators_tpu_torch.runtime import elastic, "
        "preemption, watchdog, wire\n"
        "from ray_lightning_accelerators_tpu_torch.testing import chaos\n"
        "from ray_lightning_accelerators_tpu_torch.telemetry import perf\n"
        "from ray_lightning_accelerators_tpu_torch.utils import backoff\n"
        "from ray_lightning_accelerators_tpu_torch import ElasticRunner, "
        "Preempted, WorkerWedged, get_notice\n"
        "from ray_lightning_accelerators_tpu_torch import cli\n"
        "from ray_lightning_accelerators_tpu_torch.analysis import "
        "compile_guard\n"
        "from ray_lightning_accelerators_tpu_torch.utils import logging, "
        "profiler\n"
        "from ray_lightning_accelerators_tpu_torch.telemetry import ("
        "GoodputLedger, HbmLedger, MetricsRegistry, PerfObservatory, "
        "StepTimeline, exposed_comm_crosscheck)\n"
        "from ray_lightning_accelerators_tpu_torch.telemetry import live\n"
        "from ray_lightning_accelerators_tpu_torch.analysis import lint, "
        "knobs\n"
        "from ray_lightning_accelerators_tpu_torch.analysis.rules import ("
        "host_sync, knob_registry, rank_divergence, retrace, "
        "sharding_inventory, spmd_collectives, tracer_leak, "
        "wire_exceptions)\n"
        "from ray_lightning_accelerators_tpu_torch.testing import "
        "spmd_sanitizer\n"
        "from ray_lightning_accelerators_tpu_torch.testing import ("
        "CollectiveMismatch, SpmdSanitizer, check_collective_sequences)\n"
        "from ray_lightning_accelerators_tpu_torch.telemetry import ("
        "ClusterView, LiveSources, TelemetryServer, classify_health)\n"
        # spawned ranks import the data-parallel tests' fixtures
        "import tests.torch_boring\n"
        "import importlib, pkgutil\n"
        "for m in pkgutil.walk_packages(ray_lightning_accelerators_tpu_torch"
        ".__path__, 'ray_lightning_accelerators_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'jaxlib', 'flax', 'optax', 'orbax')) "
        "or m == 'ray_lightning_accelerators_tpu' "
        "or m.startswith('ray_lightning_accelerators_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_no_port_source_names_the_jax_package():
    pat = re.compile(r"ray_lightning_accelerators_tpu(?!_torch)|"
                     r"^\s*(import|from)\s+(jax|flax|optax|orbax)\b")
    offenders = []
    for path in sorted(PORT_DIR.rglob("*")):
        if path.suffix not in (".py", ".cu", ".cuh", ".cc"):
            continue
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if pat.search(line):
                offenders.append(f"{path.relative_to(REPO)}:{i}: {line}")
    assert not offenders, "\n".join(offenders)
    # chip_smoke.py names the TPU kernels it replaces (file:line) in its
    # report, so only its imports are checked
    text = (REPO / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|flax|optax|"
                         r"ray_lightning_accelerators_tpu)\b", text,
                         re.MULTILINE)
    assert "import ray_lightning_accelerators_tpu_torch" in text or \
        "from ray_lightning_accelerators_tpu_torch" in text


def test_no_port_file_imports_jax_or_the_jax_package():
    """By the import statements themselves (the AST), not the text:
    every module of the port, the lint's rules and the sanitizer
    included, and the port's scripts."""
    import ast
    files = sorted(PORT_DIR.rglob("*.py")) + [
        REPO / "scripts" / "torch_graftlint.py",
        REPO / "scripts" / "torch_sharding_audit.py", REPO / "chip_smoke.py"]
    banned = ("jax", "jaxlib", "flax", "optax", "orbax",
              "ray_lightning_accelerators_tpu")
    offenders = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                if name.split(".")[0] in banned:
                    offenders.append(f"{path.relative_to(REPO)}:"
                                     f"{node.lineno}: {name}")
    assert not offenders, "\n".join(offenders)
    assert (PORT_DIR / "analysis" / "rules" / "spmd_collectives.py") in files


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from ray_lightning_accelerators_tpu_torch.core.module import (
        resolve_device)
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    from ray_lightning_accelerators_tpu_torch.utils.weights import (
        params_from_jax)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TransformerConfig(vocab_size=64, d_model=32, n_heads=2, d_ff=64,
                            n_layers=1, max_seq_len=16)
    for call in (lambda: GPT(cfg), lambda: resolve_device(None),
                 lambda: resolve_device("cuda"),
                 lambda: params_from_jax({"w": np.ones(3, np.float32)})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # the explicit CPU request works and gets the plain versions
    assert GPT(cfg, device="cpu").device.type == "cpu"
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("kwargs", [
    dict(gather_mode="scan", grad_compression="bf16"),
    dict(gather_mode="scan", grad_compression="int8"),
])
def test_scan_gather_is_refused_naming_its_slice(kwargs, tmp_path):
    """(The name is the refusal this test held until 4e was ported.)
    The per-layer gather inside the layer loop (4e) is ported: where
    the JAX Trainer engages it (the compressed-FSDP regime over the GPT's
    fsdp-sharded layer stack) the port's fit trains it, no refusal naming
    a slice, and the wire report says ``"scan"``.  Elsewhere ``"scan"``
    trains as the tree gather; ``gather_mode="tree"`` is the sharded
    default."""
    from ray_lightning_accelerators_tpu_torch import (DataLoader,
                                                      RayTPUAccelerator,
                                                      Trainer)
    from ray_lightning_accelerators_tpu_torch.data.loader import (
        ArrayDataset)
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    cfg = TransformerConfig(vocab_size=64, d_model=64, n_heads=2, d_ff=128,
                            n_layers=2, max_seq_len=16)
    t = Trainer(device="cpu", accelerator=RayTPUAccelerator(2, use_fsdp=True),
                default_root_dir=str(tmp_path), max_steps=2, precision="f32",
                enable_checkpointing=False, **kwargs)
    try:
        t.fit(GPT(cfg, device="cpu"),
              DataLoader(ArrayDataset(np.zeros((4, 16), np.int32)),
                         batch_size=2))
    finally:
        t.shutdown_workers()
    assert t.comms_per_step["gather_mode"] == "scan"
    assert t.global_step == 2
    assert Trainer(device="cpu", gather_mode="scan").gather_mode == "scan"
    assert Trainer(device="cpu", gather_mode="tree").gather_mode == "tree"


@pytest.mark.parametrize("kwargs", [
    dict(grad_compression="int8"), dict(grad_compression="bf16"),
    dict(shard_optimizer_state=True), dict(checkpoint_format="sharded"),
    dict(checkpoint_format="sharded-async"),
])
def test_sharded_options_are_accepted(kwargs):
    from ray_lightning_accelerators_tpu_torch import (RayTPUAccelerator,
                                                      Trainer)
    Trainer(device="cpu", **kwargs)
    Trainer(device="cpu", accelerator=RayTPUAccelerator(2, use_fsdp=True),
            **kwargs)
