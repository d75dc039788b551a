"""Accelerator base: the strategy object users hand to the Trainer.

Port of the JAX package's ``accelerators/base.py``.  There an
accelerator owns a device mesh inside one process and XLA derives the
collectives; here it describes a world of spawned ranks, one device
each, over a ``torch.distributed`` process group, laid out over the mesh
axes (``parallel/mesh.py``: data x fsdp x pipeline x expert x sequence
x tensor, tensor innermost), and the trainer and the models call the
collectives of each axis's group.  The meaning of the loader's
``batch_size`` is kept: it is the GLOBAL batch, split over the batch
axes (data x fsdp) only: ranks that differ only in their tensor,
sequence or expert coordinate read the same rows.

What an accelerator decides:
- the ranks' devices (``select_devices``): rank i on ``cuda:i``, or all
  on the CPU when the trainer runs there; more ranks than visible cards
  raise ``ValueError``.  ``dcn_data`` / ``dcn_pipeline`` (multi-slice
  meshes, JAX ``build_hybrid_mesh``) multiply the world by the DCN
  groups: each of the ``data`` and ``pipeline`` axes is ICI x DCN, the
  DCN part crossing granules (``granules``: one for a world without
  host agents, one a host agent otherwise) and the rest staying inside
  one (``parallel/mesh.py`` ``build_hybrid_mesh``).  A world that
  cannot split into the groups raises ``ValueError`` at
  ``build_mesh``.  ``devices=`` (a tune trial's lease,
  ``tune.trial_devices()``) gives the subset instead: rank i on its
  entry i (``cuda:i`` or an indexed ``cpu:i``), as many ranks as the
  mesh needs of it (all of it when the batch axis is ``-1``).  The
  subset travels to the ranks with the accelerator, where
  ``validate_process_topology`` counts the same world;
- the world size and each rank's sampler shard
  (``distributed_sampler_kwargs``: its coordinate on the batch axes);
- the launch plan the trainer spawns (``launch_spec``);
- the hook every rank runs at setup (``setup_environment``);
- the layout of each parameter (``param_shardings``) and of the
  optimizer state (``state_shardings``), as the sharding plan
  (``parallel/plan.py``) reads them: a module with
  ``param_logical_axes()`` follows the rules table
  (``parallel/sharding.py``), ``use_fsdp`` shards the other modules'
  large leaves by the heuristic, and everything else replicates.  A
  layout is ``None`` (every rank holds the leaf) or the ``(axis, dim)``
  pairs that split it; ``use_fsdp`` names the batch axis ``fsdp``
  instead of ``data``, as the JAX package relabels it.
"""

from __future__ import annotations

import math
import pickle
from typing import Any, Callable, Dict, List, Optional

import torch

from ..parallel import mesh as mesh_lib
from ..parallel import plan as plan_lib
from ..parallel import sharding as sharding_lib
from ..parallel.collectives import world_and_rank
from ..utils.logging import log


# the reference caveat that keeps the pipeline axis apart from the
# sequence axis: there is no JAX result on that mesh to hold the port to
PIPELINE_SEQUENCE_REFUSAL = (
    "the pipeline axis with the sequence axis is refused: the JAX "
    "package's GPT raises on this mesh (a context mesh mismatch inside "
    "shard_map on jax 0.9.0; ROADMAP.md section 3, reference caveats), so "
    "there is no reference result to hold the port to")


class Accelerator:
    """Describes the ranks and their devices.  Subclasses set
    ``mesh_config``; every axis is ported, the pipeline axis composed
    with every other axis but the sequence axis, and ``data`` and
    ``pipeline`` across DCN groups."""

    def __init__(self, mesh_config: Optional[mesh_lib.MeshConfig] = None,
                 init_hook: Optional[Callable[[], None]] = None,
                 use_fsdp: bool = False,
                 dcn_data: int = 1, dcn_pipeline: int = 1,
                 devices: Optional[list] = None):
        self.mesh_config = mesh_config or mesh_lib.MeshConfig()
        self.init_hook = init_hook
        self.use_fsdp = use_fsdp
        self.dcn_data = dcn_data
        self.dcn_pipeline = dcn_pipeline
        self.devices = list(devices) if devices is not None else None
        # "cuda" or "cpu": the trainer binds its own device type here
        self.device_type = "cuda"
        # leaves use_fsdp wanted to shard but could not (no dim divides)
        self.last_fsdp_fallbacks: List[dict] = []

    def unported(self) -> List[tuple]:
        """(set, what, slice) of each option the port does not run; the
        Trainer raises ``not_ported`` for the first one set, or, where the
        slice is None, ``NotImplementedError(what)``."""
        cfg = self.mesh_config
        return [
            (self.pipeline_size > 1 and cfg.sequence > 1,
             PIPELINE_SEQUENCE_REFUSAL, None),
        ]

    @property
    def dcn_size(self) -> int:
        """The number of DCN groups (granules) the mesh spans."""
        return self.dcn_data * self.dcn_pipeline

    @property
    def pipeline_size(self) -> int:
        """The pipeline axis's size: ICI x DCN."""
        return self.mesh_config.pipeline * self.dcn_pipeline

    # ---------------------------------------------------------------- #
    # Topology                                                          #
    # ---------------------------------------------------------------- #
    def bind_device(self, device: torch.device) -> None:
        """Take the trainer's device type and check the ranks fit."""
        self.device_type = torch.device(device).type
        self.select_devices()

    def select_devices(self) -> List[torch.device]:
        """One device per rank: ``cuda:i`` for rank i, or the CPU; with
        ``devices=``, the first entries of that subset.  A world the
        visible cards (or the subset) cannot hold raises ``ValueError``;
        the CPU has no device limit, and "all devices" (``data=-1``) is
        one rank there."""
        cfg = self.mesh_config
        sizes = (cfg.data, cfg.fsdp, cfg.pipeline, cfg.expert,
                 cfg.sequence, cfg.tensor)
        if self.devices is not None:
            return self._subset(sizes)
        if self.device_type != "cuda":
            n = math.prod(abs(s) for s in sizes) * self.dcn_size
            return [torch.device("cpu")] * n
        visible = torch.cuda.device_count()
        n = self._rank_count(sizes, visible)
        if n > visible:
            raise ValueError(f"mesh needs {n} devices but only "
                             f"{visible} are visible")
        return [torch.device("cuda", i) for i in range(n)]

    def _rank_count(self, sizes, available: int) -> int:
        """The world's ranks: the ICI mesh (an axis of -1 takes what the
        DCN groups leave of ``available``) times the DCN groups."""
        k = self.dcn_size
        if -1 not in sizes:
            return math.prod(sizes) * k
        if available % k:
            raise ValueError(f"{available} devices not divisible into "
                             f"{k} DCN groups")
        return math.prod(
            self.mesh_config.axis_sizes(available // k).values()) * k

    def _subset(self, sizes) -> List[torch.device]:
        devices = [torch.device(d) for d in self.devices]
        wrong = [str(d) for d in devices if d.type != self.device_type]
        if wrong:
            raise ValueError(f"devices={wrong} but the trainer runs on "
                             f"{self.device_type!r}")
        n = self._rank_count(sizes, len(devices))
        if n > len(devices):
            raise ValueError(f"mesh needs {n} devices but only "
                             f"{len(devices)} are visible")
        return devices[:n]

    @property
    def world_size(self) -> int:
        """Number of ranks: the batch shards times the model axes."""
        return len(self.select_devices())

    def granules(self) -> List[Any]:
        """Each rank's granule key: the DCN axes cross granules.  A world
        without host agents is one granule."""
        return [0] * self.world_size

    def build_mesh(self) -> mesh_lib.Mesh:
        """The axis sizes of this accelerator's world of ranks, with the
        hybrid layout (``order``) when the mesh spans DCN groups."""
        if self.dcn_size == 1:
            return mesh_lib.build_mesh(self.mesh_config, self.world_size)
        return mesh_lib.build_hybrid_mesh(
            self.mesh_config, self.world_size, self.granules(),
            dcn_data=self.dcn_data, dcn_pipeline=self.dcn_pipeline)

    # ---------------------------------------------------------------- #
    # Layouts                                                           #
    # ---------------------------------------------------------------- #
    def param_shardings(self, mesh: mesh_lib.Mesh, params: Any,
                        module: Any = None,
                        report_fallbacks: bool = True) -> Any:
        """The layout of each parameter leaf (a tree like ``params``).

        A module exposing ``param_logical_axes()`` follows the rules
        table; otherwise ``use_fsdp`` shards large leaves over the fsdp
        axis; otherwise everything replicates.  A large leaf with no
        divisible dim replicates with a warning and is listed in
        ``last_fsdp_fallbacks`` (unless ``report_fallbacks=False``)."""
        if report_fallbacks:
            self.last_fsdp_fallbacks = []
        if module is not None and hasattr(module, "param_logical_axes"):
            return sharding_lib.tree_logical_to_layouts(
                mesh, module.param_logical_axes())
        if self.use_fsdp:
            fallbacks = []

            def on_fallback(name, leaf):
                fallbacks.append({"param": name,
                                  "shape": [int(s) for s in leaf.shape]})

            layouts = sharding_lib.infer_fsdp_shardings(
                params, mesh, on_fallback=on_fallback)
            if report_fallbacks:
                from ..telemetry import recorder as telemetry
                for fb in fallbacks:
                    log.warning(
                        "use_fsdp: param %s %s has no dim divisible by "
                        "the fsdp axis; it (and its optimizer moments) "
                        "stay REPLICATED — no FSDP memory saving for "
                        "this leaf", fb["param"], tuple(fb["shape"]))
                    telemetry.emit("fsdp_fallback", **fb)
                self.last_fsdp_fallbacks = fallbacks
            return layouts
        return sharding_lib.tree_map_with_path(
            lambda _path, _leaf: plan_lib.replicated_spec(), params)

    def state_shardings(self, mesh: mesh_lib.Mesh, params: Any,
                        opt_layouts: Callable[[List[Any]], List[Any]],
                        module: Any = None,
                        report_fallbacks: bool = True) -> Dict[str, Any]:
        """The layouts of the params and of the optimizer state (its
        leaves in optax's order from ``opt_layouts``, moments inheriting
        their param's layout).  The JAX package's second ``fsdp_fallback``
        site (optax failing to map the layouts onto an exotic optimizer
        state) has no counterpart: ``core/optim.py`` ``state_layouts``
        lays each leaf out from the optimizer's structure alone."""
        param_l = self.param_shardings(mesh, params, module=module,
                                       report_fallbacks=report_fallbacks)
        return {"params": param_l,
                "opt_state": opt_layouts(plan_lib._leaves(param_l))}

    def distributed_sampler_kwargs(self) -> Dict[str, int]:
        """This rank's sampler shard: replicas = the batch axes' size
        (data x fsdp), rank = this rank's coordinate on them."""
        n, rank = world_and_rank()
        if n == 1:
            return {"num_replicas": 1, "rank": 0}
        mesh = self.build_mesh()
        shape = mesh.shape
        c = mesh.coords_of(rank)
        return {"num_replicas": mesh_lib.data_parallel_size(mesh),
                "rank": c[mesh_lib.DATA_AXIS] * shape[mesh_lib.FSDP_AXIS]
                + c[mesh_lib.FSDP_AXIS]}

    # ---------------------------------------------------------------- #
    # Launch plan                                                       #
    # ---------------------------------------------------------------- #
    def launch_spec(self) -> Dict[str, Any]:
        """The world the trainer spawns: one rank per device."""
        devices = self.select_devices()
        return {"num_processes": len(devices),
                "devices": [str(d) for d in devices]}

    def validate_process_topology(self) -> None:
        """Inside a formed world, a world size other than this
        accelerator's is a configuration error."""
        n, _rank = world_and_rank()
        if n > 1 and n != self.world_size:
            raise ValueError(
                f"{type(self).__name__} asks for {self.world_size} ranks "
                f"but this process group has {n}")

    def __getstate__(self) -> Dict[str, Any]:
        """Ranks receive the accelerator by the standard ``pickle``: an
        ``init_hook`` that cannot travel is refused here, by name."""
        if self.init_hook is not None:
            try:
                pickle.dumps(self.init_hook)
            except (pickle.PicklingError, AttributeError, TypeError) as e:
                raise TypeError(
                    f"init_hook {self.init_hook!r} cannot be sent to the "
                    f"ranks ({e}); the port ships work with the standard "
                    f"pickle: make it a module-level function") from e
        return dict(self.__dict__)

    # ---------------------------------------------------------------- #
    # Lifecycle                                                         #
    # ---------------------------------------------------------------- #
    def setup_environment(self) -> None:
        if self.init_hook is not None:
            self.init_hook()

    def teardown(self) -> None:
        """Release the cached allocations of this process's card, so a
        second fit or test starts from a clean allocator."""
        if self.device_type == "cuda" and torch.cuda.is_initialized():
            torch.cuda.empty_cache()

    def __repr__(self) -> str:
        cfg = self.mesh_config
        axes = {a: s for a, s in zip(mesh_lib.AXIS_ORDER,
                                     (cfg.data, cfg.fsdp, cfg.pipeline,
                                      cfg.expert, cfg.sequence, cfg.tensor))
                if s != 1}
        axes.update({f"dcn_{a}": s for a, s in
                     (("data", self.dcn_data),
                      ("pipeline", self.dcn_pipeline)) if s != 1})
        return f"{type(self).__name__}({axes})"
