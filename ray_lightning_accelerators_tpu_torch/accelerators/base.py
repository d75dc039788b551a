"""Accelerator base: the strategy object users hand to the Trainer.

Port of the JAX package's ``accelerators/base.py``.  There an
accelerator owns a device mesh inside one process and XLA derives the
collectives; here it describes a world of spawned ranks, one device
each, over a ``torch.distributed`` process group, and the trainer
averages the gradients across them.  The meaning of the loader's
``batch_size`` is kept: it is the GLOBAL batch, and each of N ranks
trains on ``batch_size / N`` of its rows.

What an accelerator decides:
- the ranks' devices (``select_devices``): rank i on ``cuda:i``, or all
  on the CPU when the trainer runs there; more ranks than visible cards
  raise ``ValueError``;
- the world size and each rank's sampler shard
  (``distributed_sampler_kwargs``);
- the launch plan the trainer spawns (``launch_spec``);
- the hook every rank runs at setup (``setup_environment``).

Parameter and optimizer-state shardings come with the sharded
data-parallel slice.
"""

from __future__ import annotations

import math
import pickle
from typing import Any, Callable, Dict, List, Optional

import torch

from ..parallel import mesh as mesh_lib
from ..parallel.collectives import world_and_rank


class Accelerator:
    """Describes the ranks and their devices.  Subclasses set
    ``mesh_config``; only its data axis is ported."""

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

    def unported(self) -> List[tuple]:
        """(set, what, slice) of each option the port does not run yet;
        the Trainer raises ``not_ported`` for the first one set."""
        cfg = self.mesh_config
        return [
            (self.use_fsdp or cfg.fsdp != 1, "use_fsdp (FSDP / "
             "ZeRO-3)", "multi-GPU 4b (sharded data parallelism)"),
            (cfg.tensor > 1, "the tensor axis (tensor > 1)",
             "multi-GPU 4c (model-parallel axes)"),
            (cfg.sequence > 1, "the sequence axis (sequence > 1)",
             "multi-GPU 4c (model-parallel axes)"),
            (cfg.expert > 1, "the expert axis (expert > 1)",
             "multi-GPU 4c (model-parallel axes)"),
            (cfg.pipeline > 1, "the pipeline axis (pipeline > 1)",
             "multi-GPU 4d (pipelines)"),
            (self.dcn_data * self.dcn_pipeline > 1,
             "multi-slice meshes (dcn_data / dcn_pipeline > 1)", "runtime"),
            (self.devices is not None, "an explicit device subset "
             "(devices=)", "runtime"),
        ]

    # ---------------------------------------------------------------- #
    # Topology                                                          #
    # ---------------------------------------------------------------- #
    def bind_device(self, device: torch.device) -> None:
        """Take the trainer's device type and check the ranks fit."""
        self.device_type = torch.device(device).type
        self.select_devices()

    def select_devices(self) -> List[torch.device]:
        """One device per rank: ``cuda:i`` for rank i, or the CPU.  A
        world the visible cards cannot hold raises ``ValueError``; the
        CPU has no device limit, and "all devices" (``data=-1``) is one
        rank there."""
        cfg = self.mesh_config
        sizes = (cfg.data, cfg.fsdp, cfg.pipeline, cfg.expert,
                 cfg.sequence, cfg.tensor)
        if self.device_type != "cuda":
            n = math.prod(abs(s) for s in sizes)
            return [torch.device("cpu")] * n
        visible = torch.cuda.device_count()
        if -1 in sizes:
            n = math.prod(cfg.axis_sizes(visible).values())
        else:
            n = math.prod(sizes)
            if n > visible:
                raise ValueError(f"mesh needs {n} devices but only "
                                 f"{visible} are visible")
        return [torch.device("cuda", i) for i in range(n)]

    @property
    def world_size(self) -> int:
        """Number of batch shards (the DDP world size)."""
        return len(self.select_devices())

    def distributed_sampler_kwargs(self) -> Dict[str, int]:
        """This rank's sampler shard: replicas = the world's ranks."""
        n, rank = world_and_rank()
        return {"num_replicas": n, "rank": rank}

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
        return f"{type(self).__name__}({axes})"
