"""Mesh axes and their sizes.

Port of the JAX package's ``parallel/mesh.py`` for the batch axes: the
axis names and their order (``AXIS_ORDER``, which the accelerators'
``repr`` follows), ``BATCH_AXES``, ``MeshConfig`` and its
``axis_sizes``, ``mesh_axis_size`` and ``data_parallel_size``.  The port
has no device mesh: a world of N ranks, one device each, spans the
batch axes (``data`` for plain and ZeRO-1 data parallelism, ``fsdp``
when the accelerator shards parameters), and XLA's collectives become
``torch.distributed`` calls in the trainer.  ``Mesh`` is only the axis
sizes of that world, the value the sharding plan is built for.  The
model axes (pipeline, expert, sequence, tensor) are sized and validated
here as there, but a size above 1 is refused by the trainer until the
slices that implement them land.
"""

from __future__ import annotations

import dataclasses
import math

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
PIPELINE_AXIS = "pipeline"
SEQUENCE_AXIS = "sequence"
TENSOR_AXIS = "tensor"
EXPERT_AXIS = "expert"

# outermost (slowest links) first, as in the JAX package
AXIS_ORDER = (DATA_AXIS, FSDP_AXIS, PIPELINE_AXIS, EXPERT_AXIS,
              SEQUENCE_AXIS, TENSOR_AXIS)

# the axes a global batch is split over: both plain data parallelism and
# FSDP shard the batch dimension
BATCH_AXES = (DATA_AXIS, FSDP_AXIS)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes for each mesh axis.  ``-1`` on one axis means "all remaining
    devices"."""

    data: int = -1
    fsdp: int = 1
    pipeline: int = 1
    expert: int = 1
    sequence: int = 1
    tensor: int = 1

    def axis_sizes(self, num_devices: int) -> dict:
        sizes = {
            DATA_AXIS: self.data,
            FSDP_AXIS: self.fsdp,
            PIPELINE_AXIS: self.pipeline,
            EXPERT_AXIS: self.expert,
            SEQUENCE_AXIS: self.sequence,
            TENSOR_AXIS: self.tensor,
        }
        fixed = math.prod(v for v in sizes.values() if v != -1)
        n_infer = sum(1 for v in sizes.values() if v == -1)
        if n_infer > 1:
            raise ValueError("at most one mesh axis may be -1 (inferred)")
        if n_infer == 1:
            if num_devices % fixed != 0:
                raise ValueError(
                    f"cannot infer axis size: {num_devices} devices not "
                    f"divisible by fixed product {fixed}")
            for k, v in sizes.items():
                if v == -1:
                    sizes[k] = num_devices // fixed
        elif fixed != num_devices:
            raise ValueError(
                f"mesh axes multiply to {fixed} but {num_devices} devices "
                f"are available")
        return sizes



@dataclasses.dataclass(frozen=True)
class Mesh:
    """The axis sizes of a world of ranks (``shape``, as ``jax.sharding.
    Mesh.shape``); its size is the number of ranks."""

    shape: dict

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def build_mesh(config: MeshConfig, num_devices: int) -> Mesh:
    return Mesh(config.axis_sizes(num_devices))


def mesh_axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape.get(axis, 1)


def data_parallel_size(mesh: Mesh) -> int:
    """Number of batch shards (the DDP ``world_size``)."""
    return mesh_axis_size(mesh, DATA_AXIS) * mesh_axis_size(mesh, FSDP_AXIS)
