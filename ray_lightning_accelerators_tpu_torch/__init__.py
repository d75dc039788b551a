"""PyTorch and CUDA port of the JAX package beside it, for NVIDIA
Hopper (H100).

The JAX package beside it is the reference.  This package imports
``torch`` and never ``jax``, nor anything of the JAX package.  Ported so
far: single-card training (``Trainer.fit`` / ``validate`` / ``test`` /
``predict`` with loaders or a ``DataModule``; AdamW and SGD,
checkpoints and callbacks, the parameter EMA, int8 training matmuls)
of the GPT (with the streaming LM-head loss, mixture-of-experts layers
and layer rematerialisation) and of the vision families
(``models.mnist.MNISTClassifier``, ``models.resnet.ResNet18``,
``models.vit.ViT``, with the MNIST and CIFAR-10 data modules); the
language-model data path (``data.lm``: tokenizers, packing, a streaming
dataset) and weights from torch ``state_dict``s
(``utils.torch_interop``); the GPT model's inference half
(``models.transformer.GPT``: ``generate``, ``generate_beam``, the dense
and paged decode caches), speculative decoding (``models.speculative``)
and the serve engine in its paged and dense modes
(``serve.ServeEngine``), with hand-written CUDA kernels for RMSNorm,
LayerNorm, flash attention forward and backward and the int8
weight-only matrix products (``ops/``, sources in ``csrc/``); data
parallelism over spawned ranks (``Trainer(accelerator=RayAccelerator(
num_workers=N))``, ``RayTPUAccelerator``, ``HorovodRayAccelerator``: a
``torch.distributed`` group, NCCL on the card and gloo on the CPU, the
loader sharded per rank, the gradients averaged) with the worker-side
session (``get_actor_rank``, ``put_queue``); sharded data parallelism
over those ranks (``RayTPUAccelerator(N, use_fsdp=True)``,
``Trainer(shard_optimizer_state=True)``, ``Trainer(grad_compression=
"int8" | "bf16")`` with error feedback, and the ``"sharded"`` /
``"sharded-async"`` checkpoint formats, ``utils.sharded_checkpoint``);
the model-parallel axes over those ranks: tensor (Megatron splits of
the GPT and the ViT), sequence (``ring_attention_sharded``,
``ulysses_attention_sharded``, ``Trainer(seq_parallel=)``) and expert
(the MoE experts), ``RayTPUAccelerator(N, tensor=, sequence=, expert=)``
or ``Accelerator(MeshConfig(...))``, each composing with FSDP, ZeRO-1,
the sharded checkpoints and int8 training matmuls; and the GPT's SPMD
pipeline axis (``RayTPUAccelerator(N, pipeline=S)``,
``parallel.pipeline.pipeline_apply``) with the batch axes; and Tune
(``tune.run`` with its searchers and schedulers over thread, concurrent
and process trials, ``TuneReportCallback`` /
``TuneReportCheckpointCallback`` from the ranks, ``tune.autotune_step``);
and fault tolerance on one host (``runtime.watchdog``, the preemption
drain ``Preempted`` / ``get_notice``, chaos injection
``testing.chaos``, ``ElasticRunner`` with the guardian's rewind,
``Trainer(worker_deadline_s=)``).
Entry points run on the CUDA device unless the caller passes
``device="cpu"``.
"""

from .accelerators.base import Accelerator
from .accelerators.tpu import (HorovodRayAccelerator, RayAccelerator,
                               RayTPUAccelerator)
from .core.callbacks import Callback, EarlyStopping, ModelCheckpoint
from .core.module import TorchModule
from .core.state import TrainState
from .core.trainer import Trainer
from .data.datamodule import DataModule
from .data.loader import DataLoader
from .parallel.collectives import TensorShardedParamsError
from .parallel.mesh import MeshConfig, build_mesh
from .parallel.ring_attention import ring_attention_sharded
from .parallel.ulysses import ulysses_attention_sharded
from .runtime.elastic import ElasticResizeError, ElasticRunner
from .runtime.preemption import Preempted, PreemptionNotice, get_notice
from .runtime.session import get_actor_rank, put_queue
from .runtime.watchdog import WorkerWedged
from . import tune
from .tune import TuneReportCallback, TuneReportCheckpointCallback

__all__ = ["Accelerator", "Callback", "DataLoader", "DataModule",
           "EarlyStopping", "ElasticResizeError", "ElasticRunner",
           "HorovodRayAccelerator", "MeshConfig", "ModelCheckpoint",
           "Preempted", "PreemptionNotice", "RayAccelerator",
           "RayTPUAccelerator", "TensorShardedParamsError", "TorchModule",
           "TrainState", "Trainer", "TuneReportCallback",
           "TuneReportCheckpointCallback", "WorkerWedged", "build_mesh",
           "get_actor_rank", "get_notice", "put_queue",
           "ring_attention_sharded", "tune", "ulysses_attention_sharded"]
__version__ = "0.1.0"
