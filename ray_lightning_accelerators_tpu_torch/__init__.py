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
session (``get_actor_rank``, ``put_queue``).  Entry points run on the
CUDA device unless the caller passes ``device="cpu"``.
"""

from .accelerators.tpu import (HorovodRayAccelerator, RayAccelerator,
                               RayTPUAccelerator)
from .core.callbacks import Callback, EarlyStopping, ModelCheckpoint
from .core.module import TorchModule
from .core.trainer import Trainer
from .data.datamodule import DataModule
from .data.loader import DataLoader
from .runtime.session import get_actor_rank, put_queue

__all__ = ["Callback", "DataLoader", "DataModule", "EarlyStopping",
           "HorovodRayAccelerator", "ModelCheckpoint", "RayAccelerator",
           "RayTPUAccelerator", "TorchModule", "Trainer", "get_actor_rank",
           "put_queue"]
__version__ = "0.1.0"
