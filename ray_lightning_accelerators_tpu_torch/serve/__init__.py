"""Paged continuous-batching serve engine (port of the JAX package's
``serve/``)."""

from .batcher import (AdmissionController, PoolExhausted, QueueFull,
                      RequestRejected, ServeCancelled, ServeRequest,
                      ServeResponse, blocks_for_request, chain_prefix_keys)
from .engine import BlockAllocator, ServeEngine
from .metrics import ServeMetrics

__all__ = ["AdmissionController", "BlockAllocator", "PoolExhausted",
           "QueueFull", "RequestRejected", "ServeCancelled", "ServeEngine",
           "ServeMetrics", "ServeRequest", "ServeResponse",
           "blocks_for_request", "chain_prefix_keys"]
