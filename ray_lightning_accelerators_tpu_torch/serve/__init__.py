"""Continuous-batching serve engine, paged or dense, with the speculative
lane, the KV handoff and the SLO engine (port of the JAX package's
``serve/``)."""

from .batcher import (AdmissionController, PoolExhausted, QueueFull,
                      RequestRejected, ServeCancelled, ServeRequest,
                      ServeResponse, blocks_for_request, chain_prefix_keys)
from .engine import BlockAllocator, ServeEngine
from .metrics import ServeMetrics
from .slo import DeadlineExceeded, SloPolicy, SloTracker

__all__ = ["AdmissionController", "BlockAllocator", "DeadlineExceeded",
           "PoolExhausted", "QueueFull", "RequestRejected",
           "ServeCancelled", "ServeEngine", "ServeMetrics", "ServeRequest",
           "ServeResponse", "SloPolicy", "SloTracker",
           "blocks_for_request", "chain_prefix_keys"]
