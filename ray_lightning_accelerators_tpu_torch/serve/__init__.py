"""Continuous-batching serve engine, paged or dense, with the speculative
lane, the KV handoff and the SLO engine, and the replica tier over it:
``ServeReplicas`` runs N engine replicas on the actor runtime and its
``ReplicaController`` routes, retries, hedges, revives, scales and sheds
(port of the JAX package's ``serve/``)."""

from .batcher import (AdmissionController, BrownoutShed, PoolExhausted,
                      QueueFull, RequestRejected, ServeCancelled,
                      ServeRequest, ServeResponse, blocks_for_request,
                      chain_prefix_keys)
from .controller import ControllerConfig, ReplicaController
from .engine import BlockAllocator, ServeEngine
from .metrics import ServeMetrics
from .replicas import ServeReplicas, gpt_engine
from .slo import DeadlineExceeded, SloPolicy, SloTracker

__all__ = ["AdmissionController", "BlockAllocator", "BrownoutShed",
           "ControllerConfig", "DeadlineExceeded", "PoolExhausted",
           "QueueFull", "ReplicaController", "RequestRejected",
           "ServeCancelled", "ServeEngine", "ServeMetrics",
           "ServeReplicas", "ServeRequest", "ServeResponse", "SloPolicy",
           "SloTracker", "blocks_for_request", "chain_prefix_keys",
           "gpt_engine"]
