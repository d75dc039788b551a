"""The lint's rule catalog, one module per rule (the JAX package's file
names).

Each rule module exposes ``RULE`` (the name pragmas reference) and
``check(module, ctx) -> Iterable[Finding]``.

- ``host-sync``           device->host synchronization in a hot path
                          (``.item()``, ``.tolist()``, ``.cpu()``,
                          ``torch.cuda.synchronize`` ...)
- ``rebuild``             a library build or load (nvcc, g++,
                          ``ctypes.CDLL``, ``torch.compile``) in a loop
                          or a hot path (``retrace.py``)
- ``graph-leak``          a forward's or a loss's tensor stored on
                          ``self`` or a global without ``.detach()``
                          (``tracer_leak.py``)
- ``knob-registry``       RLA_TPU_* env reads outside the knobs registry
- ``wire-exception``      typed raises in worker code missing from the
                          wire reconstruction registry
- ``spmd-collective``     collective process groups that do not resolve
                          to a mesh axis's group, the world or None
- ``rank-divergence``     rank-gated control flow enclosing collectives,
                          barriers or commits; unseeded host randomness
                          in per-step SPMD paths
- ``sharding-inventory``  spec constructors outside the audited sharding
                          modules (scripts/torch_sharding_audit.py)
"""

from . import (host_sync, knob_registry, rank_divergence, retrace,
               sharding_inventory, spmd_collectives, tracer_leak,
               wire_exceptions)

ALL_RULES = (host_sync, retrace, tracer_leak, knob_registry,
             wire_exceptions, spmd_collectives, rank_divergence,
             sharding_inventory)

RULE_NAMES = tuple(r.RULE for r in ALL_RULES)
