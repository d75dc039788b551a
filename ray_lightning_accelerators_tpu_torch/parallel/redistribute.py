"""Wave packing for bounded transfers.

Port of ``wave_schedule`` from the JAX package's
``parallel/redistribute.py``; the KV handoff ships a request's blocks
through the object store in these waves.  The rest of that module
(mesh resharding) comes with the multi-GPU slice.
"""

from __future__ import annotations

from typing import List, Sequence

DEFAULT_WAVE_BYTES = 256 << 20


def wave_schedule(sizes: Sequence[int],
                  max_bytes: int = DEFAULT_WAVE_BYTES) -> List[List[int]]:
    """Greedy, order-preserving wave packing: indices grouped so each
    group's summed bytes stay under ``max_bytes`` (an oversized item
    gets a wave of its own)."""
    waves: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    for i, sz in enumerate(sizes):
        if cur and cur_bytes + sz > max_bytes:
            waves.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += sz
    if cur:
        waves.append(cur)
    return waves
