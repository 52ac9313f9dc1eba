"""Range splitters for the sharded index (the host step of a sample-sort).

The reference bulk-loads a sharded tree with a sample-sort over a device
mesh: sort each shard's keys, pick ``d - 1`` splitters from a regular
sample, exchange rows to their range partition, merge.  This module has
the splitter step, which is plain numpy: the streaming router
(:mod:`repro_torch.distributed.router`) estimates its shard boundaries
with it, so the streaming shards and a static bulk-load partition the
keyspace the same way.
"""
from __future__ import annotations

import numpy as np

from ..core import keys as K

__all__ = ["splitters_from_sample"]


def splitters_from_sample(keys: np.ndarray, d: int) -> np.ndarray:
    """Select ``d-1`` range splitters from a key sample: sort the sample,
    take every ``len/d``-th key.

    ``keys``: ``[M, n_words]`` uint32 z-order keys (any order).
    Returns ``[d-1, n_words]`` ascending splitter keys.
    """
    keys = np.asarray(keys, np.uint32)
    if d < 2:
        return np.zeros((0, keys.shape[1]), np.uint32)
    s = keys[K.lexsort_keys_np(keys)]
    pos = (np.arange(1, d) * len(s)) // d
    return np.ascontiguousarray(s[np.minimum(pos, len(s) - 1)])
