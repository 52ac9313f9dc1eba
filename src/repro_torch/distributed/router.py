"""Key-range routing + shard fence bounds for the sharded streaming engine.

The router owns the keyspace partition of a :class:`ShardedCoconutLSM`:

  * **boundaries** — ``n_shards - 1`` z-order splitter keys, estimated
    with the sample-sort's quantile rule
    (:func:`repro_torch.distributed.samplesort.splitters_from_sample`).
    Insert batches route by a right-sided search over the splitters.
  * **reservoir** — a bounded sample of observed insert keys, refreshed
    online, from which boundaries are *re*-estimated when the stream's
    key density drifts.
  * **fence bounds** — a query-time mindist lower bound over an entire
    z-order key interval.  Keys in ``[lo, hi]`` share their common bit
    prefix; de-interleaving that prefix fixes the top bits of every SAX
    segment, so each segment's code is confined to a contiguous range.
    Summing each segment's distance to its code-range envelope gives a
    bound that holds for every series in the interval.  A shard whose
    bound cannot beat the best-so-far chain is skipped whole.

Routing, fences and bounds are host numpy (O(w) per shard).  The one
device step is :func:`batch_summaries`: an insert batch is summarized on
the engine's device (``sax_summarize``, then ``zorder``), and only the
keys come back to the host to route it; the PAA and codes stay on the
device and ride along to the shard's run build.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core import keys as K
from ..core import summarization as S
from ..kernels import ops
from .samplesort import splitters_from_sample

__all__ = ["KeyRangeRouter", "fence_mindist_sq", "key_range_code_bounds",
           "batch_keys", "batch_summaries", "key_fence_of"]


def batch_summaries(raw: np.ndarray, cfg: S.SummaryConfig, device
                    ) -> Tuple[np.ndarray, torch.Tensor, torch.Tensor]:
    """ONE summarization pass for a raw insert batch on ``device``: (keys
    ``[n, n_words]`` uint32 on the host, paas ``[n, w]`` and codes
    ``[n, w]`` tensors on ``device``).  The keys route the batch; paas and
    codes ride along (``insert(summaries=)``) so the run build never
    re-summarizes the rows."""
    x = torch.from_numpy(np.ascontiguousarray(raw, np.float32)).to(device)
    paas, codes = ops.sax_summarize(x, cfg)
    keys = ops.zorder(codes, cfg).cpu().numpy().astype(np.uint32)
    return keys, paas, codes


def batch_keys(raw: np.ndarray, cfg: S.SummaryConfig,
               device) -> np.ndarray:
    """z-order keys ``[n, n_words]`` (host uint32) for a raw insert batch."""
    return batch_summaries(raw, cfg, device)[0]


def key_fence_of(keys: np.ndarray) -> Tuple[int, int]:
    """(lo, hi) bigint fence of a key batch — lexicographic min/max in
    one O(n * n_words) pass."""
    lo_row, hi_row = K.key_extremes_np(keys)
    return (K.keys_to_bigint(lo_row[None])[0],
            K.keys_to_bigint(hi_row[None])[0])


def key_range_code_bounds(lo: int, hi: int, cfg: S.SummaryConfig
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-segment SAX code ranges implied by a z-order interval.

    Every key in ``[lo, hi]`` (bigints over the ``n_words * 32``-bit
    left-aligned key grid) shares the common bit prefix of ``lo`` and
    ``hi``.  Interleaved bit ``p = i * w + j`` is bit ``b-1-i`` of
    segment ``j`` (Algorithm 1), so a prefix of length ``P`` pins the
    top ``k_j = |{i : i*w + j < P}|`` bits of each segment's code.

    Returns (code_lo ``[w]``, code_hi ``[w]``) — the tightest per-segment
    envelope containing every code word in the interval.
    """
    w, b = cfg.segments, cfg.bits
    total_bits = cfg.n_words * 32
    diff = lo ^ hi
    prefix = total_bits - diff.bit_length() if diff else total_bits
    prefix = min(prefix, w * b)
    code_lo = np.zeros(w, np.int64)
    code_hi = np.zeros(w, np.int64)
    for j in range(w):
        known = 0
        k_j = 0
        for i in range(b):
            p = i * w + j
            if p >= prefix:
                break
            bit = (lo >> (total_bits - 1 - p)) & 1
            known = (known << 1) | bit
            k_j += 1
        free = b - k_j
        code_lo[j] = known << free
        code_hi[j] = (known << free) | ((1 << free) - 1)
    return code_lo, code_hi


def fence_mindist_sq(q_paas: np.ndarray, code_lo: np.ndarray,
                     code_hi: np.ndarray, cfg: S.SummaryConfig
                     ) -> np.ndarray:
    """Squared mindist lower bound from queries to a code-range envelope.

    ``q_paas``: ``[Q, w]`` query PAA values.  Returns ``[Q]`` bounds that
    are <= the true ED^2 to ANY series whose SAX word lies inside
    (code_lo, code_hi) per segment.
    """
    lower, upper = (t.numpy() for t in S.region_bounds(cfg.bits,
                                                       device="cpu"))
    lb = lower[code_lo]                    # [w] envelope lower edges
    ub = upper[code_hi]                    # [w] envelope upper edges
    q = np.asarray(q_paas, np.float32)
    below = np.where(q < lb[None], lb[None] - q, 0.0)
    above = np.where(q > ub[None], q - ub[None], 0.0)
    d = below + above
    return ((cfg.series_len / cfg.segments)
            * np.sum(d * d, axis=-1)).astype(np.float32)


def _keys_below(keys: np.ndarray, key: np.ndarray) -> np.ndarray:
    """Mask of ``[N, n_words]`` keys lexicographically below ``key``."""
    lt = np.zeros(len(keys), bool)
    eq = np.ones(len(keys), bool)
    for w in range(keys.shape[1]):
        lt |= eq & (keys[:, w] < key[w])
        eq &= keys[:, w] == key[w]
    return lt


class KeyRangeRouter:
    """Shard assignment by z-order key range, with online re-estimation.

    Not thread-safe by itself — :class:`ShardedCoconutLSM` serializes all
    mutations behind its routing lock.
    """

    def __init__(self, cfg: S.SummaryConfig, n_shards: int, *,
                 boundaries: Optional[np.ndarray] = None,
                 sample_cap: int = 8192):
        self.cfg = cfg
        self.n_shards = int(n_shards)
        self.sample_cap = int(sample_cap)
        self.boundaries: Optional[np.ndarray] = None   # [S-1, n_words]
        if boundaries is not None:
            self.set_boundaries(np.asarray(boundaries, np.uint32))
        self._sample = np.zeros((0, cfg.n_words), np.uint32)
        self._seen = 0
        self._rng = np.random.default_rng(0)   # deterministic reservoir

    # ------------------------------------------------------------ boundaries
    def set_boundaries(self, boundaries: np.ndarray) -> None:
        if boundaries.shape != (self.n_shards - 1, self.cfg.n_words):
            raise ValueError(
                f"boundaries must be [{self.n_shards - 1}, "
                f"{self.cfg.n_words}], got {boundaries.shape}")
        self.boundaries = np.ascontiguousarray(boundaries, np.uint32)

    def ensure_boundaries(self, keys: np.ndarray) -> bool:
        """Estimate boundaries from the first observed batch if unset.
        Returns True when boundaries were (re)computed — the caller must
        commit them before acking any routed row."""
        if self.boundaries is not None or self.n_shards == 1:
            return False
        self.set_boundaries(splitters_from_sample(keys, self.n_shards))
        return True

    def observe(self, keys: np.ndarray) -> None:
        """Feed routed keys into the bounded reservoir (uniform over the
        stream): re-estimation sees the long-run key density, not just
        the latest batch."""
        n = len(keys)
        if n == 0:
            return
        free = self.sample_cap - len(self._sample)
        if free > 0:
            take = min(free, n)
            self._sample = np.concatenate([self._sample, keys[:take]])
            keys = keys[take:]
            self._seen += take
            n -= take
        if n == 0:
            return
        idx = self._rng.integers(0, self._seen + np.arange(1, n + 1))
        hit = idx < self.sample_cap
        self._sample[idx[hit]] = keys[hit]
        self._seen += n

    def reestimate(self) -> Optional[np.ndarray]:
        """Fresh boundary estimate from the reservoir (None if too few
        samples to split meaningfully)."""
        if self.n_shards == 1 or len(self._sample) < 4 * self.n_shards:
            return None
        return splitters_from_sample(self._sample, self.n_shards)

    # --------------------------------------------------------------- routing
    def route(self, keys: np.ndarray) -> np.ndarray:
        """Destination shard per key: the number of splitters ``<=`` the
        key (a right-sided search over the ascending splitters, the
        sample-sort's bucketing)."""
        if self.n_shards == 1 or self.boundaries is None:
            return np.zeros(len(keys), np.int64)
        keys = np.asarray(keys, np.uint32)
        dest = np.zeros(len(keys), np.int64)
        for b in self.boundaries:
            dest += ~_keys_below(keys, b)
        return dest

    # --------------------------------------------------------- serialization
    def boundaries_json(self) -> Optional[List[List[int]]]:
        if self.boundaries is None:
            return None
        return [[int(x) for x in row] for row in self.boundaries]

    @staticmethod
    def boundaries_from_json(rows: Optional[List[List[int]]]
                             ) -> Optional[np.ndarray]:
        if rows is None:
            return None
        return np.asarray(rows, np.uint32)

    # ------------------------------------------------------------- balancing
    def shard_shares(self, keys: Optional[np.ndarray] = None
                     ) -> np.ndarray:
        """Projected per-shard share of the reservoir (or given keys)
        under the CURRENT boundaries — skew diagnostic."""
        keys = self._sample if keys is None else keys
        if len(keys) == 0:
            return np.zeros(self.n_shards)
        dest = self.route(keys)
        counts = np.bincount(dest, minlength=self.n_shards)
        return counts / counts.sum()
