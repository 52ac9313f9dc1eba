"""Window-query engines (paper Sec. 5): PP / TP / BTP as a uniform API.

The mechanics live in :class:`repro_torch.core.lsm.CoconutLSM` (each mode
is a compaction policy + qualifying-run filter); this module gives them
the paper's names and a single constructor for experiments:

    engine = window_engine("btp", cfg, buffer_capacity=4096)
    engine.insert(batch); engine.flush()
    d, off, info = engine.search_exact(q, k=1, window=1_000_000)
    # d/off are length-k arrays; info carries the unified pipeline's
    # accounting (partitions touched/pruned, leaves scanned/pruned)

Every mode's exact search runs through the one query pipeline
(:mod:`repro_torch.query`): the planner drops out-of-window runs (the
BTP/TP saving), post-filters straddlers row-wise, and fence-prunes whole
leaves; PP disables the temporal drop and post-filters everything.

  * PP  (post-processing)          — one fully-merged index; timestamp
    filtering after retrieval; cannot save bandwidth on old data.
  * TP  (temporal partitioning)    — one partition per flush, never merged;
    small windows cheap, large windows touch O(N/buffer) partitions.
  * BTP (bounded temporal part.)   — the paper's contribution: ratio-2
    merging bounds partitions at O(log N) while windows skip old runs.

The engine's runs live on the card unless ``device="cpu"``.  A store
(``store=``) makes the engine durable (segments + WAL).  ``shards > 1``
gives the key-range-sharded engine, persisted through ``data_dir=``.
"""
from __future__ import annotations

from typing import Optional

from .lsm import CoconutLSM
from .metrics import IOStats
from .summarization import SummaryConfig

__all__ = ["window_engine", "WINDOW_MODES"]

WINDOW_MODES = ("pp", "tp", "btp")


def window_engine(mode: str, cfg: SummaryConfig, *,
                  buffer_capacity: int = 4096, leaf_size: int = 256,
                  materialized: bool = True,
                  io: Optional[IOStats] = None,
                  store=None,
                  concurrent: bool = False,
                  wal_fsync: str = "always",
                  max_debt: int = 4,
                  shards: int = 1,
                  data_dir: Optional[str] = None,
                  device=None):
    """Build a window-query engine; ``mode`` in {"pp", "tp", "btp"}.

    ``store``/``concurrent``/``wal_fsync``/``max_debt`` pass through to
    :class:`CoconutLSM`: a store makes the engine durable (segments +
    WAL), ``concurrent=True`` moves flushes and merges to the background
    compactor so window queries run against immutable snapshots while
    ingest continues.  Concurrent engines should be closed (or used as a
    context manager) so the compactor thread shuts down deterministically.

    ``shards > 1`` returns a key-range-partitioned
    :class:`~repro_torch.distributed.sharded_lsm.ShardedCoconutLSM` with
    the same windowing mode on every shard; persistence then goes through
    ``data_dir`` (a ``ShardDirectory`` root) instead of ``store``, and
    ``data_dir`` is ignored at ``shards=1``.  ``device`` passes through.
    """
    if mode not in WINDOW_MODES:
        raise ValueError(f"mode must be one of {WINDOW_MODES}, got {mode!r}")
    if shards > 1:
        if store is not None:
            raise ValueError(
                "sharded engines persist via data_dir=, not store=")
        from ..distributed.sharded_lsm import ShardedCoconutLSM
        return ShardedCoconutLSM(
            cfg, shards=shards, buffer_capacity=buffer_capacity,
            leaf_size=leaf_size, mode=mode, materialized=materialized,
            io=io, data_dir=data_dir, concurrent=concurrent,
            wal_fsync=wal_fsync, max_debt=max_debt, device=device)
    return CoconutLSM(cfg, buffer_capacity=buffer_capacity,
                      leaf_size=leaf_size, mode=mode,
                      materialized=materialized, io=io, store=store,
                      concurrent=concurrent, wal_fsync=wal_fsync,
                      max_debt=max_debt, device=device)
