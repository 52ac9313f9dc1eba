"""Unified query subsystem: one plan -> prune -> scan -> verify pipeline.

* :mod:`repro_torch.query.partition` — the uniform :class:`Partition` view
  a search source exposes (this slice: the device-resident tree).
* :mod:`repro_torch.query.planner`   — turns partitions into a
  leaf-granular :class:`ScanPlan`: window/``ts_min`` filtering,
  whole-partition fence bounds, and per-leaf z-order fence envelopes
  ordered by mindist (the skip-sequential discipline of SIMS).
* :mod:`repro_torch.query.executor`  — runs the plan: seed probes,
  leaf-masked lower-bound scan, batched Euclidean verification through
  the CUDA kernels (or their plain twins on the CPU), or the fused
  ``scan_verify`` kernel with ``scan_mode="kernel"``.
* :mod:`repro_torch.query.merger`    — best-so-far chaining, k-NN pool
  merging, and the per-query :class:`SearchStats` accounting.
"""
from .executor import execute, exact_knn
from .merger import KnnPool, SearchStats, merge_pools, merge_topk
from .partition import Partition
from .planner import ScanPlan, build_plan

__all__ = ["Partition", "ScanPlan", "build_plan", "execute", "exact_knn",
           "KnnPool", "SearchStats", "merge_pools", "merge_topk"]
