"""Unified query subsystem: one plan -> prune -> scan -> verify pipeline.

* :mod:`repro_torch.query.partition` — the uniform :class:`Partition` view
  a search source exposes: a sorted Coconut run (device tree or mmap
  segment) or an unsorted frozen insert buffer.
* :mod:`repro_torch.query.planner`   — turns partitions into a
  leaf-granular :class:`ScanPlan`: window/``ts_min`` filtering,
  whole-partition fence bounds, and per-leaf z-order fence envelopes
  ordered by mindist (the skip-sequential discipline of SIMS).
* :mod:`repro_torch.query.executor`  — runs the plan: seed probes,
  leaf-masked lower-bound scan, batched Euclidean verification through
  the CUDA kernels (or their plain twins on the CPU), or the fused
  ``scan_verify`` kernel with ``scan_mode="kernel"``; buffers are
  brute-forced with the same ED kernel.
* :mod:`repro_torch.query.merger`    — best-so-far chaining, k-NN pool
  merging, and the per-query :class:`SearchStats` accounting.
* :mod:`repro_torch.query.approx`    — the budgeted policy over the same
  plan: a best-first leaf-frontier drain under a per-query
  :class:`Budget` (``max_leaves`` / ``max_bytes`` / ``deadline_ms``)
  with a certified lower-bound gap report and progressive refinement
  (:func:`progressive_knn`).
"""
from .approx import (Budget, approx_knn, as_budget, certified_gap,
                     progressive_knn)
from .executor import execute, exact_knn
from .merger import KnnPool, SearchStats, merge_pools, merge_topk
from .partition import Partition
from .planner import ScanPlan, build_plan

__all__ = ["Partition", "ScanPlan", "build_plan", "execute", "exact_knn",
           "Budget", "as_budget", "approx_knn", "certified_gap",
           "progressive_knn",
           "KnnPool", "SearchStats", "merge_pools", "merge_topk"]
