"""Hand-written CUDA kernels for the Coconut hot paths (+ plain twins).

Kernels (each ``<name>.py`` wraps its ``csrc/<name>.cu``; ``ops.py``
dispatches by device; ``ref.py`` holds the plain PyTorch twins that are
the CPU path and the kernels' oracle; ``loader.py`` builds, loads and
counts them):
  * mindist_batch  — batched SIMS lower bound (the exact-search hot loop)
  * batch_euclid   — squared ED, cross and gathered forms (verification,
                     seed probes)
  * scan_verify    — fused scan: lower bound + masked early-abandoning
                     verification + per-query top-k
  * fused_build    — raw series -> PAA, SAX codes and z-order keys in one
                     pass (the Coconut-Tree build)
  * sax_summarize  — raw series -> PAA and SAX codes (external-sort pass 1,
                     seed-probe query codes)
  * zorder         — SAX codes -> z-order keys (external-sort pass 1, seed
                     probes, builds from precomputed codes)
  * unpack_mindist — batched lower bound over bit-packed (format v3) code
                     rows (the scan of an on-disk segment)
  * pool_merge     — folds a leaf group's candidates into the exact scan's
                     per-query pools on the card (no TPU counterpart)
"""
from . import ops, ref  # noqa: F401
