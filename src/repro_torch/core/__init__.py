"""Coconut core: sortable summarizations + the index family built on them.

Paper: "Coconut: sortable summarizations for scalable indexes over static
and streaming data series" (Kondylakis, Dayan, Zoumpatianos, Palpanas).

Layers:
  * :mod:`repro_torch.core.keys`            z-order (invSAX) multi-word keys
  * :mod:`repro_torch.core.summarization`   PAA / SAX / mindist lower bounds
  * :mod:`repro_torch.core.tree`            Coconut-Tree (median split, SIMS exact)
  * :mod:`repro_torch.core.trie`            Coconut-Trie + iSAX top-down baseline
  * :mod:`repro_torch.core.lsm`             Coconut-LSM + PP/TP/BTP windowing
  * :mod:`repro_torch.core.windows`         the window engines by the paper's names
  * :mod:`repro_torch.core.metrics`         disk-access-model and ingest accounting
"""
from . import keys, metrics, summarization  # noqa: F401
from .lsm import CoconutLSM  # noqa: F401
from .summarization import SummaryConfig  # noqa: F401
from .tree import CoconutTree, approx_search, build, exact_search  # noqa: F401
from .trie import CoconutTrie, ISaxIndex, build_trie  # noqa: F401
