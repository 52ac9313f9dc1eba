"""Coconut core: sortable summarizations + the Coconut-Tree built on them.

Paper: "Coconut: sortable summarizations for scalable indexes over static
and streaming data series" (Kondylakis, Dayan, Zoumpatianos, Palpanas).

Layers:
  * :mod:`repro_torch.core.keys`            z-order (invSAX) multi-word keys
  * :mod:`repro_torch.core.summarization`   PAA / SAX / mindist lower bounds
  * :mod:`repro_torch.core.tree`            Coconut-Tree (median split, SIMS exact)
  * :mod:`repro_torch.core.metrics`         disk-access-model accounting
"""
from . import keys, metrics, summarization  # noqa: F401
from .summarization import SummaryConfig  # noqa: F401
from .tree import CoconutTree, approx_search, build, exact_search  # noqa: F401
