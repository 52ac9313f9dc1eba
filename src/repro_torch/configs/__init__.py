"""Configurations: the paper's index deployment (Sec. 6) and the ten
model architectures the serving launcher runs.

Each architecture module exports ``CONFIG`` (the published numbers) and
``SMOKE`` (reduced, same family); ``get(arch, smoke=)`` resolves an id.
"""
from .coconut_paper import INDEX, LEAF_SIZE, SMOKE_INDEX, SMOKE_LEAF  # noqa: F401
from .registry import ARCHS, get  # noqa: F401
