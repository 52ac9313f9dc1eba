"""Index configurations: the paper's own deployment (Sec. 6)."""
from .coconut_paper import INDEX, LEAF_SIZE, SMOKE_INDEX, SMOKE_LEAF  # noqa: F401
