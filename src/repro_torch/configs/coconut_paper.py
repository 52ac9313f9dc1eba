"""The paper's own experimental configuration (Sec. 6).

Series of 256 float32 points, 16 SAX segments (chosen by the paper's
segment sweep), 8-bit cardinality, leaf size 2000 records.
"""
from ..core.summarization import SummaryConfig

INDEX = SummaryConfig(series_len=256, segments=16, bits=8)
LEAF_SIZE = 2000
SMOKE_INDEX = SummaryConfig(series_len=64, segments=8, bits=4)
SMOKE_LEAF = 64
