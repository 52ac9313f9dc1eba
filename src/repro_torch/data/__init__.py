"""Data-series generation (paper Sec. 6 "Datasets") and the training
token pipeline."""
from .series import (query_workload, random_walk, series_batches,  # noqa: F401
                     sliding_windows, synthetic_signal)
from .tokens import TokenPipeline  # noqa: F401
