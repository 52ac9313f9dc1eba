"""Data-series generation (paper Sec. 6 "Datasets")."""
from .series import query_workload, random_walk  # noqa: F401
