"""Data-series generation (paper Sec. 6 "Datasets").

The paper's synthetic workload is a Gaussian random walk ("shown to
effectively simulate real-world financial data"), z-normalized.  Every
function draws from an explicit ``torch.Generator`` and makes its tensors on
that generator's device, so data for the card is made on the card.  The
streams differ from ``jax.random``'s: tests hand both packages the same
numpy arrays instead.
"""
from __future__ import annotations

import torch

from ..core.summarization import znormalize

__all__ = ["random_walk", "query_workload"]


def random_walk(gen: torch.Generator, n: int, length: int = 256,
                znorm: bool = True) -> torch.Tensor:
    """Paper's generator: steps ~ N(0,1), cumulatively summed."""
    x = torch.randn((n, length), generator=gen, device=gen.device)
    x = x.cumsum_(dim=-1)
    return znormalize(x) if znorm else x


def query_workload(gen: torch.Generator, dataset: torch.Tensor,
                   n_queries: int, noise: float = 0.1,
                   from_dataset_frac: float = 0.5) -> torch.Tensor:
    """Paper-style query workload: randomly selected series (optionally
    perturbed) — 'locate whether this series or a similar one exists' —
    and fresh random walks, mixed by ``from_dataset_frac``."""
    dev = gen.device
    n = dataset.shape[0]
    idx = torch.randint(0, n, (n_queries,), generator=gen, device=dev)
    base = dataset[idx.to(dataset.device)].to(dev)
    fresh = random_walk(gen, n_queries, dataset.shape[1])
    take_base = torch.rand((n_queries, 1), generator=gen,
                           device=dev) < from_dataset_frac
    q = torch.where(take_base, base, fresh)
    if noise > 0:
        q = q + noise * torch.randn(q.shape, generator=gen, device=dev)
    return znormalize(q)
