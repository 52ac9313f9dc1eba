"""Data-series generation (paper Sec. 6 "Datasets").

The paper's synthetic workload is a Gaussian random walk ("shown to
effectively simulate real-world financial data"), z-normalized.  Every
function draws from an explicit ``torch.Generator`` and makes its tensors on
that generator's device, so data for the card is made on the card.  The
streams differ from ``jax.random``'s: tests hand both packages the same
numpy arrays instead.
"""
from __future__ import annotations

import math
from typing import Iterator

import numpy as np
import torch

from ..core.summarization import znormalize

__all__ = ["random_walk", "sliding_windows", "synthetic_signal",
           "series_batches", "query_workload"]


def random_walk(gen: torch.Generator, n: int, length: int = 256,
                znorm: bool = True) -> torch.Tensor:
    """Paper's generator: steps ~ N(0,1), cumulatively summed."""
    x = torch.randn((n, length), generator=gen, device=gen.device)
    x = x.cumsum_(dim=-1)
    return znormalize(x) if znorm else x


def synthetic_signal(gen: torch.Generator, total_len: int,
                     n_modes: int = 24) -> torch.Tensor:
    """Seismic-like long signal: superposed decaying oscillations + noise."""
    dev = gen.device
    t = torch.arange(total_len, dtype=torch.float32, device=dev)
    freqs = 1e-4 + (5e-2 - 1e-4) * torch.rand(n_modes, generator=gen,
                                              device=dev)
    phases = 2 * math.pi * torch.rand(n_modes, generator=gen, device=dev)
    amps = torch.empty(n_modes, device=dev).exponential_(generator=gen)
    sig = torch.zeros(total_len, device=dev)
    for i in range(n_modes):          # modes added in order: same bits
        sig = sig + amps[i] * torch.sin(freqs[i] * t + phases[i])
    return sig + 0.3 * torch.randn(total_len, generator=gen, device=dev)


def sliding_windows(signal: torch.Tensor, length: int = 256, step: int = 4,
                    znorm: bool = True) -> torch.Tensor:
    """Extract overlapping subsequences (paper: step 4 for seismic, 1 astro)."""
    signal = torch.as_tensor(signal)
    n = (signal.shape[0] - length) // step + 1
    x = signal.unfold(0, length, step)[:n]
    return znormalize(x) if znorm else x.contiguous()


def series_batches(gen: torch.Generator, total: int, batch: int,
                   length: int = 256) -> Iterator[np.ndarray]:
    """Streaming batches (host numpy) for LSM ingestion experiments."""
    done = 0
    while done < total:
        n = min(batch, total - done)
        yield random_walk(gen, n, length).cpu().numpy()
        done += n


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
