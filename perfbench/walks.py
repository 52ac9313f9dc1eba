"""Frozen copy of the port's data-series generators, the benchmark's inputs.

Copied from ``src/repro_torch/data/series.py`` (``random_walk``,
``query_workload``) and ``src/repro_torch/core/summarization.py``
(``znormalize``) so that a later change to the program cannot change what
the benchmark feeds it.  Plain PyTorch; imports nothing of the program.

Changes from the copy: :func:`query_batch` draws a fixed number of
dataset queries a batch (``round(n * from_dataset)``) in a shuffled order,
where ``query_workload`` drew a Bernoulli mix, so that every batch of
every seed holds the same mix of easy and hard queries; :func:`make_walks`
fills a preallocated tensor in chunks, on the card or on the host;
:func:`sub_seed` derives the independent streams of one run from
``--seed``.
"""
from __future__ import annotations

import torch

GEN_CHUNK = 1 << 20
_MASK64 = (1 << 64) - 1


def sub_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for one stream of a run (splitmix64 over ``seed`` and
    the stream's numbers), so that runs of nearby seeds share nothing."""
    z = seed & _MASK64
    for s in (0x5EED, *stream):
        z = (z + 0x9E3779B97F4A7C15 + (s & _MASK64)) & _MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        z ^= z >> 31
    return z >> 1


def generator(device, seed: int, *stream: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, *stream))
    return gen


def znormalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Z-normalize each series (paper Sec. 2: required preprocessing)."""
    mu = x.mean(dim=-1, keepdim=True)
    sd = x.std(dim=-1, keepdim=True, correction=0)
    return (x - mu) / (sd + eps)


def random_walk(gen: torch.Generator, n: int, length: int = 256,
                znorm: bool = True) -> torch.Tensor:
    """Paper's generator: steps ~ N(0,1), cumulatively summed."""
    x = torch.randn((n, length), generator=gen, device=gen.device)
    x = x.cumsum_(dim=-1)
    return znormalize(x) if znorm else x


def make_walks(gen: torch.Generator, n: int, length: int,
               out=None) -> torch.Tensor:
    """``n`` z-normalized walks, made on the generator's device in chunks
    so that the temporaries stay small, and kept there or on the device
    ``out``."""
    x = torch.empty((n, length), dtype=torch.float32,
                    device=gen.device if out is None else out)
    for s in range(0, n, GEN_CHUNK):
        x[s:s + GEN_CHUNK] = random_walk(gen, min(GEN_CHUNK, n - s), length)
    return x


def query_batch(gen: torch.Generator, dataset: torch.Tensor, n_queries: int,
                noise: float = 0.1, from_dataset: float = 0.5
                ) -> torch.Tensor:
    """Paper-style query workload: dataset series plus N(0, noise) noise
    ('locate whether this series or a similar one exists') and fresh
    random walks, ``round(n_queries * from_dataset)`` of the first kind,
    in a shuffled order, all z-normalized."""
    dev = gen.device
    n_base = int(round(n_queries * from_dataset))
    idx = torch.randint(0, dataset.shape[0], (n_base,), generator=gen,
                        device=dev)
    base = dataset[idx.to(dataset.device)].to(dev)
    fresh = random_walk(gen, n_queries - n_base, dataset.shape[1])
    q = torch.cat([base, fresh])
    q = q[torch.randperm(n_queries, generator=gen, device=dev)]
    if noise > 0:
        q = q + noise * torch.randn(q.shape, generator=gen, device=dev)
    return znormalize(q)
