"""Deterministic, stateless LM token pipeline.

Batches are a pure function of (seed, step) so the fault-tolerance loop
can re-seek after a restart with no pipeline state to checkpoint.  The
synthetic corpus is the reference's Markov stream: each row starts at a
uniform token and moves by a jump drawn from [0, 17) each position (mod
the vocabulary), which gives the model local structure to learn; the
labels are the tokens rolled left by one with the last set to 0, and a
vlm/audio batch carries frontend embeddings ``0.1 * N(0, 1)``.

The draws come from a CPU ``torch.Generator`` seeded with a 32-bit word
of numpy's ``SeedSequence([seed, step])`` (the CPU generator keeps 32
bits of a seed) and are then moved to the device, so a batch is the same on the
CPU and on the card.  The reference draws from JAX's threefry keys, whose
bits this package does not reproduce: its batches and the reference's
differ (a parity test feeds both packages one numpy batch).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.tree import _device_for

__all__ = ["TokenPipeline"]


class TokenPipeline:
    def __init__(self, vocab: int, batch: int, seq_len: int, *,
                 seed: int = 0, frontend_tokens: int = 0, d_model: int = 0,
                 device=None):
        self.vocab = vocab
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.frontend_tokens = frontend_tokens
        self.d_model = d_model
        self.device = _device_for(None, device)

    def __call__(self, step: int) -> Dict[str, torch.Tensor]:
        word = np.random.SeedSequence([self.seed, int(step)]).generate_state(1)
        gen = torch.Generator().manual_seed(int(word[0]))
        B, T = self.batch, self.seq_len
        start = torch.randint(0, self.vocab, (B, 1), generator=gen)
        jumps = torch.randint(0, 17, (B, T), generator=gen)
        toks = (start + torch.cumsum(jumps, dim=1)) % self.vocab
        labels = torch.roll(toks, -1, dims=1)
        labels[:, -1] = 0
        batch = {"tokens": toks, "labels": labels}
        if self.frontend_tokens:
            batch["frontend"] = 0.1 * torch.randn(
                (B, self.frontend_tokens, self.d_model), generator=gen)
        return {k: v.to(self.device) for k, v in batch.items()}
