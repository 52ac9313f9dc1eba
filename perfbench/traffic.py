"""The one general generator: turns a traffic mix (a data file under
``perfbench/traffic/``) and ``--seed`` into the requests of a run.

A mix is a JSON object.  Its ``kind`` names the file
``perfbench/kinds/<kind>.py`` that drives the system with it, so that a
new kind of traffic is a file of its own.  The parameters this generator
reads: ``queries`` a batch, each batch drawn anew from the seed by
:func:`walks.query_batch` (``noise``, ``from_dataset``); ``windows`` (null,
or newest-row counts cycled in a seeded order, a new permutation each
cycle, a window of the run ending with its cycle); ``check_batches`` (null:
every batch is compared with the exact reference; n: n batches drawn from
the seed).  ``source`` and ``assumed`` say where the values come from.

Every seed gives the same sizes and arrivals; only their contents and
order change.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import walks

# stream numbers of walks.generator (one run's independent streams)
STREAM_DATA = 1
STREAM_QUERIES = 2
STREAM_ORDER = 3
STREAM_WARMUP = 4
STREAM_CHECK = 5


class Traffic:
    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.seed = seed
        self.kind = mix["kind"]
        self.windows = mix.get("windows") or None
        self._perm = {}

    def window(self, i: int) -> Optional[int]:
        """The newest-row window of request ``i`` (None: every row)."""
        if self.windows is None:
            return None
        m = len(self.windows)
        c, p = divmod(i, m)
        if c not in self._perm:
            g = torch.Generator().manual_seed(
                walks.sub_seed(self.seed, STREAM_ORDER, c))
            self._perm[c] = torch.randperm(m, generator=g).tolist()
        return self.windows[self._perm[c][p]]

    def unit_complete(self, done: int) -> bool:
        """Whether ``done`` requests make a whole unit of the mix (a whole
        cycle of windows), so that a window may end there."""
        return self.windows is None or done % len(self.windows) == 0

    def queries(self, i: int, dataset: torch.Tensor, device) -> torch.Tensor:
        """Batch ``i``'s queries on ``device`` (``i < 0``: warm-up), drawn
        from ``dataset`` (on the device or on the host)."""
        mix = self.mix
        stream = STREAM_QUERIES if i >= 0 else STREAM_WARMUP
        gen = walks.generator(device, self.seed, stream, abs(i))
        return walks.query_batch(gen, dataset, mix["queries"],
                                 noise=mix.get("noise", 0.1),
                                 from_dataset=mix.get("from_dataset", 0.5))

    def checked(self, n_done: int) -> list:
        """Indices of the completed requests compared with the exact
        reference: all, or ``check_batches`` drawn from the seed."""
        want = self.mix.get("check_batches")
        if want is None or want >= n_done:
            return list(range(n_done))
        g = torch.Generator().manual_seed(
            walks.sub_seed(self.seed, STREAM_CHECK))
        return sorted(torch.randperm(n_done, generator=g)[:want].tolist())
