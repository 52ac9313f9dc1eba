"""System under test for ``"index": "coconut_lsm"`` configurations: a
synchronous, in-memory ``repro_torch.core.lsm.CoconutLSM``.

Set-up streams the mix's ``prefill_rows`` rows into it as host batches of
``batch_rows``, the way a stream arrives: walks made on the device from
the seed and kept on the host, where the stream comes from.  A search
goes through a snapshot that includes the buffer (the configuration's
guarantee: an acknowledged row is searchable at once), over the newest
``window`` rows.  A row's id is its position in the insert stream, which
is its row of the stream.

``impl="control"``: the reference in the program's place, a precision
below the configuration's: TF32 k-NN over the window's rows.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import reference, walks
from perfbench.traffic import STREAM_DATA


class System:
    def __init__(self, h):
        self.h = h
        self.cfg = h.cfg
        self.n = h.traffic.mix["prefill_rows"]
        self.batch = h.traffic.mix["batch_rows"]
        self.eng = None
        self._rows = None

    def setup(self) -> None:
        h, c = self.h, self.cfg
        control = h.impl == "control"
        with h.phase("data"):
            self.dataset = walks.make_walks(
                walks.generator(h.device, h.seed, STREAM_DATA), self.n,
                c["series_len"], out=None if control else "cpu")
        if control:
            return
        from repro_torch.core.lsm import CoconutLSM
        from repro_torch.core.summarization import SummaryConfig
        self.eng = CoconutLSM(
            SummaryConfig(c["series_len"], c["segments"], c["bits"]),
            buffer_capacity=c["buffer_rows"], leaf_size=c["leaf_size"],
            size_ratio=c["size_ratio"], mode=c["mode"],
            materialized=c["materialized"], device=h.device)
        rows = self.dataset.numpy()
        with h.phase("prefill"):
            for s in range(0, self.n, self.batch):
                self.eng.insert(rows[s:s + self.batch])

    def span(self, window):
        return (0 if window is None else max(0, self.n - window)), self.n

    def search(self, q_np, k: int, window, budget):
        """(dists, ids, gap, stats) of one batch over the newest
        ``window`` rows."""
        if self.eng is None:
            lo, hi = self.span(window)
            d, o = reference.knn(self.dataset, lo, hi,
                                 torch.from_numpy(q_np), k, precision="tf32")
            return (d.cpu().numpy(), o.cpu().numpy(),
                    np.zeros(len(q_np), np.float32), None)
        d, o, info = self.eng.snapshot(include_buffer=True) \
            .search_exact_batch(q_np, k=k, window=window, budget=budget)
        return d, o, info.get("gap"), info["stats"]

    def sorted_rows(self) -> int:
        return 0 if self.eng is None else sum(r.n for r in self.eng.runs)

    def after_window(self) -> dict:
        """Free the engine (its answers are judged by the traffic)."""
        if self.eng is not None:
            self.eng.close()
            self.eng = None
            if self.h.device.type == "cuda":
                torch.cuda.empty_cache()
        return {}

    def rows(self) -> torch.Tensor:
        """The stream's rows on the device, for the reference."""
        if self._rows is None:
            self._rows = self.dataset.to(self.h.device)
        return self._rows
