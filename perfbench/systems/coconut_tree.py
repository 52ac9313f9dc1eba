"""System under test for ``"index": "coconut_tree"`` configurations: a
materialized Coconut-Tree built by ``repro_torch.core.tree.build`` over
walks made on the device, searched by ``exact_search_batch`` (exact, or
under a ``max_leaves`` budget).

Judged after the window, besides what the traffic's kind judges: the
build (every row's PAA, codes, key, offset and co-sorted raw row against
the reference's, in the reference's stable sort order).

For budgeted traffic, :meth:`seed_rows` gives the rows of the
configuration's seed guarantee: a budgeted answer is no worse than the
exact k-NN over the ``2 * leaf_size`` rows of the sorted order around the
query's z-order insertion point (the paper's approximate search, its
Algorithm 4), found here in the reference's own sorted keys, less
``SEED_MARGIN`` rows at each end, so that a window placed a few rows
apart still holds them.

``impl="control"`` puts the reference in the program's place, a
precision below the configuration's: the build's summaries in bfloat16,
the searches as TF32 k-NN.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import reference, summaries, walks
from perfbench.traffic import STREAM_DATA

SEED_MARGIN = 200        # rows left out at each end of a seed window


class System:
    def __init__(self, h):
        self.h = h
        self.cfg = h.cfg
        self.tree = None

    def setup(self) -> None:
        h, c = self.h, self.cfg
        with h.phase("data"):
            self.dataset = walks.make_walks(
                walks.generator(h.device, h.seed, STREAM_DATA), c["rows"],
                c["series_len"])
        if h.impl == "control":
            return
        from repro_torch.core import tree as T
        from repro_torch.core.summarization import SummaryConfig
        self.T = T
        with h.phase("build"):
            self.tree = T.build(
                self.dataset, SummaryConfig(c["series_len"], c["segments"],
                                            c["bits"]),
                leaf_size=c["leaf_size"], materialized=c["materialized"],
                device=h.device)

    def span(self, window):
        return 0, self.dataset.shape[0]

    def search(self, q_np, k: int, window, budget):
        """(dists, ids, gap, stats) of one batch; ``window`` is ignored
        (a static tree)."""
        if self.tree is None:
            d, o = reference.knn(self.dataset, 0, self.dataset.shape[0],
                                 torch.from_numpy(q_np), k, precision="tf32")
            return (d.cpu().numpy(), o.cpu().numpy(),
                    np.zeros(len(q_np), np.float32), None)
        d, o, st = self.T.exact_search_batch(self.tree, q_np, k=k,
                                             budget=budget)
        return d, o, st.gap, st

    def sorted_rows(self) -> int:
        return self.dataset.shape[0]

    def after_window(self) -> dict:
        """The build's number, judged while the tree is alive; then the
        tree is freed."""
        c = self.cfg
        ref = reference.build_reference(self.dataset, c["segments"],
                                        c["bits"])
        if self.tree is None:
            paas, codes, keys, order = reference.build_reference(
                self.dataset, c["segments"], c["bits"], dtype=torch.bfloat16)
            cols = (order, paas[order], codes[order], keys[order],
                    self.dataset[order])
        else:
            t = self.tree
            cols = (t.offsets, t.paas, t.codes, t.keys, t.raw)
        mismatch = reference.build_mismatches(self.dataset, ref, cols)
        self.order = ref[3]
        self.sorted_keys = summaries.packed_keys(ref[2][self.order])
        del cols, ref
        self.tree = None
        if self.h.device.type == "cuda":
            torch.cuda.empty_cache()
        return {"build_mismatch": mismatch}

    def rows(self) -> torch.Tensor:
        return self.dataset

    def seed_rows(self, q: torch.Tensor) -> torch.Tensor:
        """Dataset rows ``[Q, 2 * leaf_size - 2 * SEED_MARGIN]`` of each
        query's seed window (after :meth:`after_window`)."""
        c = self.cfg
        n, span = self.dataset.shape[0], 2 * c["leaf_size"]
        _, _, qk = summaries.summarize(q.to(self.dataset.device),
                                       c["segments"], c["bits"])
        pos = summaries.searchsorted_packed(self.sorted_keys,
                                            summaries.packed_keys(qk))
        start = (pos - span // 2).clamp(0, max(n - span, 0))
        idx = start[:, None] + torch.arange(
            SEED_MARGIN, span - SEED_MARGIN, device=pos.device)[None, :]
        return self.order[idx.clamp(0, n - 1)]
