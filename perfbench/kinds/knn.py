"""Traffic of ``"kind": "knn"``: one client, a closed loop of k-NN batches.

Batch ``i`` holds ``queries`` queries drawn anew from the seed
(``traffic.Traffic.queries``), searched with ``k``, ``budget``
(``max_leaves``, or null for exact) and the newest-row ``window`` of the
request (null: every row).  The system under test gives the primitives:
``setup()``, ``dataset`` (the rows queries are drawn from), ``span(window)``
(the rows a window covers), ``search(q_np, k, window, budget)``,
``sorted_rows()``, ``after_window()`` (its own numbers, and its state
freed) and ``rows()`` (the rows on the device, for the reference).

Judged after the window (:func:`knn_checks`): every answer against the
direct distance of the row it names; the checked batches against the
exact reference (exact traffic: the sorted distances; budgeted traffic:
the recall of the budgeted answers and the soundness of their gap).
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import reference

WARMUP_BUDGET = 16       # leaf groups of the warm-up batch


class Kind:
    def __init__(self, h, system):
        self.h = h
        self.system = system
        self.mix = h.traffic.mix
        self.answers = []            # (queries, dists, ids, gap)
        self.ranges = []             # each batch's (lo, hi) rows
        self.observed = {}

    def setup(self) -> None:
        """The system's set-up, then one budgeted batch at the window's
        batch shape, so that every kernel and host path of a batch has
        run before the window."""
        h, s = self.h, self.system
        s.setup()
        if h.impl == "control":
            return
        with h.phase("warm-up"):
            q = h.traffic.queries(-1, s.dataset, h.device)
            s.search(q.cpu().numpy(), self.mix["k"], None, WARMUP_BUDGET)

    def step(self, i: int) -> dict:
        h, mix = self.h, self.mix
        w = h.traffic.window(i)
        q = h.traffic.queries(i, self.system.dataset, h.device)
        q_np = q.cpu().numpy()
        t0 = h.clock()
        d, o, gap, st = self.system.search(q_np, mix["k"], w,
                                           mix.get("budget"))
        t1 = h.clock()
        self.answers.append((q, d, o, gap))
        self.ranges.append(self.system.span(w))
        return {"t0": t0, "t1": t1, "units": len(q), "stats": st,
                "sorted_rows": self.system.sorted_rows(), "window": w}

    def checks(self) -> dict:
        numbers = self.system.after_window()
        rows = self.system.rows()
        self.observed = knn_checks(
            numbers, self.answers, rows, self.mix["k"], self.ranges,
            self.h.traffic.checked(len(self.answers)),
            budgeted=self.mix.get("budget") is not None,
            seed_rows=getattr(self.system, "seed_rows", None))
        return numbers


def knn_checks(numbers: dict, answers, pool, k: int, ranges, checked,
               budgeted: bool, seed_rows=None) -> dict:
    """The numbers of knn traffic, into ``numbers``; returns counts seen
    on the way (reported beside them, not judged).

    ``rescore_gap``: over every answer, the relative gap between its
    distance and the direct distance of the row it names (inf for a row
    outside the searched range, or named twice for one query).
    ``kth_gap`` (exact traffic): over the checked batches, the relative
    gap between the sorted distances and the exact reference's.
    Budgeted traffic, over the checked batches: ``gap_unsound``, the
    largest relative amount by which a returned k-th distance less its
    gap exceeds the exact k-th distance (the gap's certificate broken);
    ``seed_unmet`` (where the system gives ``seed_rows``), the largest
    relative amount by which a returned k-th distance exceeds the exact
    k-th distance over the query's seed window (the answer worse than the
    seeds the configuration guarantees); and, observed, the recall of the
    answers (the mean share of the exact k nearest rows an answer holds),
    how many queries the program certified exact (gap 0) and how many of
    those differ from the exact reference."""
    rescore = 0.0
    for (q, d, o, _), (lo, hi) in zip(answers, ranges):
        if np.shape(d) != (len(q), k) or np.shape(o) != (len(q), k):
            rescore = float("inf")
            continue
        ids = torch.as_tensor(o, device=pool.device)
        bad = (ids < lo) | (ids >= hi)
        srt = torch.sort(ids, dim=1).values
        bad |= torch.cat([torch.zeros_like(srt[:, :1], dtype=torch.bool),
                          srt[:, 1:] == srt[:, :-1]], 1)
        if bool(bad.any()):
            rescore = float("inf")
            continue
        dd = reference.direct(q.to(pool.device), pool[ids])
        rescore = max(rescore, reference.rel_gap(
            torch.as_tensor(d, device=pool.device), dd))
    numbers["rescore_gap"] = rescore
    kth, unsound = 0.0, 0.0
    hits, n_q, certified, cert_wrong = 0, 0, 0, 0
    seed_unmet = 0.0
    for i in checked:
        q, d, o, gap = answers[i]
        lo, hi = ranges[i]
        if np.shape(d) != (len(q), k) or np.shape(o) != (len(q), k) or (
                budgeted and np.shape(gap) != (len(q),)):
            kth = unsound = seed_unmet = float("inf")
            n_q += len(q)
            continue
        rd, ro = reference.knn(pool, lo, hi, q, k)
        pd = torch.as_tensor(d, device=pool.device)
        if not budgeted:
            kth = max(kth, reference.rel_gap(pd, rd))
            continue
        po = torch.as_tensor(o, device=pool.device).long()
        hits += int((po[:, :, None] == ro[:, None, :]).any(2).sum())
        n_q += len(q)
        g = torch.as_tensor(gap, device=pool.device)
        m = g == 0
        certified += int(m.sum())
        if bool(m.any()):
            rel = (pd[m].double() - rd[m].double()).abs() \
                / rd[m].double().clamp_min(1e-30)
            cert_wrong += int((rel > 1e-5).any(1).sum())
        ex = (pd[:, -1].double() - g.double() - rd[:, -1].double()) \
            / rd[:, -1].double().clamp_min(1e-30)
        unsound = max(unsound, float(ex.clamp_min(0).max()))
        if seed_rows is not None:
            qd = q.to(pool.device)
            sd = reference.direct(qd, pool[seed_rows(qd)])
            skth = torch.topk(sd, k, dim=1, largest=False).values[:, -1]
            ex = (pd[:, -1].double() - skth.double()) \
                / skth.double().clamp_min(1e-30)
            seed_unmet = max(seed_unmet, float(ex.clamp_min(0).max()))
    if not budgeted:
        numbers["kth_gap"] = kth
        return {}
    numbers["gap_unsound"] = unsound
    if seed_rows is not None:
        numbers["seed_unmet"] = seed_unmet
    return {"checked_queries": n_q, "recall": hits / max(1, n_q * k),
            "certified_queries": certified,
            "certified_off_reference": cert_wrong}
