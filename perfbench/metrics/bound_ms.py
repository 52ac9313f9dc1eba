"""bound_ms: the executor's ``bound`` stage a batch
(``SearchStats.timings["bound"]``, host; the span of the same name in a
traced run): the lower bounds of the leaf groups: row indices, code
gather, the bound launch, its copy back and the live mask; the mean over
the window's batches."""


def read(win):
    v = [r["stats"].timings["bound"] for r in win.records
         if r.get("stats") is not None and "bound" in r["stats"].timings]
    return sum(v) / len(v) if v else None
