"""buffer_ms: the executor's ``buffer`` stage a batch
(``SearchStats.timings["buffer"]``, host; the span of the same name in a
traced run): the brute-force scan of the unsorted buffer: its copy to
the card, the ED, the sort, the copy back and its merge; the mean over
the window's batches."""


def read(win):
    v = [r["stats"].timings["buffer"] for r in win.records
         if r.get("stats") is not None and "buffer" in r["stats"].timings]
    return sum(v) / len(v) if v else None
