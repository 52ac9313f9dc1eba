"""merge_ms: the executor's ``merge`` stage a batch
(``SearchStats.timings["merge"]``, host; the span of the same name in a
traced run): the host pool updates after the seeds, each leaf group and
the buffer; the mean over the window's batches."""


def read(win):
    v = [r["stats"].timings["merge"] for r in win.records
         if r.get("stats") is not None and "merge" in r["stats"].timings]
    return sum(v) / len(v) if v else None
