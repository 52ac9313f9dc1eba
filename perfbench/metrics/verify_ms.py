"""verify_ms: the executor's ``verify`` stage a batch
(``SearchStats.timings["verify"]``, host; the span of the same name in a
traced run): the verification of the leaf groups: row gather, the ED (or
fused) launch and its copy back; the mean over the window's batches."""


def read(win):
    v = [r["stats"].timings["verify"] for r in win.records
         if r.get("stats") is not None and "verify" in r["stats"].timings]
    return sum(v) / len(v) if v else None
