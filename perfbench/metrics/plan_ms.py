"""plan_ms: the planner's milliseconds a batch (``SearchStats.timings
["plan"]``, host), the mean over the window's batches."""


def read(win):
    v = [r["stats"].timings["plan"] for r in win.records
         if r.get("stats") is not None and "plan" in r["stats"].timings]
    return sum(v) / len(v) if v else None
