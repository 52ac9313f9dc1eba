"""scan_ms: the executor's milliseconds a batch (``SearchStats.timings
["scan"]``: seeds, bounds, verification, merges and the buffer scan, each
stage ending in a copy to the host), the mean over the window's
batches."""


def read(win):
    v = [r["stats"].timings["scan"] for r in win.records
         if r.get("stats") is not None and "scan" in r["stats"].timings]
    return sum(v) / len(v) if v else None
