"""mindist_batch_roofline: the least time of the window's iSAX bounds
(``counts.search_bounds``) over the device time of the ``mindist_batch``
kernel's launches in the trace, in percent."""
from perfbench import counts


def read(win):
    if win.trace is None:
        return None
    t, n = win.trace.op_seconds("MindistBatch")
    if n == 0:
        return None
    c = win.cfg
    need = sum(counts.search_bounds(
        r["stats"], r["units"], c["series_len"], c["segments"],
        c["leaf_size"], r["sorted_rows"])[0]
        for r in win.records if r.get("stats") is not None)
    return 100.0 * need / t
