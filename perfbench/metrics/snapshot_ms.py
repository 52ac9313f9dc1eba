"""snapshot_ms: the LSM read view's capture a batch (the program's
``snapshot`` spans in the traced window, which the engine opens before
the search's own probe: the runs captured, the buffer concatenated, the
key fences combined), summed over the window and divided by its batches;
nothing untraced or where the program has no such span."""

NS_PER_MS = 1e6


def read(win):
    if win.trace is None or not win.records:
        return None
    t = [e - s for name, s, e, depth in win.trace.spans
         if name == "snapshot" and depth >= 1]
    if not t:
        return None
    return sum(t) / NS_PER_MS / len(win.records)
