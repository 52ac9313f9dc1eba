"""approx_batch_p95_ms: the 95th percentile (nearest rank) of the
latencies of the window's budgeted batches, on the host's clock."""
import math


def read(win):
    if win.mix.get("budget") is None:
        return None
    lat = sorted((r["t1"] - r["t0"]) * 1e3 for r in win.records)
    if len(lat) < 20:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1]
