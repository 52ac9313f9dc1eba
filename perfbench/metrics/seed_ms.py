"""seed_ms: the executor's ``seed`` stage a batch
(``SearchStats.timings["seed"]``, host; the span of the same name in a
traced run): the seed probes, summed over the sorted partitions: query
summaries, z-order keys, key search, the gathered ED, their copies back
and the pool updates; the mean over the window's batches."""


def read(win):
    v = [r["stats"].timings["seed"] for r in win.records
         if r.get("stats") is not None and "seed" in r["stats"].timings]
    return sum(v) / len(v) if v else None
