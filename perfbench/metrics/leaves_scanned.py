"""leaves_scanned: leaf blocks whose codes the executor streamed, a batch
(``SearchStats.leaves_scanned``), the mean over the window's batches."""


def read(win):
    v = [r["stats"].leaves_scanned for r in win.records
         if r.get("stats") is not None]
    return sum(v) / len(v) if v else None
