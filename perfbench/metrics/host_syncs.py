"""host_syncs: the device-to-host round trips the program waited for, a
batch (``SearchStats.host_syncs``: a copy back per bound and per
verification of a leaf group, two per seed probe and per buffer scan),
the mean over the window's batches; nothing where the program does not
count them."""


def read(win):
    v = [r["stats"].host_syncs for r in win.records
         if getattr(r.get("stats"), "host_syncs", None) is not None]
    return sum(v) / len(v) if v else None
