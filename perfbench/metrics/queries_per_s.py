"""queries_per_s: queries answered over all the window's time (knn
traffic; the host's clock, from the window's start to the end of its
last request)."""


def read(win):
    if win.mix["kind"] != "knn":
        return None
    return win.units() / win.window_s
