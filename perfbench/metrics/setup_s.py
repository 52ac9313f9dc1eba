"""setup_s: from the harness's start (before torch is imported) to the
window's start: imports, the kernels' build or load, the data made on the
card, the index built or pre-filled, the warm-up."""


def read(win):
    return win.setup_s
