"""device_idle_pct (and ``device_idle_pct.<part>``, one entry for each
end-to-end metric it moves): the share of the traced window in which no
operation ran on the card, in percent."""


def read(win):
    if win.trace is None:
        return None
    return 100.0 * (1.0 - win.trace.busy_s() / win.trace.window_s)
