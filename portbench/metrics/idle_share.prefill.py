"""1 − (the union of device activity) / (the traced window), in percent:
the share of the traced forwards' time in which the card ran nothing."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
