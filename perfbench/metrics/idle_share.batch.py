"""The device's idle share of the traced window, in %: 1 minus the union
of the device's op intervals over the window's wall time."""


def read(rec):
    t = rec.trace
    if not t or t["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["wall_s"])
