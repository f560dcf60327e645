"""The union of the device's op intervals per traced frame, ms."""


def read(rec):
    t = rec.trace
    if not t or t["busy_s"] <= 0:
        return None
    return 1e3 * t["busy_s"] / t["calls"]
