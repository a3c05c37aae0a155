"""device layer (the H100): the share of the profiled frames' traced
window in which no operation runs on the device, one minus the union of
the device's kernel, copy and set intervals over the window."""


def read(record):
    t = record["trace"]
    if not t:
        return None
    lo, hi = t["window"]
    return 100.0 * (1.0 - t["busy"] / (hi - lo))
