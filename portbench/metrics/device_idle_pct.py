"""device_idle_pct: the share of the traced window in which no device
operation ran (profiler), in %."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100 * (1 - tr["busy_s"] / tr["window_s"])
