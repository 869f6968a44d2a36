"""Share of the traced window in which no operation ran on the device (the
union of the profiler's device intervals against the window's length)."""


def read(rec):
    w = rec.window
    return 100 * (1 - w.busy_s / w.window_s) if w.busy_s > 0 else None
