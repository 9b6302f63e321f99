"""100 less the share of the window in which the card ran a kernel, a copy
or a set (the union of the profiler's device intervals); the mean over the
cards."""


def read(t):
    if t.device is None:
        return None
    idle = t.device.idle_pct()
    return sum(idle) / len(idle)
