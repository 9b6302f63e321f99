"""Share of the window's host time in the engine's host filter and
multiplex (detect._applyFilter, detect.multiplex)."""

SPANS = {"host_prep": ["detex_torch.detect:_applyFilter",
                       "detex_torch.detect:multiplex"]}


def read(t):
    s = t.spans.read("host_prep")
    return None if s is None else 100.0 * s / t.window_s
