"""Share of the window's host time in the magnitude estimates and the
SQLite writes of detection rows (_SSDetex._estMag, util.saveSQLite)."""

SPANS = {"rows": ["detex_torch.detect:_SSDetex._estMag",
                  "detex_torch.util:saveSQLite"]}


def read(t):
    s = t.spans.read("rows")
    return None if s is None else 100.0 * s / t.window_s
