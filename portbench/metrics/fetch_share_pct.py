"""Share of the window's host time spent inside next() of the chunk
iterator the engine draws from: the data layer (the 'dir' DataFetcher's
index query, npz reads, merge, trim and detrend)."""


def read(t):
    s = t.spans.read("fetch")
    return None if s is None or not t.spans.count.get("fetch") \
        else 100.0 * s / t.window_s
