"""Station-days of new continuous data (chunk_seconds a chunk, the buffer
not counted) scanned to histograms and rows in SQLite, over the host
seconds of the whole window."""


def read(t):
    return t.station_days / t.window_s
