"""Share of the window's host time in the engine's host filter of each
chunk, whichever way the chunk is filtered (detect.prepChunk: detrend,
band-pass, cast and multiplex in one native pass, or
construct._applyFilter and multiplex). The span is called "chunk_prep",
the breakdown's name for the engine's chunk preparation; no cell lists
this metric beside chunk_prep_share_pct, which gives that name to its
wrap of _SSDetex._prepChunk. A program without detect.prepChunk reads
None."""

SPANS = {"chunk_prep": ["detex_torch.detect:prepChunk"]}


def read(t):
    s = t.spans.read("chunk_prep")
    return None if s is None else 100.0 * s / t.window_s
