"""Share of the window's host time in the engine's preparation of each
chunk on the batched path (detect._SSDetex._prepChunk: merge, trim and
detrend, then with the device filter the channel sort and float32 stack,
else the host filter and multiplex). A program without _prepChunk reads
None."""

SPANS = {"chunk_prep": ["detex_torch.detect:_SSDetex._prepChunk"]}


def read(t):
    s = t.spans.read("chunk_prep")
    return None if s is None else 100.0 * s / t.window_s
