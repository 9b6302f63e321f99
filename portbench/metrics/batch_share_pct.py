"""Share of the window's host time in stacking each batch of chunks for
a bank's scan (detect._SSDetex._stackBatch: the zeroed batch array and
the copy of each chunk into it). A program without _stackBatch reads
None."""

SPANS = {"batch": ["detex_torch.detect:_SSDetex._stackBatch"]}


def read(t):
    s = t.spans.read("batch")
    return None if s is None else 100.0 * s / t.window_s
