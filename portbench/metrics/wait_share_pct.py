"""Share of the window's host time in reads of device results that wait
for the card's work behind them (ops.ds.to_host: a batch's histograms
and maxima, the re-verify's packed triggers). A read made inside another
harness span (the re-verify's, where a cell reads it) counts there, not
here. A program without to_host reads None."""

SPANS = {"wait": ["detex_torch.ops.ds:to_host"]}


def read(t):
    s = t.spans.read("wait")
    return None if s is None else 100.0 * s / t.window_s
