"""Share of the window's host time in the host-to-device copies of chunk
batches (ops.ds.to_device, from the engine, the scans and the per-chunk
path). A copy made inside another harness span (the re-verify's, where
a cell reads it) counts there, not here. A program without to_device
reads None."""

SPANS = {"upload": ["detex_torch.ops.ds:to_device"]}


def read(t):
    s = t.spans.read("upload")
    return None if s is None else 100.0 * s / t.window_s
