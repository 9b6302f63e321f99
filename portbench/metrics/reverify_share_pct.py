"""Share of the window's host time in the dense re-verify of triggered
chunks (ops.ds.run_bank_triggers_batch: DS rows, STA/LTA and the exact
trigger extraction on the device, waited on)."""

SPANS = {"reverify": ["detex_torch.ops.ds:run_bank_triggers_batch"]}


def read(t):
    s = t.spans.read("reverify")
    return None if s is None else 100.0 * s / t.window_s
