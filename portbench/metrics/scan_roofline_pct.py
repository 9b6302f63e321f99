"""The least time the window's scanned work needs on the card, over the
card's busy time in the window (counts.scan_work: raw input bytes read
once, the bank's spectra once a batch, summaries written once; the device
filter's and the overlap-save correlation's float32 operations), in
percent. Counted from the cell's shapes, not from the kernels that ran."""


def read(t):
    if t.device is None or not t.chunks_scanned:
        return None
    busy = sum(t.device.busy_s)
    if busy <= 0:
        return None
    c = t.cell
    dets = t.cfg["detectors"]
    bound_s = 0.0
    for kind in c.kinds:
        n = sum(len(v) for call in t.run.calls if call["kind"] == kind
                for v in call["handed"].values())
        if not n:
            continue
        nbytes, flops = t.counts.scan_work(
            n, int(t.cfg["batch_size"]),
            int(dets[kind]["count"]), int(dets[kind].get("dim", 1)), c.nc,
            c.n_c, c.pad_c, bool(t.cfg.get("device_prep")))
        bound_s += t.counts.bound(nbytes, flops)[0]
    return 100.0 * bound_s / busy
