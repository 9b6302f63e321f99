"""
How ``correct`` is decided: the program's answers of the window against the
plain float64 reference (portbench/reference/engine64.py), worked out again
from the raw samples and the detectors the benchmark generated.

What is compared, per cell (the traffic decides which chunks):
  - the samples the engine was handed, for a few chunks the seed draws
    before the window (samples_gap, relative to the chunk's spread);
  - for every checked chunk and detector, the rows in SQLite against the
    reference's triggers: every trigger the reference finds at least BAND
    above the threshold has a row (the gate dropped no chunk), every row
    has a reference trigger within TIE_SAMPLES samples whose DS it is
    within BAND of, or lies within BAND of the threshold (rows_unmatched,
    exact); at the row's own sample the DS (ds_gap), the DS STA/LTA
    (stalta_gap, relative), the magnitudes (mag_gap) and the SNR (snr_gap,
    relative);
  - the DS histograms of checked detectors (hist_gap: the share of counts
    in other bins than the reference's) and, for every detector, their
    totals against the scanned lengths (hist_count_miss, exact).

Checked chunks, detectors and histograms: what the traffic's window module
plans (``plan(run, rng)`` in portbench/harness/windows/), from the seed.

The control ("bfloat16") is the reference in the program's place with its
stage boundaries rounded to bfloat16 (engine64.rounded).
"""
from __future__ import annotations

import sqlite3

import numpy as np
import torch

from portbench.harness import gen as _gen
from portbench.reference import engine64 as ref

# below this far above the threshold (DS units) a reference trigger may be
# missing, and a row may stand where the reference has none: float32
# rounding of the scan can put such a peak on either side; a row may pick
# a sample this close to the reference's best
BAND = 2e-4
# how far (samples) a row's pick may lie from the reference's argmax
TIE_SAMPLES = 2
# the limit of each number compared, set between the program's largest
# reading over a dozen seeds and more and the control's smallest (PERF.md)
LIMITS = {
    "samples_gap": 1e-6,
    "ds_gap": 5e-5,
    "stalta_gap": 1e-4,
    "mag_gap": 3e-6,
    "snr_gap": 1e-6,
    "hist_gap": 1e-4,
    "rows_unmatched": 0,
    "hist_count_miss": 0,
}
COLS = ["DS", "DS_STALTA", "STMP", "Name", "Sta", "Mag", "SNR", "ProEnMag"]


def read_rows(db, table):
    """Rows of ``table`` as dicts of COLS; [] where there is none."""
    try:
        con = sqlite3.connect(db)
    except sqlite3.Error:
        return []
    try:
        cur = con.execute('SELECT %s FROM "%s"' % (
            ", ".join('"%s"' % c for c in COLS), table))
        return [dict(zip(COLS, r)) for r in cur.fetchall()]
    except sqlite3.Error:
        return []
    finally:
        con.close()


def program_answers(run):
    """The program's rows by (call, station, chunk label) and detector, as
    (sample, DS, STA/LTA, Mag, SNR, ProEnMag) lists, and its histograms by
    (call, station, detector)."""
    cell = run.cell
    rows = {}
    for ci, call in enumerate(run.calls):
        table = "ss_df" if call["kind"] == "subspace" else "sg_df"
        for r in read_rows(call["db"], table):
            lab = cell.chunk_of_time(r["STMP"])
            t0 = _gen.T0 + lab * cell.label_period()
            idx = int(round((r["STMP"] - t0) * cell.sr))
            sta = "%s" % r["Sta"]
            rows.setdefault((ci, sta, lab), {}).setdefault(
                str(r["Name"]), []).append((idx, r["DS"], r["DS_STALTA"],
                                            r["Mag"], r["SNR"],
                                            r["ProEnMag"]))
    hists = {}
    for ci, call in enumerate(run.calls):
        for sta, h in (call["hist"] or {}).items():
            if sta == "Bins" or h is None:
                continue
            for name, counts in h.items():
                hists[(ci, sta, name)] = np.asarray(counts, np.float64)
    return dict(rows=rows, hists=hists, samples=dict(run.captured))


class Numbers(object):
    def __init__(self):
        self.v = {k: 0.0 for k in LIMITS}
        self.v["rows_unmatched"] = 0
        self.v["hist_count_miss"] = 0
        self.notes = []

    def worst(self, name, value):
        if value is None or not np.isfinite(value):
            value = float("inf")
        self.v[name] = max(self.v[name], float(value))

    def miss(self, what):
        self.v["rows_unmatched"] += 1
        if len(self.notes) < 8:
            self.notes.append(what)


def _rel(a, b):
    if a is None or b is None:
        return float("inf")
    if np.isnan(a) and np.isnan(b):
        return 0.0
    return abs(a - b) / max(abs(b), 1e-30)


def _abs(a, b):
    if a is None or b is None:
        return float("inf")
    if np.isnan(a) and np.isnan(b):
        return 0.0
    return abs(a - b)


class Chunk(object):
    """A chunk as the reference sees it: the samples handed over, the
    host-filtered multiplexed chunk (all of it, for the magnitudes) and
    the part the engine scans."""

    def __init__(self, run, sta, key, prec):
        cell = run.cell
        self.handed = ref.rounded(cell.src.handed(run, sta, key), prec)
        x = ref.host_prep(self.handed, cell.sr, run.cfg["filt"], prec)
        self.mp = ref.multiplex(x)
        self.scan = self.mp[:cell.pad_c * cell.nc]


def _compare_rows(nums, got, det, ds, ck, cell, issub, what):
    """One detector on one chunk: the program's rows ``got`` against the
    reference's DS row ``ds`` and its STA/LTA."""
    thr = float(det["threshold"])
    trig = list(ref.triggers(ds, thr, int(ref.BUFF_SECONDS * cell.sr)))
    sl = ref.stalta(ds, cell.sr) if got else None
    used = set()
    for (i_p, ds_p, sl_p, mag_p, snr_p, pe_p) in got:
        if not 0 <= i_p < len(ds):
            nums.miss("%s row at sample %d outside the chunk" % (what, i_p))
            continue
        cand = [i for i in trig if abs(i - i_p) <= TIE_SAMPLES
                and i not in used]
        if cand:
            i_r = min(cand, key=lambda i: abs(i - i_p))
            used.add(i_r)
            if ds[i_r] - ds[i_p] > BAND:
                nums.miss("%s row at %d, %.6g below the reference's best at "
                          "%d" % (what, i_p, ds[i_r] - ds[i_p], i_r))
                continue
        elif not thr - BAND <= ds[i_p] < thr + BAND:
            nums.miss("%s row at %d (reference DS %.6g) has no trigger"
                      % (what, i_p, ds[i_p]))
            continue
        nums.worst("ds_gap", _abs(ds_p, ds[i_p]))
        nums.worst("stalta_gap", _rel(sl_p, sl[i_p]))
        mag_r, snr_r, pe_r = ref.magnitudes(det, ck.mp, i_p, cell.nc, issub)
        nums.worst("mag_gap", max(_abs(mag_p, mag_r), _abs(pe_p, pe_r)))
        nums.worst("snr_gap", _rel(snr_p, snr_r))
    for i in trig:
        if i not in used and ds[i] >= thr + BAND:
            nums.miss("%s reference trigger at %d (DS %.6g) has no row"
                      % (what, i, ds[i]))


def control_rows(det, ds, ck, cell, issub):
    """The rows the control writes: its own triggers and values."""
    thr = float(det["threshold"])
    out = []
    trig = ref.triggers(ds, thr, int(ref.BUFF_SECONDS * cell.sr))
    sl = ref.stalta(ds, cell.sr) if len(trig) else None
    for i in trig:
        mag, snr, pe = ref.magnitudes(det, ck.mp, int(i), cell.nc, issub)
        out.append((int(i), float(ds[i]), float(sl[i]), mag, snr, pe))
    return out


def hist_t(ds):
    """Histogram of DS rows [..., L] (torch) in the 400 bins on [0, 1],
    np.histogram's rule."""
    inner = torch.as_tensor(ref.HIST_EDGES[1:-1], device=ds.device,
                            dtype=ds.dtype)
    b = torch.bucketize(ds.reshape(-1), inner, right=True)
    return torch.bincount(b, minlength=400).cpu().numpy().astype(np.float64)


def compare(run, prog=None, control=False):
    """The numbers of the run (or, with ``control``, of the control in the
    program's place) against the reference: {name: value}, notes."""
    cell = run.cell
    dev = run.device
    # {(sta, key): {call index: detector names}},
    # {(call index, sta): (keys, detector names)}
    row_units, hist_units = cell.win.plan(
        run, np.random.default_rng([int(run.seed) % (1 << 63), 7]))
    nums = Numbers()
    if control:
        prog = dict(rows={}, hists={}, samples={})
    banks = {}

    def bank_of(sta, kind, names, L):
        key = (sta, kind, tuple(names), L)
        if key not in banks:
            dets = [run.det(kind, nm, sta) for nm in names]
            if len(banks) > 3:
                banks.clear()
            banks[key] = ref.Bank([np.asarray(d["U"]) for d in dets], L, dev)
        return banks[key]

    ref_hist = {}
    host_hist = not run.cfg.get("device_prep")
    # the units that scan the same samples share one reference
    groups = {}
    for (sta, key), per_call in row_units.items():
        start, L, _ = cell.chunk(key)
        groups.setdefault((sta, start, L), []).append((key, per_call))
    for (sta, _, _), units in sorted(groups.items(), key=lambda kv: kv[0]):
        key0 = units[0][0]
        ck = Chunk(run, sta, key0, "float64")
        cc = Chunk(run, sta, key0, "bfloat16") if control else None
        by_kind = {}
        for key, per_call in units:
            for ci, names in per_call.items():
                kind = run.calls[ci]["kind"]
                by_kind.setdefault(kind, set()).update(names)
                if not control:
                    by_kind[kind].update(prog["rows"].get(
                        (ci, sta, cell.label(key)), {}))
        for kind, names in by_kind.items():
            names = sorted(names)
            bank = bank_of(sta, kind, names, len(ck.scan))
            x = torch.as_tensor(ck.scan, device=dev)[None]
            ds = ref.ds_rows(x, bank, cell.nc)[0]
            dsc = (ref.ds_rows(torch.as_tensor(cc.scan, device=dev)[None],
                               bank, cell.nc, "bfloat16")[0]
                   if control else None)
            issub = kind == "subspace"
            for si, name in enumerate(names):
                det = run.det(kind, name, sta)
                row = ds[si].cpu().numpy()
                if control:
                    crow = control_rows(det, dsc[si].cpu().numpy(), cc, cell,
                                        issub)
                h = hist_t(ds[si]) if host_hist else None
                hc = hist_t(dsc[si]) if host_hist and control else None
                for key, per_call in units:
                    lab = cell.label(key)
                    for ci in per_call:
                        if run.calls[ci]["kind"] != kind:
                            continue
                        if control:
                            got = crow
                        else:
                            got = prog["rows"].get((ci, sta, lab), {}).get(
                                name, [])
                        _compare_rows(nums, got, det, row, ck, cell, issub,
                                      "%s %s chunk %s" % (sta, name, key))
                        hk = (ci, sta, name)
                        if host_hist and (ci, sta) in hist_units and \
                                name in hist_units[(ci, sta)][1]:
                            ref_hist[hk] = ref_hist.get(hk, 0) + h
                            if control:
                                prog["hists"][hk] = \
                                    prog["hists"].get(hk, 0) + hc
    if not host_hist:
        _device_hists(run, hist_units, ref_hist, prog if control else None)
    for (ci, sta, name), h in ref_hist.items():
        p = prog["hists"].get((ci, sta, name))
        if p is None:
            nums.worst("hist_gap", float("inf"))
            continue
        nums.worst("hist_gap", np.abs(np.asarray(p) - h).sum() /
                   max(h.sum(), 1.0))
    if not control:
        _totals(run, prog, nums)
    for sta, key in run.captured:
        raw = cell.src.handed(run, sta, key)
        got = ref.rounded(raw, "bfloat16") if control else \
            prog["samples"][(sta, key)]
        if got.shape != raw.shape:
            nums.worst("samples_gap", float("inf"))
            continue
        nums.worst("samples_gap", float(np.abs(got - raw).max() /
                                        max(raw.std(), 1e-30)))
    return nums


def _device_hists(run, hist_units, ref_hist, control_prog):
    """Reference histograms of the checked detectors of a device-filtered
    cell over every chunk handed: the device filter's definition on the
    raw chunk, the DS, the 400 bins; a few chunks at a time on the
    reference's device."""
    cell = run.cell
    dev = run.device
    for (ci, sta), (keys, names) in hist_units.items():
        kind = run.calls[ci]["kind"]
        dets = [run.det(kind, nm, sta) for nm in names]
        rec = torch.tensor(run.station(sta).record, device=dev)
        L = cell.pad_c
        bank = ref.Bank([np.asarray(d["U"]) for d in dets], L * cell.nc, dev)
        acc = np.zeros((len(names), 400))
        accc = np.zeros((len(names), 400))
        for b0 in range(0, len(keys), 16):
            raws = []
            for key in keys[b0:b0 + 16]:
                start, Lk, _ = cell.chunk(key)
                raws.append(rec[:, start:start + min(Lk, L)])
            for prec, out in (("float64", acc), ("bfloat16", accc)):
                if prec == "bfloat16" and control_prog is None:
                    continue
                x = ref.device_prep(torch.stack(raws), cell.sr,
                                    run.cfg["filt"], dev, prec)
                ds = ref.ds_rows(ref.multiplex(x), bank, cell.nc, prec)
                for si in range(len(names)):
                    out[si] += hist_t(ds[:, si])
        for si, name in enumerate(names):
            ref_hist[(ci, sta, name)] = acc[si]
            if control_prog is not None:
                control_prog["hists"][(ci, sta, name)] = accc[si]


def _totals(run, prog, nums):
    """Every detector's histogram total against the DS samples the
    handed chunks hold."""
    cell = run.cell
    for ci, call in enumerate(run.calls):
        for sta, keys in call["handed"].items():
            want = sum(max(min(cell.chunk(k)[1], cell.pad_c) - cell.n_c + 1,
                           0) for k in keys)
            for d in run.dets_of(call["kind"], sta):
                h = prog["hists"].get((ci, sta, d["name"]))
                got = 0 if h is None else float(np.sum(h))
                nums.v["hist_count_miss"] += abs(got - want)
