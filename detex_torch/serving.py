"""
Deployment artifacts and the serving scan.

Namesake of detex_tpu/serving.py: ``export_detectors`` writes a
SubSpace's detectors as the plain ``.npz`` artifact detex_tpu's
export_detectors writes (per detector ``U__<station>__<name>`` [D, n]
float32, plus a JSON ``meta`` entry with each station's nc, sampling rate
and detectors, and the artifact's ``filt`` and ``decimate``), so either
package loads the other's; ``load_detectors`` reads it and builds banks on
the card unless ``device`` says otherwise; ``scan_station`` scans a
station's multiplexed chunks against them with trigger extraction on, and
``scan_station_raw`` its raw channel chunks with the device prep
(ops/prep.py) fused in front of the scan, both on one device or sharded
across a ``mesh`` (parallel/mesh.py); ``triggers_to_frame`` turns either's
triggers into detection rows of the ss_df schema.

    detex_torch.serving.export_detectors(ss, "detectors.npz")
    dep = detex_torch.serving.load_detectors("detectors.npz")
    out = detex_torch.serving.scan_station(dep, "TA.S00", chunk_matrix)
    out = detex_torch.serving.scan_station_raw(dep, "TA.S00", raw_chunks)
    rows = detex_torch.serving.triggers_to_frame(dep, "TA.S00", out, t0s)
"""
from __future__ import annotations

import json

import numpy as np

import torch

from detex_torch.ops import ds as _ds
from detex_torch.ops import prep as _prep
from detex_torch.parallel import scan as _scan


def export_detectors(ss, path="detectors.npz", useSingles=True):
    """Write every SVD-defined subspace (and every single template with
    its sample trims, with ``useSingles``) of SubSpace ``ss`` to one npz
    (detex_tpu serving.py:25-76): per detector U [D, n] float32 under
    ``U__<station>__<name>``, and a JSON ``meta`` with each station's nc,
    sampling rate and detectors (name, kind, threshold, offsets, mags,
    events) and the clusters' filt and decimate. Returns ``path``."""
    arrays = {}
    meta = {"stations": {}, "filt": list(ss.clusters.filt or []),
            "decimate": ss.clusters.decimate, "version": 1}
    for sta in ss.Stations:
        dets = []
        frames = []
        if sta in ss.ssStations:
            frames.append(("ss", ss.subspaces[sta]))
        if useSingles and sta in ss.singStations:
            frames.append(("sg", ss.singles[sta]))
        nc = sr = None
        for kind, rows in frames:
            for row in rows:
                if kind == "ss":
                    if not row["SVDdefined"]:
                        continue
                    U = np.array([row["SVD"][x] for x in row["UsedSVDKeys"]])
                else:
                    tr = row["SampleTrims"]
                    if not tr:
                        continue
                    mptd = list(row["MPtd"].values())[0]
                    upr = mptd[tr["Starttime"]:tr["Endtime"]]
                    U = np.array([upr / np.linalg.norm(upr)])
                stats0 = list(row["Stats"].values())[0]
                nc = stats0["Nc"]
                sr = stats0["sampling_rate"]
                arrays["U__%s__%s" % (sta, row["Name"])] = U.astype(
                    np.float32)
                dets.append(dict(
                    name=row["Name"], kind=kind,
                    threshold=float(row["Threshold"]),
                    offsets=[float(x) for x in np.atleast_1d(row["Offsets"])],
                    mags=[float(row["Stats"][e]["magnitude"])
                          for e in row["Events"]],
                    events=list(row["Events"])))
        if dets:
            meta["stations"][sta] = dict(nc=int(nc), sr=float(sr),
                                         detectors=dets)
    arrays["meta"] = np.array(json.dumps(meta))
    np.savez(path, **arrays)
    return path


def load_detectors(path, chunk_sec=3600.0, conBuff=120.0, *, device="cuda"):
    """Load an exported detector artifact and build per-station banks on
    ``device`` sized for ``chunk_sec + conBuff`` second chunks (build_bank's
    default: overlap-save banks, as detex_tpu builds them on its
    accelerator).

    Returns {station: {"banks": [bank, ...], "nc": int, "sr": float,
    "meta": {...}, ...}}; each bank carries "names" and "thresholds"."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        out = {}
        for sta, sm in meta["stations"].items():
            nc = sm["nc"]
            sr = sm["sr"]
            data_len = int((chunk_sec + conBuff) * sr * nc)
            by_n = {}
            for det in sm["detectors"]:
                U = z["U__%s__%s" % (sta, det["name"])]
                by_n.setdefault(U.shape[1], []).append((det, U))
            banks = []
            for n, items in sorted(by_n.items()):
                bank = _ds.build_bank([u for _, u in items], nc, data_len,
                                      device)
                bank["names"] = [d["name"] for d, _ in items]
                bank["thresholds"] = np.array(
                    [d["threshold"] for d, _ in items], np.float32)
                banks.append(bank)
            out[sta] = dict(banks=banks, nc=nc, sr=sr, meta=sm,
                            chunk_sec=chunk_sec, conBuff=conBuff,
                            filt=list(meta.get("filt") or []) or None,
                            dec=int(meta.get("decimate") or 1))
    return out


def scan_station(dep, sta, chunks, mesh=None, bins=None, buff_sec=20.0,
                 max_trig=64, valid_lens=None, calc_hist=True):
    """Scan a [B, Lc] matrix of multiplexed chunks for one station against
    all of its detector banks, triggers included.

    ``valid_lens`` ([B], optional) gives each chunk's true multiplexed
    sample count when rows are zero-padded; windows past it are masked out
    of histograms, maxima and triggers. Returns one dict per bank:
    {names, hist [S, nbins], maxds [B, S], trig_idx, trig_val, trig_count}
    as numpy arrays."""
    sd = dep[sta]
    nc, sr = sd["nc"], sd["sr"]
    buff = int(buff_sec * sr)
    results = []
    chunks = np.asarray(chunks, np.float32)
    if valid_lens is None:
        valid_lens = np.full(chunks.shape[0], chunks.shape[1], np.int64)
    else:
        valid_lens = np.asarray(valid_lens, np.int64)
    for bank in sd["banks"]:
        pad = bank["pad_len"]
        if chunks.shape[1] < pad:
            padded = np.zeros((chunks.shape[0], pad), np.float32)
            padded[:, :chunks.shape[1]] = chunks
        else:
            padded = chunks[:, :pad]
        vlens = np.minimum(valid_lens, pad)
        hist, maxds, ti, tv, tc = _scan.scan_chunks(
            padded, bank, bank["thresholds"], nc, buff, bins=bins,
            max_trig=max_trig, valid_lens=vlens, mesh=mesh,
            calc_hist=calc_hist)
        results.append(dict(names=bank["names"],
                            hist=hist.cpu().numpy(),
                            maxds=maxds.cpu().numpy(),
                            trig_idx=ti.cpu().numpy(),
                            trig_val=tv.cpu().numpy(),
                            trig_count=tc.cpu().numpy()))
    return results


def _bank_H(bank, nc, filt, dec, sr):
    """The device prep's filter response for ``bank``, cached on it: over
    dec * nfftp bins at the raw rate sr * dec, nfftp the bank's full-length
    FFT (recomputed by the demuxed-bank formula for an overlap-save bank);
    |H|^2 when filt[3] (zero phase), else the complex H; all ones without
    a filter (detex_tpu serving._bank_H)."""
    if "H" not in bank:
        if _ds.bank_kind(bank) == "os":
            nfftp = _ds.required_fft_len(bank["pad_len"] // nc, bank["n_c"])
        else:
            nfftp = bank["nfft2"]
        nbins = dec * nfftp
        dev = bank["sum_u"].device
        if filt:
            if filt[1] >= sr / 2.0 and dec > 1:
                raise ValueError(
                    "device decimation needs the bandpass high corner "
                    "below the decimated Nyquist (%.3g Hz)" % (sr / 2.0))
            bank["H"] = _prep.butter_response(filt, sr * dec, nbins,
                                              zerophase=bool(filt[3]),
                                              device=dev)
        else:
            bank["H"] = torch.ones(nbins // 2 + 1, dtype=torch.float32,
                                   device=dev)
    return bank["H"]


def scan_station_raw(dep, sta, chans, lens=None, mesh=None, bins=None,
                     buff_sec=20.0, max_trig=64, calc_hist=True):
    """Scan raw channel chunks [B, nc, L_raw] (unfiltered, at the raw rate
    sr * decimate) of one station against all of its banks: detrend,
    bandpass and decimation by the artifact's ``filt`` and ``decimate`` run
    on the device (scan_chunks_raw), then the scan.

    ``lens`` ([B], optional) gives each chunk's true raw per-channel
    sample count for zero-padded rows. Returns scan_station's per-bank
    dicts. Needs demuxed banks (template length a multiple of nc)."""
    sd = dep[sta]
    nc, sr = sd["nc"], sd["sr"]
    dec = int(sd.get("dec") or 1)
    buff = int(buff_sec * sr)
    chans = np.asarray(chans, np.float32)
    if chans.ndim != 3 or chans.shape[1] != nc:
        raise ValueError("chans must be [B, nc=%d, L_raw]" % nc)
    B, _, L_raw = chans.shape
    lens = np.full(B, L_raw, np.int64) if lens is None else np.asarray(
        lens, np.int64)
    results = []
    for bank in sd["banks"]:
        if not bank.get("demux"):
            raise ValueError("scan_station_raw needs demuxed banks "
                             "(template length divisible by nc)")
        Lp = (bank["pad_len"] // nc) * dec
        if L_raw < Lp:
            padded = np.zeros((B, nc, Lp), np.float32)
            padded[:, :, :L_raw] = chans
        else:
            padded = chans[:, :, :Lp]
        H = _bank_H(bank, nc, sd.get("filt"), dec, sr)
        hist, maxds, ti, tv, tc = _scan.scan_chunks_raw(
            padded, np.minimum(lens, Lp), H, bank, bank["thresholds"], nc,
            buff, bins=bins, max_trig=max_trig, dec=dec, mesh=mesh,
            calc_hist=calc_hist)
        results.append(dict(names=bank["names"],
                            hist=hist.cpu().numpy(),
                            maxds=maxds.cpu().numpy(),
                            trig_idx=ti.cpu().numpy(),
                            trig_val=tv.cpu().numpy(),
                            trig_count=tc.cpu().numpy()))
    return results


def triggers_to_frame(dep, sta, results, chunk_starts):
    """Detection rows of scan_station / scan_station_raw outputs in the
    ss_df schema (detex_tpu serving.triggers_to_frame, as plain dicts: the
    port has no pandas): one {DS, STMP, Name, Sta, MSTAMPmin, MSTAMPmax}
    per trigger, in bank, chunk, detector, trigger order.
    ``chunk_starts`` are the chunks' start times (POSIX seconds)."""
    sd = dep[sta]
    sr = sd["sr"]
    rows = []
    det_meta = {d["name"]: d for d in sd["meta"]["detectors"]}
    for res in results:
        for b, t0 in enumerate(np.asarray(chunk_starts, np.float64)):
            for s, name in enumerate(res["names"]):
                offs = det_meta[name]["offsets"]
                for k in range(int(res["trig_count"][b, s])):
                    times = int(res["trig_idx"][b, s, k]) / sr + t0
                    rows.append(dict(DS=float(res["trig_val"][b, s, k]),
                                     STMP=times, Name=name, Sta=sta,
                                     MSTAMPmin=times - max(offs),
                                     MSTAMPmax=times - min(offs)))
    return rows
