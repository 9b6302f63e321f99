"""
Deployment artifacts and the serving scan.

Namesake of detex_tpu/serving.py: ``load_detectors`` reads the plain
``.npz`` detector artifact that ``detex_tpu.serving.export_detectors``
writes (per detector ``U__<station>__<name>`` [D, n] float32, plus a JSON
``meta`` entry with each station's nc, sampling rate and detectors) and
builds overlap-save banks on an explicit device; ``scan_station`` scans a
station's chunks against them with trigger extraction on.

    dep = detex_torch.serving.load_detectors("detectors.npz", device="cuda")
    out = detex_torch.serving.scan_station(dep, "TA.S00", chunk_matrix)
"""
from __future__ import annotations

import json

import numpy as np

from detex_torch.ops import ds as _ds
from detex_torch.parallel import scan as _scan


def load_detectors(path, chunk_sec=3600.0, conBuff=120.0, *, device):
    """Load an exported detector artifact and build per-station banks on
    ``device`` sized for ``chunk_sec + conBuff`` second chunks.

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
