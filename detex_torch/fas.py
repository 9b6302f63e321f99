"""
False-alarm statistics: the empirical null of the detection statistic.

Namesake of detex_tpu/fas.py (reference detex/fas.py). Null chunks are
screened with a classic STA/LTA veto, scanned with the same bank forms and
kernels as detection (ops/ds.run_bank_batch: the unfused batch of
rfft_ct_fused, irfft_ct_fused and ds_finalize_os_fold, or per chunk with
ds_finalize_os above the inverse-block cap), histogrammed, and fit on the
host with a beta distribution (and a normal) whose inverse survival
function sets each detector's threshold at the configured Pf. The null
chunks come from a ``chunks(sta)`` callable; ``fetcher_chunks`` makes one
that draws them from a DataFetcher as detex_tpu's _collectChunks does.
"""
from __future__ import annotations

import numpy as np
import scipy.stats

import detex_torch
from detex_torch import construct as _construct
from detex_torch.core.utc import UTCDateTime
from detex_torch.ops import ds as _ds
from detex_torch.ops.stalta import classic_sta_lta

# null chunks per run_bank_batch call
FAS_BATCH = 8


def _initFAS(rows, conDatNum, cluster, chunks, conLen, LTATime=5,
             STATime=0.5, numBins=401, dtype="double", staltalimit=7.5,
             issubspace=True, reverseTemplates=False, device="cuda"):
    """Fit the DS null of each subspace (``issubspace``) or single row of
    one station's ``rows`` from ``conDatNum`` null chunks of
    ``chunks(sta)`` (reference fas.py:23-86). ``conLen`` is the chunks'
    length in seconds. Returns one dict per row: "bins", "hist",
    "betadist" (a, b, loc 0, scale 1), "nnlf" and "normdist" (mu, sigma).

    The chunks are collected once per (station, Nc, sr) and every detector
    of a template length is scanned as one bank on ``device`` (padded to
    the pad_rows / pad_dims ladders, overlap-save form), FAS_BATCH chunks
    a call; only the DS rows come back to the host, one batch at a time.
    ``reverseTemplates`` scans time-reversed bases instead (the Slinkard
    2014 reverse-template null of the reference's legacy matched-filter
    engine)."""
    results = [{} for _ in rows]
    histBins = np.linspace(-.01, 1, num=numBins)
    by_sta = {}
    for ind, row in enumerate(rows):
        results[ind]["bins"] = histBins
        U, Nc, sr = (_loadMPSubSpace(row) if issubspace
                     else _loadMPSingles(row))
        if reverseTemplates:
            U = np.ascontiguousarray(U[:, ::-1])
        by_sta.setdefault((row["Station"], int(Nc), float(sr)), []).append(
            (ind, row, U))
    for (sta, Nc, sr), ents in by_sta.items():
        filt, deci = cluster.filt, cluster.decimate
        accepted, count, scount = _collectChunks(
            chunks, sta, filt, deci, dtype, conDatNum, Nc, STATime, LTATime,
            staltalimit)
        if scount < conDatNum:
            detex_torch.log(__name__, "only %d of the requested %d null "
                            "chunks usable on %s (%d tried), using all "
                            "available" % (scount, conDatNum, sta, count),
                            level="warning")
        if float(scount) / max(count, 1) <= .25:
            detex_torch.log(__name__, "sta/lta req of %s failing on station "
                            "%s, dropping sta/lta requirement"
                            % (staltalimit, sta), level="warning")
            accepted, count, scount = _collectChunks(
                chunks, sta, filt, deci, dtype, conDatNum, Nc, STATime,
                LTATime, None)
        if len(accepted) == 0:
            detex_torch.log(__name__, "Could not calculate FAS for %s %s"
                            % (sta, ents[0][1]["Name"]), level="error")
        by_n = {}
        for ent in ents:
            by_n.setdefault(ent[2].shape[1], []).append(ent)
        for n, grp in sorted(by_n.items()):
            dmax = max(e[2].shape[0] for e in grp)
            bank = _ds.build_bank([e[2] for e in grp], Nc,
                                  int(conLen * sr * Nc), device=device,
                                  prefer_os=True,
                                  pad_S=_ds.pad_rows(len(grp)),
                                  min_dmax=_ds.pad_dims(dmax))
            dsmats = [[] for _ in grp]
            for s in range(0, len(accepted), FAS_BATCH):
                for out in _ds.run_bank_batch(accepted[s:s + FAS_BATCH],
                                              bank, Nc):
                    for gi in range(len(grp)):
                        dsmats[gi].append(out[gi])
            del bank
            for gi, (ind, row, U) in enumerate(grp):
                dss = np.concatenate(dsmats[gi]).astype(
                    np.float64 if dtype == "double" else np.float32)
                dsmats[gi] = None
                results[ind].update(_fit_null(dss, histBins))
    return results


def fetcher_chunks(fetcher, stakey, conDatNum, utcstart=None, utcend=None):
    """chunks(sta) drawing the null chunks of station "NET.STA" from a
    DataFetcher as detex_tpu does (reference fas.py:138-143): conDatNum * 4
    chunks at random (the fetcher's seeded draw) over the span of the
    first station key row of the station code, or [utcstart, utcend]."""
    def chunks(sta):
        skey = [r for r in stakey if r["STATION"] == sta.split(".")[1]]
        u1 = UTCDateTime(skey[0]["STARTTIME"] if utcstart is None
                         else utcstart)
        u2 = UTCDateTime(skey[0]["ENDTIME"] if utcend is None else utcend)
        for st in fetcher.getConData(skey, utcstart=u1, utcend=u2,
                                     randSamps=conDatNum * 4):
            yield st, None, None
    return chunks


def _fit_null(dss, histBins):
    """Histogram, beta fit (loc 0, scale 1, on DS clipped to
    [1e-12, 1 - 1e-12]) with its negative log-likelihood, and normal fit
    of one detector's null DS values."""
    clipped = np.clip(dss, 1e-12, 1 - 1e-12)
    betaparams = scipy.stats.beta.fit(clipped, floc=0, fscale=1)
    return {"hist": np.histogram(dss, bins=histBins)[0],
            "betadist": betaparams,
            "nnlf": scipy.stats.beta.nnlf(betaparams, clipped),
            "normdist": scipy.stats.norm.fit(dss)}


def _collectChunks(chunks, sta, filt, deci, dtype, conDatNum, Nc, STATime,
                   LTATime, limit):
    """Filter, STA/LTA-screen and multiplex the null chunks of station
    ``sta`` from a fresh ``chunks(sta)`` iterator until ``conDatNum`` pass
    (reference fas.py:89-117 without the per-detector DS, which the caller
    batches per station). Returns (accepted multiplexed chunks, chunks
    tried, chunks accepted)."""
    count = 0
    scount = 0
    accepted = []
    for st, _, _ in chunks(sta):
        if st is None or len(st) < 1:
            continue
        count += 1
        st = _construct._applyFilter(st, filt, deci, dtype)
        if st is None or len(st) < 1:
            continue
        if not _checkSTALTA(st, STATime, LTATime, limit):
            continue
        if scount >= conDatNum:
            break
        accepted.append(_construct.multiplex(st, Nc))
        scount += 1
    if count == 0:
        detex_torch.log(__name__, "Could not get any data for %s" % sta,
                        level="error")
    return accepted, count, scount


def _loadMPSubSpace(row):
    """The used left singular vectors U [D, n], channel count and sampling
    rate of a subspace row (reference fas.py:153-172)."""
    if not isinstance(row["UsedSVDKeys"], list):
        detex_torch.log(__name__, "SVD not defined, run SVD before FAS",
                        level="error")
    chans = list(row["Channels"].values())
    if not all(x == chans[0] for x in chans):
        detex_torch.log(__name__, "all events in subspace do not share "
                        "channels", level="error")
    U = np.array([row["SVD"][x] for x in row["UsedSVDKeys"]])
    sr = list(row["Stats"].values())[0]["sampling_rate"]
    return U, len(chans[0]), sr


def _loadMPSingles(row):
    """The normalized trimmed waveform [1, n], channel count and sampling
    rate of a single row (reference fas.py:137-150)."""
    stats = list(row["Stats"].values())[0]
    sts = row["SampleTrims"]["Starttime"]
    ste = row["SampleTrims"]["Endtime"]
    arr = np.array([w[sts:ste] for w in row["MPtd"].values()])
    U = np.array([x / np.linalg.norm(x) for x in arr])
    return U, stats["Nc"], stats["sampling_rate"]


def _checkSTALTA(st, STATime, LTATime, limit):
    """False for a chunk whose classic STA/LTA on the Z (or first)
    component exceeds ``limit``, a transient signal (reference
    fas.py:175-205); ``limit`` None accepts every chunk."""
    if limit is None:
        return True
    if len(st) < 1:
        return False
    stz = st.select(component="Z")
    tr = stz[0] if len(stz) > 0 else st[0]
    sr = tr.stats.sampling_rate
    cft = classic_sta_lta(tr.data, STATime * sr, LTATime * sr)
    if np.max(cft) <= limit:
        return True
    detex_torch.log(__name__, "%s fails sta/lta req of %s between %s and %s"
                    % (tr.stats.station, limit, tr.stats.starttime,
                       tr.stats.endtime), level="warning")
    return False
