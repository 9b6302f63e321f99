"""
Continuous-data subspace detection engine.

Namesake of detex_tpu/detect.py (``_SSDetex``, reference detect.py:22-218),
on plain inputs instead of a SubSpace object: per station its channels,
sampling rate and detectors, and a callable giving its chunks as
(Stream, utc1, utc2). ``detex`` runs it and returns the DS histograms.

Per station the detectors are packed into banks by template length
(ops/ds.build_bank with the pad_rows / pad_dims ladders, overlap-save
banks) on the engine's device. Each chunk is filtered and multiplexed on
the host, or, with ``devicePrep``, only trimmed and detrended there and
filtered on the device (scan_chunks_raw), by construct.prepChunk: one
native pass (host_prep.cpp) where the chunk needs no merge, split or
decimation, else construct._applyFilter and multiplex, with the same bits
either way.
``batchSize`` chunks go through one summary-only scan per bank
(parallel/scan.scan_chunks, calc_triggers=False: histograms and maxima
only; the kernels fwd_prep_fold + spec_ds_fold, per block of 128 templates
past 128), sharded across every CUDA device of the host when there are
several (parallel/scan.engine_mesh; DETEX_TORCH_MESH=0 keeps one device),
dispatched asynchronously and materialized one batch later, so the host
prepares the next batch, or the next station, while the device scans.
The chunks are drawn on the engine's thread and prepared one batch ahead,
in draw order, on one worker thread a batched call (_prepWorker): the
prep of the next batch overlaps the dispatch of this one and the
materialize of the one before. Where the engine would wait for a chunk's
prep (the start of a station, a worker behind), it materializes the
batches in flight first, in their order.
Chunks whose maximum passes a detector's threshold (less a gate margin)
are re-verified densely on the engine's device
(ops/ds.run_bank_triggers_batch on the kept device batch, or on the chunks
uploaded again after a sharded scan: rfft_ct_fused, irfft_ct_fused,
ds_finalize_os_fold, then the STA/LTA and the exact trigger extraction on
the device), or in float64 on the host with dtype="double". Magnitudes are
estimated on the host in numpy, and rows are written to SQLite
(util.saveSQLite) in materialize order: station, batch, bank, triggered
chunk, template.

trigCon=1 (triggering on the STA/LTA of the DS), batchSize 1 and the
classify and UTC-save modes run the per-chunk (unbatched) path: one chunk
at a time through ops/ds.run_bank (rfft_ct_fused, irfft_ct_fused and
ds_finalize_os on the bank's overlap-save blocks) with host histograms.
The classify mode (``classifyEvents``) scans the template events
themselves, each cut at its tail by the template fetcher's buffer
(_conTrimSamps), and writes one row (Sta, Name, DS maximum, TimeStamp)
for every detector on every event to ``<eventCorFile>_<NET.STA>.pkl``
after each station; ``utcSaves`` keeps the multiplexed chunk and the DS
vector of every detector on every chunk spanning one of the given times
and writes them to ``UTCsaves.pkl`` once the run ends. Both tables are
lists of row dicts with detex_tpu's columns (util.readRows), written in
the working directory; detections land in SQLite in these modes too.

Every stage opens a span of detex_torch.trace (banks; fetch, prep (on the
prep worker on the batched path), prep.wait; dispatch > batch, upload,
scan; materialize > wait, gate, reverify, rows, hist) and counts chunks,
batches, re-verified chunks and rows, rows written, bytes copied each way,
chunks prepared in one native pass or not (prep.fused, prep.fallback) and
chunks whose prep had ended when the engine took them or not (prep.ahead,
prep.waited); README.md lists them.
"""
from __future__ import annotations

import itertools
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext

import numpy as np
import torch

import detex_torch
from detex_torch import host_prep as _host_prep
from detex_torch import native as _native
from detex_torch import trace as _trace
from detex_torch import util as _util
from detex_torch.construct import prepChunk
from detex_torch.core.utc import UTCDateTime
from detex_torch.ops import ds as _ds
from detex_torch.ops import prep as _prep
from detex_torch.ops import stalta as _stalta
from detex_torch.ops import triggers as _triggers
from detex_torch.parallel import scan as _pscan

MAX_TRIGGERS = 4096  # reference kill switch at 4000 (detect.py:433-436)

#: detection-row columns (reference _CreateCoeffArray's Sar frame)
SAR_COLS = ["DS", "DS_STALTA", "STMP", "Name", "Sta", "MSTAMPmin",
            "MSTAMPmax", "Mag", "SNR", "ProEnMag"]
#: columns of the classify mode's EventCors rows and of the UTC saves
EVENT_COR_COLS = ["Sta", "Name", "DS", "TimeStamp"]
UTC_SAVE_COLS = ["Station", "Name", "Threshold", "offset", "TS1", "TS2",
                 "utcSaves", "MPcon", "SSdetect"]

# device memory for the scan batches the engine keeps for the dense
# re-verify (up to two at once: in flight and materializing); a larger
# batch is not kept and its triggered chunks are uploaded again
KEEP_DEV_BATCH_BYTES = 2 << 30

# gate margins below a detector's threshold: chunks within them are
# re-verified, so a float32 maximum a hair under the threshold (~2e-5
# from the exact path over million-sample chunks), the float32 scan under
# dtype="double", or the spectral filter of devicePrep against the host
# SOS filter never drops a detection the exact path emits
GATE_EPS_SINGLE = 2e-5
GATE_EPS_DOUBLE = 1e-4
DEVICE_PREP_EPS = 0.005

# rows kept in memory before a flush to SQLite
FLUSH_ROWS = 500


def _prepWorker():
    """The one thread that prepares a batched call's chunks ahead of its
    engine thread; shut down when the call ends."""
    return ThreadPoolExecutor(max_workers=1, thread_name_prefix="detex-prep")


class _SSDetex(object):
    """Run subspace or single-template detections over every station's
    continuous chunks.

    ``stations``: {sta: {"channels": channel names (a list, or one list
    per event), "sr": sampling rate (or one per event), "nc" (optional,
    len(channels)), "detectors": [{"name", "U" [D, n], "WFs" [E, n],
    "mags" [E], "events" [E], "offsets", "threshold"}, ...]}}: the
    fields detex_tpu's _prepareDetectors reads off a SubSpace row; the
    classify mode's tail trim also reads a detector's "SampleTrims" and
    "waveforms" (its AlignedTD or MPtd) where it has them.
    ``chunks(sta)`` yields (Stream, utc1, utc2). ``dataLength`` is the
    chunk length in seconds (conDatDuration + conBuff, or the template
    fetcher's timeBeforeOrigin + timeAfterOrigin when classifying), and
    ``conBuff`` the buffer the classify mode's tail trim measures against.
    The histograms land in ``self.hist``: {"Bins": edges, sta: {name:
    counts}}."""

    def __init__(self, stations, chunks, subspaceDB, dataLength, filt=None,
                 decimate=None, issubspace=True, trigCon=0,
                 triggerLTATime=5, triggerSTATime=0, staltaThreshold=None,
                 calcHist=True, dtype="single", estimateMags=True,
                 fillZeros=False, batchSize=8, devicePrep=False,
                 classifyEvents=None, eventCorFile="EventCors",
                 utcSaves=None, conBuff=0.0, device="cuda"):
        if torch.device(device).type == "cuda":
            detex_torch.require_cuda()
        self.device = torch.device(device)
        self.staltaThreshold = staltaThreshold
        self.batchSize = int(batchSize)
        self.devicePrep = bool(devicePrep)
        self.dpDec = int(decimate or 1) if devicePrep else 1
        self.classify = classifyEvents is not None
        if self.devicePrep and (self.classify or utcSaves is not None or
                                self.batchSize <= 1 or trigCon != 0):
            detex_torch.log(__name__, "devicePrep requires the batched scan "
                            "path (trigCon=0, no classifyEvents/utcSaves, "
                            "batchSize > 1); falling back to host "
                            "preprocessing", level="warning")
            self.devicePrep = False
        self.filt = filt
        self.decimate = decimate
        self.dataLength = dataLength
        self.triggerLTATime = triggerLTATime
        self.triggerSTATime = triggerSTATime
        self.calcHist = calcHist
        self.dtype = dtype
        self.estimateMags = estimateMags
        self.fillZeros = fillZeros
        self.issubspace = issubspace
        self.trigCon = trigCon
        self.subspaceDB = subspaceDB
        self.chunks = chunks
        self.eventCorFile = eventCorFile
        self.conBuff = conBuff
        self.utcSaves = None
        if utcSaves is not None:
            try:
                ts = [UTCDateTime(x).timestamp for x in utcSaves]
            except (ValueError, TypeError):
                detex_torch.log(__name__, "utcSaves must be an iterable of "
                                "UTCDateTime-readable objects",
                                level="error")
            self.utcSaves = np.array(ts)
        self.UTCSaveList = []
        self.eventCorList = []

        self.hist = {}
        if calcHist:
            self.hist["Bins"] = np.linspace(0, 1, num=401)

        # in-flight device batches: dispatched asynchronously and
        # materialized one dispatch later, across station boundaries, so
        # the host prepares the next batch or station while the device
        # scans; materialized in order (FIFO), so the rows keep it
        self._inflight = deque()
        self._inflight_depth = 1
        # a batch's dispatch and materialize spans share its id
        self._batch_ids = itertools.count()

        for sta, station in stations.items():
            if len(station["detectors"]) > 0:
                self.hist[sta] = self._corStations(station, sta)
            if self.classify and self.eventCorList:
                _util.writeRows(self.eventCorList,
                                "%s_%s.pkl" % (self.eventCorFile, sta))
                self.eventCorList = []
        self._drainInflight()
        if self.UTCSaveList:
            _util.writeRows(self.UTCSaveList, "UTCsaves.pkl")

    # ------------------------------------------------------------------
    def _corStations(self, station, sta):
        """Prepare one station's banks and stream its data (reference
        detect.py:111-135)."""
        channels = _getChannels(station)
        samplingRates = _getSampleRates(station)
        if channels is None or samplingRates is None:
            return None
        if int(station.get("nc", len(channels))) != len(channels):
            detex_torch.log(__name__, "nc %s of %s does not match its %d "
                            "channels" % (station["nc"], sta, len(channels)),
                            level="error")
        dets = station["detectors"]
        threshold = {d["name"]: float(d["threshold"]) for d in dets}
        names = sorted(threshold)
        return self._corDat(threshold, sta, channels, names, dets,
                            samplingRates[0])

    def _prepareDetectors(self, dets, sta, channels, samplingRate):
        """Pack the detectors into banks by template length on the engine's
        device and gather the per-detector data of the magnitudes
        (reference _loadMPSubSpace, detect.py:319-388), with the terms of
        _estMag that depend on the detector alone. Returns (det, banks,
        devicePrep): whether this station's chunks are filtered on the
        device, each bank then also carrying the filter response H."""
        Nc = len(channels)
        ftype = np.float64 if self.dtype == "double" else np.float32
        det = {}
        for d in dets:
            U = np.asarray(d["U"])
            WFs = np.asarray(d["WFs"])
            mags = np.asarray(d["mags"])
            # WFU = WFs (U^T U), associated as (WFs U^T) U
            WFU = np.dot(np.dot(WFs, U.T), U)
            info = det[d["name"]] = dict(
                U=U, WFs=WFs, n=U.shape[1], mags=mags,
                events=list(d["events"]), offsets=d["offsets"], WFU=WFU)
            if self.issubspace:
                # the training events normalised for single-lag
                # correlations, in float64 on the dtype="double" path
                W = np.asarray(WFs, ftype)
                NT = (W - W.mean(axis=1, keepdims=True)) / \
                    (W.std(axis=1, keepdims=True) * W.shape[1])
                info.update(var_WFU=np.var(WFU, axis=1), NT=NT,
                            NT_sum=NT.sum(axis=1),
                            ewf_std=np.std(WFs, axis=1), touse=mags > -15)
            else:
                info.update(std_WFU0=np.std(WFU[0]),
                            WFU0_sq=np.dot(WFU[0], WFU[0]))
        banks = []
        devicePrep = self.devicePrep
        by_n = {}
        for name in sorted(det):
            by_n.setdefault(det[name]["n"], []).append(name)
        pad_len = int(self.dataLength * samplingRate * Nc)
        for n, names in sorted(by_n.items()):
            # pad rows are zero templates (DS 0) gated by +inf thresholds
            dmax = max(det[nm]["U"].shape[0] for nm in names)
            bank = _ds.build_bank([det[nm]["U"] for nm in names], Nc,
                                  pad_len, device=self.device,
                                  prefer_os=True,
                                  pad_S=_ds.pad_rows(len(names)),
                                  min_dmax=_ds.pad_dims(dmax))
            bank["names"] = names
            if devicePrep:
                devicePrep = self._bankFilter(bank, Nc, pad_len,
                                              samplingRate)
            banks.append(bank)
        return det, banks, devicePrep

    def _bankFilter(self, bank, Nc, pad_len, samplingRate):
        """devicePrep's filter response on ``bank`` (detect.py:250-287): at
        the raw rate over dec * nfftp bins, nfftp the demuxed bank's FFT
        length (recomputed for an overlap-save bank); ones without a
        filter. Returns False where devicePrep cannot run: the station
        then falls back to the host prep."""
        if not bank.get("demux"):
            detex_torch.log(__name__, "devicePrep requires template lengths "
                            "divisible by the channel count; falling back "
                            "to host prep", level="warning")
            return False
        dec = self.dpDec
        if bank.get("os"):
            nfftp = _ds.required_fft_len(pad_len // Nc, bank["n_c"])
        else:
            nfftp = bank["nfft2"]
        nbins = dec * nfftp
        if self.filt is None:
            bank["H"] = torch.ones(nbins // 2 + 1, dtype=torch.float32,
                                   device=self.device)
            return True
        if self.filt[1] >= samplingRate / 2.0 and dec > 1:
            detex_torch.log(__name__, "devicePrep decimation needs the "
                            "bandpass below the decimated Nyquist; falling "
                            "back to host prep", level="warning")
            return False
        bank["H"] = _prep.butter_response(self.filt, samplingRate * dec,
                                          nbins, zerophase=bool(self.filt[3]),
                                          device=self.device)
        return True

    def _corDat(self, threshold, sta, channels, names, dets, samplingRate):
        """Stream one station's chunks and detect (reference
        detect.py:137-218): the batched path, or one chunk at a time for
        trigCon=1, batchSize 1 and the classify and UTC-save modes."""
        tableName = "ss_df" if self.issubspace else "sg_df"
        histdic = ({na: np.zeros(len(self.hist["Bins"]) - 1) for na in names}
                   if self.calcHist else None)
        nc = len(channels)
        with _trace.span("banks"):
            det, banks, devicePrep = self._prepareDetectors(
                dets, sta, channels, samplingRate)
        datGen = iter(self.chunks(sta))
        if (self.batchSize > 1 and self.trigCon == 0 and not self.classify
                and self.utcSaves is None):
            return self._corDatBatched(threshold, sta, names, det, banks, nc,
                                       datGen, histdic, tableName, devicePrep)
        # trigCon=1 triggers on staltaThreshold, not the DS Threshold
        trigth = self._trigThresholds(threshold)
        tail_trim = self._conTrimSamps(dets, nc, samplingRate)
        rows, numdets = [], 0
        while True:
            with _trace.span("fetch"):
                item = next(datGen, None)
            if item is None:
                break
            st, utc1, utc2 = item
            if st is None or len(st) < 1:
                detex_torch.log(__name__, "could not get data on %s from %s "
                                "to %s" % (sta, utc1, utc2), level="warning")
                continue
            result = self._scanChunk(st, det, banks, nc, sta, utc1, utc2,
                                     tail_trim=tail_trim)
            if result is None:
                continue
            dsdict, MPcon, sr, tstamp = result
            for name, dsvec in dsdict.items():
                if self.calcHist:
                    hg, _ = np.histogram(dsvec, bins=self.hist["Bins"])
                    histdic[name] = histdic[name] + hg
                maxds = float(dsvec.max()) if len(dsvec) else 0.0
                stalta_vec = None
                if not self.fillZeros and self.triggerLTATime:
                    stalta_vec = self._dsStalta(
                        dsvec, self.triggerLTATime * sr,
                        self.triggerSTATime * sr)
                if self.utcSaves is not None:
                    self._makeUTCSaveDF(name, threshold, sta, det, MPcon,
                                        dsvec, sr, tstamp)
                if self.classify:
                    self.eventCorList.append(dict(zip(
                        EVENT_COR_COLS, [sta, name, maxds, tstamp])))
                if self.trigCon == 1:
                    trig_val = (float(np.nanmax(stalta_vec))
                                if stalta_vec is not None else 0.0)
                else:
                    trig_val = maxds
                if trig_val > trigth[name]:
                    with _trace.span("rows"):
                        rows.extend(self._checkedRows(self._createCoeffArray(
                            dsvec, stalta_vec, name, trigth, sta, det, MPcon,
                            nc, sr, tstamp), sta))
                        if len(rows) > FLUSH_ROWS:
                            self._saveRows(rows, tableName)
                            numdets += len(rows)
                            rows = []
        with _trace.span("rows"):
            self._saveRows(rows, tableName)
        detex_torch.log(__name__, "%s on %s completed, %d potential "
                        "detection(s) recorded"
                        % ("Subspaces" if self.issubspace else "Singletons",
                           sta, len(rows) + numdets))
        return histdic if self.calcHist else None

    def _corDatBatched(self, threshold, sta, names, det, banks, nc, datGen,
                       histdic, tableName, devicePrep):
        """The batched scan path (reference detect.py:386-552): chunks are
        filtered and multiplexed on the host (or, with devicePrep, only
        merged and trimmed), ``batchSize`` chunks ahead of the engine on
        the prep worker, stacked ``batchSize`` at a time and scanned
        summary-only per bank; a batch is materialized one dispatch later
        (_materializeOne). The station's context (its devicePrep, a bank's
        gate and histogram sums, the rows not yet flushed) rides with its
        batches, which may materialize during the next station's
        preparation."""
        pending = []  # _prepChunk's (x, sr, tstamp, st)
        thr64 = [np.asarray([threshold[nm] for nm in bank["names"]],
                            np.float64) for bank in banks]
        # the scan's thresholds, pad rows gated by +inf
        thresholds_by_bank = [
            np.pad(t, (0, int(bank["sum_u"].shape[0]) - len(t)),
                   constant_values=np.inf).astype(np.float32)
            for t, bank in zip(thr64, banks)]
        gate_eps = max(DEVICE_PREP_EPS if devicePrep else 0.0,
                       GATE_EPS_DOUBLE if self.dtype == "double"
                       else GATE_EPS_SINGLE)
        # the gate of a bank's real rows: threshold less margin in float64,
        # cast to the dtype in which a float32 maximum compares with a
        # Python float (float32 under NEP 50), so that maxds > gate is
        # maxds[bi, si] > threshold[name] - gate_eps row by row
        dt = np.result_type(np.float32(0.0), 0.0)
        bins = self.hist["Bins"] if self.calcHist else None
        ctx = dict(sta=sta, rows=[], numdets=0, histdic=histdic,
                   tableName=tableName, det=det, threshold=threshold, nc=nc,
                   devicePrep=devicePrep, open_batches=0, station_done=False,
                   keep_warned=False, banks=banks, thr64=thr64,
                   gate=[np.asarray(t - gate_eps, dt) for t in thr64],
                   hist=[np.zeros((len(t), len(bins) - 1))
                         if self.calcHist else None for t in thr64])
        # with several CUDA devices the batches are sharded across all of
        # them (the sharded scan uploads each shard to its device itself);
        # the re-verify stays on the engine's device
        mesh = _pscan.engine_mesh(self.device)

        def dispatch(batch):
            if not batch:
                return
            bid = next(self._batch_ids)
            with _trace.span("dispatch", batch=bid):
                outs = [self._dispatchBank(bank, th, batch, nc, devicePrep,
                                           bins, mesh, ctx)
                        for bank, th in zip(banks, thresholds_by_bank)]
            _trace.count("batches")
            ctx["open_batches"] += 1
            self._inflight.append((ctx, outs, list(batch), bid))
            while len(self._inflight) > self._inflight_depth:
                self._materializeOne()

        nmax = max(d["n"] for d in det.values())

        def prep(st):
            with _trace.span("prep"):
                return self._prepChunk(st, sta, nc, nmax, devicePrep)

        def resolve(fut):
            # the oldest chunk in draw order; a usable one joins the batch.
            # While its prep runs, the batches in flight (this station's or
            # the one before's) materialize rather than the engine waiting:
            # in the same order as after the next dispatch, so the rows are
            # the same
            while not fut.done() and self._inflight:
                self._materializeOne()
            if fut.done():
                _trace.count("prep.ahead")
                chunk = fut.result()
            else:
                _trace.count("prep.waited")
                with _trace.span("prep.wait"):
                    chunk = fut.result()
            if chunk is None:
                return
            _trace.count("chunks")
            pending.append(chunk)
            if len(pending) >= self.batchSize:
                dispatch(pending)
                pending.clear()

        # the chunks are drawn here, on the engine's thread, and prepared
        # one batch ahead on a worker thread (numpy and the native
        # libraries, which release the GIL; no torch call), so that the
        # prep of the next batch overlaps this batch's dispatch and the
        # previous batch's materialize; load the native libraries first,
        # so that their lazy loaders never run on two threads at once
        _native.available()
        _host_prep.available()
        ahead = deque()
        worker = _prepWorker()
        try:
            while True:
                with _trace.span("fetch"):
                    item = next(datGen, None)
                if item is None:
                    break
                st, utc1, utc2 = item
                if st is None or len(st) < 1:
                    detex_torch.log(__name__, "could not get data on %s from "
                                    "%s to %s" % (sta, utc1, utc2),
                                    level="warning")
                    continue
                ahead.append(worker.submit(prep, st))
                if len(ahead) > self.batchSize:
                    resolve(ahead.popleft())
            while ahead:
                resolve(ahead.popleft())
        finally:
            worker.shutdown(wait=True, cancel_futures=True)
        dispatch(pending)
        ctx["station_done"] = True
        if ctx["open_batches"] == 0:
            self._finalizeStation(ctx)
        # the batches still in flight materialize during the next
        # station's preparation or the final drain; histdic fills in place
        return histdic if self.calcHist else None

    def _prepChunk(self, st, sta, nc, nmax, devicePrep):
        """One chunk of the batched path as (x, sr, tstamp, st): ``x`` the
        filtered, multiplexed chunk, or with devicePrep the merged and
        trimmed channels stacked as float32 [nc, L] and ``st`` their
        Stream (else None); None for a chunk that cannot be used."""
        try:
            # devicePrep: trim and detrend only on the host; the bandpass
            # and the decimation run on the device
            prepped = prepChunk(
                st, nc, None if devicePrep else self.filt,
                None if devicePrep else self.decimate, self.dtype,
                fillZeros=self.fillZeros, mux=not devicePrep)
        except Exception:
            detex_torch.log(__name__, "failed to filter chunk on %s" % sta,
                            level="warning")
            return None
        if prepped is None:
            return None
        out, stats, conSt = prepped
        sr = stats.sampling_rate
        tstamp = stats.starttime.timestamp
        if devicePrep:
            sr = sr / self.dpDec  # DS runs at the decimated rate
            if (out.shape[1] // self.dpDec) * nc <= nmax:
                return None
            return out.astype(np.float32, copy=False), sr, tstamp, conSt
        if len(out) <= nmax:
            return None
        return out, sr, tstamp, None

    def _dispatchBank(self, bank, th, batch, nc, devicePrep, bins, mesh,
                      ctx):
        """Stack one batch for one bank, zero-padded to batchSize chunks
        (the padding chunks' valid length masks everything out), and start
        its summary-only scan: (bank, hist, maxds, the batch kept on the
        device or None, its valid lengths)."""
        pad = bank["pad_len"]
        X, lens = self._stackBatch(batch, nc, pad, devicePrep)
        if devicePrep:
            # on a mesh each shard opens its own "scan" span
            # (parallel/scan._run_shards)
            with _trace.span("scan") if mesh is None else nullcontext():
                hist, maxds, *_ = _pscan.scan_chunks_raw(
                    X, lens, bank["H"], bank, th, nc, buff_samps=1,
                    bins=bins, max_trig=1, dec=self.dpDec, mesh=mesh,
                    calc_hist=self.calcHist, calc_triggers=False)
            return bank, hist, maxds, None, None
        if mesh is not None:
            # no batch is kept on a mesh: triggered chunks upload again to
            # the engine's device for the re-verify
            hist, maxds, *_ = _pscan.scan_chunks(
                X, bank, th, nc, buff_samps=1, bins=bins, max_trig=1,
                valid_lens=lens, mesh=mesh, calc_hist=self.calcHist,
                calc_triggers=False)
            return bank, hist, maxds, None, None
        # the engine uploads the batch itself and keeps it until
        # materialize: the dense re-verify gathers its triggered chunks
        # from it instead of uploading them again
        Xin = _ds.to_device(X, self.device)
        with _trace.span("scan"):
            hist, maxds, *_ = _pscan.scan_chunks(
                Xin, bank, th, nc, buff_samps=1, bins=bins, max_trig=1,
                valid_lens=lens, calc_hist=self.calcHist,
                calc_triggers=False)
        if X.nbytes <= KEEP_DEV_BATCH_BYTES:
            return bank, hist, maxds, Xin, lens
        if not ctx["keep_warned"]:
            ctx["keep_warned"] = True
            detex_torch.log(__name__, "scan batch (%.0f MB) exceeds the "
                            "re-verify retention budget; triggered chunks "
                            "will upload again" % (X.nbytes / 1e6))
        return bank, hist, maxds, None, None

    def _stackBatch(self, batch, nc, pad, devicePrep):
        """One batch zero-padded to batchSize chunks for a bank of
        ``pad_len`` ``pad``: with devicePrep the channels (B, nc, Lp),
        else the multiplexed chunks (B, pad), as float32, and the valid
        lengths (0 for a padding chunk)."""
        B = self.batchSize
        with _trace.span("batch"):
            X = np.zeros((B, nc, (pad // nc) * self.dpDec) if devicePrep
                         else (B, pad), np.float32)
            lens = [0] * B
            for bi, (x, *_) in enumerate(batch):
                L = lens[bi] = min(x.shape[-1], X.shape[-1])
                X[bi, ..., :L] = x[..., :L]
        return X, lens

    def _materializeOne(self):
        """Materialize the oldest in-flight batch: gate on its maxima,
        re-verify the triggered chunks, accumulate the histograms and
        flush rows (reference detect.py:562-747)."""
        ctx, outs, batch, bid = self._inflight.popleft()
        with _trace.span("materialize", batch=bid):
            for k, out in enumerate(outs):
                self._materializeBank(ctx, k, batch, *out)
            if len(ctx["rows"]) > FLUSH_ROWS:
                with _trace.span("rows"):
                    self._saveRows(ctx["rows"], ctx["tableName"])
                ctx["numdets"] += len(ctx["rows"])
                ctx["rows"] = []
            ctx["open_batches"] -= 1
            if ctx["station_done"] and ctx["open_batches"] == 0:
                self._finalizeStation(ctx)

    def _materializeBank(self, ctx, k, batch, bank, hist_dev, maxds_dev, Xd,
                         xlens):
        """Bank ``k`` of a materializing batch: read its summaries back,
        gate, re-verify the triggered chunks (on the device, gathered from
        the kept batch ``Xd`` or uploaded again; in float64 on the host
        for dtype="double"), append their rows to ctx["rows"] and add its
        histograms to the station's."""
        sta = ctx["sta"]
        det = ctx["det"]
        nc = ctx["nc"]
        use_sl = bool(not self.fillZeros and self.triggerLTATime)
        hist = _ds.to_host(hist_dev)
        maxds = _ds.to_host(maxds_dev)
        S = len(bank["names"])
        with _trace.span("gate"):
            # triggered (chunk, row) pairs in row-major order
            mask = maxds[:len(batch), :S] > ctx["gate"][k]
            trig_bis = np.flatnonzero(mask.any(axis=1)).tolist()
            trig_rows = [np.flatnonzero(mask[bi]).tolist() for bi in trig_bis]
        if trig_bis:
            use_dev_trig = self.dtype != "double"
            _trace.count("chunks_gated", len(trig_bis))
            _trace.count("reverify_rows_gated", sum(map(len, trig_rows)))
            _trace.count("reverify_rows_computed",
                         len(trig_bis) * int(bank["sum_u"].shape[0])
                         if use_dev_trig else sum(map(len, trig_rows)))
            with _trace.span("reverify"):
                if ctx["devicePrep"]:
                    # the exact host filter, for the triggered chunks only
                    with _trace.span("reverify.filter"):
                        mpcons = [self._refilter(batch[bi][3], nc)
                                  for bi in trig_bis]
                else:
                    mpcons = [batch[bi][0] for bi in trig_bis]
                _pscan._note_route("dense-reverify-device" if use_dev_trig
                                   else "dense-reverify-host")
                if use_dev_trig:
                    thr_list = [ctx["thr64"][k][trig].tolist()
                                for trig in trig_rows]
                    srs = [batch[bi][1] for bi in trig_bis]
                    x_dev = lens_dev = None
                    if Xd is not None:
                        # the triggered chunks gathered from the kept batch
                        # (devicePrep keeps none: its rows are
                        # host-filtered)
                        x_dev = Xd[torch.as_tensor(trig_bis,
                                                   device=Xd.device)]
                        lens_dev = [xlens[bi] for bi in trig_bis]
                    trig_out = _ds.run_bank_triggers_batch(
                        mpcons, bank, nc, trig_rows, thr_list, srs,
                        self.triggerLTATime or 0.0,
                        self.triggerSTATime or 0.0, use_sl, MAX_TRIGGERS,
                        x_dev=x_dev, lens_dev=lens_dev)
            with _trace.span("rows"):
                for zi, (bi, trig, MPcon) in enumerate(
                        zip(trig_bis, trig_rows, mpcons)):
                    sr, tstamp = batch[bi][1:3]
                    for si in trig:
                        name = bank["names"][si]
                        if use_dev_trig:
                            idx, ds_at, sl_at = trig_out[zi][si]
                            if len(idx) >= MAX_TRIGGERS:
                                detex_torch.log(
                                    __name__, "over %d events found in "
                                    "single data block on %s for %s"
                                    % (MAX_TRIGGERS, sta, name),
                                    level="error")
                            rl = self._coeffRowList(idx, ds_at, sl_at, name,
                                                    sta, det, MPcon, nc, sr,
                                                    tstamp)
                        else:
                            rl = self._hostRows(MPcon, name,
                                                ctx["threshold"], sta, det,
                                                nc, sr, tstamp, use_sl)
                        ctx["rows"].extend(self._checkedRows(rl, sta))
        with _trace.span("hist"):
            if self.calcHist:
                ctx["hist"][k] += hist[:S]

    def _refilter(self, st, nc):
        """devicePrep's exact host filter of one triggered chunk, from the
        payload's detrended traces ``st`` (left as they are): detrended
        again in float64, band-passed and multiplexed."""
        return prepChunk(st.copy(), nc, self.filt, self.decimate, self.dtype,
                         fillZeros=self.fillZeros)[0]

    def _hostRows(self, MPcon, name, threshold, sta, det, nc, sr, tstamp,
                  use_sl):
        """The rows of detector ``name`` on one triggered chunk re-verified
        in float64 on the host (dtype="double")."""
        with _trace.span("reverify.host"):
            dsvec = _ds.ds_numpy(np.asarray(MPcon, np.float64),
                                 det[name]["U"], nc)
            if dsvec.max() > 1.1:
                dsvec = np.where(np.isfinite(dsvec), dsvec, 0.0)
            stalta_vec = None
            if use_sl:
                stalta_vec = self._dsStalta(dsvec, self.triggerLTATime * sr,
                                            self.triggerSTATime * sr)
        return self._createCoeffArray(dsvec, stalta_vec, name, threshold,
                                      sta, det, MPcon, nc, sr, tstamp)

    @staticmethod
    def _checkedRows(rows, sta):
        """The 300-row warning and the drop of rows with DS above 1.05
        (reference detect.py:362-371)."""
        if len(rows) > 300:
            detex_torch.log(__name__, "over 300 events found in single data "
                            "block on %s; perhaps minCoef is too low?" % sta,
                            level="warning")
        if any(r[0] > 1.05 for r in rows):
            detex_torch.log(__name__, "DS values above 1.05 found on %s, "
                            "removing" % sta, level="warning")
            rows = [r for r in rows if r[0] <= 1.05]
        return rows

    def _finalizeStation(self, ctx):
        """The last flush, the histograms and the completion log of one
        station, once all its batches have materialized."""
        with _trace.span("rows"):
            self._saveRows(ctx["rows"], ctx["tableName"])
        detex_torch.log(__name__, "%s on %s completed, %d potential "
                        "detection(s) recorded"
                        % ("Subspaces" if self.issubspace else "Singletons",
                           ctx["sta"], len(ctx["rows"]) + ctx["numdets"]))
        ctx["rows"] = []
        if self.calcHist:
            for bank, acc in zip(ctx["banks"], ctx["hist"]):
                for name, counts in zip(bank["names"], acc):
                    ctx["histdic"][name] = counts.copy()

    def _saveRows(self, rows, tableName):
        """Append detection rows to ``tableName`` (util.saveSQLite)."""
        with _trace.span("sqlite"):
            _util.saveSQLite(rows, self.subspaceDB, tableName, SAR_COLS)
        _trace.count("rows_written", len(rows))

    def _drainInflight(self):
        while self._inflight:
            self._materializeOne()

    def _conTrimSamps(self, dets, nc, sr):
        """The classify mode's tail trim in multiplexed samples (detex_tpu
        detect.py:765-790, reference _getConTrims): each event chunk loses
        median(template duration) - conBuff seconds at its end when that is
        positive, so energy past the template span in the trailing buffer
        is not classified. A detector's duration is its SampleTrims
        window, or its shortest waveform, or its template length. The
        reference's slice was a no-op; this is the trim it meant, as
        detex_tpu applies it. Continuous chunks are never trimmed."""
        if not self.classify:
            return 0
        ctrims = []
        for d in dets:
            trims = d.get("SampleTrims") or {}
            wfs = d.get("waveforms")
            if "Starttime" in trims and "Endtime" in trims:
                n = trims["Endtime"] - trims["Starttime"]
            elif wfs:
                n = min(len(w) for w in wfs.values())
            else:
                n = np.asarray(d["U"]).shape[1]
            ctrims.append(self.conBuff - n / (sr * nc))
        ctrim = float(np.median(ctrims)) if ctrims else 0.0
        return int(-ctrim * sr * nc) if ctrim < 0 else 0

    def _makeUTCSaveDF(self, name, threshold, sta, det, MPcon, dsvec, sr,
                       tstamp):
        """Keep the chunk and the DS vector of detector ``name`` when the
        chunk spans one of the requested times (reference
        detect.py:298-316)."""
        TS1 = tstamp
        TS2 = tstamp + len(dsvec) / sr
        inUTCs = (self.utcSaves > TS1) & (self.utcSaves < TS2)
        if np.any(inUTCs):
            self.UTCSaveList.append(dict(zip(UTC_SAVE_COLS, [
                sta, name, threshold[name], det[name]["offsets"], TS1, TS2,
                self.utcSaves[inUTCs], MPcon, dsvec])))

    def _scanChunk(self, st, det, banks, nc, sta, utc1, utc2, tail_trim=0):
        """Filter, multiplex (cut ``tail_trim`` samples at the end) and
        run every bank on one chunk (reference _getRA,
        detect.py:220-296): ({name: DS vector}, MPcon, sr, tstamp), or
        None for a chunk that cannot be used."""
        with _trace.span("prep"):
            try:
                prepped = prepChunk(st, nc, self.filt, self.decimate,
                                    self.dtype, fillZeros=self.fillZeros)
            except Exception:
                detex_torch.log(__name__, "failed to filter chunk on %s, "
                                "skipping" % sta, level="warning")
                return None
            if prepped is None:
                return None
            MPcon, stats, _ = prepped
            sr = stats.sampling_rate
            tstamp = stats.starttime.timestamp
        if tail_trim > 0:
            MPcon = MPcon[:max(len(MPcon) - int(tail_trim), 0)]
        if len(MPcon) <= max(d["n"] for d in det.values()):
            detex_torch.log(__name__, "data block on %s from %s to %s is too "
                            "short, skipping" % (sta, utc1, utc2),
                            level="warning")
            return None
        _trace.count("chunks")
        with _trace.span("scan"):
            if self.dtype == "double":
                x64 = np.asarray(MPcon, np.float64)
                vec_of = {name: _ds.ds_numpy(x64, det[name]["U"], nc)
                          for name in det}
            else:
                vec_of = {}
                for bank in banks:
                    ds = _ds.run_bank(MPcon, bank, nc)
                    for i, name in enumerate(bank["names"]):
                        vec_of[name] = ds[i]
        dsdict = {}
        for name, vec in vec_of.items():
            if len(vec) < 10:
                detex_torch.log(__name__, "data block on %s too short, "
                                "skipping" % sta, level="warning")
                return None
            if vec.max() > 1.1:  # zero infs (reference detect.py:277-281)
                vec = np.where(np.isfinite(vec), vec, 0.0)
            dsdict[name] = vec
        return dsdict, MPcon, sr, tstamp

    def _dsStalta(self, dsvec, lta_samps, sta_samps):
        """STA/LTA of a DS row (numpy in, numpy out): on the engine's device
        in float32, in float64 on the host for dtype="double"."""
        if self.dtype == "double":
            return _stalta.ds_stalta_np(dsvec, lta_samps, sta_samps)
        c = torch.as_tensor(np.asarray(dsvec, np.float32), device=self.device)
        return _ds.to_host(_stalta.ds_stalta(c, lta_samps, sta_samps))

    def _trigThresholds(self, threshold):
        """Per-detector trigger thresholds: the DS thresholds for trigCon
        0; the user's staltaThreshold (a float, or a dict keyed by
        detector name) for trigCon 1."""
        if self.trigCon != 1:
            return threshold
        st = self.staltaThreshold
        if isinstance(st, dict):
            missing = sorted(set(threshold) - set(st))
            if missing:
                detex_torch.log(__name__, "staltaThreshold dict is missing "
                                "detectors: %s" % ", ".join(missing),
                                level="error")
            return {n: float(st[n]) for n in threshold}
        return {n: float(st) for n in threshold}

    def _createCoeffArray(self, dsvec, stalta_vec, name, threshold, sta, det,
                          MPcon, nc, sr, tstamp):
        """Triggers and magnitudes of one detector on one chunk (reference
        _CreateCoeffArray, detect.py:390-445): rows in SAR_COLS order.
        Triggers are extracted on the engine's device in float32, or in
        float64 on the host for dtype="double"."""
        ceval = dsvec if self.trigCon == 0 else stalta_vec
        buff_samps = int(20 * sr)  # reference buff = 20 s (detect.py:545)
        thr = float(threshold[name])
        if self.dtype == "double":
            idx = _triggers.extract_triggers_np(ceval, thr, buff_samps,
                                                max_triggers=MAX_TRIGGERS)
        else:
            c = torch.as_tensor(np.asarray(ceval, np.float32),
                                device=self.device)[None]
            idx, cnt = _triggers.extract_triggers(c, thr, buff_samps,
                                                  max_triggers=MAX_TRIGGERS)
            idx = _ds.to_host(idx[0, :int(cnt[0])])
        if len(idx) >= MAX_TRIGGERS:
            detex_torch.log(__name__, "over %d events found in single data "
                            "block on %s for %s" % (MAX_TRIGGERS, sta, name),
                            level="error")
        coefs = [float(dsvec[t]) for t in idx]
        slvals = (None if self.fillZeros or stalta_vec is None
                  else [float(stalta_vec[t]) for t in idx])
        return self._coeffRowList(idx, coefs, slvals, name, sta, det, MPcon,
                                  nc, sr, tstamp)

    def _coeffRowList(self, idx, coefs, slvals, name, sta, det, MPcon, nc,
                      sr, tstamp):
        """The detection rows (SAR_COLS) of trigger indices ``idx`` with
        their DS and STA/LTA values (tail of the reference's
        _CreateCoeffArray)."""
        rows = []
        info = det[name]
        minof = np.min(info["offsets"])
        maxof = np.max(info["offsets"])
        for k, trigIndex in enumerate(idx):
            coef = float(coefs[k])
            times = float(trigIndex) / sr + tstamp
            SLValue = 0.0 if slvals is None else float(slvals[k])
            if self.estimateMags:
                with _trace.span("mags"):
                    peMag, stMag, SNR = self._estMag(int(trigIndex), info,
                                                     MPcon, nc, coef, times,
                                                     name, sta)
            else:
                peMag, stMag, SNR = np.nan, np.nan, np.nan
            rows.append([coef, SLValue, times, name, sta, times - maxof,
                         times - minof, stMag, SNR, peMag])
        return rows

    def _estMag(self, trigIndex, info, MPcon, nc, coef, times, name, sta):
        """Projected-energy and std-ratio magnitudes, CC^2-weighted
        (reference _estMag detect.py:447-499, Chambers et al. 2015), and
        the SNR, on the host in numpy; the detector's own terms come from
        _prepareDetectors."""
        U = info["U"]
        mags = info["mags"]
        WFlen = info["WFU"].shape[1]
        ConDat = MPcon[trigIndex * nc: trigIndex * nc + WFlen]
        if len(ConDat) < WFlen:
            return np.nan, np.nan, np.nan
        if self.issubspace:
            # (U^T U) ConDat associated as U^T (U ConDat)
            ssCon = U.T @ (U @ ConDat)
            proEn = np.var(ssCon) / info["var_WFU"]
        # pre-event noise level for the SNR
        if trigIndex * nc > 5 * WFlen:
            pe = MPcon[trigIndex * nc - 5 * WFlen: trigIndex * nc]
        else:
            pe = MPcon[trigIndex * nc: trigIndex * nc + WFlen + 6 * WFlen]
        rollingstd = _native.rolling_std(pe, WFlen)
        baseNoise = np.median(rollingstd) if len(rollingstd) else np.nan
        SNR = np.std(ConDat) / baseNoise if baseNoise else np.nan
        if self.issubspace:
            touse = info["touse"]
            if not np.any(touse):
                detex_torch.log(__name__, "No magnitudes above -15 usable for "
                                "detection at %s on station %s and %s"
                                % (times, sta, name), level="warning")
                return np.nan, np.nan, SNR
            # single-lag normalized correlations with the training events,
            # in NT's dtype
            NT = info["NT"]
            cd = np.asarray(ConDat, NT.dtype)
            eventCors = (NT @ cd - info["NT_sum"] * cd.mean()) / cd.std()
            peMag = _estPEMag(mags, proEn, eventCors, touse)
            stMag = _estSTDMag(mags, ConDat, info["ewf_std"], eventCors,
                               touse)
        else:
            if np.isnan(mags[0]) or mags[0] < -15:
                return np.nan, np.nan, SNR
            peMag = mags[0] + np.dot(ConDat, info["WFU"][0]) / info["WFU0_sq"]
            stMag = mags[0] + np.log10(np.std(ConDat) / info["std_WFU0"])
        return peMag, stMag, SNR


def _getChannels(station):
    """The station's sorted channel list, or None (with a warning) when
    the per-event channel lists differ (reference detect.py:600-616)."""
    ch = station["channels"]
    lists = [list(v) for v in ch.values()] if isinstance(ch, dict) \
        else [list(ch)]
    chans = set(x for lst in lists for x in lst)
    if not all(chans == set(x) for x in lists):
        detex_torch.log(__name__, "Not all channels are the same for each "
                        "event, skipping", level="warning")
        return None
    return sorted(chans)


def _getSampleRates(station):
    """The station's sampling rate as a one-item list, or None (with a
    warning) when the per-event rates differ (reference
    detect.py:619-634)."""
    sr = station["sr"]
    srs = set(np.atleast_1d(np.asarray(sr, np.float64)).tolist())
    if len(srs) > 1:
        detex_torch.log(__name__, "Not all sample rates equal, skipping",
                        level="warning")
        return None
    return sorted(srs)


def _estPEMag(mags, proEn, eventCors, touse):
    """CC^2-weighted projected-energy magnitude, Chambers et al. 2015
    (reference detect.py:637-649): each usable training event estimates
    mag_i + log10(sqrt(proEn_i)), averaged with squared-correlation
    weights."""
    w = np.square(eventCors)[touse]
    est = mags[touse] + np.log10(np.sqrt(proEn[touse]))
    return float(np.sum(est * w) / np.sum(w))


def _estSTDMag(mags, ConDat, ewf_std, eventCors, touse):
    """CC^2-weighted std-ratio magnitude (reference detect.py:652-664), on
    the training events' standard deviations ``ewf_std``."""
    w = np.square(eventCors)[touse]
    est = mags[touse] + np.log10(np.std(ConDat) / ewf_std[touse])
    return float(np.sum(est * w) / np.sum(w))


def detex(stations, chunks, subspaceDB="SubSpace.db", conDatDuration=3600.0,
          conBuff=120.0, filt=None, decimate=None, issubspace=True,
          trigCon=0, triggerLTATime=5, triggerSTATime=0,
          staltaThreshold=None, calcHist=True, dtype="single",
          estimateMags=True, fillZeros=False, batchSize=8, devicePrep=False,
          classifyEvents=None, eventCorFile="EventCors", utcSaves=None,
          dataLength=None, device="cuda"):
    """Run the detection engine over every station's continuous chunks and
    append the detections to table ``ss_df`` (subspace detectors,
    ``issubspace``) or ``sg_df`` (single templates) of the SQLite
    database ``subspaceDB`` (the user's seam of detex_tpu's
    SubSpace.detex, subspace.py:996-1075).

    ``stations`` and ``chunks`` as _SSDetex takes them; the chunks are
    ``conDatDuration + conBuff`` seconds long. ``filt`` [freqmin,
    freqmax, corners, zerophase] and ``decimate`` are the templates'
    preprocessing. trigCon 0 triggers on the DS at each detector's
    threshold, 1 on the DS STA/LTA (windows ``triggerLTATime``,
    ``triggerSTATime`` seconds) at ``staltaThreshold`` (a float or a
    {name: float} dict). ``dtype`` "single" scans and re-verifies in
    float32 on the device, "double" re-verifies in float64 on the host.
    ``batchSize`` chunks are scanned per device call (1: one at a time);
    ``devicePrep`` filters raw chunks on the device. Runs on ``device``
    (the card unless "cpu" is asked for).

    ``classifyEvents`` (anything but None, as detex_tpu's template key is
    there) runs the classify
    mode: ``chunks(sta)`` yields the template events, ``dataLength``
    seconds long (default conDatDuration + conBuff), each cut at its end
    by the tail trim against ``conBuff``, and every detector's DS maximum
    on every event is a row of ``<eventCorFile>_<NET.STA>.pkl``.
    ``utcSaves`` (times UTCDateTime reads) keeps each chunk spanning one
    of them, with every detector's DS vector, in ``UTCsaves.pkl``. Both
    modes run the per-chunk path and still write their detections.

    Returns the DS histograms as SubSpace.histSubSpaces holds them:
    {"Bins": edges, sta: {name: counts}} (without ``calcHist``, {sta:
    None})."""
    if trigCon not in (0, 1):
        detex_torch.log(__name__, "trigCon must be 0 (DS) or 1 (STA/LTA of "
                        "DS)", level="error")
    if trigCon == 1 and fillZeros:
        detex_torch.log(__name__, "trigCon=1 needs the STA/LTA, which is "
                        "disabled by fillZeros", level="error")
    if trigCon == 1 and staltaThreshold is None:
        detex_torch.log(__name__, "trigCon=1 requires staltaThreshold (float "
                        "or {detector-name: float})", level="error")
    if dataLength is None:
        dataLength = conDatDuration + conBuff
    return _SSDetex(stations, chunks, subspaceDB, dataLength,
                    filt=filt, decimate=decimate, issubspace=issubspace,
                    trigCon=trigCon, triggerLTATime=triggerLTATime,
                    triggerSTATime=triggerSTATime,
                    staltaThreshold=staltaThreshold, calcHist=calcHist,
                    dtype=dtype, estimateMags=estimateMags,
                    fillZeros=fillZeros, batchSize=batchSize,
                    devicePrep=devicePrep, classifyEvents=classifyEvents,
                    eventCorFile=eventCorFile, utcSaves=utcSaves,
                    conBuff=conBuff, device=device).hist
