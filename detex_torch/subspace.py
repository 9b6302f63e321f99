"""
Clustering and subspace containers: ClusterStream and Cluster (clustering
state) and SubSpace (subspace and single-template detectors: picks, SVD
and dimension selection, FAS thresholds, detection).

Namesake of detex_tpu/subspace.py (reference detex/subspace.py) on plain
rows: each station of a SubSpace holds a list of row dicts with
detex_tpu's column names (Name, Station, Events, Stats, Channels,
AlignedTD or MPtd, SampleTrims, SVD, UsedSVDKeys, FracEnergy, NumBasis,
Offsets, FAS, Threshold). The SVD runs in ops/svd.py (float64 on the host
for dtype "double", float32 on the card for "single"), thresholds come from
the empirical null of fas.py (beta fit with scipy on the host), and
detection is the engine of detect.py. FAS's null chunks and detection's
continuous chunks come from the SubSpace's fetcher (``cfetcher``, the
'dir' DataFetcher of data/fetcher.py) as detex_tpu draws them, or from a
``chunks(sta)`` callable the caller passes; the classify mode of detection
reads the template events through the cluster's fetcher.

``ClusterStream.write``, ``Cluster.write`` and ``SubSpace.write`` pickle
the port's objects (util.py: no tensor and no caller's callable in the
state, loaded back by util.loadClusters / loadSubSpace through a
restricted unpickler); ``ClusterStream.writeSimpleHypoDDInput`` writes
hypoDD's dt.cc. Trims come from a pick file (``attachPickTimes``), from
picks made by hand (``pickTimes``, streamPick.py) or from the STA/LTA of
the aligned waveforms (``autoPickTimes``). The plots and printers
(``dendro``, ``simMatrix``, ``plotEvents``, ``plotThresholds``, ...)
import matplotlib when they are called; nothing else here needs it.
"""
from __future__ import annotations

import json
import numbers
import os
from functools import partial

import numpy as np
import scipy.stats
from scipy.cluster.hierarchy import fcluster

import detex_torch
from detex_torch import detect as _detect
from detex_torch import fas as _fas
from detex_torch import stats as _stats
from detex_torch import util as _util
from detex_torch.data import keys as _keys
from detex_torch.ops import svd as _svd
from detex_torch.ops import xcorr as _xcorr

# Trim windows are rounded up to a multiple of TRIM_QUANTUM per-channel
# samples, so that detectors whose pick-derived lengths differ by a few
# samples share one bank (the engine and FAS group detectors into banks by
# template length): detex_tpu's default quantum.
TRIM_QUANTUM = 64


def _quantize_trims(d1, Nc, max_len=None):
    """Round a SampleTrims window length up to a multiple of
    TRIM_QUANTUM * Nc multiplexed samples, in place. The window is
    extended forward into the aligned data; when that runs past
    ``max_len`` (the shortest event waveform) the start moves earlier
    instead, and when the quantized window cannot fit at all the length is
    rounded down (or left as it is below one quantum). Starttime stays
    channel-aligned and non-negative."""
    q = TRIM_QUANTUM * int(Nc)
    if q <= int(Nc) or "Starttime" not in d1 or "Endtime" not in d1:
        return d1
    s0, s1 = int(d1["Starttime"]), int(d1["Endtime"])
    ln = s1 - s0
    if ln <= 0:
        return d1
    lnq = -(-ln // q) * q
    if max_len is not None and s0 + lnq > int(max_len):
        s0n = int(max_len) - lnq
        s0n -= s0n % int(Nc)      # floor keeps s0n + lnq <= max_len
        if s0n >= 0:
            s0 = s0n
        elif ln // q > 0:         # cannot fit: shrink to the lower rung
            lnq = (ln // q) * q
        else:
            return d1
    d1["Starttime"], d1["Endtime"] = s0, s0 + lnq
    return d1


class ClusterStream(object):
    """Per-station Cluster objects, made by construct.createCluster
    (reference subspace.py:46-287). ``trdf`` holds the station rows
    (Station, Link, CCs, Lags, Subsamp, Events, Stats, MPtd, Channels),
    ``streams`` the raw template streams createSubSpace loads again;
    ``temkey``, ``stakey`` (key rows) and ``fetcher`` are those of a
    cluster made from key files, else None."""

    def __init__(self, trdf, templates, streams, eventList, ccReq, filt,
                 decimate, trim, eventsOnAllStations, enforceOrigin,
                 device, temkey=None, stakey=None, fetcher=None,
                 fileName=None):
        self.trdf = trdf
        self.temkey = temkey
        self.stakey = stakey
        self.fetcher = fetcher
        self.filename = fileName
        self.templates = templates
        self.streams = streams
        self.eventList = eventList
        self.ccReq = None  # can vary between stations
        self.filt = filt
        self.decimate = decimate
        self.trim = trim
        self.eventsOnAllStations = eventsOnAllStations
        self.enforceOrigin = enforceOrigin
        self.device = device
        self.stalist = [row["Station"] for row in trdf]
        self.stalist2 = [x.split(".")[1] for x in self.stalist]
        locations = _event_locations(temkey)
        self.clusters = [
            Cluster(row["Station"],
                    eventList if eventsOnAllStations else row["Events"],
                    row.get("Link"), ccReq, CCs=row.get("CCs"),
                    locations=locations)
            for row in trdf]

    def row(self, sta):
        """The station row of ``sta`` ("NET.STA")."""
        return self.trdf[self.stalist.index(sta)]

    def __getstate__(self):
        return _util.host_state(self.__dict__)

    def writeSimpleHypoDDInput(self, fileName="dt.cc", coef=1, minCC=.35):
        """Write hypoDD's cross-correlation file (dt.cc) from each
        station's upper-triangle CC, lag and subsample matrices (detex_tpu
        subspace.py:105-153, reference subspace.py:70-155): one "# n1 n2
        0.0" header per template pair (numbers from the template key's
        order, zero-padded), then a "STA lag CC**coef S" line for every
        station where the pair's CC reaches ``minCC``. Needs a cluster
        made from key files with enforceOrigin=True."""
        if not self.enforceOrigin:
            detex_torch.log(__name__, "Sample lags are not meaningful unless "
                            "origin times are enforced; re-run createCluster "
                            "with enforceOrigin=True", level="error")
        if self.temkey is None:
            detex_torch.log(__name__, "writeSimpleHypoDDInput numbers the "
                            "events by the template key: make the cluster "
                            "from key files", level="error")
        reqZeros = int(np.ceil(np.log10(max(len(self.temkey), 2))))
        fmt = "{:0%dd}" % reqZeros
        temnum = {r["NAME"]: num for num, r in enumerate(self.temkey)}
        obs = {}  # (num1, num2) -> [line, ...] in stalist order
        for sta in self.stalist:
            key = list(self[sta].key)
            row = self.row(sta)
            m = len(key)
            cc = np.asarray(row["CCs"], np.float64)
            lag = np.asarray(row["Lags"], np.float64)
            sub = np.asarray(row["Subsamp"], np.float64)
            sr = row["Stats"][key[0]]["sampling_rate"]
            Nc = row["Stats"][key[0]]["Nc"]
            iu, ju = np.triu_indices(m, k=1)
            vals = cc[iu, ju]
            good = np.isfinite(vals) & (vals >= minCC)
            secs = lag[iu, ju] / (sr * Nc) + sub[iu, ju]
            for i, j, c, lg in zip(iu[good], ju[good], vals[good],
                                   secs[good]):
                ni = temnum.get(key[i])
                nj = temnum.get(key[j])
                if ni is None or nj is None:
                    continue
                # the matrices run key[i] -> key[j]; the lag flips when the
                # template key orders the pair the other way
                pair, lg = ((ni, nj), lg) if ni < nj else ((nj, ni), -lg)
                obs.setdefault(pair, []).append(
                    "%s %0.4f %0.4f S" % (sta, lg, c ** coef))
        lines = []
        for (n1, n2) in sorted(obs):
            lines.append("# %s %s 0.0" % (fmt.format(n1), fmt.format(n2)))
            lines.extend(obs[(n1, n2)])
        with open(fileName, "w") as fil:
            fil.write("\n".join(lines) + ("\n" if lines else ""))

    def write(self):
        """Pickle this ClusterStream to ``self.filename`` (reference
        subspace.py:261-267); util.loadClusters reads it."""
        detex_torch.log(__name__, "writing ClusterStream instance as %s"
                        % self.filename)
        _util.saveObject(self, self.filename)

    def updateReqCC(self, reqCC):
        """Re-threshold clusters without recomputing correlations: a float
        for every station, a {station: float} dict or a list in station
        order (reference subspace.py:174-201)."""
        if isinstance(reqCC, float):
            if reqCC < 0 or reqCC > 1:
                detex_torch.log(__name__, "reqCC must be between 0 and 1",
                                level="error")
            for cl in self.clusters:
                cl.updateReqCC(reqCC)
        elif isinstance(reqCC, dict):
            for key, val in reqCC.items():
                self[key].updateReqCC(val)
        elif isinstance(reqCC, (list, tuple)):
            for num, ccr in enumerate(reqCC):
                self[num].updateReqCC(ccr)

    def printAtr(self):
        for cl in self.clusters:
            cl.printAtr()

    def dendro(self, **kwargs):
        for cl in self.clusters:
            cl.dendro(**kwargs)

    def simMatrix(self, groupClusts=False, savename=False, returnMat=False,
                  **kwargs):
        return [cl.simMatrix(groupClusts, savename, returnMat, **kwargs)
                for cl in self.clusters]

    def plotEvents(self, projection=None, plotSingles=True, **kwargs):
        for cl in self.clusters:
            cl.plotEvents(projection, plotSingles, **kwargs)

    def __getitem__(self, key):
        if isinstance(key, int):
            return self.clusters[key]
        if isinstance(key, str):
            if len(key.split(".")) == 1:
                return self.clusters[self.stalist2.index(key)]
            if len(key.split(".")) == 2:
                return self.clusters[self.stalist.index(key)]
        detex_torch.log(__name__, "indexer must be an int, sta, or net.sta; "
                        "got %s" % key, level="error")

    def __len__(self):
        return len(self.clusters)

    def __repr__(self):
        return "ClusterStream with %d stations" % len(self.stalist)


def _event_locations(temkey):
    """{event: (LAT, LON)} of the first template-key row of each name
    (what the event map plots), empty without a key."""
    locs = {}
    for r in temkey or []:
        locs.setdefault(r["NAME"], (float(r["LAT"]), float(r["LON"])))
    return locs


class Cluster(object):
    """Per-station clustering state (reference subspace.py:290-712):
    ``link`` the scipy single-linkage tree over the events ``key``,
    ``clusts`` / ``singles`` at ``ccReq``; ``CCs`` the station's [m, m]
    correlation matrix over ``key`` (upper triangle) and ``locations``
    {event: (LAT, LON)} from the template key, for the plots."""

    nonClustColor = "0.6"   # the singles' color on the event map

    def __init__(self, station, eventList, link, ccReq, CCs=None,
                 locations=None):
        self.link = link
        self.station = station
        self.key = list(eventList)
        self.CCs = CCs
        self.locations = dict(locations or {})
        self.updateReqCC(ccReq)

    def updateReqCC(self, newccReq):
        """Re-form clusters at a new required CC without re-correlating
        (capability of reference subspace.py:305-346): the flat clusters at
        dissimilarity ``1 - ccReq`` from ``fcluster`` on the stored
        linkage, ordered by the height of their root merge, tallest first,
        then by first member, so detector numbering matches the
        reference's subset-cover walk over the link table."""
        if newccReq < 0. or newccReq > 1.:
            detex_torch.log(__name__, "Parameter ccReq must be between 0 "
                            "and 1", level="error")
        self.ccReq = newccReq
        height = 1. - newccReq
        labels = fcluster(self.link, height, criterion="distance")
        members = {}
        for leaf, lab in enumerate(labels):
            members.setdefault(int(lab), []).append(leaf)
        # root-merge height per flat cluster: linkage rows come in
        # non-decreasing height order, so the last sub-threshold merge seen
        # for a label is its root; one representative leaf per internal
        # node maps a merge row to its flat label
        n_leaf = len(self.key)
        rep = {}
        root_height = {}
        for i, row in enumerate(np.asarray(self.link)):
            a = int(row[0])
            ra = rep[a] if a >= n_leaf else a
            rep[n_leaf + i] = ra
            if row[2] <= height:
                root_height[int(labels[ra])] = float(row[2])
        grouped = sorted(
            (lab for lab, mem in members.items() if len(mem) > 1),
            key=lambda lab: (-root_height[lab], members[lab][0]))
        if not grouped:
            detex_torch.log(__name__, "No events cluster with corr coef = "
                            "%1.3f" % self.ccReq)
        self.clusts = [[self.key[i] for i in members[lab]]
                       for lab in grouped]
        self.singles = sorted(self.key[mem[0]]
                              for mem in members.values() if len(mem) == 1)
        self.clustcount = sum(len(c) for c in self.clusts)

    # -- plots ------------------------------------------------------------
    def dendro(self, hideEventLabels=True, show=True, saveName=False,
               **kwargs):
        """Dendrogram of the linkage (reference subspace.py:415-460),
        colored at 1 - ccReq; the figure, saved to ``saveName`` if
        given."""
        import matplotlib.pyplot as plt
        from scipy.cluster.hierarchy import dendrogram
        fig, ax = plt.subplots(figsize=(9, 5))
        labels = None if hideEventLabels else self.key
        dendrogram(self.link, color_threshold=1 - self.ccReq, labels=labels,
                   ax=ax, **kwargs)
        ax.set_ylabel("Dissimilarity (1 - CC)")
        ax.set_title("%s (ccReq=%.2f)" % (self.station, self.ccReq))
        if saveName:
            fig.savefig(saveName)
        if show:  # pragma: no cover - interactive
            plt.show()
        plt.close(fig)
        return fig

    def simMatrix(self, groupClusts=False, savename=False, returnMat=False,
                  show=False, **kwargs):
        """Image of the symmetric similarity matrix, events in key order or,
        with ``groupClusts``, cluster by cluster then the singles
        (reference subspace.py:628-688); the matrix with ``returnMat``."""
        import matplotlib.pyplot as plt
        m = len(self.key)
        cc = np.asarray(self.CCs, np.float64)
        full = np.where(np.isnan(cc), 0.0, cc)
        full = full + full.T + np.eye(m)
        order = np.arange(m)
        if groupClusts:
            order = np.asarray([self.key.index(e) for cl in self.clusts
                                for e in cl]
                               + [self.key.index(e) for e in self.singles])
        mat = full[np.ix_(order, order)]
        fig, ax = plt.subplots()
        im = ax.imshow(mat, vmin=0, vmax=1, interpolation="nearest")
        fig.colorbar(im, ax=ax, label="correlation coefficient")
        ax.set_title(self.station)
        if savename:
            fig.savefig(savename)
        if show:  # pragma: no cover
            plt.show()
        plt.close(fig)
        return mat if returnMat else None

    def plotEvents(self, projection=None, plotSingles=True, show=False,
                   **kwargs):
        """Longitude / latitude scatter of the events, colored by cluster,
        singles in grey (the reference's basemap plot without a map
        projection, subspace.py:462-626); events without a location are
        left out. Returns the figure."""
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots()
        groups = [("clust %d" % ci, cl, {}) for ci, cl in
                  enumerate(self.clusts)]
        if plotSingles:
            groups.append(("singles", self.singles,
                           dict(c=self.nonClustColor)))
        for label, evs, kw in groups:
            locs = [self.locations[e] for e in evs if e in self.locations]
            ax.scatter([x[1] for x in locs], [x[0] for x in locs],
                       label=label, **kw)
        ax.set_xlabel("Longitude")
        ax.set_ylabel("Latitude")
        ax.legend(fontsize=7)
        ax.set_title(self.station)
        if show:  # pragma: no cover
            plt.show()
        plt.close(fig)
        return fig

    def printAtr(self):
        print("%s had %d events and %d clusters with ccReq=%.3f"
              % (self.station, len(self.key), len(self.clusts), self.ccReq))

    def write(self):
        """Pickle this Cluster to clust.pkl, as detex_tpu's does
        (subspace.py:352-356)."""
        detex_torch.log(__name__, "writing cluster instance as clust.pkl")
        _util.saveObject(self, "clust.pkl")

    def __repr__(self):
        return ("Cluster(station=%s, %d events, %d clusters, %d singles)"
                % (self.station, len(self.key), len(self.clusts),
                   len(self.singles)))


def _read_picks(pksFile):
    """Phase picks as a list of {TimeStamp (float), Station, Event, Phase}
    dicts: ``pksFile`` a CSV path with those columns (read as pandas reads
    it, data/keys.read_csv), or the rows themselves."""
    if not isinstance(pksFile, (str, os.PathLike)):
        rows = [dict(r) for r in pksFile]
    else:
        try:
            rows = _keys.read_csv(pksFile)[1]
        except OSError:
            detex_torch.log(__name__, "%s does not exist or is not a csv "
                            "file" % pksFile, level="error")
    for r in rows:
        r["TimeStamp"] = float(r["TimeStamp"])
    return rows


def _fetcher_tem_chunks(fetcher, stakey, eveKey):
    """chunks(sta) of the classify mode from the cluster's fetcher: the
    template events of ``eveKey`` on the station key rows of the station
    code, with their times (detex_tpu detect.py:118-124, 303-306)."""
    def chunks(sta):
        skey = [r for r in stakey if r["STATION"] == sta.split(".")[1]]
        return fetcher.getTemData(eveKey, skey, returnName=False,
                                  returnTimes=True)
    return chunks


def _fetcher_con_chunks(fetcher, stakey, utcStart, utcEnd):
    """chunks(sta) of the engine from a fetcher: its continuous chunks of
    the station key rows of the station code, with their times (detex_tpu
    detect.py:304-309)."""
    def chunks(sta):
        skey = [r for r in stakey if r["STATION"] == sta.split(".")[1]]
        return fetcher.getConData(skey, utcstart=utcStart, utcend=utcEnd,
                                  returnTimes=True)
    return chunks


class SubSpace(object):
    """Per-station subspace and single rows: picks, SVD and dimension
    selection, thresholds, FAS and detection (reference
    subspace.py:715-2037). ``subspaces`` / ``singles`` map "NET.STA" to a
    list of row dicts. ``conDatDuration`` + ``conBuff`` seconds is the
    length of the continuous chunks FAS and detection scan, served by
    ``cfetcher`` (a DataFetcher, or None when the caller passes chunk
    callables); banks go on ``device``."""

    def __init__(self, singlesDict, subSpaceDict, cl, dtype, Pf,
                 conDatDuration, conBuff, device, cfetcher=None):
        self.clusters = cl
        self.cfetcher = cfetcher
        self.subspaces = subSpaceDict
        self.singles = singlesDict
        self.dtype = dtype
        self.Pf = Pf
        self.conDatDuration = conDatDuration
        self.conBuff = conBuff
        self.device = device
        self._fasChunks = None
        self.ssStations = sorted(self.subspaces.keys())
        self.singStations = sorted(self.singles.keys())
        self.Stations = sorted(set(self.ssStations) | set(self.singStations))

    # ------------------------------------------------------------------
    def validateClusters(self):
        """Drop aligned (and trimmed) waveforms that no longer reach the
        cluster's required CC with any later event of the cluster
        (reference subspace.py:738-773)."""
        for sta in list(self.subspaces.keys()):
            ccreq = self.clusters[sta].ccReq
            for row in self.subspaces[sta]:
                trims = row["SampleTrims"]
                if "Starttime" in trims and "Endtime" in trims:
                    start, stop = trims["Starttime"], trims["Endtime"]
                else:
                    start, stop = 0, -1
                for ev1num, ev1 in enumerate(list(row["Events"])[:-1]):
                    ccs = []
                    for ev2 in list(row["Events"])[ev1num + 1:]:
                        t = row["AlignedTD"][ev1][start:stop]
                        s = row["AlignedTD"][ev2][start:stop]
                        ccs.append(float(np.max(_xcorr.normcorr(
                            t, s, device=self.device))))
                    if len(ccs) > 0 and max(ccs) < ccreq:
                        detex_torch.log(__name__, "%s fails validation "
                                        "check or is ill-aligned on station "
                                        "%s, removing" % (ev1, row["Station"]))
                        row["Events"].remove(ev1)
                        row["AlignedTD"].pop(ev1, None)

    # ------------------------------------------------------------------
    def SVD(self, selectCriteria=2, selectValue=0.9, conDatNum=100,
            threshold=None, normalize=False, useSingles=True,
            validateWaveforms=True, backupThreshold=None, chunks=None,
            **kwargs):
        """SVD the aligned waveforms, select the dimension of
        representation and set the detection thresholds (reference
        subspace.py:786-912): selectCriteria 1 maximizes the probability
        of detection at Pf for a design SNR ``selectValue`` (stats.py), 2
        keeps the dimensions capturing ``selectValue`` of the average
        energy and sets thresholds from the empirical null, 3 as 2 with
        thresholds from the fractional energy, 4 a fixed basis count. A
        ``threshold`` > 0 is used as it is; otherwise the null comes from
        ``conDatNum`` chunks of ``chunks(sta)``, or of the fetcher (see
        getFAS)."""
        self._checkSelection(selectCriteria, selectValue, threshold)
        if validateWaveforms:
            self.validateClusters()
        for station in self.ssStations:
            for row in list(self.subspaces[station]):
                keys = sorted(row["Events"])
                arr, basisLength = self._trimGroups(row, keys, station)
                if basisLength == 0:
                    detex_torch.log(__name__, "subspace %s on %s is failing "
                                    "alignment and trimming, deleting it"
                                    % (row["Name"], station),
                                    level="warning")
                    self.subspaces[station].remove(row)
                    continue
                U, svals = _svd.svd_basis(arr, normalize=normalize,
                                          dtype=self.dtype,
                                          device=self.device)
                svdDict = {float(sv): U[:, i] for i, sv in enumerate(svals)}
                fracEnergy = self._getFracEnergy(row, U)
                usedBasis = self._getUsedBasis(svdDict, fracEnergy,
                                               selectCriteria, selectValue)
                row.update(SVD=svdDict, FracEnergy=fracEnergy,
                           UsedSVDKeys=usedBasis, SVDdefined=True,
                           NumBasis=len(usedBasis))
        if len(self.ssStations) > 0:
            self._setThresholds(selectCriteria, selectValue, conDatNum,
                                threshold, backupThreshold, chunks, kwargs)
        if len(self.singStations) > 0 and useSingles:
            self.setSinglesThresholds(conDatNum=conDatNum,
                                      threshold=threshold,
                                      backupThreshold=backupThreshold,
                                      chunks=chunks, **kwargs)

    def _trimGroups(self, row, keys, station):
        """Aligned, (pick-)trimmed and demeaned waveforms [events, n] for
        the SVD (reference subspace.py:921-943) and n."""
        trims = row["SampleTrims"]
        aliTD = row["AlignedTD"]
        if "Starttime" in trims and "Endtime" in trims:
            stim = max(trims["Starttime"], 0)
            etim = trims["Endtime"]
            arr = np.vstack([aliTD[x][stim:etim] -
                             np.mean(aliTD[x][stim:etim]) for x in keys])
        else:
            detex_torch.log(__name__, "No trim times for %s and station %s, "
                            "try running attachPickTimes"
                            % (row["Name"], station), level="warning")
            arr = np.vstack([aliTD[x] - np.mean(aliTD[x]) for x in keys])
        return arr, arr.shape[1]

    def _checkSelection(self, selectCriteria, selectValue, threshold):
        if selectCriteria == 1:
            if selectValue <= 0:
                detex_torch.log(__name__, "selectCriteria 1 maximizes "
                                "detection probability at the instance Pf; "
                                "selectValue is the design total signal "
                                "energy-to-noise ratio and must be > 0",
                                level="error", e=ValueError)
        elif selectCriteria in [2, 3]:
            if selectValue > 1 or selectValue < 0:
                detex_torch.log(__name__, "selectValue must be a float "
                                "between 0 and 1 for selectCriteria %d"
                                % selectCriteria, level="error",
                                e=ValueError)
        elif selectCriteria == 4:
            if selectValue < 0 or not isinstance(selectValue, int):
                detex_torch.log(__name__, "selectValue must be an int >= 0 "
                                "when selectCriteria==4", level="error",
                                e=ValueError)
        else:
            detex_torch.log(__name__, "selectCriteria of %s is not "
                            "supported" % selectCriteria, level="error")
        if threshold is not None:
            if not isinstance(threshold, numbers.Number) or threshold < 0:
                detex_torch.log(__name__, "threshold must be None or a "
                                "positive float", level="error",
                                e=ValueError)

    def _getFracEnergy(self, row, U):
        """Cumulative energy capture per dimension of each event, and
        their "Average" and "Minimum" (reference subspace.py:968-997)."""
        keys = list(row["Events"])
        trims = row["SampleTrims"]
        wfs = []
        for key in keys:
            aliwf = row["AlignedTD"][key]
            if "Starttime" in trims and "Endtime" in trims:
                aliwf = aliwf[trims["Starttime"]:trims["Endtime"]]
            wfs.append(aliwf)
        cum = _svd.frac_energy(U, np.vstack(wfs), dtype=self.dtype,
                               device=self.device)
        fracDict = {key: cum[i] for i, key in enumerate(keys)}
        fracDict["Average"] = np.average(cum, axis=0)
        fracDict["Minimum"] = np.min(cum, axis=0)
        return fracDict

    def _getUsedBasis(self, svdDict, cumFracEnergy, selectCriteria,
                      selectValue):
        """The singular-value keys of the basis vectors used as the
        detector (reference subspace.py:999-1013; selectCriteria 1 from
        stats.dim_of_max_pd)."""
        keys = sorted(svdDict.keys(), reverse=True)
        if selectCriteria == 1:
            avg = np.array(cumFracEnergy["Average"], dtype=float)
            N = len(next(iter(svdDict.values())))
            ndim, pds = _stats.dim_of_max_pd(avg, N, self.Pf,
                                             float(selectValue))
            detex_torch.log(__name__, "selectCriteria 1: %d dimension(s) "
                            "maximize P_D=%.4f at Pf=%.2e (design SNR %.1f)"
                            % (ndim, pds[ndim - 1], self.Pf, selectValue))
            return keys[:ndim]
        if selectCriteria in [2, 3]:
            avg = np.array(cumFracEnergy["Average"], dtype=float)
            avg[-1] = 1.00
            return keys[:int(np.argmax(avg >= selectValue))]
        if selectCriteria == 4:
            return keys[:selectValue + 1]

    def _threshold_from_fas(self, fas, sta, row, thresholdDist,
                            backupThreshold):
        """Threshold at Pf from a fitted null: the normal's isf, or the
        beta's, bisected on its log survival function when the isf comes
        out above 0.9 (scipy's extreme-tail trouble)."""
        if thresholdDist == "norm":
            mu, sigma = fas["normdist"]
            return float(scipy.stats.norm.isf(self.Pf, mu, sigma))
        beta_a, beta_b = fas["betadist"][0:2]
        th = scipy.stats.beta.isf(self.Pf, beta_a, beta_b, 0, 1)
        if th > .9:
            th, pft = self._approxThld(beta_a, beta_b, sta, row, self.Pf,
                                       backupThreshold)
            detex_torch.log(__name__, "beta.isf failed with pf=%e, "
                            "approximated threshold to %f (Pf=%e) for "
                            "station %s %s" % (self.Pf, th, pft, sta,
                                               row["Name"]),
                            level="warning")
        return th

    def _setThresholds(self, selectCriteria, selectValue, conDatNum,
                       threshold, backupThreshold, chunks, kwargs=None):
        """Subspace thresholds (reference subspace.py:1015-1054). kwargs
        may carry thresholdDist "beta" (default) or "norm"."""
        kwargs = dict(kwargs or {})
        thresholdDist = kwargs.pop("thresholdDist", "beta")
        if threshold is not None and threshold > 0:
            for station in self.ssStations:
                for row in self.subspaces[station]:
                    row["Threshold"] = threshold
            return
        if selectCriteria in [1, 2, 4]:
            self.getFAS(conDatNum, chunks=chunks, **kwargs)
            for station in self.ssStations:
                for row in self.subspaces[station]:
                    row["Threshold"] = self._threshold_from_fas(
                        row["FAS"], station, row, thresholdDist,
                        backupThreshold)
        elif selectCriteria == 3:
            for station in self.ssStations:
                for row in self.subspaces[station]:
                    row["Threshold"] = (row["FracEnergy"]["Minimum"]
                                        [row["NumBasis"]] * selectValue)

    def setSinglesThresholds(self, conDatNum=50, recalc=False,
                             threshold=None, backupThreshold=None,
                             chunks=None, **kwargs):
        """Thresholds of the single templates; singles without pick times
        are dropped and the rest renamed SG0.. (reference
        subspace.py:1056-1108)."""
        kwargs = dict(kwargs)
        thresholdDist = kwargs.pop("thresholdDist", "beta")
        for sta in self.singStations:
            sing = self.singles[sta]
            for k, row in enumerate(sing):
                row["Name"] = "SG%d" % k
            self.singles[sta] = [r for r in sing
                                 if len(r["SampleTrims"].keys()) > 0]
        if threshold is None:
            self.getFAS(conDatNum, chunks=chunks, useSingles=True,
                        useSubSpaces=False, recalc=recalc, **kwargs)
        for sta in self.singStations:
            for row in self.singles[sta]:
                if threshold:
                    row["Threshold"] = threshold
                else:
                    row["Threshold"] = self._threshold_from_fas(
                        row["FAS"][0], sta, row, thresholdDist,
                        backupThreshold)

    def _approxThld(self, beta_a, beta_b, sta, row, target,
                    backupThreshold=None):
        """Threshold where ``beta.isf`` misbehaves (scipy bug #4677 gives
        ~1 for extreme tail probabilities; the reference grid-searched,
        subspace.py:1110-1140): sf(x) = Pf solved by bisection on
        ``beta.logsf``, monotone and well-conditioned down to Pf ~ 1e-300.
        Falls back to ``backupThreshold`` (or raises) when the fitted null
        cannot reach the target inside (0, 1). Returns (threshold, its
        false-alarm probability)."""
        logsf = partial(scipy.stats.beta.logsf, a=beta_a, b=beta_b)
        logt = np.log(target)
        lo, hi = 0.0, 1.0
        if np.isfinite(logsf(x=0.5)) and logsf(x=lo) > logt:
            for _ in range(200):  # bisection to ~1e-60 interval width
                mid = 0.5 * (lo + hi)
                v = logsf(x=mid)
                if not np.isfinite(v) or v > logt:
                    lo = mid
                else:
                    hi = mid
                if hi - lo < 1e-12 * max(hi, 1e-12):
                    break
            th = 0.5 * (lo + hi)
            v = logsf(x=th)
            # only a genuine interior root (sf(th) within 2x of Pf); a
            # degenerate fit drives the bisection into the x=1 boundary
            if 0.0 < th < 1.0 and np.isfinite(v) and abs(v - logt) < 0.7:
                return th, float(np.exp(v))
        if backupThreshold is None:
            detex_torch.log(__name__, "Threshold root-find failing for %s "
                            "on %s, set it manually or use a "
                            "backupThreshold" % (sta, row["Name"]),
                            level="error", e=ValueError)
        detex_torch.log(__name__, "Threshold root-find failing for %s on "
                        "%s, using backup %.2f"
                        % (sta, row["Name"], backupThreshold),
                        level="warning")
        return backupThreshold, target

    # ------------------------------------------------------------------
    # Picks
    # ------------------------------------------------------------------
    def pickTimes(self, duration=30, traceLimit=15, repick=False,
                  subspaces=True, singles=True, pickerFactory=None):
        """Pick each unpicked subspace and single by hand and define its
        SampleTrims from the picks (reference subspace.py:1328-1416): the
        group's aligned waveforms open in ``pickerFactory(stream)``
        (default streamPick.streamPick, the matplotlib picker: q / a / w
        / s pick P / Pend / S / Send at the cursor, "v" goes on, escape
        stops with the progress kept); the earliest pick opens the
        window, ``duration`` seconds (or the latest pick) close it.
        ``pickerFactory`` may be any callable ``stream -> obj`` whose
        ``._picks`` and ``.KeepGoing`` the loop reads, so a script can
        pick without a window; attachPickTimes(pksFile) and
        autoPickTimes() need none."""
        if pickerFactory is None:
            from detex_torch.streamPick import streamPick as pickerFactory
        if subspaces:
            if self._pickTimes(self.subspaces, duration, traceLimit,
                               pickerFactory, repick=repick) is False:
                return
        if singles:
            self._pickTimes(self.singles, duration, traceLimit,
                            pickerFactory, repick=repick)

    def _pickTimes(self, trdfDict, duration, traceLimit, pickerFactory,
                   repick=False):
        """The picking loop over one {station: rows} dict; False when the
        user stopped it."""
        for sta in trdfDict:
            for row in trdfDict[sta]:
                if row["SampleTrims"] and not repick:
                    continue
                st = self._makeOpStream(row, traceLimit)
                pks = pickerFactory(st)
                d1 = {b.phase_hint: b.time.timestamp
                      for b in pks._picks if b}
                if d1:
                    eves, starttimes, Nc, Sr = self._getStats(row)
                    # the picked traces are the multiplexed waveforms at
                    # sr 1 from time 0: a pick's timestamp is its sample;
                    # the window opens at a channel-aligned sample
                    fp = int(min(d1.values()))
                    d1["Starttime"] = fp - fp % Nc
                    stime = d1["Starttime"]
                    if duration:
                        d1["Endtime"] = stime + int(duration * Sr * Nc)
                        d1["DurationSeconds"] = duration
                    else:
                        etime = int(max(d1.values()))
                        d1["Endtime"] = etime
                        d1["DurationSeconds"] = (etime - stime) / (Sr * Nc)
                    wfs = self._waveforms(row)
                    _quantize_trims(d1, Nc,
                                    max_len=min(len(wfs[e]) for e in eves))
                    stime = d1["Starttime"]
                    row["SampleTrims"] = d1
                    stats = row["Stats"]
                    for event in eves:
                        stN = stats[event]["starttime"] + stime / (Nc * Sr)
                        stats[event]["starttime"] = stN
                        stats[event]["offset"] = (
                            stN - stats[event]["origintime"])
                if not pks.KeepGoing:
                    detex_torch.log(__name__, "aborting picking, progress "
                                    "saved")
                    return False
            self._updateOffsets()
        return True

    @staticmethod
    def _waveforms(row):
        """A row's {event: waveform}: the aligned ones of a subspace, the
        multiplexed one of a single."""
        wfs = row.get("AlignedTD")
        return wfs if isinstance(wfs, dict) else row["MPtd"]

    def _makeOpStream(self, row, traceLimit):
        """A group's waveforms as a Stream to pick: one trace per event
        (channel = event name, sampling rate 1 from time 0, so pick
        timestamps are multiplexed samples; reference
        subspace.py:1418-1441), at most ``traceLimit``."""
        from detex_torch.core.stream import Stream, Trace
        st = Stream()
        wfs = self._waveforms(row)
        for key in row["Events"][:traceLimit]:
            st += Trace(data=np.asarray(wfs[key]),
                        header=dict(channel=key,
                                    network=str(row.get("Name", "")),
                                    station=row["Station"]))
        return st

    def autoPickTimes(self, duration=30, staTime=0.5, ltaTime=5.0,
                      repick=False):
        """SampleTrims without picks (detex_tpu's extension): for each
        unpicked subspace and single, the classic STA/LTA
        (ops/stalta.classic_sta_lta) of the mean absolute aligned
        waveform; the window opens 0.5 s before its largest ratio,
        snapped to a channel, runs ``duration`` seconds and is quantized
        as attachPickTimes' windows are. Start times and offsets move
        with it."""
        from detex_torch.ops.stalta import classic_sta_lta
        for trdfDict in (self.subspaces, self.singles):
            for sta in trdfDict:
                for row in trdfDict[sta]:
                    if row["SampleTrims"] and not repick:
                        continue
                    eves, starttimes, Nc, Sr = self._getStats(row)
                    wfs = [self._waveforms(row)[e] for e in eves]
                    short = min(len(x) for x in wfs)
                    stack = np.mean(np.abs(np.vstack(
                        [w[:short] for w in wfs])), axis=0)
                    cft = classic_sta_lta(stack, staTime * Sr * Nc,
                                          ltaTime * Sr * Nc)
                    onset = int(np.argmax(cft)) if cft.max() > 0 else 0
                    start = max(onset - int(0.5 * Sr * Nc), 0)
                    start -= start % Nc
                    end = start + int(duration * Sr * Nc)
                    end -= end % Nc
                    end = min(end, short)
                    d1 = {"Starttime": int(start), "Endtime": int(end),
                          "DurationSeconds": duration}
                    _quantize_trims(d1, Nc, max_len=short)
                    start = d1["Starttime"]
                    row["SampleTrims"] = d1
                    for event in eves:
                        st = row["Stats"][event]
                        st["starttime"] = st["starttime"] + start / (Nc * Sr)
                        st["offset"] = st["starttime"] - st["origintime"]
        self._updateOffsets()

    def attachPickTimes(self, pksFile="PhasePicks.csv", function="median",
                        defaultDuration=30):
        """Attach phase picks (a CSV with columns TimeStamp, Station,
        Event, Phase, or a list of such rows) and define each row's
        SampleTrims (reference subspace.py:1461-1552). Rows that already
        have trims keep them."""
        pks = _read_picks(pksFile)
        funs = {"mean": np.mean, "max": np.max, "min": np.min,
                "median": np.median}
        if function not in funs:
            detex_torch.log(__name__, "function %s not supported; options: "
                            "mean, median, min, max" % function,
                            level="error")
        fun = funs[function]
        for cl in self.clusters.clusters:
            sta = cl.station
            for trdfDict in (self.singles, self.subspaces):
                if sta not in trdfDict:
                    continue
                for row in trdfDict[sta]:
                    if len(row["SampleTrims"].keys()) > 0:
                        continue
                    evs = set(row["Events"])
                    pk = [p for p in pks
                          if p["Event"] in evs and p["Station"] == sta]
                    eves, starttimes, Nc, Sr = self._getStats(row)
                    if len(pk) > 0:
                        trims = self._getSampTrim(eves, starttimes, Nc, Sr,
                                                  pk, defaultDuration, fun,
                                                  sta, row)
                        if isinstance(trims, dict):
                            row["SampleTrims"] = trims
                self._updateOffsets()

    def _getSampTrim(self, eves, starttimes, Nc, Sr, pk, defaultDuration,
                     fun, sta, row):
        """A group's sample trim from phase picks (capability of reference
        subspace.py:1554-1615): per event the earliest pick opens the
        window (clamped into the trace) and ``defaultDuration``, or the
        pick span, closes it; the group trim is ``fun`` over the per-event
        windows, snapped down to a channel-aligned multiplexed sample and
        quantized (_quantize_trims). None if any pick falls beyond its
        trace."""
        samps_per_sec = Nc * Sr
        waveforms = row.get("MPtd")
        if not isinstance(waveforms, dict):
            waveforms = row["AlignedTD"]
        first_pick, last_pick = {}, {}
        for p in pk:
            ev, t = p["Event"], p["TimeStamp"]
            first_pick[ev] = min(first_pick.get(ev, t), t)
            last_pick[ev] = max(last_pick.get(ev, t), t)
        stats = row["Stats"]
        windows = []  # (start_samp, stop_samp, duration_sec) per event
        for ev in eves:
            if ev not in first_pick:
                continue
            t_open = float(first_pick[ev])
            trace_t0 = starttimes[ev]
            open_samp = (t_open - trace_t0) * samps_per_sec
            wf = waveforms.get(ev)
            if wf is None:
                wf = row["AlignedTD"][ev]
            if open_samp > len(wf):
                detex_torch.log(__name__, "Start samples for %s on %s exceed "
                                "available data, skipping attaching pick"
                                % (ev, sta), level="warning")
                return None
            if open_samp < 0:
                detex_torch.log(__name__, "Start time in phase file < 0 for "
                                "event %s" % ev, level="warning")
                open_samp, t_open = 0.0, trace_t0
            t_close = (t_open + defaultDuration if defaultDuration
                       else float(last_pick[ev]))
            assert t_close > t_open and t_close > trace_t0
            windows.append((open_samp, (t_close - trace_t0) * samps_per_sec,
                            t_close - t_open))
            stats[ev]["Starttime"] = t_open
            stats[ev]["offset"] = t_open - stats[ev]["origintime"]
        if not windows:
            return None

        def snap(vals):  # channel-aligned multiplexed sample
            s = int(fun(vals))
            return s - s % Nc

        opens, closes, durations = zip(*windows)
        d1 = {"Starttime": snap(opens), "Endtime": snap(closes),
              "DurationSeconds": int(fun(durations))}
        wlens = [len(waveforms[ev]) for ev in eves if ev in waveforms]
        return _quantize_trims(d1, Nc, max_len=min(wlens) if wlens else None)

    def _getStats(self, row):
        """Events, per-event start times, channel count and sampling rate
        of a group, which must share the last two (capability of reference
        subspace.py:1617-1634)."""
        eves = list(row["Events"])
        rates = {float(np.round(row["Stats"][e]["sampling_rate"]))
                 for e in eves}
        if len(rates) != 1:
            detex_torch.log(__name__, "Events on %s have different sampling "
                            "rates" % row["Station"], level="error")
        chans = {row["Stats"][e]["Nc"] for e in eves}
        if len(chans) != 1:
            detex_torch.log(__name__, "Events on %s do not have the same "
                            "channels" % row["Station"], level="error")
        starttimes = {e: row["Stats"][e]["starttime"] for e in eves}
        return eves, starttimes, chans.pop(), rates.pop()

    def _updateOffsets(self):
        """Every row's robust [min, median, max] offset (capability of
        reference subspace.py:1443-1459)."""
        for trdfDict in (self.subspaces, self.singles):
            for sta in trdfDict:
                for row in trdfDict[sta]:
                    offs = np.array([s["offset"]
                                     for s in row["Stats"].values()], float)
                    row["Offsets"] = self._getOffsets(offs)

    def _getOffsets(self, offsets, m=25.):
        """[min, median, max] of the offsets after dropping those more
        than ``m`` median absolute deviations out (capability of reference
        subspace.py:1636-1650)."""
        if len(offsets) > 1:
            dev = np.abs(offsets - np.median(offsets))
            mad = np.median(dev)
            if mad:
                offsets = offsets[dev / mad < m]
        return [np.min(offsets), np.median(offsets), np.max(offsets)]

    # ------------------------------------------------------------------
    def getFAS(self, conDatNum, LTATime=5, STATime=0.5, staltalimit=8.0,
               useSubSpaces=True, useSingles=False, numBins=401,
               recalc=False, chunks=None, **kwargs):
        """Estimate the empirical null (false-alarm statistics) of each
        subspace and single (reference subspace.py:1652-1743) from
        ``conDatNum`` null chunks of ``chunks(sta)``: a callable that
        returns, on every call, a fresh iterator of candidate chunks
        (Stream, utc1, utc2) of station "NET.STA", conDatDuration +
        conBuff seconds long. Without ``chunks`` the last callable given
        is used, and without one the SubSpace's fetcher draws them as
        detex_tpu's does: conDatNum * 4 chunks at random over the station
        key's span (fas.fetcher_chunks)."""
        chunks = chunks or self._fasChunks
        self._fasChunks = chunks
        if chunks is None and self.cfetcher is not None:
            chunks = _fas.fetcher_chunks(self.cfetcher, self.clusters.stakey,
                                         conDatNum)
        fas_kw = dict(LTATime=LTATime, STATime=STATime,
                      staltalimit=staltalimit, numBins=numBins,
                      dtype=self.dtype, device=self.device)
        conLen = self.conDatDuration + self.conBuff
        if useSubSpaces:
            self._updateOffsets()
            for sta in self.subspaces:
                rows = self.subspaces[sta]
                if not rows:
                    continue
                if isinstance(rows[0]["FAS"], dict) and not recalc:
                    detex_torch.log(__name__, "FAS for station %s already "
                                    "calculated; pass recalc=True to redo"
                                    % sta)
                    continue
                res = _fas._initFAS(rows, conDatNum, self.clusters,
                                    self._need_chunks(chunks), conLen,
                                    **fas_kw)
                for row, r in zip(rows, res):
                    row["FAS"] = r
        if useSingles:
            for sta in self.singles:
                # the station's singles in ONE _initFAS call: its null
                # chunks are collected once and scanned as one bank
                todo = [r for r in self.singles[sta]
                        if not (isinstance(r["FAS"], list) and not recalc)
                        and len(r["SampleTrims"]) >= 1]
                if not todo:
                    continue
                res = _fas._initFAS(todo, conDatNum, self.clusters,
                                    self._need_chunks(chunks), conLen,
                                    issubspace=False, **fas_kw)
                for row, r in zip(todo, res):
                    row["FAS"] = [r]

    @staticmethod
    def _need_chunks(chunks):
        if chunks is None:
            detex_torch.log(__name__, "FAS needs null chunks: pass "
                            "chunks=callable(sta), a conDatFetcher to "
                            "createSubSpace, or a threshold",
                            level="error", e=ValueError)
        return chunks

    # ------------------------------------------------------------------
    def _stations(self, issubspace):
        """The engine's plain station inputs from this SubSpace's rows
        (what detex_tpu's _prepareDetectors reads off its frames)."""
        out = {}
        frames = self.subspaces if issubspace else self.singles
        for sta, rows in frames.items():
            dets = []
            for row in rows:
                events = list(row["Events"])
                tr = row["SampleTrims"]
                if issubspace:
                    U = np.array([row["SVD"][x] for x in row["UsedSVDKeys"]])
                    WFs = np.array([row["AlignedTD"][x][tr["Starttime"]:
                                                        tr["Endtime"]]
                                    if "Starttime" in tr
                                    else row["AlignedTD"][x]
                                    for x in events])
                else:
                    mptd = list(row["MPtd"].values())[0]
                    upr = mptd[tr["Starttime"]:tr["Endtime"]] if tr else mptd
                    U = np.array([upr / np.linalg.norm(upr)])
                    WFs = np.array([upr])
                wfs = row.get("AlignedTD")
                dets.append(dict(
                    name=row["Name"], U=U, WFs=WFs, events=events,
                    mags=[row["Stats"][x]["magnitude"] for x in events],
                    offsets=row["Offsets"], threshold=row["Threshold"],
                    SampleTrims=tr, waveforms=wfs if isinstance(wfs, dict)
                    else row.get("MPtd")))
            if not dets:
                continue
            row = rows[0]
            out[sta] = dict(channels=dict(row["Channels"]),
                            sr=[row["Stats"][x]["sampling_rate"]
                                for x in row["Events"]],
                            detectors=dets)
        return out

    def detex(self, utcStart=None, utcEnd=None, subspaceDB="SubSpace.db",
              trigCon=0, triggerLTATime=5, triggerSTATime=0,
              multiprocess=False, delOldCorrs=True, calcHist=True,
              useSubSpaces=True, useSingles=False, estimateMags=True,
              classifyEvents=None, eventCorFile="EventCors", utcSaves=None,
              fillZeros=False, batchSize=32, devicePrep=False,
              staltaThreshold=None, chunks=None):
        """Run the detectors over continuous data with the engine
        (detect.detex) and write the detections, filter parameters,
        detector info and DS histograms to the SQLite database
        ``subspaceDB`` with the reference schema (reference
        subspace.py:1745-1902). The continuous chunks (Stream, utc1, utc2)
        of conDatDuration + conBuff seconds are the fetcher's over each
        station key row's span, or over [utcStart, utcEnd] (detex_tpu
        detect.py:304-309), or come from ``chunks(sta)`` when the caller
        passes it; the other options are detect.detex's. With more than
        one CUDA device the engine shards its chunk batches across all of
        them by itself (DETEX_TORCH_MESH=0 keeps one device); ``batchSize``
        is used as given, and a batch that the device count does not
        divide is padded with empty chunks. ``multiprocess`` raises, as in
        both packages.

        ``classifyEvents`` (a template key, path or rows) runs the classify
        mode over the key's events, read through the cluster's fetcher
        (getTemData, timeBeforeOrigin + timeAfterOrigin seconds) and cut
        at their tails against its conBuff: one row per detector and event
        in ``<eventCorFile>_<NET.STA>.pkl`` in the working directory.
        ``utcSaves`` (times) keeps the chunks and DS vectors spanning them
        in UTCsaves.pkl. Both run the per-chunk path whatever
        ``batchSize`` is, and write their tables as lists of row dicts
        (util.readRows); detections still land in ``subspaceDB``."""
        if multiprocess:
            detex_torch.log(__name__, "multiprocess is not supported: the "
                            "engine batches chunks on the card and shards "
                            "them across every CUDA device by itself",
                            level="error")
        kw = dict(conBuff=self.conBuff)
        if classifyEvents is not None:
            fetcher = self.clusters.fetcher
            if fetcher is None or chunks is not None:
                detex_torch.log(__name__, "classifyEvents reads the template "
                                "events through the cluster's fetcher: make "
                                "the cluster from key files and pass no "
                                "chunks", level="error", e=ValueError)
            chunks = _fetcher_tem_chunks(
                fetcher, self.clusters.stakey,
                _util.readKey(classifyEvents, "template"))
            kw.update(classifyEvents=classifyEvents,
                      dataLength=(fetcher.timeBeforeOrigin +
                                  fetcher.timeAfterOrigin),
                      conBuff=fetcher.conBuff)
        if chunks is None:
            if self.cfetcher is None:
                detex_torch.log(__name__, "detex needs continuous data: "
                                "pass chunks=callable(sta) or a "
                                "conDatFetcher to createSubSpace",
                                level="error", e=ValueError)
            chunks = _fetcher_con_chunks(self.cfetcher, self.clusters.stakey,
                                         utcStart, utcEnd)
        if os.path.exists(subspaceDB):
            if delOldCorrs:
                os.remove(subspaceDB)
                detex_torch.log(__name__, "Deleting old subspace database %s"
                                % subspaceDB)
            else:
                detex_torch.log(__name__, "Not deleting old subspace "
                                "database %s" % subspaceDB)
        kw.update(conDatDuration=self.conDatDuration,
                  eventCorFile=eventCorFile, utcSaves=utcSaves,
                  filt=self.clusters.filt, decimate=self.clusters.decimate,
                  trigCon=trigCon, triggerLTATime=triggerLTATime,
                  triggerSTATime=triggerSTATime,
                  staltaThreshold=staltaThreshold, calcHist=calcHist,
                  dtype=self.dtype, estimateMags=estimateMags,
                  fillZeros=fillZeros, batchSize=batchSize,
                  devicePrep=devicePrep, device=self.device)
        if useSubSpaces:
            if not all(r["SVDdefined"] for rows in self.subspaces.values()
                       for r in rows):
                detex_torch.log(__name__, "call SVD before running subspace "
                                "detectors", level="error")
            self.histSubSpaces = _detect.detex(
                self._stations(True), chunks, subspaceDB, issubspace=True,
                **kw)
        if useSingles:
            self.setSinglesThresholds()
            self.histSingles = _detect.detex(
                self._stations(False), chunks, subspaceDB, issubspace=False,
                **kw)
        if useSubSpaces or useSingles:
            self._writeTables(subspaceDB, useSubSpaces, useSingles)

    def _writeTables(self, db, useSubSpaces, useSingles):
        """filt_params, ss_info / sg_info and ss_hist / sg_hist (reference
        subspace.py:1904-1995)."""
        if self.clusters.filt is not None:
            _util.saveSQLite([list(self.clusters.filt)], db, "filt_params",
                             ["FREQMIN", "FREQMAX", "CORNERS", "ZEROPHASE"])
        for use, frames, table, sub in (
                (useSubSpaces, self.subspaces, "ss_info", True),
                (useSingles, self.singles, "sg_info", False)):
            if not use:
                continue
            rows = []
            for sta in self.Stations:
                for ss in frames.get(sta, []):
                    fas = ss["FAS"] if sub else (ss["FAS"] or [None])[0]
                    b1, b2 = (fas["betadist"][0], fas["betadist"][1]) \
                        if isinstance(fas, dict) and len(fas) > 1 \
                        else (np.nan, np.nan)
                    rows.append([ss["Name"], ss["Station"],
                                 ",".join(ss["Events"]), ss["Threshold"]]
                                + ([ss["NumBasis"]] if sub else [])
                                + [b1, b2])
            cols = (["Name", "Sta", "Events", "Threshold"]
                    + (["NumBasisUsed"] if sub else []) + ["beta1", "beta2"])
            _util.saveSQLite(rows, db, table, cols)
        for use, attr, table in ((useSubSpaces, "histSubSpaces", "ss_hist"),
                                 (useSingles, "histSingles", "sg_hist")):
            hist = getattr(self, attr, None)
            if not use or not hist or "Bins" not in hist:
                continue
            rows = [["Bins", "Bins",
                     json.dumps(np.asarray(hist["Bins"]).tolist())]]
            for sta in self.Stations:
                for skey, val in (hist.get(sta) or {}).items():
                    rows.append([skey, sta,
                                 json.dumps(np.asarray(val).tolist())])
            _util.saveSQLite(rows, db, table, ["Name", "Sta", "Value"])

    # ------------------------------------------------------------------
    # Plots and printers (reference subspace.py:1144-1325); each returns
    # its figures, one a subspace
    # ------------------------------------------------------------------
    def _figures(self, draw, show, want=lambda row: True):
        """One figure a subspace row that ``want`` accepts, drawn by
        ``draw(ax, sta, row)``; closed after (shown first with
        ``show``)."""
        import matplotlib.pyplot as plt
        figs = []
        for sta in self.ssStations:
            for row in self.subspaces[sta]:
                if not want(row):
                    continue
                fig, ax = plt.subplots()
                draw(ax, sta, row)
                figs.append(fig)
                if show:  # pragma: no cover
                    plt.show()
                plt.close(fig)
        return figs

    def plotThresholds(self, conDatNum=None, xlim=(-.01, .5), show=False,
                       **kwargs):
        """Each subspace's null histogram (as a density), its beta fit and
        its threshold."""
        def draw(ax, sta, row):
            bins = np.asarray(row["FAS"]["bins"])
            centers = 0.5 * (bins[1:] + bins[:-1])
            hist = np.asarray(row["FAS"]["hist"], dtype=float)
            width = bins[1] - bins[0]
            ax.bar(centers, hist / max(hist.sum() * width, 1e-12),
                   width=width, alpha=0.5, label="empirical null")
            b = row["FAS"]["betadist"]
            xs = np.linspace(xlim[0] + 1e-6, xlim[1], 400)
            ax.plot(xs, scipy.stats.beta.pdf(xs, b[0], b[1]),
                    label="beta fit")
            ax.axvline(row["Threshold"], color="r", ls="--",
                       label="threshold")
            ax.set_xlim(*xlim)
            ax.set_title("%s %s" % (sta, row["Name"]))
            ax.legend()
        return self._figures(draw, show, lambda row: isinstance(
            row["FAS"], dict) and "hist" in row["FAS"])

    def plotFracEnergy(self, show=False):
        """Each event's fractional energy captured against the dimension,
        their average and the dimension used."""
        def draw(ax, sta, row):
            for ev in row["Events"]:
                ax.plot(row["FracEnergy"][ev], alpha=.4)
            ax.plot(row["FracEnergy"]["Average"], "k", lw=2,
                    label="average")
            ax.axvline(row["NumBasis"], color="r", ls="--",
                       label="NumBasis")
            ax.set_xlabel("dimension of representation")
            ax.set_ylabel("fractional energy captured")
            ax.set_title("%s %s" % (sta, row["Name"]))
            ax.legend()
        return self._figures(draw, show, lambda row: isinstance(
            row["FracEnergy"], dict))

    def plotAlignedEvents(self, show=False):
        """The aligned (and trimmed) waveforms, each scaled to its largest
        absolute value."""
        def draw(ax, sta, row):
            for ev in row["Events"]:
                wf = np.asarray(row["AlignedTD"][ev], dtype=float)
                st = row["SampleTrims"]
                if "Starttime" in st:
                    wf = wf[st["Starttime"]:st["Endtime"]]
                ax.plot(wf / (np.abs(wf).max() or 1), alpha=.5)
            ax.set_title("%s %s aligned" % (sta, row["Name"]))
        return self._figures(draw, show)

    def plotBasisVectors(self, show=False):
        """The used basis vectors, offset by 0.2 each."""
        def draw(ax, sta, row):
            for i, key in enumerate(row["UsedSVDKeys"]):
                ax.plot(np.asarray(row["SVD"][key]) + i * 0.2, alpha=.8)
            ax.set_title("%s %s basis" % (sta, row["Name"]))
        return self._figures(draw, show, lambda row: isinstance(
            row["SVD"], dict))

    def plotOffsetTimes(self, show=False):
        """A histogram of each subspace's event offsets (start time minus
        origin time)."""
        def draw(ax, sta, row):
            ax.hist([row["Stats"][x]["offset"] for x in row["Events"]])
            ax.set_title("%s %s offsets" % (sta, row["Name"]))
        return self._figures(draw, show)

    def printOffsets(self):
        for station in self.ssStations:
            for row in self.subspaces[station]:
                off = row["Offsets"]
                print("%s, %s, min=%3f, max=%3f, range=%3f"
                      % (row["Station"], row["Name"], off[0], off[2],
                         off[2] - off[0]))

    # ------------------------------------------------------------------
    def __getstate__(self):
        # the caller's null-chunk callable is not kept
        return dict(_util.host_state(self.__dict__), _fasChunks=None)

    def write(self, filename="subspace.pkl"):
        """Pickle this SubSpace to ``filename`` (reference
        subspace.py:2018-2026); util.loadSubSpace reads it."""
        _util.saveObject(self, filename)

    def __getitem__(self, key):
        if isinstance(key, int):
            return self.subspaces[self.ssStations[key]]
        if isinstance(key, str):
            if len(key.split(".")) == 2:
                return self.subspaces[key]
            if len(key.split(".")) == 1:
                return self.subspaces[{x.split(".")[1]: x for x in
                                       self.ssStations}[key]]
        detex_torch.log(__name__, "%s must be an int or station string"
                        % key, level="error")

    def __len__(self):
        return len(self.subspaces)
