"""
Factories and host preprocessing: createCluster (waveform-similarity
clustering), createSubSpace (subspace construction), and the filter and
multiplex steps every template and continuous chunk goes through.

Namesake of detex_tpu/construct.py (reference construct.py), with its
entry points: key files (template, station and phases keys, read by
data/keys.readKey) and a data fetcher (data/fetcher.py's 'dir' method)
give the template waveforms, cut ``trim`` around each origin or first
pick. The same constructors also take plain inputs as keywords: per
station {event: Stream} of raw template waveforms (what a fetcher's
getTemData yields) and template rows {name: {"time", "mag"}}. Rows that
are DataFrames in detex_tpu are dicts with the same column names; CC, lag
and subsample matrices are square [m, m] numpy arrays, upper triangle
filled. The all-pairs correlation of each station is one
ops/xcorr.xcorr_all_pairs call on the caller's device, the single-linkage
tree is scipy's on the host, and alignment is align.py's tree walk. The
detection engine runs every chunk through prepChunk before its scan, and
each triggered chunk of a devicePrep scan again before the re-verify:
_applyFilter and multiplex, or one native pass with the same bits
(host_prep.py) where the chunk allows it.
"""
from __future__ import annotations

import os

import numpy as np
import torch
from scipy.cluster.hierarchy import linkage

import detex_torch
from detex_torch import align as _align
from detex_torch import host_prep as _host_prep
from detex_torch import native as _native
from detex_torch import trace as _trace
from detex_torch.core import filters as _filters
from detex_torch.core.stream import Stream, Trace
from detex_torch.core.utc import UTCDateTime
from detex_torch.data import fetcher as getdata
from detex_torch.data.keys import readKey
from detex_torch.ops import xcorr as _xcorr

DISSIM_OFFSET = 1.0000001  # reference construct.py:153


# channel lengths of one chunk may differ by this many samples before
# multiplex warns (it trims to the shortest either way)
TRIM_TOLERANCE = 15


def multiplex(st, Nc):
    """Interleave the Nc channels of a Stream into one vector
    (Fortran-order flatten of the [Nc, n] stack), every channel cut to the
    shortest."""
    if Nc == 1:
        return np.asarray(st[0].data)
    chans = [np.asarray(x.data) for x in st]
    lens = np.array([len(x) for x in chans])
    if lens.max() - lens.min() > TRIM_TOLERANCE:
        detex_torch.log(__name__, "Channel lengths are not within %d on "
                        "%s.%s from %s to %s; trimming to the shortest "
                        "channel" % (TRIM_TOLERANCE, st[0].stats.network,
                                     st[0].stats.station,
                                     st[0].stats.starttime,
                                     st[0].stats.endtime), level="warning")
    trimdim = lens.min()
    return np.vstack([x[:trimdim] for x in chans]).flatten(order="F")


def _applyFilter(st, filt, decimate=False, dtype="double", fillZeros=False):
    """Sort, merge, decimate, trim, split, detrend and bandpass a Stream in
    place (reference construct.py:990-1030); dtype "single" casts the
    traces to float32. Returns the filtered Stream, empty when the chunk
    cannot be used. _fusedPass does these steps in one pass where they
    reduce to trim, detrend and bandpass: change both together."""
    if st is None or len(st) < 1:
        detex_torch.log(__name__, "_applyFilter got a stream with 0 length",
                        level="warning")
        return Stream()
    st.sort()
    nc = list(set(x.stats.channel for x in st))
    if len(st) > len(nc):  # fragmented: keep largest chunk or zero-fill
        st = _mergeChannelsFill(st) if fillZeros else _mergeChannels(st)
    if not len(st) == len(nc) or len(st) < 1:
        sta = st[0].stats.station if len(st) else "?"
        detex_torch.log(__name__, "Stream is too fractured on %s" % sta,
                        level="warning")
        return Stream()
    if decimate:
        st.decimate(decimate)
    startTrim = max(x.stats.starttime.timestamp for x in st)
    endTrim = min(x.stats.endtime.timestamp for x in st)
    if startTrim > endTrim:
        return Stream()
    st.trim(starttime=UTCDateTime(startTrim), endtime=UTCDateTime(endTrim))
    st = st.split()
    st.detrend("linear")
    if isinstance(filt, (list, tuple)):
        st.filter("bandpass", freqmin=filt[0], freqmax=filt[1],
                  corners=filt[2], zerophase=filt[3])
    if dtype == "single":
        for tr in st:
            tr.data = tr.data.astype(np.float32)
    return st


def prepChunk(st, nc, filt, decimate=False, dtype="double", fillZeros=False,
              mux=True):
    """The detection engine's preparation of one chunk: _applyFilter,
    then multiplex (``mux``) or the [nc, n] stack of the sorted channels
    cut to the shortest. Returns (out, the Stats that stamp the chunk with
    its rate and start, the prepared Stream), or None where _applyFilter
    leaves nothing; out is float32 for dtype "single", else float64. One
    native pass (_fusedPass) does it all where the chunk allows, with the
    same bits, and counts prep.fused; every other chunk takes _applyFilter
    and multiplex and counts prep.fallback. ``st`` is sorted in place, and
    filtered in place on the fallback."""
    got = _fusedPass(st, nc, filt, decimate, dtype, mux)
    _trace.count("prep.fallback" if got is None else "prep.fused")
    if got is not None:
        return got
    conSt = _applyFilter(st, filt, decimate, dtype, fillZeros=fillZeros)
    if len(conSt) < 1:
        return None
    stats = conSt[0].stats
    if mux:
        return multiplex(conSt, nc), stats, conSt
    conSt.sort()
    L = min(len(tr.data) for tr in conSt)
    return np.stack([tr.data[:L] for tr in conSt]), stats, conSt


def _fusedPass(st, nc, filt, decimate, dtype, mux):
    """prepChunk's result in one call of host_prep.prep, where the chunk
    shows that the call gives _applyFilter's bits: after st.sort(), ``nc``
    channels of one trace each (nothing to merge), one sampling rate, one
    type of host_prep.IN_TYPES, no decimation, one length of at least 2
    samples after _applyFilter's trim (on views of the data), no NaN
    (nothing to split; the call checks) and the native host library that
    _applyFilter would filter with. None for every other chunk."""
    if (st is None or len(st) != nc or decimate or
            not (_native.available() and _host_prep.available())):
        return None
    st.sort()
    if len(set(tr.stats.channel for tr in st)) != nc:
        return None
    sr = st[0].stats.sampling_rate
    kind = st[0].data.dtype
    if kind not in _host_prep.IN_TYPES or any(
            tr.stats.sampling_rate != sr or tr.data.dtype != kind or
            tr.data.ndim != 1 for tr in st):
        return None
    sos, zerophase = None, False
    if isinstance(filt, (list, tuple)):
        sos = _filters._bandpass_sos(filt[0], filt[1], sr, filt[2])
        zerophase = filt[3]
    # _applyFilter's trim (Trace.trim slices; a trace it empties is dropped)
    startTrim = max(tr.stats.starttime.timestamp for tr in st)
    endTrim = min(tr.stats.endtime.timestamp for tr in st)
    cut = Stream([Trace(tr.data, tr.stats.copy()) for tr in st])
    cut.trim(starttime=UTCDateTime(startTrim), endtime=UTCDateTime(endTrim))
    n = len(cut[0].data) if len(cut) == nc else 0
    if n < 2 or any(len(tr.data) != n for tr in cut):
        return None
    out = _host_prep.prep([np.ascontiguousarray(tr.data) for tr in cut],
                          sos, zerophase,
                          np.float32 if dtype == "single" else np.float64,
                          mux)
    if out is None:
        return None
    rows = out.reshape(n, nc).T if mux else out      # channel c's samples
    stats = [tr.stats for tr in cut]
    return out, stats[0], Stream([Trace(x, s) for x, s in zip(rows, stats)])


def _mergeChannels(st):
    """Keep the longest continuous stretch common to all channels
    (reference construct.py:1033-1066)."""
    st1 = st.copy()
    st1.merge(fill_value=0.0)
    start = max(x.stats.starttime.timestamp for x in st1)
    end = min(x.stats.endtime.timestamp for x in st1)
    if start > end:
        return Stream()
    st1.trim(starttime=UTCDateTime(start), endtime=UTCDateTime(end))
    if len(st1) < 1:
        return Stream()
    ar_len = min(len(x.data) for x in st1)
    ar = np.ones(ar_len)
    for tr in st1:
        ar = ar * tr.data[:ar_len]
    if (ar == 0.0).any():
        # longest run where every channel is nonzero
        nz = (ar != 0.0).astype(np.int8)
        edges = np.flatnonzero(np.diff(np.concatenate(([0], nz, [0]))))
        starts, ends = edges[::2], edges[1::2]
        if len(starts) == 0:
            return Stream()
        k = int(np.argmax(ends - starts))
        best_start, best_len = int(starts[k]), int(ends[k] - starts[k])
        sr = st1[0].stats.sampling_rate
        t0 = UTCDateTime(start + best_start / sr)
        t1 = UTCDateTime(start + (best_start + best_len - 1) / sr)
        st.trim(starttime=t0, endtime=t1)
        return st
    return st1


def _mergeChannelsFill(st):
    """Merge each channel's fragments with zeros in the gaps."""
    st.merge(fill_value=0.0)
    return st


def _checkClusterInputs(filt, dtype, trim, decimate):
    """Validate createCluster's inputs (reference construct.py:1074-1101);
    returns the dtype, "double" in place of an unknown one."""
    if filt is not None and len(filt) != 4:
        detex_torch.log(__name__, "filt must either be None (no filter) or "
                        "a len 4 list or tuple", level="error")
    if dtype not in ("double", "single"):
        detex_torch.log(__name__, "dtype must be 'double' or 'single', not "
                        "%s" % dtype, level="warning")
        dtype = "double"
    if trim is not None:
        if len(trim) != 2:
            detex_torch.log(__name__, "Trim must be a list or tuple of "
                            "length 2", level="warning")
        elif -trim[0] > trim[1]:
            detex_torch.log(__name__, "Invalid trim parameters",
                            level="error")
    if decimate is not None and not isinstance(decimate, int):
        detex_torch.log(__name__, "decimate must be an int", level="error",
                        e=TypeError)
    return dtype


# ---------------------------------------------------------------------------
# event loading (reference construct.py:615-925)
# ---------------------------------------------------------------------------


def _loadEvents(streams, templates, filt, decimate, dtype,
                enforceOrigin=False):
    """Station rows of multiplexed templates, sorted by station (the TRDF
    of reference construct.py:615-655): each {"Station", "Events",
    "Channels", "Stats", "MPtd"}; stations where fewer than
    two events survive are left out."""
    rows = []
    for sta in sorted(streams):
        sts, eves, chans, stats = _loadStream(streams[sta], templates, filt,
                                              decimate, sta, dtype,
                                              enforceOrigin)
        if eves is None:
            continue
        row = dict(Station=sta, Events=eves, Channels=chans, Stats=stats,
                   MPtd={ev: multiplex(sts[ev], stats[ev]["Nc"])
                         for ev in eves})
        _testStreamLengths(row)
        rows.append(row)
    return rows


def _loadStream(events, templates, filt, decimate, station, dtype,
                enforceOrigin=False):
    """Filter every template waveform of one station ({event: Stream},
    copied before filtering) and reject the unusable ones with a logged
    reason: fractured, missing from ``templates``, shorter than 20% of
    the station's median total length, or with an all-zero channel
    (capability of reference construct.py:852-925). Returns (streams,
    sorted names, channels, stats) dicts, or four Nones when fewer than
    two events survive."""
    records = {}
    for ev, raw in events.items():
        st = _applyFilter(raw.copy(), filt, decimate, dtype)
        if st is None or len(st) < 1:
            continue
        if ev not in templates:
            detex_torch.log(__name__, "%s not in template key, skipping"
                            % ev)
            continue
        chans = [tr.stats.channel for tr in st]
        if len(set(chans)) != len(st):
            detex_torch.log(__name__, "%s on %s is fractured or channels "
                            "are missing, skipping" % (ev, station))
            continue
        if enforceOrigin:
            st.trim(starttime=UTCDateTime(templates[ev]["time"]), pad=True,
                    fill_value=0.0)
        hdr = st[0].stats
        records[ev] = dict(
            st=st, channels=chans,
            stats={"processing": list(hdr.get("processing", [])),
                   "sampling_rate": hdr.sampling_rate,
                   "starttime": hdr.starttime.timestamp,
                   "Nc": len(chans)},
            nsamp=sum(len(tr.data) for tr in st),
            dead=any(not np.any(tr.data) for tr in st))
    if not records:
        return None, None, None, None
    median_len = np.median([r["nsamp"] for r in records.values()])
    for ev in list(records):
        if records[ev]["nsamp"] < 0.2 * median_len:
            detex_torch.log(__name__, "%s is fractured or missing data, "
                            "removing" % ev, level="warning")
            del records[ev]
        elif records[ev]["dead"]:
            detex_torch.log(__name__, "%s has an all-zero channel, deleting"
                            % ev, level="warning")
            del records[ev]
    if len(records) < 2:
        detex_torch.log(__name__, "Less than 2 events survived "
                        "preprocessing for station %s" % station,
                        level="warning")
        return None, None, None, None
    evlist = sorted(records)
    return ({e: records[e]["st"] for e in evlist}, evlist,
            {e: records[e]["channels"] for e in evlist},
            {e: records[e]["stats"] for e in evlist})


def _testStreamLengths(row):
    """Cut a station row's templates to the common length: the shortest
    of those longer than 90% of the median; shorter events are dropped
    (reference construct.py:679-698)."""
    lens = np.array([len(v) for v in row["MPtd"].values()])
    le = int(np.min(lens[lens > np.median(lens) * .9]))
    kill = [x for x in row["Events"] if len(row["MPtd"][x]) < le]
    for key in row["Events"]:
        row["MPtd"][key] = row["MPtd"][key][:le]
    row["Events"] = [x for x in row["Events"] if x not in kill]
    for key in kill:
        detex_torch.log(__name__, "%s on %s is out of length tolerance, "
                        "removing" % (key, row["Station"]), level="warning")
        row["MPtd"].pop(key, None)


def _flatNoNan(mat):
    """Row-major flatten with NaNs dropped: the condensed upper triangle of
    a square matrix whose diagonal and lower triangle are NaN (reference
    construct.py:701-707)."""
    ar = np.asarray(mat, dtype=np.float64).flatten()
    return ar[~np.isnan(ar)]


def _condensed(mat):
    """Condensed upper triangle (row-major), NaNs kept."""
    iu = np.triu_indices(mat.shape[0], k=1)
    return np.asarray(mat, dtype=np.float64)[iu]


# ---------------------------------------------------------------------------
# createCluster (reference construct.py:25-171)
# ---------------------------------------------------------------------------


def createCluster(CCreq=0.5, fetch_arg="EventWaveForms",
                  filt=(1, 10, 2, True), stationKey="StationKey.csv",
                  templateKey="TemplateKey.csv", trim=(10, 120),
                  saveclust=True, fileName="clust.pkl", decimate=None,
                  dtype="double", eventsOnAllStations=False,
                  enforceOrigin=False, fillZeros=False, phases=None,
                  device="cuda", streams=None, templates=None):
    """Cluster template waveforms by all-pairs normalized cross-correlation
    and single-linkage hierarchical clustering; returns a ClusterStream
    (reference createCluster, construct.py:25-102).

    The waveforms come from ``fetch_arg`` (a DataFetcher or a directory
    path, made with ``fillZeros``) for every station of ``stationKey`` and
    event of ``templateKey``, cut ``trim`` = [seconds before, seconds
    after] the origin, or the station's first pick in ``phases``. Or pass
    them as ``streams`` {"NET.STA": {event: Stream}} with ``templates``
    {event: {"time": origin time, "mag": magnitude}}, and the keys and
    fetcher are not used. Each event is filtered (``filt`` [freqmin,
    freqmax, corners, zerophase], ``decimate``), checked and multiplexed;
    each station's pairs are correlated in one ops/xcorr.xcorr_all_pairs
    call on ``device`` (the card unless "cpu"). With ``saveclust`` the
    ClusterStream is pickled to ``fileName`` (ClusterStream.write; read
    back by util.loadClusters or createSubSpace(clust=fileName))."""
    from detex_torch.subspace import ClusterStream

    if torch.device(device).type == "cuda":
        detex_torch.require_cuda()
    dtype = _checkClusterInputs(filt, dtype, trim, decimate)
    stakey = temkey = fetcher = None
    if streams is None:
        stakey = readKey(stationKey, key_type="station")
        temkey = readKey(templateKey, key_type="template")
        if phases is not None:
            phases = readKey(phases, "phases")
        fetcher = getdata.quickFetch(fetch_arg, fillZeros=fillZeros)
        streams, templates = _fetchTemplates(fetcher, stakey, temkey, trim,
                                             phases)
    TRDF = _loadEvents(streams, templates, filt, decimate, dtype,
                       enforceOrigin=enforceOrigin)
    if len(TRDF) < 1:
        detex_torch.log(__name__, "No events survived pre-processing, check "
                        "the template streams and event quality",
                        level="error")
    if eventsOnAllStations:
        eventList = sorted(set.intersection(
            *[set(row["Events"]) for row in TRDF]))
        if len(eventList) < 2:
            detex_torch.log(__name__, "less than 2 events in population "
                            "have required stations", level="error")
    for row in TRDF:
        detex_torch.log(__name__, "performing cluster analysis on %s"
                        % row["Station"])
        if not eventsOnAllStations:
            eventList = row["Events"]
        if len(row["Events"]) < 2:
            detex_torch.log(__name__, "Less than 2 valid events on station "
                            "%s" % row["Station"], level="warning")
            continue
        cc, lag, sub = _makeCCMatrices(eventList, row, device)
        row.update(CCs=cc, Lags=lag, Subsamp=sub,
                   Link=linkage(_flatNoNan(DISSIM_OFFSET - cc)))
    eventListAll = sorted(set.union(*[set(row["Events"]) for row in TRDF]))
    clust = ClusterStream(
        TRDF, templates, streams, eventListAll, CCreq,
        list(filt) if filt is not None else None, decimate, list(trim),
        eventsOnAllStations, enforceOrigin, device, temkey=temkey,
        stakey=stakey, fetcher=fetcher, fileName=fileName)
    if saveclust:
        clust.write()
    return clust


def _fetchTemplates(fetcher, stakey, temkey, trim, phases):
    """The plain inputs of the key-file path: per station of the station
    key the raw template waveforms the fetcher's getTemData yields
    ({"NET.STA": {event: Stream}}; every station row of the same station
    code, as detex_tpu's _loadStream asks), and {event: {"time", "mag"}}
    from the first template-key row of each name."""
    templates = {}
    for r in temkey:
        templates.setdefault(r["NAME"], {"time": r["TIME"], "mag": r["MAG"]})
    streams = {}
    for srow in stakey:
        sta = "%s.%s" % (srow["NETWORK"], srow["STATION"])
        skey = [r for r in stakey if r["STATION"] == srow["STATION"]]
        streams[sta] = {ev: st for st, ev in fetcher.getTemData(
            temkey, skey, trim[0], trim[1], returnName=True, phases=phases)}
    return streams, templates


def _makeCCMatrices(eventList, row, device):
    """The square CC / lag / subsample matrices of one station's events
    from one xcorr_all_pairs call (replaces reference _makeDFcclags,
    construct.py:369-394)."""
    ncs = {len(row["Channels"][ev]) for ev in eventList}
    if len(ncs) != 1:
        detex_torch.log(__name__, "Number of channels not equal, cannot "
                        "perform correlation", level="error")
    X = np.stack([row["MPtd"][ev] for ev in eventList])
    return _xcorr.xcorr_all_pairs(X, ncs.pop(), device=device)


# ---------------------------------------------------------------------------
# createSubSpace (reference construct.py:177-301)
# ---------------------------------------------------------------------------


def createSubSpace(Pf=10 ** -12, clust="clust.pkl", minEvents=2,
                   dtype="double", conDatFetcher=None, conDatDuration=3600.0,
                   conBuff=120.0, device=None):
    """Build a SubSpace from a ClusterStream: the events are loaded again
    from the cluster's template streams (at this ``dtype``), each cluster
    is aligned by its linkage lag tree and cut to a common length, and the
    per-station subspace and single rows are made (reference
    construct.py:177-301). SVD and thresholds come later (SubSpace.SVD).

    ``conDatFetcher`` (a DataFetcher or a directory path) serves the
    continuous data FAS and detection scan; a cluster made from key files
    without one reads ContinuousWaveForms, as detex_tpu's does. Its chunks
    are conDatDuration + conBuff seconds long; without a fetcher the
    ``conDatDuration`` and ``conBuff`` given here say how long the
    caller's chunks are. ``clust`` is a ClusterStream or the path of one
    that ClusterStream.write pickled (loaded by util.loadClusters on
    ``device``). ``device`` defaults to the cluster's (the card for a
    loaded one)."""
    from detex_torch import util as _util
    from detex_torch.subspace import ClusterStream, SubSpace

    if isinstance(clust, (str, os.PathLike)):
        cl = _util.loadClusters(clust, device="cuda" if device is None
                                else device)
    elif isinstance(clust, ClusterStream):
        cl = clust
    else:
        detex_torch.log(__name__, "Invalid clust type, must be a path or "
                        "ClusterStream instance", level="error",
                        e=ValueError)
    if isinstance(conDatFetcher, getdata.DataFetcher):
        cfetcher = conDatFetcher
    elif isinstance(conDatFetcher, (str, os.PathLike)):
        cfetcher = getdata.quickFetch(conDatFetcher)
    elif cl.fetcher is not None:
        cfetcher = getdata.quickFetch(getdata.conDirDefault)
    else:
        cfetcher = None
    if cfetcher is not None:
        conDatDuration, conBuff = cfetcher.conDatDuration, cfetcher.conBuff
    templates = cl.templates
    TRDF = _loadEvents(cl.streams, templates, cl.filt, cl.decimate, dtype)
    for row in TRDF:
        row["Link"] = cl[row["Station"]].link
        row["Clust"] = cl[row["Station"]].clusts
    detex_torch.log(__name__, "Starting Subspace Construction")
    ssDict = {}
    for row in TRDF:
        staSS = _makeSSDF(row, minEvents)
        if len(staSS) < 1:
            detex_torch.log(__name__, "No events grouped into subspaces on "
                            "%s" % row["Station"], level="warning")
            continue
        for srow in staSS:
            eventList = list(srow["Events"])
            cc_sub, lag_sub = _getInfoFromClust(cl, srow)
            link = linkage(_flatNoNan(DISSIM_OFFSET - cc_sub))
            delays = _align.alignment_delays(link, cc_sub, lag_sub)
            srow["AlignedTD"] = _align.align_and_trim(srow.pop("MPtd"),
                                                      eventList, delays)
            ustimes = _updateStartTimes(srow, eventList, delays, templates)
            srow["Stats"] = ustimes
            offsets = [ustimes[ev]["offset"] for ev in eventList]
            srow["Offsets"] = [float(np.min(offsets)),
                               float(np.median(offsets)),
                               float(np.max(offsets))]
        ssDict[row["Station"]] = staSS
    singDic = _makeSingleEventDict(cl, TRDF, templates)
    return SubSpace(singDic, ssDict, cl, dtype, Pf, conDatDuration, conBuff,
                    cl.device if device is None else device,
                    cfetcher=cfetcher)


def _getInfoFromClust(cl, srow):
    """The cluster's [m, m] CC and lag sub-matrices of the station's
    matrices, upper triangle kept (reference construct.py:304-336). Both
    event lists are sorted, so the (i < j) orientation carries over."""
    cll = cl.row(srow["Station"])
    full_events = list(cll["Events"])
    pos = np.array([full_events.index(ev) for ev in srow["Events"]])
    m = len(pos)
    cc = np.asarray(cll["CCs"], np.float64)[np.ix_(pos, pos)]
    lag = np.asarray(cll["Lags"], np.float64)[np.ix_(pos, pos)]
    lower = ~np.triu(np.ones((m, m), dtype=bool), k=1)
    cc[lower] = np.nan
    lag[lower] = 0.0
    return cc, lag


def _updateStartTimes(srow, eventList, delays, templates):
    """Per-event stats with start times moved by the alignment trims, and
    origin time, magnitude and offset (reference construct.py:346-366)."""
    statsdict = {k: dict(v) for k, v in srow["Stats"].items()
                 if k in eventList}
    for ev, dsamp in zip(eventList, delays):
        st = statsdict[ev]
        stime_new = st["starttime"] + float(dsamp) / (st["sampling_rate"] *
                                                      st["Nc"])
        otime = UTCDateTime(templates[ev]["time"]).timestamp
        st.update(starttime=stime_new, origintime=otime,
                  magnitude=templates[ev]["mag"], offset=stime_new - otime)
    return statsdict


def _row_defaults():
    """The columns a subspace row starts with before SVD."""
    return dict(AlignedTD=None, SVD=None, UsedSVDKeys=None, FracEnergy=None,
                SVDdefined=False, SampleTrims={}, Threshold=np.nan, FAS=None,
                NumBasis=0, Offsets=None)


def _makeSSDF(row, minEvents):
    """One subspace row per cluster of a station row, named SS<k> in
    cluster order, those with fewer than ``minEvents`` events left out
    (reference construct.py:562-601)."""
    out = []
    for ind, clust in enumerate(row["Clust"]):
        evelist = sorted(clust)
        srow = dict(_row_defaults(), Name="SS%d" % ind,
                    Station=row["Station"], Events=evelist,
                    MPtd=_trimDict(row, "MPtd", evelist),
                    Stats=_trimDict(row, "Stats", evelist),
                    Channels=_trimDict(row, "Channels", evelist))
        if len(evelist) >= minEvents:
            out.append(srow)
    return out


def _makeSingleEventDict(cl, TRDF, templates):
    """Per station, one row per single event, named SG<k> (reference
    construct.py:525-559)."""
    singlesdict = {}
    for row in TRDF:
        rows = []
        for sn, ev in enumerate(cl[row["Station"]].singles):
            stats = _trimDict(row, "Stats", [ev])
            otime = UTCDateTime(templates[ev]["time"]).timestamp
            stats[ev]["origintime"] = otime
            stats[ev]["offset"] = stats[ev]["starttime"] - otime
            stats[ev]["magnitude"] = templates[ev]["mag"]
            rows.append(dict(
                Name="SG%d" % sn, Station=row["Station"], Events=[ev],
                MPtd=_trimDict(row, "MPtd", [ev]), Stats=stats,
                Channels=_trimDict(row, "Channels", [ev]), SampleTrims={},
                FAS=None, Threshold=np.nan, Offsets=None))
        singlesdict[row["Station"]] = rows
    return singlesdict


def _trimDict(row, column, evelist):
    """A row's dict column cut to the given events (reference
    construct.py:604-610)."""
    return {k: row[column][k] for k in evelist if row[column].get(k)
            is not None}
