"""
Waveform acquisition from an indexed local directory (the reference's
detex/getdata.py, method "dir").

Namesake of detex_tpu/data/fetcher.py on rows instead of DataFrames: the
same ``DataFetcher`` options and generators (``getTemData``,
``getConData``, ``getStream``), the same ``.index.db`` two-table schema
(``ind``: one row per readable file, its quality stats and its path
encoded as per-depth integer ids; ``indkey``: the per-depth path-component
vocabulary), the same seeded random draw of continuous chunks
(``_divideIntoChunks``, which FAS's null depends on) and the same 10%
sliver rule at a request's edges. Waveform files are npz or miniSEED
(data/waveio.read, which the index and every fetch read through).

The client methods ("client", "iris", "neic", "uuss", "ewave") and
``makeDataDirectories`` download through obspy's FDSN, NEIC and Earthworm
clients over a network; they raise here.
"""
from __future__ import annotations

import glob
import itertools
import json
import os

import numpy as np

import detex_torch
from detex_torch.core.stream import Stream
from detex_torch.core.utc import UTCDateTime
from detex_torch.data import keys as _keys
from detex_torch.data.keys import readKey
from detex_torch.data.waveio import formatKey, read  # noqa: F401

conDirDefault = "ContinuousWaveForms"
eveDirDefault = "EventWaveForms"

INDEX_COLUMNS = ["Path", "FileName", "Starttime", "Endtime", "Gaps", "Nc",
                 "Nt", "Duration", "Station"]


def _no_client(what):
    detex_torch.log(__name__, "%s needs obspy's FDSN / NEIC / Earthworm "
                    "clients and a network, which the port does not use; "
                    "use method 'dir' on a local directory" % what,
                    level="error", e=NotImplementedError)


def quickFetch(fetch_arg, **kwargs):
    """A DataFetcher from minimal information (reference
    getdata.py:50-95): a DataFetcher passes through, a client method name
    raises, anything else is a directory path."""
    if isinstance(fetch_arg, DataFetcher):
        return fetch_arg
    if isinstance(fetch_arg, (str, os.PathLike)):
        fetch_arg = os.fspath(fetch_arg)
        if fetch_arg in DataFetcher.supMethods:
            if fetch_arg == "dir":
                detex_torch.log(__name__, "If using method dir you must pass "
                                "a path to directory", level="error")
            return DataFetcher(fetch_arg, removeResponse=True, **kwargs)
        if not os.path.exists(fetch_arg):
            detex_torch.log(__name__, "Directory %s does not exist"
                            % fetch_arg, level="error")
        return DataFetcher("dir", directoryName=fetch_arg, **kwargs)
    detex_torch.log(__name__, "Input not understood, read docs and try "
                    "again", level="error")


class DataFetcher(object):
    """Data acquisition front end (reference getdata.py:244-609); only
    method "dir" is served."""

    supMethods = ["dir", "client", "iris", "neic", "uuss", "ewave"]

    def __init__(self, method, client=None, removeResponse=False,
                 inventoryArg=None, directoryName=None, opType="VEL",
                 prefilt=(0.05, 0.1, 15, 20), conDatDuration=3600,
                 conBuff=120, timeBeforeOrigin=60, timeAfterOrigin=240,
                 checkData=True, fillZeros=False, randSeed=42):
        self.method = str(method).lower()
        self.client = client
        self.removeResponse = removeResponse
        self.inventoryArg = inventoryArg
        self.directoryName = directoryName
        self.opType = opType
        self.prefilt = list(prefilt) if prefilt is not None else None
        self.conDatDuration = conDatDuration
        self.conBuff = conBuff
        self.timeBeforeOrigin = timeBeforeOrigin
        self.timeAfterOrigin = timeAfterOrigin
        self.checkData = checkData
        self.fillZeros = fillZeros
        self.randSeed = randSeed  # deterministic random chunk sampling
        self._checkInputs()

    def _checkInputs(self):
        if self.method not in self.supMethods:
            detex_torch.log(__name__, "method %s not supported. Options: %s"
                            % (self.method, self.supMethods), level="error")
        if self.method != "dir":
            _no_client("DataFetcher method %r" % self.method)
        if self.directoryName is None:
            self.directoryName = conDirDefault
        if not os.path.exists(self.directoryName):
            detex_torch.log(__name__, "directory %s not found"
                            % self.directoryName, level="error", e=IOError)
        self.directory = self.directoryName

    # -- generators -----------------------------------------------------------
    def getTemData(self, temkey, stakey, tb4=None, taft=None, returnName=True,
                   temDir=None, skipIfExists=False, skipDict=None,
                   returnTimes=False, phases=None):
        """Yield the event (template) stream of every station / event pair,
        cut ``tb4`` before and ``taft`` after the origin, or the station's
        first pick of the event when ``phases`` has one (reference
        getdata.py:351-453)."""
        if tb4 is None:
            tb4 = self.timeBeforeOrigin
        if taft is None:
            taft = self.timeAfterOrigin
        if skipDict is not None and len(skipDict) < 1:
            skipDict = None
        stakey = readKey(stakey, key_type="station")
        temkey = readKey(temkey, key_type="template")
        if phases is not None:
            phases = readKey(phases, "phases")
        for srow, trow in itertools.product(stakey, temkey):
            netsta = "%s.%s" % (srow["NETWORK"], srow["STATION"])
            if skipDict is not None and netsta in skipDict:
                if trow["NAME"] in skipDict[netsta]:
                    continue
            if skipIfExists and temDir is not None:
                pfile = glob.glob(os.path.join(temDir, trow["NAME"],
                                               netsta + "*"))
                if len(pfile) > 0:
                    continue
            t = UTCDateTime(trow["TIME"])
            if phases is not None:
                cur = [p for p in phases if p["Event"] == trow["NAME"]
                       and p["Station"] == netsta]
                if len(cur) > 0:
                    t = UTCDateTime(min(UTCDateTime(p["TimeStamp"]).timestamp
                                        for p in cur))
                else:
                    detex_torch.log(__name__, "%s on %s not in phase file, "
                                    "using origin" % (trow["NAME"],
                                                      srow["STATION"]))
            start = t - tb4
            end = t + taft
            chan = str(srow["CHANNELS"]).split("-")
            st = self.getStream(start, end, srow["NETWORK"], srow["STATION"],
                                chan, "??")
            if st is None:
                continue
            if returnName:
                yield st, trow["NAME"]
            elif returnTimes:
                yield st, start, end
            else:
                yield st

    def getConData(self, stakey, secBuff=None, returnName=False,
                   returnTimes=False, conDir=None, skipIfExists=False,
                   utcstart=None, utcend=None, duration=None, randSamps=None):
        """Yield continuous chunks of ``conDatDuration`` + ``secBuff``
        seconds over each station's time range, or over [utcstart, utcend],
        or ``randSamps`` of them drawn at random with the fetcher's seed
        (reference getdata.py:455-539)."""
        stakey = readKey(stakey, "station")
        if secBuff is None:
            secBuff = self.conBuff
        if duration is None:
            duration = self.conDatDuration
        for ser in stakey:
            netsta = "%s.%s" % (ser["NETWORK"], ser["STATION"])
            ts1 = UTCDateTime(ser["STARTTIME"]) if utcstart is None \
                else UTCDateTime(utcstart)
            ts2 = UTCDateTime(ser["ENDTIME"]) if utcend is None \
                else UTCDateTime(utcend)
            utcs = _divideIntoChunks(ts1, ts2, duration, randSamps,
                                     seed=self.randSeed)
            for utc in utcs:
                if skipIfExists and conDir is not None:
                    path, fil = _makePathFile(conDir, netsta, utc)
                    if len(glob.glob(os.path.join(path, fil + "*"))) > 0:
                        continue
                start = utc
                end = utc + self.conDatDuration + secBuff
                chan = str(ser["CHANNELS"]).split("-")
                st = self.getStream(start, end, ser["NETWORK"],
                                    ser["STATION"], chan, "*")
                if st is None or len(st) < 1:
                    continue
                if utcend is not None:
                    if UTCDateTime(utcend).timestamp < \
                            st[0].stats.endtime.timestamp:
                        st.trim(endtime=utcend)
                if len(st) < 1:
                    continue
                if returnName and returnTimes:
                    path, fname = _makePathFile(conDir, netsta, utc)
                    yield st, path, fname, start, end
                elif returnName:
                    path, fname = _makePathFile(conDir, netsta, utc)
                    yield st, path, fname
                elif returnTimes:
                    yield st, start, end
                else:
                    yield st

    def getStream(self, start, end, net, sta, chan="???", loc="??"):
        """One Stream from ``start`` to ``end``, merged, split at gaps and
        detrended (zero-filled with ``fillZeros``); None if unavailable
        (reference getdata.py:541-609)."""
        start = UTCDateTime(start)
        end = UTCDateTime(end)
        if not isinstance(chan, (list, tuple)):
            chan = [chan]
        st = _loadDirectoryData(self, start, end, net, sta, chan, loc)
        if self.checkData:
            st = _dataCheck(st, start, end)
        if st is None or len(st) < 1:
            return None
        st.trim(starttime=start, endtime=end)
        st.merge(1)
        st = st.split()
        st.detrend("linear")
        if self.fillZeros:
            st.trim(starttime=start, endtime=end, pad=True, fill_value=0.0)
            st.merge(1, fill_value=0.0)
        return st


# ---------------------------------------------------------------------------
# dir-method loading via .index.db
# ---------------------------------------------------------------------------


def _loadDirectoryData(fet, start, end, net, sta, chan, loc):
    """Load the files of one station overlapping [start, end] from an
    indexed directory (capability of reference getdata.py:614-669). A
    file reaching back before the request must cover at least 10% of it
    past its start (unless it also spans past its end), and one reaching
    past its end must start at least 10% of it before the end; interior
    files always stay."""
    t1 = UTCDateTime(start).timestamp
    t2 = UTCDateTime(end).timestamp
    buf = 3 * fet.conDatDuration
    rows = _loadIndexDb(fet.directoryName, net + "." + sta, t1 - buf,
                        t2 + buf)
    if rows is None or len(rows) < 1:
        detex_torch.log(__name__, "data from %s to %s on %s not found in %s"
                        % (UTCDateTime(t1), UTCDateTime(t2), sta,
                           fet.directoryName), level="warning")
        return None
    span = t2 - t1
    kept = []
    for r in rows:
        s, e = r["Starttime"], r["Endtime"]
        head_sliver = s <= t1 and e < t2 and e - t1 < 0.1 * span
        tail_sliver = e >= t2 and s > t1 and t2 - s < 0.1 * span
        if not (head_sliver or tail_sliver):
            kept.append(r)
    if len(kept) < 1:
        return None
    st = Stream()
    for r in kept:
        st1 = read(os.path.join(r["Path"], r["FileName"]))
        if st1 is not None:
            st += st1
    stout = Stream()
    for cha in (chan if isinstance(chan, (list, tuple)) else [chan]):
        stout += st.select(channel=cha)
    loc = "*" if loc in ("???", "??") else loc
    return stout.select(location=loc)


def _dataCheck(st, start, end):
    """Round non-integer sampling rates; None for a stream with an all-zero
    channel (reference getdata.py:801-828)."""
    if st is None or len(st) < 1:
        return None
    netsta = st[0].stats.network + "." + st[0].stats.station
    t = str(st[0].stats.starttime).split(".")[0]
    for tr in st:
        if tr.stats.sampling_rate % 1 != 0:
            tr.stats.sampling_rate = float(np.round(tr.stats.sampling_rate))
            detex_torch.log(__name__, "Found non-int sampling_rates, rounded "
                            "on %s around %s" % (netsta, t), level="warning")
    if any(not np.any(np.nan_to_num(x.data)) for x in st):
        detex_torch.log(__name__, "At least one channel is all 0s on %s "
                        "around %s, skipping" % (netsta, t), level="warning")
        return None
    return st


def _divideIntoChunks(utc1, utc2, duration, randSamps, seed=42):
    """Chunk start times from utc1 to utc2, ``duration`` apart, on
    multiples of ``duration``; with ``randSamps`` a draw of that many
    start times (every one, in a random order, when it is more than a
    quarter of them) from numpy's default_rng(seed), the draw detex_tpu
    makes (the reference's random.sample was unseeded, getdata.py:869-898)."""
    ts1 = utc1.timestamp - utc1.timestamp % duration
    ts2 = utc2.timestamp - utc2.timestamp % duration
    if randSamps is None:
        t = ts1
        while t <= ts2:
            yield UTCDateTime(t)
            t += duration
    else:
        utcList = np.arange(utc1.timestamp, utc2.timestamp, duration)
        if randSamps > len(utcList) / 4:
            detex_torch.log(__name__, "Population too small for %d random "
                            "samples, taking %d" % (randSamps, len(utcList)))
            randSamps = len(utcList)
        rng = np.random.default_rng(seed)
        idx = rng.choice(len(utcList), size=int(randSamps), replace=False)
        for i in idx:
            yield UTCDateTime(utcList[i])


def _makePathFile(conDir, netsta, utc):
    """Expected path and file name of a continuous chunk (reference
    getdata.py:901-914)."""
    utc = UTCDateTime(utc)
    year = "%04d" % utc.year
    jd = "%03d" % utc.julday
    hr, mi, se = "%02d" % utc.hour, "%02d" % utc.minute, "%02d" % utc.second
    path = os.path.join(conDir, netsta, year, jd)
    fname = "%s.%s-%sT%s-%s-%s" % (netsta, year, jd, hr, mi, se)
    return path, fname


def makeDataDirectories(*args, **kwargs):
    """Download event and continuous data into the detex directory layout
    (reference getdata.py:98-241): needs a network client, not ported."""
    _no_client("makeDataDirectories")


getAllData = makeDataDirectories  # legacy alias (reference getdata.py:1042)


# ---------------------------------------------------------------------------
# Directory indexing (.index.db), the reference's schema
# ---------------------------------------------------------------------------


def indexDirectory(dirPath):
    """Create ``.index.db`` for a waveform directory with the reference's
    two-table schema (getdata.py:918-986): 'ind' one row per readable
    file (quality stats and the file's absolute path encoded as per-depth
    integer ids), 'indkey' the per-depth path-component vocabulary (row =
    depth, column col_<id>). Directories are walked in os.walk's order,
    files sorted by name in each."""
    from detex_torch import util
    detex_torch.log(__name__, "indexing, or updating index for %s"
                    % dirPath)
    vocab = []  # vocab[depth] = {component: id}, insertion-ordered

    def encode(parts):
        ids = []
        for depth, part in enumerate(parts):
            if depth == len(vocab):
                vocab.append({})
            lookup = vocab[depth]
            ids.append(lookup.setdefault(part, len(lookup)))
        return json.dumps(ids)

    rows = []
    for dirpath, _dirnames, filenames in os.walk(dirPath):
        parts = os.path.abspath(dirpath).split(os.path.sep)
        for fname in sorted(filenames):
            if fname.startswith("."):
                continue
            fullpath = os.path.join(os.path.sep.join(parts), fname)
            quality = _checkQuality(fullpath)
            if quality is None:
                detex_torch.log(__name__, "failed to read %s, skipping"
                                % fullpath, level="warning")
                continue
            rows.append([encode(parts), fname] +
                        [quality[c] for c in INDEX_COLUMNS[2:]])
    if not rows:
        detex_torch.log(__name__, "No readable files found in %s" % dirPath,
                        level="error")
    width = max(len(v) for v in vocab)
    key = [list(v) + [""] * (width - len(v)) for v in vocab]
    dbPath = os.path.join(dirPath, ".index.db")
    if os.path.exists(dbPath):
        os.remove(dbPath)
    util.saveSQLite(rows, dbPath, "ind", INDEX_COLUMNS)
    util.saveSQLite(key, dbPath, "indkey",
                    ["col_%d" % i for i in range(width)])


def _checkQuality(stPath):
    """Quality stats of one waveform file (reference getdata.py:989-1007);
    None if it cannot be read."""
    st = read(stPath)
    if st is None or len(st) < 1:
        return None
    gaps = st.get_gaps()
    gapsum = float(np.sum([x[-2] for x in gaps])) if gaps else 0.0
    starttime = min(x.stats.starttime.timestamp for x in st)
    endtime = max(x.stats.endtime.timestamp for x in st)
    nc = len(set(x.stats.channel for x in st))
    netsta = st[0].stats.network + "." + st[0].stats.station
    return {"Gaps": gapsum, "Starttime": starttime, "Endtime": endtime,
            "Duration": endtime - starttime, "Nc": nc, "Nt": len(st),
            "Station": netsta}


def _loadIndexDb(dirPath, station, t1, t2):
    """The 'ind' rows of one station inside [t1, t2], each row's Path
    decoded against the 'indkey' vocabulary, sorted by file name; None
    when there are none. A directory without an index is indexed first."""
    from detex_torch import util
    dbPath = os.path.join(dirPath, ".index.db")
    if not os.path.exists(dbPath):
        detex_torch.log(__name__, "%s is not currently indexed, indexing now"
                        % dirPath)
        indexDirectory(dirPath)
    sql = ('SELECT * FROM ind WHERE Starttime>=%f AND Endtime<=%f AND '
           'Station="%s"' % (t1, t2, station))
    rows = util.loadSQLite(dbPath, "ind", sql=sql, silent=False)
    if rows is None or len(rows) < 1:
        return None
    key = util.loadSQLite(dbPath, "indkey", convertNumeric=False)
    order = sorted(key[0], key=lambda c: int(c.split("_")[1]))
    vocab = [[r[c] for c in order] for r in key]  # [depth][id] -> part
    for r in rows:
        r["Path"] = _decodePath(r["Path"], vocab)
    return _keys.sort_rows(rows, "FileName")


def _decodePath(encoded, vocab):
    parts = [vocab[depth][i] for depth, i in enumerate(json.loads(encoded))]
    if parts and parts[0] == "":  # absolute path: leading empty component
        return os.path.sep.join(parts)
    return os.path.join(*parts)
