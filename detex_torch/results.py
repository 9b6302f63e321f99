"""
Association and results: the detections of a SubSpace database grouped
into events across stations, split into auto-detections (a template's own
event) and new detections, and verified against a catalog.

Namesake of detex_tpu/results.py (reference detex/results.py) on rows
instead of DataFrames. ``Dets``, ``Autos`` and ``Vers`` are lists of row
dicts with detex_tpu's columns in its order (Event, DSav, DSmax,
NumStations, DS_STALTA, MSTAMPmin, MSTAMPmax, Mag, ProEnMag, Verified,
Dets; ``Dets`` holds the group's detection rows; ``Vers`` drops Verified
and adds the catalog's extra columns, VerMag, VerLat, VerLon, VerDepth and
VerName). Every sort is pandas' sort on the same values
(data/keys.sort_rows: numpy's quicksort for one numeric column, a stable
lexsort of rank codes for several), and the means are pandas' NaN-skipping
sums over counts, so ties and rounding come out as detex_tpu's do. A
pickled DataFrame veriFile needs pandas and is refused.
"""
from __future__ import annotations

import csv
import numbers
import os

import numpy as np
import scipy.stats

import detex_torch
from detex_torch import util as _util
from detex_torch.core.utc import UTCDateTime
from detex_torch.data import fetcher as getdata
from detex_torch.data import keys as _keys

COLUMNS = ["Event", "DSav", "DSmax", "NumStations", "DS_STALTA",
           "MSTAMPmin", "MSTAMPmax", "Mag", "ProEnMag", "Verified", "Dets"]
VERI_COLUMNS = ["TIME", "LAT", "LON", "MAG", "DEPTH", "NAME"]


def detResults(trigCon=0, trigParameter=0, associateReq=0,
               ss_associateBuffer=1, sg_associateBuffer=2.5,
               requiredNumStations=4, veriBuffer=1, ssDB="SubSpace.db",
               templateKey="TemplateKey.csv", stationKey="StationKey.csv",
               veriFile=None, includeAllVeriColumns=True, reduceDets=True,
               Pf=False, stations=None, starttime=None, endtime=None,
               fetch="ContinuousWaveForms", exceptionalThreshold=None):
    """Associate the detections of ``ssDB`` into events and return an
    SSResults (parameters as reference results.py:22-112): per station the
    max-DS member of each group of detections closer than the associate
    buffer is kept, detections of several stations overlapping in time
    form an event when ``requiredNumStations`` stations (or an
    ``exceptionalThreshold`` DS, a float or {station: float}) carry it,
    events within the buffer of a template's origin are auto-detections,
    and ``veriFile`` (csv or SQLite table "verify") verifies them."""
    _checkExistence([ssDB, templateKey, stationKey])
    _checkInputs(trigCon, trigParameter, associateReq, ss_associateBuffer,
                 requiredNumStations)
    if associateReq != 0:
        detex_torch.log(__name__, "associateReq values other than 0 not yet "
                        "supported", level="error")
    temkey = _util.readKey(templateKey, "template")
    stakey = _util.readKey(stationKey, "station")
    ss_info, sg_info = _loadInfoDataFrames(ssDB)
    try:
        fetcher = getdata.quickFetch(fetch)
    except (detex_torch.DetexError, OSError, NotImplementedError):
        fetcher = None
    filt = _util.loadSQLite(ssDB, "filt_params")
    ss_PfKey, sg_PfKey = _makePfKey(ss_info, sg_info, Pf)
    if reduceDets:
        ssdf = _deleteDetDups(ssDB, trigCon, trigParameter,
                              ss_associateBuffer, starttime, endtime,
                              stations, "ss_df", PfKey=ss_PfKey)
        sgdf = _deleteDetDups(ssDB, trigCon, trigParameter,
                              sg_associateBuffer, starttime, endtime,
                              stations, "sg_df", PfKey=sg_PfKey)
    else:
        if Pf:
            detex_torch.log(__name__, "When using the Pf parameter "
                            "reduceDets must be True", level="error")
        ssdf = _util.loadSQLite(ssDB, "ss_df")
        sgdf = _util.loadSQLite(ssDB, "sg_df")
    if ssdf is None and sgdf is None:
        detex_torch.log(__name__, "No detections found that meet given "
                        "criteria", level="error")
    df = _concat([x for x in (ssdf, sgdf) if x is not None])
    if isinstance(stations, (list, tuple)):
        df = [r for r in df if r["Sta"] in stations]
    Dets, Autos = _associateDetections(df, associateReq, requiredNumStations,
                                       ss_associateBuffer, ss_info, temkey,
                                       exceptionalThreshold)
    Vers = _verifyEvents(Dets, Autos, veriFile, veriBuffer,
                         includeAllVeriColumns)
    return SSResults(Dets, Autos, Vers, ss_info, filt, temkey, stakey,
                     templateKey, fetcher)


# ---------------------------------------------------------------------------
# column helpers (pandas' reductions on row lists)
# ---------------------------------------------------------------------------


def _concat(tables):
    """Rows of ``tables`` one after another, every row with the union of
    their columns (first-seen order), NaN where a table lacks one."""
    cols = []
    for t in tables:
        for r in t:
            for c in r:
                if c not in cols:
                    cols.append(c)
    nan = float("nan")
    return [{c: r.get(c, nan) for c in cols} for t in tables for r in t]


def _to_float(v):
    """pandas.to_numeric(errors="coerce") of one value."""
    if v is None or isinstance(v, bool):
        return float("nan") if v is None else float(v)
    if isinstance(v, numbers.Real):
        return float(v)
    f = _keys.parse_float(str(v))
    return float("nan") if f is None else f


def _col(rows, c):
    return np.array([_to_float(r[c]) for r in rows], dtype=np.float64)


def _mean(vals):
    """pandas' Series.mean: the sum with NaN as 0 over the count of the
    rest."""
    mask = np.isnan(vals)
    count = float(len(vals) - mask.sum())
    if mask.any():
        vals = np.where(mask, 0.0, vals)
    return vals.sum() / count if count > 0 else np.nan


def _nanext(vals, fn):
    """pandas' Series.min / max: NaN skipped, NaN when nothing is left."""
    vals = vals[~np.isnan(vals)]
    return fn(vals) if len(vals) else np.nan


def _drop_duplicates(rows, col, keep="first"):
    """pandas' drop_duplicates(subset=col, keep=...), row order kept."""
    seen = {}
    for i, r in enumerate(rows):
        if keep == "first":
            seen.setdefault(r[col], i)
        else:
            seen[r[col]] = i
    kept = set(seen.values())
    return [r for i, r in enumerate(rows) if i in kept]


# ---------------------------------------------------------------------------
# thresholds from Pf
# ---------------------------------------------------------------------------


def _makePfKey(ss_info, sg_info, Pf):
    """Per-detector DS thresholds at ``Pf`` from the stored beta
    parameters (reference results.py:172-205): rows of Sta, Name, DS and
    betadist."""
    if not Pf:
        return None, None
    out = []
    for info in (ss_info, sg_info):
        if info is None:
            out.append(None)
            continue
        rows = []
        for row in info:
            TH = scipy.stats.beta.isf(Pf, row["beta1"], row["beta2"], 0, 1)
            if TH > .94:
                TH, _pf = _approximateThreshold(row["beta1"], row["beta2"],
                                                Pf, 1000, 3)
            rows.append(dict(Sta=row["Sta"], Name=row["Name"], DS=TH,
                             betadist=[row["beta1"], row["beta2"], 0, 1]))
        out.append(rows)
    return out[0], out[1]


def _approximateThreshold(beta_a, beta_b, target, numintervals, numloops):
    """Forward grid search around scipy bug #4677 (reference
    results.py:208-229)."""
    startVal, stopVal = 0, 1
    loops = 0
    while loops < numloops:
        Xs = np.linspace(startVal, stopVal, numintervals)
        pfs = scipy.stats.beta.sf(Xs, beta_a, beta_b)
        resids = np.abs(pfs - target)
        minind = int(resids.argmin())
        bestPf = pfs[minind]
        bestX = Xs[minind]
        startVal = Xs[max(minind - 1, 0)]
        stopVal = Xs[min(minind + 1, numintervals - 1)]
        loops += 1
        if minind == 0 or minind == numintervals - 1:
            raise ValueError("Grid search failing, set threshold manually")
    return bestX, bestPf


# ---------------------------------------------------------------------------
# verification
# ---------------------------------------------------------------------------


def _verifyEvents(Dets, Autos, veriFile, veriBuffer, includeAllVeriColumns):
    """Match associated events to a ground-truth catalog (reference
    results.py:232-296): a catalog event verifies the unverified event of
    the largest DSav whose window, widened by half ``veriBuffer`` on each
    side, holds its time (Dets searched before Autos). Marks Verified in
    ``Dets`` / ``Autos``; returns the verified rows, one per event name,
    or None without a veriFile."""
    if veriFile is None:
        return None
    if isinstance(veriFile, str) and not os.path.exists(veriFile):
        detex_torch.log(__name__, "No veriFile passed or it does not exist, "
                        "skipping verification", level="warning")
        return None
    vercols, vertem = _readVeriFile(veriFile)
    for r in vertem:
        r["STMP"] = UTCDateTime(r["TIME"]).timestamp
    verlist = []
    cols = ["TIME", "LAT", "LON", "MAG", "ProEnMag", "DEPTH", "NAME"]
    additionalColumns = list(set(vercols + ["STMP"]) - set(cols))
    for verrow in vertem:
        matched = False
        for table in (Dets, Autos):
            if matched or len(table) < 1:
                continue
            stmp = verrow["STMP"]
            cand = [r for r in table
                    if r["MSTAMPmin"] - veriBuffer / 2.0 < stmp
                    and r["MSTAMPmax"] + veriBuffer / 2.0 > stmp
                    and not bool(r["Verified"])]
            if len(cand) > 0:
                best = _nanext(_col(cand, "DSav"), np.max)
                trudet = [dict(r) for r in cand if r["DSav"] == best]
                next(r for r in cand if r["DSav"] == best)["Verified"] = True
                for r in trudet:
                    if includeAllVeriColumns:
                        for col in additionalColumns:
                            if col not in r:
                                r[col] = verrow[col]
                    r.update(VerMag=verrow["MAG"], VerLat=verrow["LAT"],
                             VerLon=verrow["LON"], VerDepth=verrow["DEPTH"],
                             VerName=verrow["NAME"])
                verlist.append(trudet)
                matched = True
    if not verlist:
        return []
    verifs = _keys.sort_rows(_concat(verlist), ["Event", "DSav"])
    verifs = _drop_duplicates(verifs, "Event")
    for r in verifs:
        del r["Verified"]
    return verifs


def _readVeriFile(veriFile):
    """The verification catalog as (columns, rows): ``veriFile`` rows, a
    csv file or an SQLite database with table "verify" (reference
    results.py:299-317). A pickled DataFrame needs pandas and raises."""
    if isinstance(veriFile, (list, tuple)):
        rows = [dict(r) for r in veriFile]
        cols = list(rows[0]) if rows else []
    else:
        cols = rows = None
        try:
            cols, rows = _keys.read_csv(veriFile)
        except (UnicodeDecodeError, csv.Error, detex_torch.DetexError):
            rows = _util.loadSQLite(veriFile, "verify")
            if rows:
                cols = list(rows[0])
            elif _looks_pickle(veriFile):
                detex_torch.log(__name__, "%s is a pickle; a pickled "
                                "DataFrame veriFile needs pandas, which the "
                                "port does not use: give a csv or SQLite "
                                "file" % veriFile, level="error",
                                e=NotImplementedError)
        if rows is None:
            detex_torch.log(__name__, "%s could not be read; must be csv or "
                            "sqlite db" % veriFile, level="error")
    if not set(VERI_COLUMNS).issubset(cols):
        detex_torch.log(__name__, "%s lacks required columns %s"
                        % (veriFile, VERI_COLUMNS), level="error")
    return list(cols), rows


def _looks_pickle(path):
    try:
        with open(path, "rb") as fh:
            return fh.read(1) == b"\x80"
    except OSError:
        return False


# ---------------------------------------------------------------------------
# loading and per-station dedup
# ---------------------------------------------------------------------------


def _buildSQL(PfKey, trigCon, trigParameter, stations, starttime, endtime,
              tableName):
    """SQL statements loading the detections that pass the trigger (or
    per-detector Pf) condition in the time window (reference
    results.py:320-368)."""
    SQL = []
    if not starttime or not endtime:
        starttime = 0.0
        endtime = 4500 * 3600 * 24 * 365.25
    else:
        starttime = UTCDateTime(starttime).timestamp
        endtime = UTCDateTime(endtime).timestamp
    if isinstance(stations, (list, tuple)):
        if PfKey is not None:
            PfKey = [r for r in PfKey if r["Sta"] in stations]
    else:
        stations = ["*"] if PfKey is None else [r["Sta"] for r in PfKey]
    if PfKey is not None:
        for row in PfKey:
            table = "sg_df" if "SG" in row["Name"] else "ss_df"
            SQL.append('SELECT * FROM %s WHERE Sta="%s" AND Name="%s" AND '
                       'DS>=%f AND MSTAMPmin>%f AND MSTAMPmin<%f'
                       % (table, row["Sta"], row["Name"], row["DS"],
                          starttime, endtime))
    else:
        cond = "DS" if trigCon == 0 else "DS_STALTA"
        for sta in stations:
            if sta == "*":
                SQL.append('SELECT * FROM %s WHERE %s >= %s AND '
                           'MSTAMPmin>=%f AND MSTAMPmin<=%f'
                           % (tableName, cond, trigParameter, starttime,
                              endtime))
            else:
                SQL.append('SELECT * FROM %s WHERE Sta="%s" AND %s >= %s '
                           'AND MSTAMPmin>=%f AND MSTAMPmin<=%f'
                           % (tableName, sta, cond, trigParameter,
                              starttime, endtime))
    return SQL


def _deleteDetDups(ssDB, trigCon, trigParameter, associateBuffer, starttime,
                   endtime, stations, tableName, PfKey=None):
    """Keep only the max-DS detection of each per-station overlap group
    (reference results.py:371-400): sorted by station and start, a new
    group (column Gnum, from 1) opens where the station changes or a
    detection starts more than ``associateBuffer`` after the previous one
    ends. None when no query could run (no such table)."""
    sslist = []
    for sql in _buildSQL(PfKey, trigCon, trigParameter, stations, starttime,
                         endtime, tableName):
        loaded = _util.loadSQLite(ssDB, tableName, sql=sql)
        if loaded is not None:
            sslist.append(loaded)
    if len(sslist) < 1:
        return None
    ssdf = _keys.sort_rows(_concat(sslist), ["Sta", "MSTAMPmin"])
    gnum = 0
    prev = None
    for r in ssdf:
        con1 = prev is not None and \
            (r["MSTAMPmin"] - associateBuffer) > prev["MSTAMPmax"]
        con2 = prev is None or r["Sta"] != prev["Sta"]
        gnum += int(con1 or con2)
        prev = r
        r["Gnum"] = gnum
    ssdf = _keys.sort_rows(ssdf, ["Gnum", "DS"])
    return _drop_duplicates(ssdf, "Gnum", keep="last")


# ---------------------------------------------------------------------------
# association
# ---------------------------------------------------------------------------


def _associateDetections(ssdf, associateReq, requiredNumStations,
                         associateBuffer, ss_info, temkey,
                         exceptionalThreshold):
    """Group detections across stations by time overlap (reference
    results.py:403-460): sorted by start, a group opens where a detection
    starts more than ``associateBuffer`` after the previous one ends.
    Returns [Dets, Autos]."""
    ssdf = _keys.sort_rows(ssdf, "MSTAMPmin")
    groups = []
    prev = None
    for r in ssdf:
        if prev is None or \
                (r["MSTAMPmin"] - associateBuffer) > prev["MSTAMPmax"]:
            groups.append([])
        groups[-1].append(r)
        prev = r
    autolist, detlist = [], []
    temstmp = np.array([UTCDateTime(r["TIME"]).timestamp for r in temkey])
    for g in groups:
        stas = set(r["Sta"] for r in g)
        con1 = len(stas) >= requiredNumStations
        if not con1 and isinstance(exceptionalThreshold, float):
            con1 = con1 or (_nanext(_col(g, "DS"), np.max) >=
                            exceptionalThreshold)
        elif not con1 and isinstance(exceptionalThreshold, dict):
            con1 = con1 or _check_if_exceptional(g, exceptionalThreshold)
        if con1:
            if len(stas) < len(g):
                g = _keys.sort_rows(g, "DS")
                g = _drop_duplicates(g, "Sta", keep="last")
                g = _keys.sort_rows(g, "MSTAMPmin")
            event = _autoEvent(g, temkey, temstmp, associateBuffer)
            if event is not None:
                autolist.append(_eventRow(g, event))
            else:
                utc = UTCDateTime(np.mean([_mean(_col(g, "MSTAMPmin")),
                                           _mean(_col(g, "MSTAMPmax"))]))
                detlist.append(_eventRow(
                    g, str(utc).replace(":", "-").split(".")[0]))
    return [detlist, autolist]


def _check_if_exceptional(g, exth):
    """Per-station exceptional-threshold gate (reference
    results.py:463-467)."""
    ex = np.array([exth.get(r["Sta"], 100) for r in g])
    ds = _col(g, "DS")
    return bool(np.any((ds >= ex) & (ds <= 1.01)))


def _eventRow(g, event):
    """One Dets / Autos row of group ``g`` named ``event``."""
    mag, proEnMag = _getMagnitudes(g)
    ds = _col(g, "DS")
    return dict(zip(COLUMNS, [
        event, _mean(ds), _nanext(ds, np.max), len(g),
        _mean(_col(g, "DS_STALTA")), _nanext(_col(g, "MSTAMPmin"), np.min),
        _nanext(_col(g, "MSTAMPmax"), np.max), mag, proEnMag, False, g]))


def _autoEvent(g, temkey, temstmp, associateBuffer):
    """The template-key event a group is an auto-detection of: for each
    detection in order, the first template whose origin lies within the
    buffer of its window; the last detection with one decides (reference
    _createAutoTable, results.py:478-499). None for a new detection."""
    event = None
    for r in g:
        hit = np.flatnonzero((temstmp + associateBuffer > r["MSTAMPmin"]) &
                             (temstmp - associateBuffer < r["MSTAMPmax"]))
        if len(hit) > 0:
            event = temkey[hit[0]]["NAME"]
    return event


def _getMagnitudes(g):
    """Median network magnitude and projected-energy magnitude of a group,
    NaN skipped."""
    out = []
    for c in ("Mag", "ProEnMag"):
        vals = _col(g, c)
        out.append(np.nanmedian(vals) if (~np.isnan(vals)).any()
                   else np.nan)
    return out[0], out[1]


def _checkInputs(trigCon, trigParameter, associateReq, associateBuffer,
                 requiredNumStations):
    """(reference results.py:536-568)"""
    if not isinstance(trigCon, int) or trigCon not in (0, 1):
        detex_torch.log(__name__, "trigcon must be an int, either 0 or 1",
                        level="error")
    if trigCon == 0:
        if not isinstance(trigParameter, numbers.Real) or \
                trigParameter > 1 or trigParameter < 0:
            detex_torch.log(__name__, "When trigCon==0 trigParameter must be "
                            "between 0 and 1", level="error")
    elif trigCon == 1:
        if not isinstance(trigParameter, numbers.Real) or \
                (trigParameter < 1 and trigParameter != 0):
            detex_torch.log(__name__, "When trigCon==1 trigParameter must be "
                            "greater than 1 (or 0 for all)", level="error")
    if not isinstance(associateReq, int) or associateReq < 0:
        detex_torch.log(__name__, "associateReq must be an integer >= 0",
                        level="error")
    if not isinstance(associateBuffer, numbers.Real) or associateBuffer < 0:
        detex_torch.log(__name__, "associateBuffer must be a real number "
                        ">= 0", level="error")
    if not isinstance(requiredNumStations, int) or requiredNumStations < 1:
        detex_torch.log(__name__, "requiredNumStations must be an integer "
                        ">= 1", level="error")


def _checkExistence(existList):
    for fil in existList:
        if isinstance(fil, str) and not os.path.exists(fil):
            raise IOError("%s does not exist" % fil)


def _loadInfoDataFrames(ssDB):
    """ss_info and sg_info rows with their NumEvents (reference
    results.py:577-585); None for a missing table."""
    ss_info = _util.loadSQLite(ssDB, "ss_info")
    if ss_info is not None:
        for r in ss_info:
            r["NumEvents"] = len(r["Events"].split(","))
    sg_info = _util.loadSQLite(ssDB, "sg_info")
    if sg_info is not None:
        for r in sg_info:
            r["NumEvents"] = 1
    return ss_info, sg_info


class SSResults(object):
    """Associated detection results (reference results.py:588-698)."""

    def __init__(self, Dets, Autos, Vers, ss_info, ss_filt, temkey, stakey,
                 templateKey, fetcher):
        self.Autos = Autos
        self.Dets = Dets
        self.NumVerified = len(Vers) if isinstance(Vers, list) else "N/A"
        self.Vers = Vers
        self.info = ss_info
        self.filt = ss_filt
        self.StationKey = stakey
        self.TemplateKey = temkey
        self.TemKeyPath = templateKey
        self.fetcher = fetcher

    def writeDetections(self, onlyVerified=False, minDS=False, minMag=False,
                        eventDir="EventWaveForms", updateTemKey=True,
                        temkeyPath=None, timeBeforeOrigin=60,
                        timeAfterOrigin=240, waveFormat="npz"):
        """Cut the waveforms of the new detections, ``timeBeforeOrigin``
        to ``timeAfterOrigin`` around each one's mean time, from the
        fetcher into ``eventDir``/d<Event>/ (one file a station of the
        station key) and append the detections to the template key with a
        "d"-prefixed name (reference results.py:603-692). A file that
        cannot be fetched or written is logged and skipped, as in the
        reference. Returns the paths written."""
        dets = list(self.Dets)
        if onlyVerified:
            dets = [r for r in dets if r["Verified"]]
        if minDS:
            dets = [r for r in dets if r["DSav"] >= minDS]
        if minMag:
            dets = [r for r in dets if _to_float(r["Mag"]) >= minMag]
        if temkeyPath is None:
            temkeyPath = self.TemKeyPath
        written = []
        newrows = []
        for row in dets:
            origin = UTCDateTime(np.mean([row["MSTAMPmax"],
                                          row["MSTAMPmin"]]))
            eveDirName = "d" + row["Event"]
            evedir = os.path.join(eventDir, eveDirName)
            os.makedirs(evedir, exist_ok=True)
            index_path = os.path.join(eventDir, ".index.db")
            if os.path.exists(index_path):
                os.remove(index_path)
            for starow in self.StationKey:
                net, sta = starow["NETWORK"], starow["STATION"]
                start = origin - timeBeforeOrigin
                stop = origin + timeAfterOrigin
                ext = getdata.formatKey[waveFormat]
                path = os.path.join(evedir, ".".join([net, sta, row["Event"],
                                                      ext]))
                try:
                    st = self.fetcher.getStream(start, stop, net, sta)
                    st.write(path, waveFormat)
                    written.append(path)
                except Exception as e:  # the reference skips any failure
                    detex_torch.log(__name__, "Could not write and save %s "
                                    "for station %s: %r" % (row["Event"],
                                                            sta, e),
                                    level="warning")
            time = str(UTCDateTime(origin.timestamp))
            newrows.append(dict(
                NAME=eveDirName,
                TIME=time.replace(":", "-").replace("Z", ""),
                MAG=row["Mag"], LAT=np.nan, LON=np.nan, DEPTH=np.nan))
        if updateTemKey and newrows:
            columns = list(self.TemplateKey[0]) if self.TemplateKey else []
            for c in newrows[0]:
                if c not in columns:
                    columns.append(c)
            _keys.write_csv(temkeyPath, columns,
                            list(self.TemplateKey) + newrows)
        return written

    def __repr__(self):
        return ("SSResults instance with %d autodetections and %d new "
                "detections, %s are verified"
                % (len(self.Autos), len(self.Dets), str(self.NumVerified)))
