"""
Interop with location programs and external catalogs: KML, hypoDD,
HypoInverse and NonLinLoc writers, the hyp2000 / hypo71 / EQsearch
summary readers and the ANF and arc catalog readers.

Namesake of detex_tpu/interop.py (reference util.py:28-560, 699-867) on
rows: the writers take key paths or key rows (data/keys.readKey, or
``read_csv`` where detex_tpu reads with ``pandas.read_csv``) and write
detex_tpu's bytes; the readers return lists of {column: value} row dicts
with the columns and values of detex_tpu's DataFrames (``read_fwf`` here
types fixed-width fields as ``pandas.read_fwf`` does). The conversions to
and from obspy's Catalog and Inventory (templateKey2Catalog,
catalog2Templatekey, inventory2StationKey) need obspy and raise
NotImplementedError (ROADMAP A22).
"""
from __future__ import annotations

import glob
import os

import numpy as np

import detex_torch
from detex_torch.core.utc import UTCDateTime
from detex_torch.data import keys as _keys
from detex_torch.data.keys import readKey


def read_fwf(path, colspecs, names):
    """The rows of a fixed-width text file as ``pandas.read_fwf(path,
    colspecs=colspecs, names=names)`` reads them: blank lines skipped,
    each field stripped of spaces and tabs and each column typed as
    pandas' parser types it (data/keys: ints, floats, bools, strings, an
    empty field NaN). Returns (names, rows)."""
    with open(path) as fh:
        lines = [ln.rstrip("\r\n") for ln in fh]
    lines = [ln for ln in lines if ln.strip(" \t")]
    cols = [_keys._infer([ln[a:b].strip(" \t") for ln in lines])
            for a, b in colspecs]
    return list(names), [dict(zip(names, vals)) for vals in zip(*cols)]


def _rows(df):
    """Rows of a key given as rows, or read from a CSV path as
    ``pandas.read_csv`` reads it."""
    if isinstance(df, (str, os.PathLike)):
        return _keys.read_csv(df)[1]
    return [dict(r) for r in df]


# ---------------------------------------------------------------------------
# KML (reference util.py:28-201, written without simplekml)
# ---------------------------------------------------------------------------

_KML_HEAD = ('<?xml version="1.0" encoding="UTF-8"?>\n'
             '<kml xmlns="http://www.opengis.net/kml/2.2">\n<Document>\n')
_KML_TAIL = "</Document>\n</kml>\n"


def _write_kml(points, outname):
    """points: iterable of (name, lon, lat)."""
    with open(outname, "w") as fh:
        fh.write(_KML_HEAD)
        for name, lon, lat in points:
            fh.write("<Placemark><name>%s</name><Point><coordinates>"
                     "%f,%f</coordinates></Point></Placemark>\n"
                     % (name, float(lon), float(lat)))
        fh.write(_KML_TAIL)
    return outname


def writeKMLFromTemplateKey(df="TemplateKey.csv", outname="templates.kml"):
    """KML of template (event) locations (reference util.py:43-67)."""
    return _write_kml([(r["NAME"], r["LON"], r["LAT"]) for r in _rows(df)],
                      outname)


def writeKMLFromStationKey(df="StationKey.csv", outname="stations.kml"):
    """KML of station locations (reference util.py:70-94)."""
    return _write_kml([(r["STATION"], r["LON"], r["LAT"])
                       for r in _rows(df)], outname)


def writeKMLFromDF(DF, outname="map.kml"):
    """KML from readHypo2000Sum-style rows (reference util.py:30-40)."""
    return _write_kml([(r["DateString"], r["Lon"], r["Lat"]) for r in DF],
                      outname)


def writeKMLFromHypDD(hypreloc="hypoDD.reloc", outname="hypo.kml"):
    """KML from hypoDD relocations (reference util.py:149-160)."""
    points = np.atleast_2d(np.genfromtxt(hypreloc))
    return _write_kml([(str(int(a[0])), a[2], a[1]) for a in points],
                      outname)


def writeKMLFromEQSearchSum(eqsum="eqsrchsum", outname="eqsearch.kml"):
    """KML from a UUSS EQsearch summary file (reference util.py:163-201)."""
    return _write_kml([(r["TIME"], r["LON"], r["LAT"])
                       for r in _readEQSearchSum(eqsum)], outname)


def writeKMLFromHypInv(hypout="sum2000", outname="hypoInv.kml"):
    """KML from a hypoInverse-2000 summary file (reference
    util.py:97-118; point names are the yyyymmddhh origin stamp)."""
    pts = [("".join(c for c in r["DateString"] if c.isdigit())[:10],
            r["Lon"], r["Lat"]) for r in readHypo2000Sum(hypout)]
    return _write_kml(pts, outname)


def writeKMLFromArcDF(df, outname="Arc.kml"):
    """KML from readArc-style verified-location rows (reference
    util.py:120-126): one point per row at (verlon, verlat), named by the
    row's position."""
    return _write_kml([(str(i), r["verlon"], r["verlat"])
                       for i, r in enumerate(df)], outname)


def writeKMLfromHYPInput(hypin="test.pha", outname="hypoInInv.kml"):
    """KML from a hypoInverse phase-input file (reference
    util.py:129-147): terminator lines carry the trial origin in degrees
    and decimal minutes in fixed-width fields (W hemisphere assumed)."""
    pts = []
    with open(hypin) as fh:
        for line in fh:
            # blank trailing fields are zeros in this fixed-width format,
            # so short terminator lines are padded, not dropped
            if not line.startswith(" " * 6) or len(line.rstrip("\n")) < 16:
                continue
            z = line.rstrip("\n").ljust(29).replace(" ", "0")
            lat = (float(z[14:16]) +
                   (float(z[17:19]) + float(z[19:21]) / 100.0) / 60.0)
            lon = -(float(z[21:24]) +
                    (float(z[25:27]) + float(z[27:29]) / 100.0) / 60.0)
            pts.append((str(len(pts) + 1), lon, lat))
    return _write_kml(pts, outname)


# ---------------------------------------------------------------------------
# hypoDD (reference util.py:206-260)
# ---------------------------------------------------------------------------


def writeHypoDDStationInput(stakey, fileName="station.dat",
                            useElevations=True, inFt=False):
    """Write hypoDD's station.dat (reference util.py:206-232)."""
    conFact = 0.3048 if inFt else 1.0
    lines = []
    for row in readKey(stakey, key_type="station"):
        line = "%s %.6f %.6f" % (row["NETWORK"] + "." + row["STATION"],
                                 row["LAT"], row["LON"])
        if useElevations:
            line += " %.2f" % (row["ELEVATION"] * conFact)
        lines.append(line)
    with open(fileName, "w") as fil:
        fil.write("\n".join(lines) + "\n")
    return fileName


def writeHypoDDEventInput(temkey, fileName="event.dat"):
    """Write hypoDD's event.dat (reference util.py:235-260), events
    numbered in the template key's order."""
    temkey = readKey(temkey, key_type="template")
    reqZeros = int(np.ceil(np.log10(max(len(temkey), 2))))
    fmt = "{:0%dd}" % reqZeros
    lines = []
    for num, row in enumerate(temkey):
        utc = UTCDateTime(row["TIME"])
        DATE = "%04d%02d%02d" % (utc.year, utc.month, utc.day)
        TIME = "%02d%02d%04d" % (utc.hour, utc.minute,
                                 int(utc.second * 100))
        mag = row["MAG"] if row["MAG"] > -20 else 0.0
        lines.append("%s, %s, %04f, %04f, %02f, %02f, 0.0, 0.0, 0.0, %s"
                     % (DATE, TIME, row["LAT"], row["LON"], row["DEPTH"],
                        mag, fmt.format(num)))
    with open(fileName, "w") as fil:
        fil.write("\n".join(lines) + "\n")
    return fileName


# ---------------------------------------------------------------------------
# hypoInverse (reference util.py:264-488)
# ---------------------------------------------------------------------------


def _returnLat(lat, degPre=2):
    deg = int(abs(lat))
    minutes = (abs(lat) - deg) * 60
    char = "S" if lat < 0 else " "
    return ("%0*d" % (degPre, deg), "%5.2f" % minutes, char)


def _returnLon(lon, degPre=3):
    deg = int(abs(lon))
    minutes = (abs(lon) - deg) * 60
    char = "E" if lon > 0 else " "
    return ("%0*d" % (degPre, deg), "%5.2f" % minutes, char)


def makeHypoInversePhaseFile(phases, evekey, outname, fix=0,
                             usePhases=("P",), fixFirstStation=False):
    """Write a hypoinverse y2k phase file (manual v1.39 p.113) from a
    phase-pick key (reference util.py:264-318). A pick row's Channel is
    used where the key has one, else "EHZ"."""
    phases = readKey(phases, key_type="phases")
    out = ["\n"]
    for everow in readKey(evekey, key_type="template"):
        phas = [p for p in phases if p["Event"] == everow["NAME"]]
        if len(phas) < 1:
            continue
        for pha in phas:
            phase = str(pha["Phase"]).upper()
            if phase not in usePhases:
                continue
            net, sta = str(pha["Station"]).split(".")[:2]
            chan = pha.get("Channel", "EHZ")
            _checkLens(net, chan, sta)
            out.append(_makeSHypStationLine(sta, chan, net,
                                            pha["TimeStamp"], phase))
        out.append(_makeHypTermLine(everow, fix, fixFirstStation))
        out.append("\n")
    with open(outname, "w") as fh:
        fh.write("".join(out))
    return outname


def _checkLens(net, chan, sta):
    if len(net) > 2:
        detex_torch.log(__name__, "network code must be <= 2 characters: %s"
                        % net, level="error")
    if len(chan) > 3:
        detex_torch.log(__name__, "channel code must be <= 3 characters: %s"
                        % chan, level="error")
    if len(sta) > 5:
        detex_torch.log(__name__, "station code must be <= 5 characters: %s"
                        % sta, level="error")


def _dateDigits(utc):
    """The YYYYMMDDHHMMSS.ss digits of a UTCDateTime."""
    return ("%04d%02d%02d%02d%02d%05.2f"
            % (utc.year, utc.month, utc.day, utc.hour, utc.minute,
               utc.second + utc.microsecond / 1e6))


def _makeSHypStationLine(sta, cha, net, ts, pha):
    ds = _dateDigits(UTCDateTime(ts))
    ssss = "%5.2f" % float(ds[12:])
    ty = "%s 0" % pha
    return "{:<5}{:<4}{:<5}{:<3}{:<12}{:<80}{:<2}\n".format(
        sta, net, cha, ty, ds[0:12], ssss, "01")


def _makeHypTermLine(everow, fix, fixFirstStation):
    fixchar = {0: " ", 1: "-", 2: "X", 3: "O"}[fix]
    hhmmssss = _dateDigits(UTCDateTime(everow["TIME"]))[8:16]
    if fixFirstStation:
        lat = latmin = latchar = " "
        lon = lonmin = lonchar = " "
        dep = " "
    else:
        lat, latmin, latchar = _returnLat(everow["LAT"])
        lon, lonmin, lonchar = _returnLon(everow["LON"])
        dep = "%05.2f" % everow["DEPTH"]
    return "{:<6}{:<8}{:<3}{:<4}{:<4}{:<4}{:<5}{:<1}\n".format(
        " ", hhmmssss, lat + latchar, latmin, lon + lonchar, lonmin, dep,
        fixchar)


def makeHypoInverseStationFile(stationKey, outname):
    """Hypoinverse station file, data format #2 (reference
    util.py:375-409)."""
    lines = []
    for srow in readKey(stationKey, key_type="station"):
        latd, latm, latc = _returnLat(srow["LAT"], degPre=4)
        lond, lonm, lonc = _returnLon(srow["LON"], degPre=4)
        ele = "%4d" % srow["ELEVATION"]
        for chan in str(srow["CHANNELS"]).split("-"):
            fstr = "{:<6}{:<3}{:<1}{:<5}{:<3}{:<7}{:<1}{:<4}{:<7}{:<1}{:<4}"
            sto = fstr.format(srow["STATION"], srow["NETWORK"], " ", chan,
                              latd, latm, latc, lond, lonm, lonc, ele)
            ends = "5.0  P  0.00  0.00  0.00  0.00 0  0.00--"
            lines.append("{:<86}".format(sto + ends))
    with open(outname, "w") as fh:
        fh.write(os.linesep.join(lines) + os.linesep)
    return outname


def readHypo2000Sum(sumfile):
    """The rows of a hyp2000 summary file (reference util.py:412-453;
    western hemisphere assumed)."""
    with open(sumfile) as fh:
        lines = [line.rstrip("\n") for line in fh]
    rows = []
    for l in lines:  # noqa: E741
        if len(l) < 93:
            continue
        rows.append(dict(
            Lat=float(l[16:18]) + (float(l[19:21].replace(" ", "0")) +
                                   float(l[21:23].replace(" ", "0")) / 100)
            / 60,
            Lon=-float(l[23:26]) - (float(l[27:29].replace(" ", "0")) +
                                    float(l[29:31].replace(" ", "0")) / 100)
            / 60,
            DateString=(l[0:4] + "-" + l[4:6] + "-" + l[6:8] + "T" +
                        l[8:10] + "-" + l[10:12] + "-" + l[12:14] + "." +
                        l[14:16]),
            Dep=float(l[31:34].replace(" ", "0").replace("-", "0")) +
            float(l[34:36].replace(" ", "0")) / 100,
            RMS=float(l[48:50].replace(" ", "0")) +
            float(l[50:52].replace(" ", "0")) / 100,
            HozError=float(l[85:87].replace(" ", "0")) +
            float(l[87:89].replace(" ", "0")) / 100.0,
            VertError=float(l[89:91].replace(" ", "0")) +
            float(l[91:93].replace(" ", "0")) / 100.0))
    return rows


def _isnan(v):
    return isinstance(v, float) and v != v


def readHypo71Sum(sumfile):
    """The rows of a y2k hypo71-format summary file (reference
    util.py:456-488): depth, numphase, azgap, stadist, rms, horerr,
    vererr, then lat and lon (negative where a hemisphere letter is
    given), times (POSIX seconds) and names."""
    fw = [(0, 20), (19, 22), (22, 23), (23, 28), (28, 32), (32, 33),
          (33, 38), (38, 45), (52, 55), (55, 59), (59, 64), (64, 69),
          (69, 74), (74, 79)]
    cols = ["ds", "latd", "latc", "latm", "lond", "lonc", "lonm", "depth",
            "numphase", "azgap", "stadist", "rms", "horerr", "vererr"]
    _, rows = read_fwf(sumfile, fw, cols)
    out = []
    for r in rows:
        utc = UTCDateTime(str(r["ds"]).replace(" ", ""))
        o = {c: r[c] for c in cols[7:]}
        o["lat"] = (r["latd"] + r["latm"] / 60.) * \
            (1 if _isnan(r["latc"]) else -1)
        o["lon"] = (r["lond"] + r["lonm"] / 60.) * \
            (1 if _isnan(r["lonc"]) else -1)
        o["times"] = utc.timestamp
        o["names"] = str(utc).split(".")[0].replace(":", "-")
        out.append(o)
    return out


# ---------------------------------------------------------------------------
# NonLinLoc (reference util.py:493-560)
# ---------------------------------------------------------------------------


def writePhaseNLL(phases, evekey, NLLoc_dir, useP=True, useS=True):
    """Write NonLinLoc phase files, one per event with picks, from a
    phase-pick key (TimeStamp, Station, Event, Phase; reference
    util.py:493-560). Returns the paths written."""
    phases = readKey(phases, key_type="phases")
    os.makedirs(NLLoc_dir, exist_ok=True)
    written = []
    for everow in readKey(evekey, key_type="template"):
        phas = [p for p in phases if p["Event"] == everow["NAME"]]
        if len(phas) < 1:
            continue
        on = (str(everow["NAME"]).split(".")[0].replace("-", "")
              .replace("T", "") + ".p")
        outpath = os.path.join(NLLoc_dir, on)
        with open(outpath, "w") as fh:
            for pha in phas:
                p = str(pha["Phase"]).upper()
                if (p == "P" and useP) or (p == "S" and useS):
                    fh.write(_makeNLLine(pha, p))
            fh.write("\n")
        written.append(outpath)
    return written


def _makeNLLine(pha, phase):
    utc = UTCDateTime(pha["TimeStamp"])
    parts = ["%-6s" % pha["Station"].split(".")[-1], "%-4s" % "?",
             "%-4s" % "?", "%-1s" % "?", "%-6s" % phase, "%-1s" % "?",
             "%04d%02d%02d" % (utc.year, utc.month, utc.day),
             "%02d%02d" % (utc.hour, utc.minute),
             "%07.4f" % (utc.second + utc.microsecond / 1e6),
             "%-3s" % "GAU", "%-9s" % ".01", "%9.2e" % -1, "%9.2e" % -1,
             "%9.2e" % -1]
    return " ".join(parts) + "\n"


# ---------------------------------------------------------------------------
# Catalogs (reference util.py:699-867; the obspy conversions raise)
# ---------------------------------------------------------------------------

EQSEARCH_COLUMNS = ["TIME", "NAME", "LAT", "LON", "MAG", "DEPTH"]


def _readEQSearchSum(eq):
    """Template-key rows (TIME, NAME, LAT, LON, MAG, DEPTH) of a UUSS
    EQsearch summary file (years above 50 are 19xx)."""
    clspecs = [(0, 2), (2, 4), (4, 6), (7, 9), (9, 11), (12, 17), (18, 20),
               (21, 26), (27, 30), (31, 36), (37, 43), (45, 50)]
    names = ["year", "mo", "day", "hr", "min", "sec", "latdeg", "latmin",
             "londeg", "lonmin", "dep", "mag"]
    _, rows = read_fwf(eq, clspecs, names)
    out = []
    for r in rows:
        year = "19%02d" % r["year"] if r["year"] > 50 else \
            "20%02d" % r["year"]
        TIME = "%s-%02d-%02dT%02d-%02d-%05.2f" % (
            year, r["mo"], r["day"], r["hr"], r["min"], r["sec"])
        out.append(dict(zip(EQSEARCH_COLUMNS, [
            TIME, TIME, r["latdeg"] + r["latmin"] / 60.0,
            -r["londeg"] - r["lonmin"] / 60.0, r["mag"], r["dep"]])))
    return out


def EQSearch2TemplateKey(eq="eqsrchsum", oname="eqTemplateKey.csv"):
    """Template key rows from a UUSS EQsearch summary file, written to
    ``oname`` as detex_tpu's to_csv writes them (reference
    util.py:767-809)."""
    rows = _readEQSearchSum(eq)
    if oname:
        _keys.write_csv(oname, EQSEARCH_COLUMNS, rows)
    return rows


def _needs_obspy(what):
    detex_torch.log(__name__, "%s converts obspy objects; the port does not "
                    "use obspy (ROADMAP A22)" % what, level="error",
                    e=NotImplementedError)


def templateKey2Catalog(temkey="TemplateKey.csv", picks=None):
    """Template key (and picks) to an obspy Catalog (reference
    util.py:699-764): needs obspy, not ported."""
    _needs_obspy("templateKey2Catalog")


def catalog2Templatekey(cat, fileName=None):
    """obspy Catalog to a template key (reference util.py:812-867): needs
    obspy, not ported."""
    _needs_obspy("catalog2Templatekey")


def inventory2StationKey(inv, starttime, endtime, fileName=None):
    """obspy Inventory to a station key (reference util.py:630-696):
    needs obspy, not ported."""
    _needs_obspy("inventory2StationKey")


# ---------------------------------------------------------------------------
# ANF / hypoinverse-arc catalog readers (reference extras/ANF.py, arc.py)
# ---------------------------------------------------------------------------

ANF_COLUMNS = ["TIME", "NAME", "LAT", "LON", "MAG", "DEPTH"]


def readANF(anfdir, lon1=-180, lon2=180, lat1=-90, lat2=90, getPhases=False,
            UTC1="1960-01-01", UTC2="3000-01-01", Pcodes=("P", "Pg"),
            Scodes=("S", "Sg")):
    """Template-key rows of the ANF (Array Network Facility) .origin files
    under ``anfdir`` inside the box and time range (reference
    extras/ANF.py:16-120)."""
    rows = []
    for f in sorted(glob.glob(os.path.join(anfdir, "**", "*.origin"),
                              recursive=True)):
        with open(f) as fh:
            lines = list(fh)
        for line in lines:
            try:
                lat = float(line[0:9])
                lon = float(line[9:20])
                dep = float(line[20:29])
                ts = float(line[29:46])
                mb = float(line[128:135])
                ml = float(line[143:150])
            except (ValueError, IndexError):
                continue
            if not (lon1 <= lon <= lon2 and lat1 <= lat <= lat2):
                continue
            if not (UTCDateTime(UTC1).timestamp <= ts <=
                    UTCDateTime(UTC2).timestamp):
                continue
            mag = ml if ml > -900 else mb
            name = str(UTCDateTime(ts)).split(".")[0].replace(":", "-")
            rows.append(dict(TIME=name, NAME=name, LAT=lat, LON=lon,
                             MAG=mag, DEPTH=dep))
    return rows


def ANF2TemplateKey(anfdir, fileName="TemplateKey.csv", **kwargs):
    """Write a template key from an ANF catalog directory."""
    rows = readANF(anfdir, **kwargs)
    if fileName:
        _keys.write_csv(fileName, ANF_COLUMNS, rows)
    return rows


def readArc(arcfile):
    """The origin rows and phase rows of a hypoinverse archive ('arc')
    file (reference extras/arc.py: event summary lines followed by
    station phase lines, '$' shadow lines skipped)."""
    events = []
    phases = []
    cur_event = None
    with open(arcfile) as fh:
        lines = list(fh)
    for line in lines:
        if not line.strip() or line.startswith("$"):
            continue
        # summary lines start with a 12+ digit date string
        head = line[:14].replace(" ", "")
        if len(line) > 45 and head[:8].isdigit() and len(head) >= 12:
            try:
                year, month, day = int(line[0:4]), int(line[4:6]), \
                    int(line[6:8])
                hour, minute = int(line[8:10]), int(line[10:12])
                sec = float(line[12:16].replace(" ", "0")) / 100.0
                lat = float(line[16:18]) + \
                    float(line[19:23].replace(" ", "0")) / 100.0 / 60.0
                lon = -(float(line[23:26]) +
                        float(line[27:31].replace(" ", "0")) / 100.0 / 60.0)
                dep = float(line[31:36].replace(" ", "0")) / 100.0
                t = UTCDateTime(year, month, day, hour, minute, 0) + sec
                cur_event = str(t).split(".")[0].replace(":", "-")
                events.append(dict(NAME=cur_event, TIME=cur_event, LAT=lat,
                                   LON=lon, DEPTH=dep, MAG=np.nan))
                continue
            except (ValueError, IndexError):
                pass
        # phase lines: 5-char station + 2-char net at fixed columns
        if cur_event is not None and len(line) > 30 and line[0:5].strip():
            sta = line[0:5].strip()
            net = line[5:7].strip()
            pha = line[14:15].strip() or "P"
            phases.append(dict(Event=cur_event,
                               Station="%s.%s" % (net, sta), Phase=pha,
                               TimeStamp=np.nan))
    return events, phases
