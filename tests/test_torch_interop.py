"""detex_torch's interop.py and quality_check.py on the CPU against
detex_tpu's.

The writers run on the ``synth_case`` keys (tests/conftest.py) and on
summary, relocation, ANF and arc files written here with fixed-width
fields; every file a writer makes is held byte for byte against detex_tpu's
file from the same inputs. The readers' rows are held against detex_tpu's
DataFrames as records (``df.to_dict("records")``): the same columns in
the same order and every value equal, NaN where detex_tpu has NaN.
check_data_quality runs on two copies of the synthetic continuous
directory with one file cut to a quarter hour, and again with
``move_bad=True``: the rows equal detex_tpu's (paths relative to each
copy), the same file moves, and each directory is indexed again without
it. The obspy conversions raise NotImplementedError.
"""
import math
import os
import shutil

import numpy as np
import pandas as pd
import pytest

from detex_tpu import interop as jint
from detex_tpu import quality_check as jqc
from detex_torch import interop as tint
from detex_torch import quality_check as tqc
from detex_torch.data import waveio


def _put(fields, width):
    """A fixed-width line of ``width`` characters with each (column, text)
    of ``fields`` placed at its column."""
    line = [" "] * width
    for col, text in fields:
        line[col:col + len(text)] = list(text)
    return "".join(line)


def _same_value(a, b):
    if isinstance(b, float) and math.isnan(b):
        return isinstance(a, float) and math.isnan(a)
    return type(a) is type(b) and a == b


def same_records(rows, df):
    """``rows`` equal to ``df.to_dict("records")``: columns in order and
    every value equal, NaN as NaN."""
    want = df.to_dict("records")
    assert len(rows) == len(want)
    for r, w in zip(rows, want):
        assert list(r) == list(df.columns)
        for c in w:
            assert _same_value(r[c], w[c]), (c, r[c], w[c])


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


def _both(tmp_path, name, fn_t, fn_j):
    """Run a writer of each package into its own file; return both
    files' bytes."""
    pt, pj = str(tmp_path / ("t_" + name)), str(tmp_path / ("j_" + name))
    fn_t(pt)
    fn_j(pj)
    return _bytes(pt), _bytes(pj)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Summary, relocation, ANF and arc files with fixed-width fields."""
    d = tmp_path_factory.mktemp("interop")
    out = {}
    # hyp2000 summary lines (>= 93 columns; one short line is skipped)
    lines = []
    for k, (lat_m, lon_m, dep) in enumerate(((12.34, 5.5, 7.25),
                                             (0.07, 59.9, 12.0))):
        lines.append(_put([
            (0, "2015031512%02d%02d%02d" % (10 + k, 20 + k, 37 * k)),
            (16, "39"), (19, "%02d" % int(lat_m)),
            (21, "%02d" % int(round(lat_m % 1 * 100))), (23, "111"),
            (27, "%02d" % int(lon_m)),
            (29, "%02d" % int(round(lon_m % 1 * 100))),
            (31, "%3d" % int(dep)), (34, "%02d" % int(dep % 1 * 100)),
            (48, " 0"), (50, "%02d" % (11 + k)), (85, " %d" % k),
            (87, "45"), (89, " 1"), (91, "07")], 100))
    lines.append("short line")
    out["sum2000"] = str(d / "sum2000")
    with open(out["sum2000"], "w") as fh:
        fh.write("\n".join(lines) + "\n")
    # y2k hypo71 summary: one line with hemisphere letters, one without,
    # one with an empty error field
    lines = []
    for k, (latc, lonc, vererr) in enumerate((("", "", "1.2"),
                                              ("S", "E", "0.7"),
                                              ("", "", ""))):
        lines.append(_put([
            (0, "2016071%dT0%d1530" % (k, k)), (20, "%2d" % (38 + k)),
            (22, latc), (23, "%5.2f" % (12.5 + k)), (28, "%4d" % (111 - k)),
            (32, lonc), (33, "%5.2f" % (44.25 - k)),
            (38, "%7.2f" % (6.5 + k)), (52, "%3d" % (12 + k)),
            (55, "%4d" % (90 + 7 * k)), (59, "%5.1f" % (3.5 * k + 1)),
            (64, "%5.2f" % (0.05 * (k + 1))), (69, "%5.1f" % (0.4 + k)),
            (74, "%5s" % vererr)], 80))
    out["hypo71"] = str(d / "hypo71.sum")
    with open(out["hypo71"], "w") as fh:
        fh.write("\n".join(lines) + "\n")
    # UUSS EQsearch summary (years 99 and 07)
    lines = []
    for yr, sec, mag in (("99", "12.34", " 2.1"), ("07", " 5.00", "   3")):
        lines.append(_put([
            (0, yr), (2, "06"), (4, "21"), (7, "13"), (9, "47"),
            (12, sec), (18, "40"), (21, "33.12"), (27, "111"),
            (31, " 2.50"), (37, "  7.25"), (45, mag)], 52))
    out["eqsum"] = str(d / "eqsrchsum")
    with open(out["eqsum"], "w") as fh:
        fh.write("\n".join(lines) + "\n")
    out["reloc"] = str(d / "hypoDD.reloc")
    np.savetxt(out["reloc"], np.array([[1, 40.1, -111.3, 5.0],
                                       [12, 40.25, -111.05, 7.5]]))
    # ANF origins: one inside the box, one outside, one with ml missing
    anf = d / "anf" / "2010"
    anf.mkdir(parents=True)
    lines = []
    for lat, lon, ts, mb, ml in ((40.5, -111.5, 1.3e9, 2.1, 2.4),
                                 (10.0, -111.5, 1.3e9 + 50, 1.0, 1.5),
                                 (41.25, -112.0, 1.3e9 + 99.5, 3.3,
                                  -999.0)):
        lines.append(_put([(0, "%9.4f" % lat), (9, "%11.4f" % lon),
                           (20, "%9.4f" % 8.0), (29, "%17.5f" % ts),
                           (128, "%7.2f" % mb), (143, "%7.2f" % ml)], 160))
    with open(str(anf / "a.origin"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    out["anf"] = str(d / "anf")
    out["arc"] = str(d / "x.arc")
    with open(out["arc"], "w") as fh:
        fh.write("\n".join([
            _put([(0, "201503151210"), (12, "3712"), (16, "39"),
                  (19, "1234"), (23, "111"), (27, " 550"), (31, "  725")],
                 60),
            _put([(0, "S00  TA  BHZ P")], 40),
            "$ shadow line " + "x" * 40,
            _put([(0, "S01  TA  BHZ  S")], 40)]) + "\n")
    return out


def test_kml_writers_byte_identical(synth_case, files, tmp_path):
    tk, sk = synth_case["templateKey"], synth_case["stationKey"]
    cases = [
        ("tem.kml", lambda p: tint.writeKMLFromTemplateKey(tk, p),
         lambda p: jint.writeKMLFromTemplateKey(tk, p)),
        ("tem_rows.kml", lambda p: tint.writeKMLFromTemplateKey(
            pd.read_csv(tk).to_dict("records"), p),
         lambda p: jint.writeKMLFromTemplateKey(pd.read_csv(tk), p)),
        ("sta.kml", lambda p: tint.writeKMLFromStationKey(sk, p),
         lambda p: jint.writeKMLFromStationKey(sk, p)),
        ("df.kml", lambda p: tint.writeKMLFromDF(
            tint.readHypo2000Sum(files["sum2000"]), p),
         lambda p: jint.writeKMLFromDF(
            jint.readHypo2000Sum(files["sum2000"]), p)),
        ("dd.kml", lambda p: tint.writeKMLFromHypDD(files["reloc"], p),
         lambda p: jint.writeKMLFromHypDD(files["reloc"], p)),
        ("eq.kml", lambda p: tint.writeKMLFromEQSearchSum(files["eqsum"], p),
         lambda p: jint.writeKMLFromEQSearchSum(files["eqsum"], p)),
        ("inv.kml", lambda p: tint.writeKMLFromHypInv(files["sum2000"], p),
         lambda p: jint.writeKMLFromHypInv(files["sum2000"], p)),
        ("arc.kml", lambda p: tint.writeKMLFromArcDF(
            [dict(verlon=-111.5, verlat=40.25), dict(verlon=-112.0,
                                                     verlat=39.5)], p),
         lambda p: jint.writeKMLFromArcDF(pd.DataFrame(
             dict(verlon=[-111.5, -112.0], verlat=[40.25, 39.5])), p)),
    ]
    for name, ft, fj in cases:
        got, want = _both(tmp_path, name, ft, fj)
        assert got == want, name
        assert got.count(b"<Placemark>") > 0, name


def test_hypodd_inputs_byte_identical(synth_case, tmp_path):
    tk, sk = synth_case["templateKey"], synth_case["stationKey"]
    for kw in (dict(), dict(useElevations=False), dict(inFt=True)):
        got, want = _both(
            tmp_path, "station.dat",
            lambda p: tint.writeHypoDDStationInput(sk, p, **kw),
            lambda p: jint.writeHypoDDStationInput(sk, p, **kw))
        assert got == want and got.count(b"\n") == 2
    got, want = _both(tmp_path, "event.dat",
                      lambda p: tint.writeHypoDDEventInput(tk, p),
                      lambda p: jint.writeHypoDDEventInput(tk, p))
    assert got == want and got.count(b"\n") == len(pd.read_csv(tk))


def test_hypoinverse_files_byte_identical(synth_case, tmp_path):
    tk, sk = synth_case["templateKey"], synth_case["stationKey"]
    pk = synth_case["phaseKey"]
    for kw in (dict(), dict(fix=2, fixFirstStation=True),
               dict(usePhases=("P", "S"), fix=1)):
        got, want = _both(
            tmp_path, "x.pha",
            lambda p: tint.makeHypoInversePhaseFile(pk, tk, p, **kw),
            lambda p: jint.makeHypoInversePhaseFile(pk, tk, p, **kw))
        assert got == want and len(got) > 200
    got, want = _both(tmp_path, "x.sta",
                      lambda p: tint.makeHypoInverseStationFile(sk, p),
                      lambda p: jint.makeHypoInverseStationFile(sk, p))
    assert got == want and got.count(b"\n") == 6
    # the phase file read back as hypoInverse input
    pha = str(tmp_path / "in.pha")
    tint.makeHypoInversePhaseFile(pk, tk, pha)
    got, want = _both(tmp_path, "hin.kml",
                      lambda p: tint.writeKMLfromHYPInput(pha, p),
                      lambda p: jint.writeKMLfromHYPInput(pha, p))
    assert got == want and got.count(b"<Placemark>") == len(
        pd.read_csv(tk))


def test_nonlinloc_phase_files_byte_identical(synth_case, tmp_path):
    tk, pk = synth_case["templateKey"], synth_case["phaseKey"]
    for kw in (dict(), dict(useS=False), dict(useP=False)):
        got = tint.writePhaseNLL(pk, tk, str(tmp_path / "t"), **kw)
        want = jint.writePhaseNLL(pk, tk, str(tmp_path / "j"), **kw)
        assert [os.path.basename(p) for p in got] == \
            [os.path.basename(p) for p in want]
        assert len(got) == len(pd.read_csv(tk))
        for a, b in zip(got, want):
            assert _bytes(a) == _bytes(b)


def test_summary_readers_match_jax(files):
    rows = tint.readHypo2000Sum(files["sum2000"])
    assert len(rows) == 2
    same_records(rows, jint.readHypo2000Sum(files["sum2000"]))
    rows = tint.readHypo71Sum(files["hypo71"])
    want = jint.readHypo71Sum(files["hypo71"])
    assert len(rows) == 3 and math.isnan(rows[2]["vererr"])
    assert rows[1]["lat"] < 0 < rows[0]["lat"]
    same_records(rows, want)
    same_records(tint._readEQSearchSum(files["eqsum"]),
                 jint._readEQSearchSum(files["eqsum"]))


def test_fixed_width_reader_types_as_pandas(tmp_path):
    path = str(tmp_path / "fw.txt")
    with open(path, "w") as fh:
        fh.write("  12 3.5 ab  \n\n 7   x  cd 1\n   -4 1e3   \n")
    specs, names = [(0, 4), (4, 8), (8, 12), (12, 14)], list("abcd")
    _, rows = tint.read_fwf(path, specs, names)
    same_records(rows, pd.read_fwf(path, colspecs=specs, names=names))


def test_catalog_readers_and_writers_match_jax(files, tmp_path):
    got, want = _both(tmp_path, "eq.csv",
                      lambda p: tint.EQSearch2TemplateKey(files["eqsum"], p),
                      lambda p: jint.EQSearch2TemplateKey(files["eqsum"], p))
    assert got == want and got.count(b"\n") == 3
    rows = tint.readANF(files["anf"], lat1=30, lat2=50)
    assert len(rows) == 2
    same_records(rows, jint.readANF(files["anf"], lat1=30, lat2=50))
    got, want = _both(tmp_path, "anf.csv",
                      lambda p: tint.ANF2TemplateKey(files["anf"], p),
                      lambda p: jint.ANF2TemplateKey(files["anf"], p))
    assert got == want
    ev_t, ph_t = tint.readArc(files["arc"])
    ev_j, ph_j = jint.readArc(files["arc"])
    assert len(ev_t) == 1 and len(ph_t) == 2
    same_records(ev_t, ev_j)
    same_records(ph_t, ph_j)


def test_obspy_conversions_raise():
    with pytest.raises(NotImplementedError):
        tint.templateKey2Catalog("TemplateKey.csv")
    with pytest.raises(NotImplementedError):
        tint.catalog2Templatekey(None)
    with pytest.raises(NotImplementedError):
        tint.inventory2StationKey(None, 0, 1)


def _copies(synth_case, tmp_path, tag):
    """Two copies of the synthetic continuous directory (one a package),
    without their index, with the same file cut to its first 900 s."""
    out = []
    for pkg in ("t", "j"):
        d = str(tmp_path / ("%s_%s" % (tag, pkg)))
        shutil.copytree(synth_case["conDir"], d)
        os.remove(os.path.join(d, ".index.db"))
        out.append(d)
    victim = None
    for root, _, names in sorted(os.walk(out[0])):
        for n in sorted(names):
            if n.endswith(".npz") and "T05" in n:
                victim = os.path.relpath(os.path.join(root, n), out[0])
                break
        if victim:
            break
    for d in out:
        path = os.path.join(d, victim)
        st = waveio.read(path)
        st.trim(endtime=st[0].stats.starttime + 900.0)
        os.remove(path)
        waveio.write_stream(st, path)
    return out[0], out[1], victim


def _relative(rows, root):
    return [dict(r, Path=os.path.relpath(r["Path"], root)) for r in rows]


@pytest.mark.parametrize("move_bad", [False, True])
def test_check_data_quality_matches_jax(synth_case, tmp_path, move_bad):
    dt, dj, victim = _copies(synth_case, tmp_path, "q")
    got = tqc.check_data_quality(dt, move_bad=move_bad)
    want = jqc.check_data_quality(dj, move_bad=move_bad)
    want["Path"] = [os.path.relpath(p, dj) for p in want["Path"]]
    same_records(_relative(got, dt), want)
    bad = [r for r in got if not r["ok"]]
    assert [os.path.join(os.path.relpath(r["Path"], dt), r["FileName"])
            for r in bad] == [victim]
    assert not bad[0]["duration_ok"] and bad[0]["gaps_ok"]
    assert len(got) == 2 * 20
    if move_bad:
        for d in (dt, dj):
            assert sorted(os.listdir(d + "_bad")) == \
                [os.path.basename(victim)]
            assert not os.path.exists(os.path.join(d, victim))
        again = tqc.check_data_quality(dt)
        assert len(again) == len(got) - 1 and all(r["ok"] for r in again)


def test_check_data_quality_rules_match_jax(tmp_path):
    """A one-sample file (zero duration) fails the gap check, and without
    expected_nc the channel count is the smallest of the most frequent
    counts (two files of 2 channels, two of 3)."""
    from detex_torch.core import Stream, Trace
    for pkg in ("t", "j"):
        d = tmp_path / pkg / "XX.S1"
        d.mkdir(parents=True)
        for k, (nc, npts) in enumerate(((3, 900), (2, 900), (3, 880),
                                        (2, 1), (1, 900))):
            st = Stream([Trace(np.arange(npts, dtype=np.float64) * (c + 1),
                               dict(network="XX", station="S1",
                                    channel="BH" + "ZNE"[c],
                                    sampling_rate=10.0,
                                    starttime=1e9 + 100.0 * k))
                         for c in range(nc)])
            waveio.write_stream(st, str(d / ("f%d" % k)))
    got = tqc.check_data_quality(str(tmp_path / "t"))
    want = jqc.check_data_quality(str(tmp_path / "j"))
    want["Path"] = [os.path.relpath(p, str(tmp_path / "j"))
                    for p in want["Path"]]
    same_records(_relative(got, str(tmp_path / "t")), want)
    assert [r["nc_ok"] for r in got] == [False, True, False, True, False]
    assert [r["gaps_ok"] for r in got] == [True, True, True, False, True]


def test_quality_helpers_match_jax(synth_case):
    path = None
    for root, _, names in sorted(os.walk(synth_case["conDir"])):
        npz = sorted(n for n in names if n.endswith(".npz"))
        if npz:
            path = os.path.join(root, npz[0])
            break
    assert tqc.checkQuality(path) == jqc.checkQuality(path)
    got = [u.timestamp for u in tqc.divideIntoHours("2009-04-01T00-30-00",
                                                    "2009-04-01T05-00-00")]
    want = [u.timestamp for u in jqc.divideIntoHours("2009-04-01T00-30-00",
                                                     "2009-04-01T05-00-00")]
    assert got == want and len(got) == 6
