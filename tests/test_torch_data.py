"""detex_torch's data layer on the CPU against detex_tpu's: the synthetic
Case1 catalog, the key files, the npz waveform files, the directory index
and the 'dir' fetcher's chunks.

Both packages' SynthCatalog at the ``synth_case`` parameters of
tests/conftest.py write their directories side by side. Held bit for bit:
the catalog (events, hidden events, travel times, source wavelets), every
written array, the index tables of one directory indexed by each package,
and the chunks of getTemData and getConData (plain, trimmed to utcstart /
utcend, and the seeded random draw FAS takes its null from), read with
both packages' scipy filters (their native libraries switched off: the
detrend of getStream is scipy's in both). The key CSVs are byte-identical. The
port's readKey keeps pandas' column typing and its NaN for empty cells.
"""
import filecmp
import os
import sqlite3

import numpy as np
import pandas as pd
import pytest

from detex_tpu import native as jnative
from detex_tpu.core.stream import Stream as JStream
from detex_tpu.core.stream import Trace as JTrace
from detex_tpu.data import fetcher as jfetch
from detex_tpu.data import keys as jkeys
from detex_tpu.data import synth as jsynth
from detex_tpu.data import waveio as jwaveio
from detex_torch import native as tnative
from detex_torch.core import Stream as TStream
from detex_torch.core import Trace as TTrace
from detex_torch.data import fetcher as tfetch
from detex_torch.data import keys as tkeys
from detex_torch.data import synth as tsynth
from detex_torch.data import waveio as twaveio

SYNTH = dict(n_sources=2, events_per_source=3, n_singles=1, n_stations=2,
             sr=25.0, span_hours=20, seed=1, noise=0.04)
HIDDEN = dict(n=2, mag=1.4, sources=[0, 1])


@pytest.fixture(scope="module")
def cats(tmp_path_factory):
    root = tmp_path_factory.mktemp("tdata")
    out = {}
    for tag, mod in (("j", jsynth), ("t", tsynth)):
        cat = mod.SynthCatalog(**SYNTH)
        cat.add_hidden_events(**HIDDEN)
        out[tag] = (cat, cat.write_directories(str(root / tag), tb4=10,
                                               taft=60))
    return out


@pytest.fixture()
def scipy_filters(monkeypatch):
    """Both packages' host filters on scipy (their native libraries
    off)."""
    for lib in (jnative, tnative):
        monkeypatch.setattr(lib, "_TRIED", True)
        monkeypatch.setattr(lib, "_LIB", None)


def _same_streams(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.id == y.id
        assert x.stats.sampling_rate == y.stats.sampling_rate
        assert x.stats.starttime.timestamp == y.stats.starttime.timestamp
        assert x.data.dtype == y.data.dtype
        np.testing.assert_array_equal(x.data, y.data)


def test_synth_catalog_matches_jax(cats):
    (jc, jp), (tc, tp) = cats["j"], cats["t"]
    assert tc.events == jc.events and tc.hidden == jc.hidden
    assert tc.ttimes == jc.ttimes and tc.t0 == jc.t0
    assert sorted(tc.sources) == sorted(jc.sources)
    for k, waves in jc.sources.items():
        for a, b in zip(tc.sources[k], waves):
            np.testing.assert_array_equal(a, b)
    n = 0
    for sub in ("eventDir", "conDir"):
        for dirpath, _, files in os.walk(jp[sub]):
            for f in files:
                if f.startswith("."):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, f), jp["root"])
                with np.load(os.path.join(jp["root"], rel)) as a, \
                        np.load(os.path.join(tp["root"], rel)) as b:
                    assert sorted(a.files) == sorted(b.files)
                    for x in a.files:
                        assert a[x].dtype == b[x].dtype
                        np.testing.assert_array_equal(a[x], b[x])
                n += 1
    assert n == 14 + 40


def test_key_files_byte_identical_and_parse_equal(cats):
    """The port writes each key CSV byte for byte as pandas' to_csv does,
    and its readKey gives detex_tpu's rows (values and order)."""
    jp, tp = cats["j"][1], cats["t"][1]
    for key, kind in (("templateKey", "template"), ("stationKey", "station"),
                      ("phaseKey", "phases"), ("veriFile", "template")):
        assert filecmp.cmp(jp[key], tp[key], shallow=False), key
        want = jkeys.readKey(jp[key], kind).to_dict("records")
        got = tkeys.readKey(tp[key], kind)
        assert [list(r) for r in got] == [list(r) for r in want]
        for g, w in zip(got, want):
            for c in w:
                assert type(g[c]) is type(w[c]) or (
                    isinstance(g[c], float) and isinstance(w[c], float)), c
                assert g[c] == w[c], (key, c)


def test_read_key_keeps_pandas_types_and_nan(tmp_path):
    """A numeric-looking STATION / NETWORK is read as an int and then made
    str ("0042" -> "42"); an empty cell is NaN (never ""), so the
    empty-string filter drops nothing; rows sort as pandas sorts them,
    NaN last; long decimals parse as pandas parses them."""
    path = tmp_path / "StationKey.csv"
    path.write_text(
        "NETWORK,STATION,STARTTIME,ENDTIME,LAT,LON,ELEVATION,CHANNELS\n"
        "07,0042,2009-04-01T00-00-00,2009-04-02T00-00-00,40.5,-111.2,2000,"
        "BHE-BHN-BHZ\n"
        "07,0042,2009-04-01T00-00-00,2009-04-02T00-00-00,,-111.2,,BHZ\n"
        "07,0009,2009-04-01T00-00-00,2009-04-02T00-00-00,40.6,-111.2,2100,"
        "BHZ\n"
        "07,0042,2009-03-01T00-00-00,,40.5,-111.2,1990,BHZ\n")
    want = jkeys.readKey(str(path), "station").to_dict("records")
    got = tkeys.readKey(str(path), "station")
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for c in w:
            if isinstance(w[c], float) and np.isnan(w[c]):
                assert isinstance(g[c], float) and np.isnan(g[c])
            else:
                assert g[c] == w[c] and type(g[c]) is type(w[c]), c
    # sorted by CHANNELS, then ELEVATION (1990, 2100, NaN last), ...
    assert [r["STATION"] for r in got] == ["42", "42", "9", "42"]
    assert np.isnan(got[3]["ELEVATION"]) and np.isnan(got[3]["LAT"])
    assert got[0]["NETWORK"] == "7"
    assert any(isinstance(r["ELEVATION"], float) and np.isnan(r["ELEVATION"])
               for r in got)
    rng = np.random.default_rng(5)
    words = ["%.*f" % (int(rng.integers(0, 12)), x) for x in
             rng.uniform(1.2e9, 1.3e9, 300)] + \
        [repr(float(x)) for x in rng.standard_normal(300) * 1e3] + \
        ["%.9e" % x for x in rng.standard_normal(100)]
    csv = tmp_path / "p.csv"
    csv.write_text("A\n" + "\n".join(words) + "\n")
    want = pd.read_csv(csv).A.to_numpy()
    got = np.array([r["A"] for r in tkeys.read_csv(str(csv))[1]])
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))


def test_npz_files_read_across_packages(tmp_path):
    """Each package reads the other's npz files: every trace's data,
    dtype, ids, rate and start time."""
    rng = np.random.default_rng(3)
    hdr = [dict(network="TA", station="S9", location="", channel=c,
                sampling_rate=40.0, starttime=1.2e9 + 0.125) for c in
           ("BHE", "BHN", "BHZ")]
    data = [rng.standard_normal(500), rng.standard_normal(500).astype(
        np.float32), np.arange(500, dtype=np.int32)]
    jst = JStream([JTrace(d.copy(), dict(h)) for d, h in zip(data, hdr)])
    tst = TStream([TTrace(d.copy(), dict(h)) for d, h in zip(data, hdr)])
    jst.write(str(tmp_path / "j.npz"), "npz")
    tst.write(str(tmp_path / "t"), "npz")
    _same_streams(twaveio.read(str(tmp_path / "j.npz")),
                  jwaveio.read(str(tmp_path / "j.npz")))
    _same_streams(jwaveio.read(str(tmp_path / "t.npz")),
                  twaveio.read(str(tmp_path / "t.npz")))
    _same_streams(twaveio.read(str(tmp_path / "t")), tst)
    assert twaveio.read(str(tmp_path / "missing.npz")) is None
    with pytest.raises(NotImplementedError, match="obspy"):
        tst.write(str(tmp_path / "x.sac"), "sac")


def _tables(db):
    con = sqlite3.connect(db)
    try:
        return {t: (con.execute('PRAGMA table_info("%s")' % t).fetchall(),
                    con.execute('SELECT * FROM "%s"' % t).fetchall())
                for t in ("ind", "indkey")}
    finally:
        con.close()


@pytest.mark.parametrize("sub", ["eventDir", "conDir"])
def test_index_tables_equal(cats, sub):
    """indexDirectory of one directory by each package: the same 'ind' and
    'indkey' tables, declared types and rows in order."""
    d = cats["t"][1][sub]
    db = os.path.join(d, ".index.db")
    jfetch.indexDirectory(d)
    want = _tables(db)
    tfetch.indexDirectory(d)
    got = _tables(db)
    assert got == want
    assert len(got["ind"][1]) == (14 if sub == "eventDir" else 40)


@pytest.mark.parametrize("phases", [False, True])
def test_get_tem_data_matches_jax(cats, scipy_filters, phases):
    jp, tp = cats["j"][1], cats["t"][1]
    jf = jfetch.DataFetcher("dir", directoryName=jp["eventDir"])
    tf = tfetch.DataFetcher("dir", directoryName=tp["eventDir"])
    kw = lambda p: dict(phases=p["phaseKey"]) if phases else {}
    got = list(tf.getTemData(tp["templateKey"], tp["stationKey"], 10, 50,
                             **kw(tp)))
    want = list(jf.getTemData(jp["templateKey"], jp["stationKey"], 10, 50,
                              **kw(jp)))
    assert [n for _, n in got] == [n for _, n in want] and len(got) == 14
    for (a, _), (b, _) in zip(got, want):
        _same_streams(a, b)


CON_CASES = {
    "all": dict(),
    "trimmed": dict(utcstart="2009-04-01T03-30-00",
                    utcend="2009-04-01T09-10-00"),
    "draw16": dict(randSamps=16),
    "draw4": dict(randSamps=4, utcstart="2009-04-01T00-00-00",
                  utcend="2009-04-01T20-00-00"),
    "draw-past-a-quarter": dict(randSamps=6),
}


@pytest.mark.parametrize("case", sorted(CON_CASES))
def test_get_con_data_matches_jax(cats, scipy_filters, case):
    """getConData's chunks in the same order, bit for bit: the station
    key's span, a utcstart / utcend window (the last chunk trimmed at
    utcend), and the seeded random draws (randSamps 4 of 20 hours; 6 and
    16, more than a quarter, which take every hour in a seeded order)."""
    jp, tp = cats["j"][1], cats["t"][1]
    jf = jfetch.DataFetcher("dir", directoryName=jp["conDir"])
    tf = tfetch.DataFetcher("dir", directoryName=tp["conDir"])
    kw = CON_CASES[case]
    got = list(tf.getConData(tp["stationKey"], returnTimes=True, **kw))
    want = list(jf.getConData(jkeys.readKey(jp["stationKey"], "station"),
                              returnTimes=True, **kw))
    assert len(got) == len(want) > 0
    for (a, a1, a2), (b, b1, b2) in zip(got, want):
        assert (a1.timestamp, a2.timestamp) == (b1.timestamp, b2.timestamp)
        _same_streams(a, b)
    if case == "draw4":
        assert len(got) == 2 * 4
    if case == "trimmed":
        assert got[-1][0][0].stats.endtime.timestamp <= \
            tfetch.UTCDateTime("2009-04-01T09-10-00").timestamp


@pytest.mark.parametrize("edge", ["head", "tail"])
def test_sliver_rule_at_both_edges(cats, edge):
    """A file reaching past one edge of a request is kept when it covers
    at least 10% of the request inside it, dropped below that (the hour
    files are 3720 s, so hours overlap by 120 s); both packages load the
    same files."""
    tp = cats["t"][1]
    jf = jfetch.DataFetcher("dir", directoryName=tp["conDir"])
    tf = tfetch.DataFetcher("dir", directoryName=tp["conDir"])
    t0 = tfetch.UTCDateTime("2009-04-01T05-00-00").timestamp
    span = 1000.0
    for inside, kept in ((101.0, True), (99.0, False)):
        if edge == "head":       # hour 5 ends `inside` s past the start
            t1 = t0 + 3720.0 - inside
        else:                    # hour 7 starts `inside` s before the end
            t1 = t0 + 2 * 3600.0 + inside - span
        st_t = tfetch._loadDirectoryData(tf, t1, t1 + span, "TA", "S00",
                                         ["BH?"], "??")
        st_j = jfetch._loadDirectoryData(jf, t1, t1 + span, "TA", "S00",
                                         ["BH?"], "??")
        starts = sorted({tr.stats.starttime.timestamp for tr in st_t})
        assert starts == sorted({tr.stats.starttime.timestamp
                                 for tr in st_j})
        edge_file = t0 if edge == "head" else t0 + 2 * 3600.0
        assert (edge_file in starts) == kept, (edge, inside, starts)


def test_merge_positional_method_does_not_fill_with_one():
    """merge(1): method 1, gaps NaN (split() recovers the segments), as
    detex_tpu's merge(1); merge(1, fill_value=0.0) fills with zeros."""
    hdr = dict(network="TA", station="S1", channel="BHZ", sampling_rate=10.0)
    parts = [(0.0, np.arange(1.0, 11.0)), (2.0, np.arange(21.0, 26.0))]

    def make(S, T):
        return S([T(d.copy(), dict(hdr, starttime=1e9 + t)) for t, d in
                  parts])
    got = make(TStream, TTrace).merge(1)
    want = make(JStream, JTrace).merge(1)
    assert len(got) == 1
    np.testing.assert_array_equal(got[0].data, want[0].data)
    assert np.isnan(got[0].data[10:20]).all() and 1.0 not in \
        got[0].data[10:20]
    assert [len(t) for t in got.split()] == [10, 5]
    filled = make(TStream, TTrace).merge(1, fill_value=0.0)
    assert (filled[0].data[10:20] == 0.0).all()
    assert make(TStream, TTrace).get_gaps() == \
        make(JStream, JTrace).get_gaps()


def test_client_methods_and_downloads_raise(tmp_path):
    """The obspy client methods and makeDataDirectories need a network;
    the port refuses them, and a missing directory."""
    for method in ("iris", "client", "neic", "uuss", "ewave"):
        with pytest.raises(NotImplementedError, match="obspy"):
            tfetch.DataFetcher(method)
    with pytest.raises(NotImplementedError):
        tfetch.quickFetch("iris")
    with pytest.raises(NotImplementedError):
        tfetch.makeDataDirectories()
    with pytest.raises(Exception):
        tfetch.quickFetch(str(tmp_path / "nothing"))
