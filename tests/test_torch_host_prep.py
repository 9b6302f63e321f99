"""The engine's chunk preparation in one native pass (construct.prepChunk
on detex_torch/kernels/host_prep.cpp) held bit for bit against the path it
replaces, construct._applyFilter then multiplex (or, with devicePrep, the
float32 channel stack), on the CPU.

The old path is the same engine code with the fused pass refused
(construct._fusedPass monkeypatched to None), so every comparison holds the
whole of _prepChunk, _refilter and _scanChunk: payload, dtype, shape,
sampling rate and start time. Chunks that need a merge, a split of NaN
gaps, a decimation or that come out of the trim with unequal lengths take
the old path and count prep.fallback; a library that cannot be built sends
every chunk there. One case holds the fused pass against detex_tpu's
_applyFilter + multiplex.
"""
import subprocess

import numpy as np
import pytest

from detex_tpu import construct as jcons
from detex_tpu import native as jnative
from detex_tpu.core import Stream as JStream
from detex_tpu.core import Trace as JTrace
from detex_torch import construct as tcons
from detex_torch import detect as tdetect
from detex_torch import host_prep
from detex_torch import native as tnative
from detex_torch import trace
from detex_torch import util as tutil
from detex_torch.core import Stream as TStream
from detex_torch.core import Trace as TTrace

SR = 40.0
T0 = 1238544000.0
N = 6000
CHANS = ("BHE", "BHN", "BHZ")
FILTS = {"none": None, "zerophase": [1, 10, 2, True],
         "one-pass": [1, 10, 4, False]}


@pytest.fixture(scope="module", autouse=True)
def both_libraries():
    if not (tnative.available() and host_prep.available()):
        pytest.skip("the native libraries could not be built here")


def _data(rng, kind, n):
    if kind == "int32":
        return rng.integers(-2 ** 23, 2 ** 23, n).astype(np.int32)
    x = rng.standard_normal(n) * 800.0 + 0.02 * np.arange(n) + 40.0
    return x.astype(kind)


def _stream(kind, nc=3, seed=0, offsets=(0, 3, 7), lens=None, cls=TStream,
            tr_cls=TTrace):
    """nc channels starting ``offsets`` samples apart (and a fraction of a
    sample more on the second), so that _applyFilter's trim cuts each, in
    reverse channel order so that the sort has work to do."""
    rng = np.random.default_rng(seed)
    traces = []
    for c in range(nc):
        n = (lens or [N] * nc)[c]
        hdr = dict(network="XX", station="S1", location="",
                   channel=CHANS[c], sampling_rate=SR,
                   starttime=T0 + offsets[c] / SR + 0.004 * (c == 1))
        traces.append(tr_cls(_data(rng, kind, n), hdr))
    return cls(traces[::-1])


def _engine(filt, dtype, decimate=None):
    """An engine with only what _prepChunk, _refilter and _scanChunk read."""
    eng = object.__new__(tdetect._SSDetex)
    eng.filt, eng.decimate, eng.dtype = filt, decimate, dtype
    eng.fillZeros = False
    eng.dpDec = 1
    return eng


def _refuse(monkeypatch):
    monkeypatch.setattr(tcons, "_fusedPass", lambda *a, **kw: None)


def _counts():
    c = trace.counters()
    return c.get("prep.fused", 0), c.get("prep.fallback", 0)


def _same_payload(got, want, devicePrep):
    (xg, srg, tg, stg), (xw, srw, tw, stw) = got, want
    assert srg == srw and tg == tw
    assert xg.dtype == xw.dtype and xg.shape == xw.shape
    assert np.array_equal(xg, xw)
    if devicePrep:
        assert xg.dtype == np.float32 and xg.ndim == 2
        assert len(stg) == len(stw)
        for a, b in zip(stg, stw):
            assert a.stats.channel == b.stats.channel
            assert a.stats.starttime.timestamp == b.stats.starttime.timestamp
            assert a.stats.npts == b.stats.npts
            assert a.data.dtype == b.data.dtype
            assert np.array_equal(a.data, b.data)
    else:
        assert xg.ndim == 1 and stg is None and stw is None


@pytest.mark.parametrize("nc", [1, 3])
@pytest.mark.parametrize("filt", sorted(FILTS))
@pytest.mark.parametrize("dtype", ["single", "double"])
@pytest.mark.parametrize("kind", ["int32", "float32", "float64"])
def test_prep_chunk_bits_match_old_path(monkeypatch, kind, dtype, filt,
                                        nc):
    """_prepChunk's payload on the host-filter branch (the multiplexed
    chunk) and, with no filter, on the devicePrep branch (the float32
    channel stack and the detrended traces the re-verify re-filters): the
    fused pass's bits, dtype, shape, rate and start time are the old
    path's, one prep.fused a chunk."""
    eng = _engine(FILTS[filt], dtype)
    got = {}
    f0, b0 = _counts()
    for dp in (False, True):
        got[dp] = eng._prepChunk(_stream(kind, nc), "XX.S1", nc, 0, dp)
    assert _counts() == (f0 + 2, b0)
    _refuse(monkeypatch)
    for dp in (False, True):
        want = eng._prepChunk(_stream(kind, nc), "XX.S1", nc, 0, dp)
        _same_payload(got[dp], want, dp)
    if not FILTS[filt]:
        # the old multiplex of the detrended chunk, straight
        mp = tcons.multiplex(tcons._applyFilter(_stream(kind, nc), None,
                                                None, dtype), nc)
        assert np.array_equal(got[False][0], mp)


@pytest.mark.parametrize("corners", [1, 3, 4])
@pytest.mark.parametrize("nc", [2, 5])
def test_other_shapes_match_old_path(nc, corners):
    """Channel counts and filter orders off the unrolled shapes (an even
    count, an odd one past two pairs, one to four sections, zero phase):
    the old path's bits."""
    chans = ("BHE", "BHN", "BHZ", "HHE", "HHN")
    st = TStream([TTrace(_data(np.random.default_rng(c), "int32", N - c),
                         dict(network="XX", station="S1", channel=chans[c],
                              sampling_rate=SR, starttime=T0 + c / SR))
                  for c in range(nc)])
    filt = [1, 10, corners, True]
    got = tcons.prepChunk(st.copy(), nc, filt, None, "single")[0]
    want = tcons.multiplex(tcons._applyFilter(st.copy(), filt, None,
                                              "single"), nc)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("filt", ["zerophase", "one-pass"])
@pytest.mark.parametrize("dtype", ["single", "double"])
def test_refilter_from_device_prep_payload(monkeypatch, dtype, filt):
    """devicePrep's re-verify re-filter from the payload's detrended
    traces (detrended again in float64, band-passed, multiplexed): the old
    path's bits, the payload left as it was, one count a chunk."""
    eng = _engine(FILTS[filt], dtype)
    traces = eng._prepChunk(_stream("int32"), "XX.S1", 3, 0, True)[3]
    before = [tr.data.copy() for tr in traces]
    f0, b0 = _counts()
    got = eng._refilter(traces, 3)
    assert _counts() == (f0 + 1, b0)
    assert all(np.array_equal(a, tr.data)
               for a, tr in zip(before, traces))
    _refuse(monkeypatch)
    want = eng._refilter(traces, 3)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    # and what the reverify computed before: the payload copied, filtered
    old = tcons.multiplex(tcons._applyFilter(
        traces.copy(), FILTS[filt], None, dtype), 3)
    assert np.array_equal(got, old)


@pytest.mark.parametrize("dtype", ["single", "double"])
def test_scan_chunk_prep_matches_old_path(monkeypatch, dtype):
    """The per-chunk path's multiplexed chunk, rate and start time, with a
    tail trim."""
    eng = _engine(FILTS["zerophase"], dtype)
    monkeypatch.setattr(tdetect._ds, "run_bank",
                        lambda MPcon, bank, nc: np.zeros((1, 100)))
    monkeypatch.setattr(tdetect._ds, "ds_numpy",
                        lambda x, U, nc: np.zeros(100))
    det = {"d0": dict(n=30, U=None)}
    out = {}
    for refuse in (False, True):
        if refuse:
            _refuse(monkeypatch)
        out[refuse] = eng._scanChunk(_stream("float64"), det,
                                     [dict(names=["d0"])], 3, "XX.S1",
                                     None, None, tail_trim=12)[1:]
    (a, sra, ta), (b, srb, tb) = out[False], out[True]
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert len(a) == 3 * (N - 7) - 12
    assert sra == srb and ta == tb


def _fragmented():
    st = _stream("float64")
    tr = st[0]
    head, tail = tr.copy(), tr.copy()
    head.data = head.data[:2000]
    head.stats.npts = 2000
    tail.trim(starttime=tr.stats.starttime + 2100 / SR)
    return TStream([head, tail] + st.traces[1:])


def _nan_gap():
    st = _stream("float64")
    st[1].data[3000:3050] = np.nan
    return st


def _short_data():
    """A trace whose data ends 3 samples before its npts says: the trim
    leaves it shorter than the others (multiplex cuts them to it)."""
    st = _stream("int32")
    st[-1].data = st[-1].data[:-3]
    return st


# case -> (stream maker, decimate)
FALLBACKS = {
    "fragmented": (_fragmented, None),
    "nan-gap": (_nan_gap, None),
    "unequal-after-trim": (lambda: _short_data(), None),
    "decimate": (lambda: _stream("float64"), 2),
}


@pytest.mark.parametrize("case", sorted(FALLBACKS))
def test_fallbacks_take_the_old_path(monkeypatch, case):
    """A fragmented stream, NaN gaps, channels of unequal length after
    the trim and a decimation: the old path's result, one prep.fallback
    and no prep.fused."""
    make, dec = FALLBACKS[case]
    if case == "unequal-after-trim":
        old = tcons._applyFilter(make(), None, None, "single")
        assert len(set(len(tr) for tr in old)) == 2
    eng = _engine(FILTS["zerophase"], "single", decimate=dec)
    f0, b0 = _counts()
    got = eng._prepChunk(make(), "XX.S1", 3, 0, False)
    assert _counts() == (f0, b0 + 1)
    _refuse(monkeypatch)
    want = eng._prepChunk(make(), "XX.S1", 3, 0, False)
    _same_payload(got, want, False)


def test_prep_refuses_beyond_its_bounds():
    """More than 16 channels or 16 sections: None (the engine's fallback);
    channels of two lengths or types, or strided: ValueError before any
    pointer is passed."""
    x = [np.arange(100, dtype=np.float64) for _ in range(17)]
    for bad in ([x[0], x[1][:99]], [x[0], x[1].astype(np.float32)],
                [x[0], np.arange(200.0)[::2]], [x[0][:1], x[1][:1]]):
        with pytest.raises(ValueError):
            host_prep.prep(bad, None, True, np.float32, True)
    sos = np.tile([[1.0, 0.0, 0.0, 1.0, 0.0, 0.0]], (17, 1))
    assert host_prep.prep(x, None, True, np.float32, True) is None
    assert host_prep.prep(x[:3], sos, True, np.float32, True) is None
    assert host_prep.prep(x[:3], sos[:16], True, np.float32,
                          True) is not None


def test_library_built_with_native_flags_only(monkeypatch, tmp_path):
    """The library is built by g++ with exactly native.CXX_FLAGS, into the
    build directory under a digest of the source and the flags."""
    calls = []
    real = subprocess.run

    def run(cmd, *a, **kw):
        calls.append(list(cmd))
        return real(cmd, *a, **kw)

    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(host_prep, "_TRIED", False)
    monkeypatch.setattr(host_prep, "_LIB", None)
    assert host_prep.available()
    so = host_prep.library_path()
    assert so.parent == tmp_path / "_build" and so.is_file()
    assert so.name.startswith("libdetex_host_prep_")
    assert len(calls) == 1
    cmd = calls[0]
    assert cmd[0] == "g++"
    assert cmd[1:-3] == list(tnative.CXX_FLAGS)
    assert cmd[-3] == str(host_prep.SOURCE) and cmd[-2] == "-o"
    assert so.name == tnative.library_path(host_prep.SOURCE,
                                           host_prep.STEM).name


@pytest.mark.parametrize("devicePrep", [False, True])
def test_unbuildable_library_falls_back(monkeypatch, tmp_path, devicePrep):
    """Where g++ cannot build the library, every chunk takes
    _applyFilter and multiplex (prep.fallback), with the old path's
    result; with the native host library gone too, its scipy path."""
    eng = _engine(FILTS["zerophase"], "single")
    want = eng._prepChunk(_stream("int32"), "XX.S1", 3, 0, devicePrep)

    def fail(so, source=None):
        raise subprocess.CalledProcessError(1, "g++")

    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tnative, "_build", fail)
    monkeypatch.setattr(host_prep, "_TRIED", False)
    monkeypatch.setattr(host_prep, "_LIB", None)
    assert not host_prep.available()
    f0, b0 = _counts()
    got = eng._prepChunk(_stream("int32"), "XX.S1", 3, 0, devicePrep)
    assert _counts() == (f0, b0 + 1)
    _same_payload(got, want, devicePrep)
    # no native host library either: scipy's filter, as _applyFilter's
    monkeypatch.setattr(tnative, "_TRIED", True)
    monkeypatch.setattr(tnative, "_LIB", None)
    got = eng._prepChunk(_stream("int32"), "XX.S1", 3, 0, devicePrep)
    old = tcons._applyFilter(_stream("int32"), None if devicePrep else
                             FILTS["zerophase"], None, "single")
    if devicePrep:
        assert np.array_equal(got[0], np.stack([tr.data for tr in old]))
    else:
        assert np.array_equal(got[0], tcons.multiplex(old, 3))


@pytest.mark.parametrize("dtype", ["single", "double"])
def test_fused_matches_detex_tpu(dtype):
    """The fused pass against detex_tpu's _applyFilter + multiplex on the
    same chunk (its own native library): the same bits."""
    if not jnative.available():
        pytest.skip("detex_tpu's native library could not be built here")
    filt = [1, 10, 2, True]
    js = _stream("int32", cls=JStream, tr_cls=JTrace)
    want = jcons.multiplex(jcons._applyFilter(js, filt, None, dtype), 3)
    got, stats, _ = tcons.prepChunk(_stream("int32"), 3, filt, None, dtype)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert stats.starttime.timestamp == js[0].stats.starttime.timestamp


# ---------------------------------------------------------------------------
# one engine run a branch, fused against refused
# ---------------------------------------------------------------------------
L = 10000
N_CHUNKS = 5


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    dets = []
    for k in range(2):
        u = rng.standard_normal(600)
        U = (u / np.linalg.norm(u))[None]
        dets.append(dict(name="d%d" % k, U=U, WFs=3.0 * U, mags=[1.0],
                         events=["e%d" % k], offsets=[0.0], threshold=0.3))
    X = np.round(rng.standard_normal((N_CHUNKS, 3 * L)) * 1000.0)
    for b, at in ((1, 2000), (3, 6000)):
        X[b, 3 * at:3 * at + 600] += 150000.0 * dets[0]["U"][0]
    X = X.astype(np.int32)
    stations = {"XX.S1": dict(channels=list(CHANS), sr=25.0,
                              detectors=dets)}

    def chunks(sta):
        for b in range(N_CHUNKS):
            yield TStream([TTrace(X[b, c::3].copy(), dict(
                network="XX", station="S1", channel=CHANS[c],
                sampling_rate=25.0, starttime=1e9 + 400.0 * b))
                for c in range(3)]), None, None
    return stations, chunks


def _engine_run(db, devicePrep):
    stations, chunks = _inputs()
    before = trace.counters()
    hist = tdetect.detex(stations, chunks, str(db), conDatDuration=380.0,
                         conBuff=20.0, filt=[1, 8, 2, True], device="cpu",
                         batchSize=2, devicePrep=devicePrep)
    after = trace.counters()
    delta = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("prep.fused", "prep.fallback", "chunks",
                       "chunks_gated")}
    return hist, tutil.loadSQLite(str(db), "ss_df"), delta


@pytest.mark.parametrize("devicePrep", [False, True])
def test_engine_rows_and_histograms_same_when_refused(monkeypatch, tmp_path,
                                                      devicePrep):
    """detect.detex on the batched path, with and without devicePrep: the
    same SQLite rows and histograms whether the fused pass takes every
    chunk (and every re-filter) or none."""
    h1, r1, c1 = _engine_run(tmp_path / "fused.db", devicePrep)
    assert c1["chunks"] == N_CHUNKS and c1["prep.fallback"] == 0
    refilters = c1["chunks_gated"] if devicePrep else 0
    assert c1["prep.fused"] == N_CHUNKS + refilters
    _refuse(monkeypatch)
    h2, r2, c2 = _engine_run(tmp_path / "old.db", devicePrep)
    assert c2["prep.fused"] == 0
    assert c2["prep.fallback"] == N_CHUNKS + refilters
    assert len(r1) > 0 and repr(r1) == repr(r2)
    assert sorted(h1) == sorted(h2)
    for sta, v in h1.items():
        if sta == "Bins":
            assert np.array_equal(v, h2[sta])
            continue
        for name, counts in v.items():
            assert np.array_equal(counts, h2[sta][name]), (sta, name)


@pytest.mark.parametrize("devicePrep", [False, True])
def test_engine_prepares_every_chunk_through_prep_chunk(monkeypatch,
                                                        tmp_path,
                                                        devicePrep):
    """detect.detex prepares each chunk, and re-filters each triggered
    chunk of a devicePrep scan, by one call of the name detect.prepChunk
    (what a wrap of that name times), one count a call."""
    calls = []
    real = tdetect.prepChunk

    def counted(*a, **kw):
        calls.append(kw.get("mux", True))
        return real(*a, **kw)

    monkeypatch.setattr(tdetect, "prepChunk", counted)
    _, _, c = _engine_run(tmp_path / "counted.db", devicePrep)
    refilters = c["chunks_gated"] if devicePrep else 0
    assert len(calls) == N_CHUNKS + refilters
    assert len(calls) == c["prep.fused"] + c["prep.fallback"]
    assert calls.count(False) == (N_CHUNKS if devicePrep else 0)
