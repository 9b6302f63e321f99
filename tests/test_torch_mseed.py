"""detex_torch's native host library (native.py) and miniSEED codec
(data/mseed.py, waveio) held against detex_tpu's and against scipy.

Each bound function of the port's build of native/detex_host.cpp gives
the same bits as detex_tpu.native on the same inputs, and the filters
stay within 1e-9 of scipy (tests/test_native.py's cases). The miniSEED
cases are tests/test_mseed.py's on the port: round trips per encoding,
multi-record STEIM1 / STEIM2, oversize STEIM2 differences, gaps, the
hand-built STEIM2 vector, INT16 and little-endian records, fractional
rates, unsupported records and the directory fetcher; across the
packages, files detex_tpu writes read identically in the port, and the
port writes the same bytes as detex_tpu.
"""
import os
import struct

import numpy as np
import pytest
from scipy import signal as sig

from detex_tpu import native as jnative
from detex_tpu.core.stream import Stream as JStream
from detex_tpu.core.stream import Trace as JTrace
from detex_tpu.data import mseed as jmseed
from detex_torch import native as tnative
from detex_torch.core import Stream, Trace
from detex_torch.core.utc import UTCDateTime
from detex_torch.data import mseed, waveio


@pytest.fixture(scope="module", autouse=True)
def both_libraries():
    if not (tnative.available() and jnative.available()):
        pytest.skip("the native library could not be built here")


def _sos():
    return sig.iirfilter(2, [0.05, 0.4], btype="band", ftype="butter",
                         output="sos")


def test_build_lands_in_the_ports_directory(monkeypatch, tmp_path):
    """A fresh build goes to the port's build directory under a digest of
    the source and flags, through a temporary name; detex_tpu's
    native/libdetex_host.so is neither written nor read."""
    theirs = os.path.join(os.path.dirname(str(tnative.SOURCE)),
                          "libdetex_host.so")
    before = os.stat(theirs).st_mtime_ns if os.path.exists(theirs) else None
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tnative, "_TRIED", False)
    monkeypatch.setattr(tnative, "_LIB", None)
    assert tnative.available()
    so = tnative.library_path()
    assert so.parent == tmp_path / "_build" and so.is_file()
    assert [p.name for p in so.parent.iterdir()] == [so.name]
    assert str(tnative._LIB._name) == str(so)
    after = os.stat(theirs).st_mtime_ns if os.path.exists(theirs) else None
    assert before == after
    default = os.path.join(os.path.dirname(tnative.__file__), "kernels",
                           "_build")
    monkeypatch.undo()
    assert str(tnative.library_path().parent) == default


def test_filters_same_bits_as_jax_and_near_scipy():
    """sosfilt (one pass and zero phase), detrend_linear, interleave,
    prep_chunk and rolling_std: detex_tpu's bits, scipy within 1e-9
    (the detrend and the fused prep 1e-8, as tests/test_native.py)."""
    rng = np.random.default_rng(42)
    sos = _sos()
    x = rng.standard_normal(5000)
    for zp in (False, True):
        got = tnative.sosfilt(sos, x, zerophase=zp)
        assert np.array_equal(got, jnative.sosfilt(sos, x, zerophase=zp))
        want = sig.sosfilt(sos, x)
        if zp:
            want = sig.sosfilt(sos, want[::-1])[::-1]
        assert np.abs(got - want).max() <= 1e-9
    y = rng.standard_normal(1000) + np.linspace(-5, 13, 1000)
    got = tnative.detrend_linear(y)
    assert np.array_equal(got, jnative.detrend_linear(y))
    assert np.abs(got - sig.detrend(y, type="linear")).max() <= 1e-8
    chans = rng.standard_normal((3, 100))
    assert np.array_equal(tnative.interleave(chans), chans.flatten("F"))
    chans = rng.standard_normal((3, 2000)) + 3.0
    got = tnative.prep_chunk(chans, sos, zerophase=True)
    assert np.array_equal(got, jnative.prep_chunk(chans, sos, True))
    want = np.vstack([sig.sosfilt(sos, sig.sosfilt(sos, sig.detrend(
        c, type="linear"))[::-1])[::-1] for c in chans]).flatten("F")
    assert np.abs(got - want).max() <= 1e-8
    z = rng.standard_normal(500)
    got = tnative.rolling_std(z, 50)
    assert np.array_equal(got, jnative.rolling_std(z, 50))
    from detex_torch.ops.rolling import rolling_std
    assert np.abs(got - rolling_std(z, 50)).max() <= 1e-10


def test_steim_encoders_and_record_decoder_same_bits_as_jax(tmp_path):
    """steim1_encode / steim2_encode give detex_tpu's frames, and
    mseed_record decodes a record as detex_tpu's does."""
    rng = np.random.default_rng(3)
    x = np.cumsum(rng.integers(-3000, 3000, 4000)).astype(np.int32)
    for name in ("steim1_encode", "steim2_encode"):
        got = getattr(tnative, name)(x, 63)
        assert got == getattr(jnative, name)(x, 63)
        assert got[0] > 0
    p = str(tmp_path / "j.msd")
    jmseed.write_mseed(JStream(traces=[JTrace(x.astype(np.float64), dict(
        network="TA", station="S01", location="", channel="BHZ",
        sampling_rate=100.0, starttime=1262304000.0))]), p,
        encoding="STEIM2")
    with open(p, "rb") as fh:
        buf = fh.read()
    a = tnative.mseed_record(buf, 0)
    b = jnative.mseed_record(buf, 0)
    assert a[:4] == b[:4] and np.array_equal(a[4], b[4])


def _stream(rng, n=5000, sr=100.0, t0=1262304000.0, kind="int"):
    if kind == "int":
        data = np.cumsum(rng.integers(-300, 300, size=n)).astype(
            np.float64)
    else:
        data = rng.standard_normal(n)
    return Stream([Trace(data, dict(network="TA", station="S01",
                                    location="", channel="BHZ",
                                    sampling_rate=sr, starttime=t0))])


@pytest.mark.parametrize("enc", ["STEIM1", "STEIM2", "INT32", "FLOAT32",
                                 "FLOAT64"])
def test_roundtrip(tmp_path, enc):
    st = _stream(np.random.default_rng(42))
    p = str(tmp_path / ("x_%s.msd" % enc))
    mseed.write_mseed(st, p, encoding=enc, reclen=512)
    tr = mseed.read_mseed(p)
    assert len(tr) == 1
    tr = tr[0]
    assert tr.stats.station == "S01" and tr.stats.channel == "BHZ"
    assert tr.stats.sampling_rate == 100.0
    assert abs(tr.stats.starttime.timestamp - 1262304000.0) < 1e-4
    assert np.array_equal(tr.data, st[0].data)


@pytest.mark.parametrize("enc", ["STEIM1", "STEIM2"])
def test_big_steim_multi_record(tmp_path, enc):
    """Many records and every packing class: 200,000 samples of wide
    dynamic range (32-bit diffs) in STEIM1, the 4- to 30-bit classes in
    STEIM2 at 512-byte records."""
    if enc == "STEIM1":
        rng = np.random.default_rng(42)
        data = np.cumsum(rng.integers(-40000, 40000, size=200000)).astype(
            np.float64)
        data[1000:1100] += 2 ** 28
        reclen = 4096
    else:
        r2 = np.random.default_rng(77)
        data = np.concatenate([
            np.cumsum(r2.integers(-6, 6, size=3000)),
            np.cumsum(r2.integers(-100, 100, size=3000)),
            np.cumsum(r2.integers(-12000, 12000, size=3000)),
            np.cumsum(r2.integers(-2 ** 27, 2 ** 27, size=300))]).astype(
                np.float64)
        reclen = 512
    st = Stream([Trace(data, dict(network="UU", station="ABCDE",
                                  location="01", channel="EHZ",
                                  sampling_rate=40.0,
                                  starttime=1400000000.0))])
    p = str(tmp_path / "big.msd")
    mseed.write_mseed(st, p, encoding=enc, reclen=reclen)
    got = mseed.read_mseed(p)
    assert len(got) == 1 and np.array_equal(got[0].data, data)
    assert got[0].stats.location == "01"


def test_steim2_rejects_oversize_diffs(tmp_path):
    data = np.zeros(100, np.float64)
    data[50] = 2 ** 30 + 5
    st = Stream([Trace(data, dict(network="UU", station="S3",
                                  channel="EHZ", sampling_rate=40.0,
                                  starttime=1400000000.0))])
    with pytest.raises(ValueError):
        mseed.write_mseed(st, str(tmp_path / "bad2.msd"), encoding="STEIM2")


def test_gap_splits_traces(tmp_path):
    rng = np.random.default_rng(42)
    p1, p2 = str(tmp_path / "a.msd"), str(tmp_path / "b.msd")
    mseed.write_mseed(_stream(rng, n=3000), p1, encoding="STEIM1",
                      reclen=512)
    mseed.write_mseed(_stream(rng, n=2000, t0=1262304000.0 + 40.0), p2,
                      encoding="STEIM1", reclen=512)
    with open(p1, "ab") as fh, open(p2, "rb") as fb:
        fh.write(fb.read())
    got = mseed.read_mseed(p1)
    assert [len(t.data) for t in got] == [3000, 2000]


def test_steim2_handbuilt_vector(tmp_path):
    """A hand-assembled STEIM2 record: one frame with 30-bit, 2x15-bit,
    3x10-bit, 7x4-bit and 4x8-bit difference words."""
    x0 = 1000
    diffs = [0, -5, 7, 100, -200, 300, 1, -2, 3, -4, 5, -6, 7, 120, -120,
             99, -99]
    samples = [x0]
    for d in diffs[1:]:
        samples.append(samples[-1] + d)
    words = [x0 & 0xffffffff, samples[-1] & 0xffffffff,
             (1 << 30) | (diffs[0] & 0x3fffffff),
             (2 << 30) | ((diffs[1] & 0x7fff) << 15) | (diffs[2] & 0x7fff),
             (3 << 30) | ((diffs[3] & 0x3ff) << 20) |
             ((diffs[4] & 0x3ff) << 10) | (diffs[5] & 0x3ff)]
    nibs = [0, 0, 2, 2, 2]
    w = 2 << 30
    for j, d in enumerate(diffs[6:13]):
        w |= (d & 0xf) << (4 * (6 - j))
    words.append(w)
    nibs.append(3)
    w = 0
    for d in diffs[13:17]:
        w = (w << 8) | (d & 0xff)
    words.append(w)
    nibs.append(1)
    while len(words) < 15:
        words.append(0)
        nibs.append(0)
    w0 = 0
    for j, c in enumerate(nibs):
        w0 |= c << (2 * (14 - j))
    frame = struct.pack(">16I", w0, *[w & 0xffffffff for w in words])
    hdr = struct.pack(
        ">6scc5s2s3s2sHHBBBxHHhhBBBBlHH",
        b"000001", b"D", b" ", b"TEST ", b"  ", b"BHZ", b"XX",
        2020, 100, 12, 30, 15, 0, len(samples), 50, 1, 0, 0, 0, 1, 0,
        64, 48)
    b1000 = struct.pack(">HHBBBx", 1000, 0, 11, 1, 9)
    rec = hdr + b1000 + b"\x00" * (64 - len(hdr) - len(b1000)) + frame
    rec += b"\x00" * (512 - len(rec))
    p = str(tmp_path / "s2.msd")
    with open(p, "wb") as fh:
        fh.write(rec)
    st = mseed.read_mseed(p)
    assert len(st) == 1 and st[0].stats.station == "TEST"
    assert st[0].stats.sampling_rate == 50.0
    assert np.array_equal(st[0].data, np.asarray(samples, np.float64))


def test_int16_and_little_endian_records(tmp_path):
    samples = [100, -200, 300, -400, 32000, -32000]

    def rec(le):
        e = "<" if le else ">"
        hdr = struct.pack(
            e + "6scc5s2s3s2sHHBBBxHHhhBBBBlHH",
            b"000001", b"D", b" ", b"S02  ", b"  ", b"BHN", b"XX",
            2015, 200, 6, 7, 8, 1234, len(samples), 25, 1,
            0, 0, 0, 1, 0, 64, 48)
        b1000 = struct.pack(e + "HHBBBx", 1000, 0, 1, 0 if le else 1, 8)
        body = struct.pack(e + "%dh" % len(samples), *samples)
        r = hdr + b1000 + b"\x00" * (64 - len(hdr) - len(b1000)) + body
        return r + b"\x00" * (256 - len(r))

    for le in (False, True):
        p = str(tmp_path / ("i16_%d.msd" % le))
        with open(p, "wb") as fh:
            fh.write(rec(le))
        st = mseed.read_mseed(p)
        assert len(st) == 1, le
        assert np.array_equal(st[0].data, np.asarray(samples, np.float64))
        assert st[0].stats.sampling_rate == 25.0
        assert abs(st[0].stats.starttime.timestamp % 1 - 0.1234) < 1e-6


def test_fractional_rate_and_lossless_default(tmp_path):
    """40.5 Hz through the rational factor form (an irrational rate
    raises); float data written without an encoding is lossless."""
    st = _stream(np.random.default_rng(42), n=20000, sr=40.5)
    p = str(tmp_path / "sr.msd")
    mseed.write_mseed(st, p, encoding="STEIM1", reclen=512)
    assert mseed.read_mseed(p)[0].stats.sampling_rate == 40.5
    with pytest.raises(ValueError):
        mseed._rate_factors(np.pi)
    data = np.sin(np.arange(4000) * 0.01) * 0.7
    st = Stream([Trace(data, dict(network="TA", station="S01",
                                  channel="BHZ", sampling_rate=100.0,
                                  starttime=1262304000.0))])
    st.write(str(tmp_path / "fl.msd"), format="mseed")
    got = waveio.read(str(tmp_path / "fl.msd"))
    assert np.array_equal(got[0].data, data)
    assert mseed._auto_encoding(data.astype(np.float32)) == "FLOAT32"
    assert mseed._auto_encoding(np.round(data * 1e3)) == "STEIM1"


def test_skips_unsupported_records(tmp_path):
    """An ASCII log record inside an archive is skipped, not fatal."""
    st = _stream(np.random.default_rng(42), n=2000)
    p = str(tmp_path / "mix.msd")
    mseed.write_mseed(st, p, encoding="STEIM1", reclen=512)
    with open(p, "rb") as fh:
        buf = fh.read()
    hdr = struct.pack(
        ">6scc5s2s3s2sHHBBBxHHhhBBBBlHH",
        b"000099", b"D", b" ", b"S01  ", b"  ", b"LOG", b"TA",
        2010, 1, 0, 0, 0, 0, 20, 0, 0, 0, 0, 0, 1, 0, 64, 48)
    b1000 = struct.pack(">HHBBBx", 1000, 0, 0, 1, 9)
    logrec = hdr + b1000 + b"\x00" * (64 - len(hdr) - len(b1000))
    logrec += b"detex log line".ljust(448, b"\x00")
    with open(p, "wb") as fh:
        fh.write(buf[:512] + logrec + buf[512:])
    got = mseed.read_mseed(p)
    assert len(got) == 1 and len(got[0].data) == 2000


@pytest.mark.parametrize("enc", [None, "STEIM1", "STEIM2", "INT32",
                                 "FLOAT32", "FLOAT64"])
def test_files_cross_packages(tmp_path, enc):
    """Three channels, one integer counts, one float32, one float64 with a
    gap: the port writes detex_tpu's bytes, and each package reads the
    other's file to the same traces."""
    rng = np.random.default_rng(11)
    datas = [np.cumsum(rng.integers(-500, 500, 7000)).astype(np.float64),
             rng.standard_normal(7000).astype(np.float32),
             rng.standard_normal(7000)]
    if enc in ("STEIM1", "STEIM2", "INT32"):
        datas = [np.round(d * (1 if i == 0 else 1000)).astype(np.float64)
                 for i, d in enumerate(datas)]
    hdrs = [dict(network="UU", station="SRU", location="", channel=c,
                 sampling_rate=40.0, starttime=1.3e9 + 0.0125)
            for c in ("EHE", "EHN", "EHZ")]
    tst = Stream([Trace(d.copy(), dict(h)) for d, h in zip(datas, hdrs)])
    jst = JStream(traces=[JTrace(d.copy(), dict(h))
                          for d, h in zip(datas, hdrs)])
    pt, pj = str(tmp_path / "t.msd"), str(tmp_path / "j.msd")
    mseed.write_mseed(tst, pt, encoding=enc)
    jmseed.write_mseed(jst, pj, encoding=enc)
    with open(pt, "rb") as a, open(pj, "rb") as b:
        assert a.read() == b.read()
    for got, want in ((mseed.read_mseed(pj), jmseed.read_mseed(pj)),
                      (jmseed.read_mseed(pt), mseed.read_mseed(pt))):
        assert len(got) == len(want) == 3
        for x, y in zip(got, want):
            assert x.id == y.id
            assert x.stats.sampling_rate == y.stats.sampling_rate
            assert x.stats.starttime.timestamp == \
                y.stats.starttime.timestamp
            assert x.data.dtype == y.data.dtype
            assert np.array_equal(x.data, y.data)


def test_mseed_directory_fetcher(tmp_path):
    """A Detex-style miniSEED continuous directory indexes and serves
    through the port's DataFetcher('dir'); the index holds what
    detex_tpu's index of the same files holds, and a fetched stream is
    detex_tpu's, sample for sample."""
    from detex_tpu.data import fetcher as jfetch
    from detex_torch.data import fetcher as tfetch
    rng = np.random.default_rng(42)
    t0 = UTCDateTime("2010-01-01T00:00:00").timestamp
    roots = {}
    for tag in ("t", "j"):
        roots[tag] = tmp_path / tag / "ContinuousWaveForms"
        (roots[tag] / "TA.S01" / "2010" / "001").mkdir(parents=True)
    for h in range(2):
        trs = [Trace(np.cumsum(rng.integers(-50, 50, 360000)).astype(
            np.float64), dict(network="TA", station="S01", channel=c,
                              sampling_rate=100.0,
                              starttime=t0 + h * 3600.0))
            for c in ("BHE", "BHN", "BHZ")]
        for tag in ("t", "j"):
            mseed.write_mseed(Stream(trs), str(
                roots[tag] / "TA.S01" / "2010" / "001" /
                ("TA.S01.%03d.msd" % h)), encoding="STEIM1")
    tfet = tfetch.DataFetcher("dir", directoryName=str(roots["t"]),
                              conDatDuration=3600, conBuff=120)
    jfet = jfetch.DataFetcher("dir", directoryName=str(roots["j"]),
                              conDatDuration=3600, conBuff=120)
    args = (t0 + 1800, t0 + 5400, "TA", "S01", ["BHE", "BHN", "BHZ"], "*")
    st = tfet.getStream(*args)
    want = jfet.getStream(*args)
    assert st is not None and len(st) == 3
    for tr, wt in zip(st, want):
        assert abs(tr.stats.starttime.timestamp - (t0 + 1800)) < 0.02
        assert len(tr.data) >= 3600 * 100 - 2
        assert tr.stats.starttime.timestamp == wt.stats.starttime.timestamp
        assert np.array_equal(tr.data, wt.data)
    from detex_torch import util as tutil
    from detex_tpu import util as jutil
    ti = tutil.loadSQLite(str(roots["t"] / ".index.db"), "ind",
                          columns=True)
    ji = jutil.loadSQLite(str(roots["j"] / ".index.db"), "ind")
    assert list(ti["FileName"]) == list(ji.FileName)
    for col in ("Starttime", "Endtime", "Gaps", "Nc", "Nt", "Duration"):
        assert np.array_equal(np.asarray(ti[col], np.float64),
                              np.asarray(ji[col], np.float64)), col
