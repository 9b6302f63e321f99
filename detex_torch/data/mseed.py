"""
miniSEED v2 reader and writer without obspy.

Namesake of detex_tpu/data/mseed.py. miniSEED is the format of every
Detex archive; record parsing and the STEIM1 / STEIM2 / INT16 / INT32 /
FLOAT32 / FLOAT64 decoders, and the STEIM encoders, run in the native
host library (detex_torch.native, native/detex_host.cpp
``detex_mseed_record``, ``detex_steim1_encode``, ``detex_steim2_encode``),
trace assembly and record packing here, so that either package reads the
other's files and both write the same bytes.

Scope: miniSEED v2 with blockette 1000 (which everything modern writes);
no blockette-100 rate override, ASCII, or legacy encodings. Without the
native library reading and writing raise IOError.
"""
from __future__ import annotations

import struct

import numpy as np

import detex_torch
from detex_torch import native
from detex_torch.core.stream import Stream, Trace
from detex_torch.core.utc import UTCDateTime

_ENCODINGS = {"STEIM1": 10, "STEIM2": 11, "INT32": 3, "FLOAT32": 4,
              "FLOAT64": 5}


def available():
    """Native miniSEED support present?"""
    return native.available()


def read_mseed(path):
    """Read a miniSEED file into a Stream (traces split on gaps larger
    than half a sample). Records with unsupported encodings (e.g. ASCII
    LOG channels) or corrupt payloads are skipped; an unparseable header
    stops the scan with a warning, keeping everything read so far."""
    with open(path, "rb") as fh:
        buf = fh.read()
    recs = []
    off = 0
    scratch = np.empty(65536, np.float64)
    while off + 64 <= len(buf):
        try:
            reclen, ident, t0, sr, x = native.mseed_record(
                buf, off, scratch=scratch)
        except IOError:
            detex_torch.log(__name__, "unparseable miniSEED record at "
                            "offset %d of %s; keeping %d records read so "
                            "far" % (off, path, len(recs)),
                            level="warning")
            break
        off += reclen
        if sr > 0 and len(x):
            recs.append((ident, t0, sr, x))
    recs.sort(key=lambda r: (r[0], r[1]))
    traces = []
    cur = None
    for ident, t0, sr, x in recs:
        # contiguity check against the running end time
        if (cur is not None and cur["id"] == ident and cur["sr"] == sr and
                abs(t0 - cur["end"]) < 0.5 / sr):
            cur["data"].append(x)
            cur["end"] += len(x) / sr
            continue
        if cur is not None:
            traces.append(cur)
        cur = dict(id=ident, t0=t0, sr=sr, data=[x],
                   end=t0 + len(x) / sr)
    if cur is not None:
        traces.append(cur)
    out = []
    for tr in traces:
        net, sta, loc, chan = (tr["id"].split(".") + [""] * 4)[:4]
        data = np.concatenate(tr["data"])
        out.append(Trace(data, header=dict(
            network=net, station=sta, location=loc, channel=chan,
            sampling_rate=tr["sr"], starttime=UTCDateTime(tr["t0"]))))
    return Stream(out)


def _btime(t):
    """(year, doy, hour, minute, sec, fract0.1ms) of an epoch second.

    Split integer 0.1 ms ticks FIRST: deriving the calendar fields and
    the fraction from ``t`` separately double-rounds near X.9999...
    seconds (datetime rounds the second up while the fraction also
    rounds to 10000), shifting a record header a full second."""
    ticks = int(round(t * 1e4))
    secs, frac = divmod(ticks, 10000)
    tt = UTCDateTime(float(secs)).datetime.timetuple()
    return (tt.tm_year, tt.tm_yday, tt.tm_hour, tt.tm_min, tt.tm_sec,
            frac)


def _rate_factors(sr):
    """Exact SEED (factor, multiplier) pair for a sampling rate, using
    the f>0/m<0 rational form for non-integer rates (e.g. 40.5 = 81/-2).
    Raises for rates int16 factors cannot represent."""
    from fractions import Fraction
    if sr <= 0:
        raise ValueError("sampling_rate must be positive")
    if float(sr).is_integer() and sr <= 32767:
        return int(sr), 1
    inv = 1.0 / sr
    if inv.is_integer() and inv <= 32767:
        return -int(inv), 1
    fr = Fraction(sr).limit_denominator(32767)
    if float(fr) == float(sr) and fr.numerator <= 32767:
        return int(fr.numerator), -int(fr.denominator)
    raise ValueError("sampling_rate %r is not representable in miniSEED "
                     "int16 rate factors" % sr)


def _pack_header(seq, net, sta, loc, chan, t0, sr, nsamp, enc, reclen_log):
    year, doy, hh, mm, ss, frac = _btime(t0)
    f, m = _rate_factors(sr)
    hdr = struct.pack(
        ">6scc5s2s3s2sHHBBBxHHhhBBBBlHH",
        ("%06d" % (seq % 1000000)).encode(), b"D", b" ",
        sta[:5].ljust(5).encode(), loc[:2].ljust(2).encode(),
        chan[:3].ljust(3).encode(), net[:2].ljust(2).encode(),
        year, doy, hh, mm, ss, frac, nsamp, f, m,
        0, 0, 0, 1,      # activity/io/quality flags, 1 blockette
        0,               # time correction
        64, 48)          # data offset, first blockette offset
    b1000 = struct.pack(">HHBBBx", 1000, 0, enc, 1, reclen_log)
    return hdr + b1000 + b"\x00" * (64 - len(hdr) - len(b1000))


def _auto_encoding(data):
    """Lossless default: STEIM1 for integral int32-range data (the
    reference's obspy archives are integer counts), else FLOAT32/FLOAT64
    by dtype — never silently quantize float waveforms."""
    d = np.asarray(data)
    if np.issubdtype(d.dtype, np.integer):
        return "STEIM1"
    if (d.size and np.all(np.isfinite(d)) and
            np.all(d == np.rint(d)) and
            np.all(d <= 2 ** 31 - 1) and np.all(d >= -2 ** 31)):
        return "STEIM1"
    return "FLOAT32" if d.dtype == np.float32 else "FLOAT64"


def write_mseed(st, path, encoding=None, reclen=4096):
    """Write a Stream as miniSEED v2 (big-endian, blockette 1000).

    ``encoding=None`` (default) picks losslessly per trace: STEIM1 for
    integral data (the reference's obspy-written archives are integer
    counts), FLOAT32/FLOAT64 for float waveforms. "STEIM2" (better
    compression; diffs limited to 30 bits — raises beyond) round-trips
    reference archives in their original encoding. Forcing "STEIM1"/
    "STEIM2" rounds floats to integers; "INT32" truncates."""
    if encoding is not None and encoding not in _ENCODINGS:
        raise ValueError("encoding must be None or one of %s" %
                         sorted(_ENCODINGS))
    reclen_log = int(np.log2(reclen))
    if (1 << reclen_log) != reclen or not 128 <= reclen <= 65536:
        raise ValueError("reclen must be a power of two in [128, 65536]")
    payload = reclen - 64
    seq = 1
    out = []
    for tr in st:
        net = tr.stats.network or ""
        sta = tr.stats.station or ""
        loc = getattr(tr.stats, "location", "") or ""
        chan = tr.stats.channel or ""
        sr = float(tr.stats.sampling_rate)
        _rate_factors(sr)   # validate representability up front
        t = float(tr.stats.starttime.timestamp)
        tr_enc = encoding or _auto_encoding(tr.data)
        enc = _ENCODINGS[tr_enc]
        if tr_enc in ("STEIM1", "STEIM2"):
            data = np.asarray(np.round(tr.data), np.int32)
        elif tr_enc == "INT32":
            data = np.asarray(tr.data, np.int32)
        elif tr_enc == "FLOAT32":
            data = np.asarray(tr.data, np.float32)
        else:
            data = np.asarray(tr.data, np.float64)
        t0_tr = t
        i = 0
        while i < len(data):
            if tr_enc in ("STEIM1", "STEIM2"):
                # <= 61380 samples/record at reclen 65536: always fits
                # the u16 header field
                enc_fn = (native.steim1_encode if tr_enc == "STEIM1"
                          else native.steim2_encode)
                got, frames = enc_fn(data[i:], payload // 64)
                body = frames
            else:
                per = min(payload // data.itemsize, 65535)
                got = min(per, len(data) - i)
                body = data[i:i + got].astype(
                    data.dtype.newbyteorder(">")).tobytes()
                body += b"\x00" * (payload - len(body))
            if got <= 0:
                raise IOError("miniSEED encoding stalled")
            out.append(_pack_header(seq, net, sta, loc, chan, t, sr,
                                    got, enc, reclen_log) + body)
            seq += 1
            i += got
            # header time from the running sample index, not repeated
            # float accumulation (t += got/sr drifts over many records)
            t = t0_tr + i / sr
    with open(path, "wb") as fh:
        fh.write(b"".join(out))
    return path
