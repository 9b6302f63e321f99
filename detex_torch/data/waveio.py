"""
Waveform file IO.

Namesake of detex_tpu/data/waveio.py for its native formats: ``npz`` (one
``data_<i>`` array per trace and a JSON ``meta`` list of each trace's
network, station, location, channel, sampling rate and start time) and
miniSEED (data/mseed.py on the native host library), so either package
reads the other's files. Formats only obspy reads (SAC, pickled streams)
are not ported (ROADMAP A22): asking for them raises, as does miniSEED
when the native library could not be built.
"""
from __future__ import annotations

import json
import os

import numpy as np

import detex_torch
from detex_torch.core.stream import Stats, Stream, Trace

# file extension per format (reference getdata formatKey)
formatKey = {"mseed": "msd", "pickle": "pkl", "sac": "sac", "Q": "Q",
             "npz": "npz"}

_META_KEYS = ("network", "station", "location", "channel", "sampling_rate")


def _unported(what):
    detex_torch.log(__name__, "%s needs obspy, which the port does not use "
                    "(ROADMAP A22); use format='npz' or 'mseed'" % what,
                    level="error", e=NotImplementedError)


def _mseed():
    """data/mseed.py, or NotImplementedError without the native library."""
    from detex_torch.data import mseed
    if not mseed.available():
        detex_torch.log(__name__, "miniSEED needs the native host library, "
                        "which g++ could not build (detex_torch.native)",
                        level="error", e=NotImplementedError)
    return mseed


def write_stream(st, path, format="npz"):
    """Write Stream ``st`` to ``path``: format "npz" (".npz" appended when
    missing) or "mseed" (data/mseed.write_mseed, lossless encoding by
    default)."""
    fmt = str(format).lower()
    if fmt == "mseed":
        return _mseed().write_mseed(st, path)
    if fmt != "npz":
        _unported("writing format %s" % format)
    arrays = {}
    meta = []
    for i, tr in enumerate(st):
        arrays["data_%d" % i] = np.asarray(tr.data)
        m = {k: tr.stats.get(k) for k in _META_KEYS}
        m["starttime"] = tr.stats.starttime.timestamp
        meta.append(m)
    arrays["meta"] = np.array(json.dumps(meta))
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    np.savez(path if path.endswith(".npz") else path + ".npz", **arrays)
    return path


def read(path):
    """Read an npz or miniSEED waveform file into a Stream; None (with a
    warning) when it cannot be read, as detex_tpu's read (reference
    getdata.read, getdata.py:33-47). An npz file is ``path`` or
    ``path + ".npz"``; any other file is read as miniSEED when its first
    record header says so."""
    p = path if path.endswith(".npz") else path + ".npz"
    if not os.path.exists(p):
        if _looks_mseed(path):
            return _mseed().read_mseed(path)
        detex_torch.log(__name__, "Cannot read %s" % path, level="warning")
        return None
    try:
        with np.load(p, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            return Stream([Trace(z["data_%d" % i], Stats(m))
                           for i, m in enumerate(meta)])
    except (OSError, ValueError, KeyError):
        detex_torch.log(__name__, "Cannot read %s" % path, level="warning")
        return None


def _looks_mseed(path):
    """miniSEED sniff: 6-digit sequence + D/R/Q/M quality byte."""
    try:
        with open(path, "rb") as fh:
            head = fh.read(8)
    except OSError:
        return False
    return (len(head) >= 8 and
            all(48 <= b <= 57 or b == 32 for b in head[:6]) and
            head[6:7] in (b"D", b"R", b"Q", b"M"))
