"""
The benchmark's own writer of a 'dir' archive: one npz file a chunk
length (an hour in Case1) a station, in the layout that
detex_torch/data/waveio.py reads (a ``data_<i>`` array a trace and a
JSON ``meta`` list of each trace's
network, station, location, channel, sampling rate and start time), under
Detex's directory layout NET.STA/YEAR/JULDAY/NET.STA.YEAR-JULDAYTHH-MM-SS.
"""
from __future__ import annotations

import datetime
import json
import os

import numpy as np

from portbench.harness.gen import T0


def chunk_file(root, name, t):
    d = datetime.datetime.fromtimestamp(t, datetime.timezone.utc)
    jd = d.timetuple().tm_yday
    path = os.path.join(root, name, "%04d" % d.year, "%03d" % jd)
    fname = "%s.%04d-%03dT%02d-%02d-%02d.npz" % (name, d.year, jd, d.hour,
                                                d.minute, d.second)
    return path, fname


def write_archive(cell, stations, root):
    """Write every station's record as files of one chunk length under
    ``root``; returns the station key rows that cover the span (chunks 0
    .. span - 1)."""
    sr = cell.sr
    per = int(round(cell.chunk_s * sr))
    rows = []
    for st in stations:
        n_files = st.record.shape[1] // per
        for h in range(n_files):
            t = T0 + cell.chunk_s * h
            path, fname = chunk_file(root, st.name, t)
            os.makedirs(path, exist_ok=True)
            arrays = {"data_%d" % c: st.record[c, h * per:(h + 1) * per]
                      for c in range(cell.nc)}
            meta = [dict(network=st.net, station=st.sta, location="",
                         channel=ch, sampling_rate=sr, starttime=t)
                    for ch in cell.channels]
            arrays["meta"] = np.array(json.dumps(meta))
            out = os.path.join(path, fname)
            np.savez(out, **arrays)
            # on the disk now, so that writing it back does not fall in
            # the window
            fd = os.open(out, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        rows.append(dict(NETWORK=st.net, STATION=st.sta, LOCATION="",
                         CHANNELS="-".join(cell.channels),
                         STARTTIME=T0,
                         ENDTIME=T0 + cell.span_chunks * cell.chunk_s - 1.0,
                         LAT=40.0, LON=-111.0, ELEVATION=1500.0))
    return rows
