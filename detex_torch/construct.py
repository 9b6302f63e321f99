"""
Host preprocessing of continuous chunks: merge, trim, detrend, bandpass,
decimate and multiplex.

Namesake of detex_tpu/construct.py's multiplexing and filtering helpers
(construct.py:33-146; reference construct.py:928-1066), on the port's own
Stream (detex_torch.core). The detection engine runs every chunk through
_applyFilter and multiplex before its scan, and each triggered chunk of a
devicePrep scan again before the re-verify.
"""
from __future__ import annotations

import numpy as np

import detex_torch
from detex_torch.core.stream import Stream
from detex_torch.core.utc import UTCDateTime


# channel lengths of one chunk may differ by this many samples before
# multiplex warns (it trims to the shortest either way)
TRIM_TOLERANCE = 15


def multiplex(st, Nc):
    """Interleave the Nc channels of a Stream into one vector
    (Fortran-order flatten of the [Nc, n] stack), every channel cut to the
    shortest."""
    if Nc == 1:
        return np.asarray(st[0].data)
    chans = [np.asarray(x.data) for x in st]
    lens = np.array([len(x) for x in chans])
    if lens.max() - lens.min() > TRIM_TOLERANCE:
        detex_torch.log(__name__, "Channel lengths are not within %d on "
                        "%s.%s from %s to %s; trimming to the shortest "
                        "channel" % (TRIM_TOLERANCE, st[0].stats.network,
                                     st[0].stats.station,
                                     st[0].stats.starttime,
                                     st[0].stats.endtime), level="warning")
    trimdim = lens.min()
    return np.vstack([x[:trimdim] for x in chans]).flatten(order="F")


def _applyFilter(st, filt, decimate=False, dtype="double", fillZeros=False):
    """Sort, merge, decimate, trim, split, detrend and bandpass a Stream in
    place (reference construct.py:990-1030); dtype "single" casts the
    traces to float32. Returns the filtered Stream, empty when the chunk
    cannot be used."""
    if st is None or len(st) < 1:
        detex_torch.log(__name__, "_applyFilter got a stream with 0 length",
                        level="warning")
        return Stream()
    st.sort()
    nc = list(set(x.stats.channel for x in st))
    if len(st) > len(nc):  # fragmented: keep largest chunk or zero-fill
        st = _mergeChannelsFill(st) if fillZeros else _mergeChannels(st)
    if not len(st) == len(nc) or len(st) < 1:
        sta = st[0].stats.station if len(st) else "?"
        detex_torch.log(__name__, "Stream is too fractured on %s" % sta,
                        level="warning")
        return Stream()
    if decimate:
        st.decimate(decimate)
    startTrim = max(x.stats.starttime.timestamp for x in st)
    endTrim = min(x.stats.endtime.timestamp for x in st)
    if startTrim > endTrim:
        return Stream()
    st.trim(starttime=UTCDateTime(startTrim), endtime=UTCDateTime(endTrim))
    st = st.split()
    st.detrend("linear")
    if isinstance(filt, (list, tuple)):
        st.filter("bandpass", freqmin=filt[0], freqmax=filt[1],
                  corners=filt[2], zerophase=filt[3])
    if dtype == "single":
        for tr in st:
            tr.data = tr.data.astype(np.float32)
    return st


def _mergeChannels(st):
    """Keep the longest continuous stretch common to all channels
    (reference construct.py:1033-1066)."""
    st1 = st.copy()
    st1.merge(fill_value=0.0)
    start = max(x.stats.starttime.timestamp for x in st1)
    end = min(x.stats.endtime.timestamp for x in st1)
    if start > end:
        return Stream()
    st1.trim(starttime=UTCDateTime(start), endtime=UTCDateTime(end))
    if len(st1) < 1:
        return Stream()
    ar_len = min(len(x.data) for x in st1)
    ar = np.ones(ar_len)
    for tr in st1:
        ar = ar * tr.data[:ar_len]
    if (ar == 0.0).any():
        # longest run where every channel is nonzero
        nz = (ar != 0.0).astype(np.int8)
        edges = np.flatnonzero(np.diff(np.concatenate(([0], nz, [0]))))
        starts, ends = edges[::2], edges[1::2]
        if len(starts) == 0:
            return Stream()
        k = int(np.argmax(ends - starts))
        best_start, best_len = int(starts[k]), int(ends[k] - starts[k])
        sr = st1[0].stats.sampling_rate
        t0 = UTCDateTime(start + best_start / sr)
        t1 = UTCDateTime(start + (best_start + best_len - 1) / sr)
        st.trim(starttime=t0, endtime=t1)
        return st
    return st1


def _mergeChannelsFill(st):
    """Merge each channel's fragments with zeros in the gaps."""
    st.merge(fill_value=0.0)
    return st
