"""
Lightweight numpy-backed Trace/Stream containers of the detection engine.

Namesake of detex_tpu/core/stream.py (a copy of what the engine's filter
path, the data layer and the pickers call: sort, copy, merge, trim, slice,
split, detrend, filter, decimate, select, get_gaps, write, max). Gaps are
NaN runs inside a merged trace; ``split()`` recovers the contiguous
segments, as obspy's masked-array merge / split do.
"""
from __future__ import annotations

import copy as _copy

import numpy as np

from detex_torch.core import filters as _filters
from detex_torch.core.utc import UTCDateTime


class Stats(dict):
    """Attribute-style dict of trace metadata."""

    _defaults = dict(network="", station="", location="", channel="",
                     sampling_rate=1.0)

    def __init__(self, header=None):
        super().__init__()
        self.update(self._defaults)
        self["starttime"] = UTCDateTime(0.0)
        self["npts"] = 0
        if header:
            for k, v in dict(header).items():
                self[k] = v

    def __setitem__(self, key, value):
        if key == "starttime":
            value = UTCDateTime(value)
        if key == "sampling_rate":
            value = float(value)
        super().__setitem__(key, value)

    def __getattr__(self, name):
        if name == "delta":
            return 1.0 / self["sampling_rate"]
        if name == "endtime":
            n = max(self["npts"] - 1, 0)
            return self["starttime"] + n * (1.0 / self["sampling_rate"])
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value

    def copy(self):
        new = Stats()
        for k, v in self.items():
            new[k] = _copy.copy(v)
        return new


class Trace(object):
    """A single-channel contiguous (or NaN-gapped) waveform segment."""

    def __init__(self, data=None, header=None):
        if data is None:
            data = np.array([], dtype=np.float64)
        self.data = np.asarray(data)
        self.stats = header if isinstance(header, Stats) else Stats(header)
        self.stats["npts"] = len(self.data)

    # -- basic ------------------------------------------------------------
    @property
    def id(self):
        s = self.stats
        return "%s.%s.%s.%s" % (s.network, s.station, s.location, s.channel)

    def copy(self):
        tr = Trace(self.data.copy(), self.stats.copy())
        return tr

    def __len__(self):
        return len(self.data)

    def __repr__(self):
        s = self.stats
        return ("%s | %s - %s | %.1f Hz, %d samples"
                % (self.id, s.starttime, s.endtime, s.sampling_rate,
                   len(self.data)))

    # -- processing ---------------------------------------------------------
    def detrend(self, type="linear"):
        """Remove a least-squares line (the only detrend the engine runs)."""
        if type != "linear":
            raise ValueError("unsupported detrend type %s" % type)
        if len(self.data) > 1:
            self.data = _filters.detrend_linear(self.data)
        return self

    def filter(self, ftype, **kw):
        """Bandpass (freqmin, freqmax, corners, zerophase), obspy's way."""
        if ftype != "bandpass":
            raise ValueError("unsupported filter %s" % ftype)
        self.data = _filters.bandpass(
            self.data, kw["freqmin"], kw["freqmax"],
            self.stats.sampling_rate, corners=kw.get("corners", 4),
            zerophase=kw.get("zerophase", False))
        return self

    def decimate(self, factor):
        self.data = _filters.decimate(self.data, factor,
                                      self.stats.sampling_rate)
        self.stats.sampling_rate = self.stats.sampling_rate / factor
        self.stats.npts = len(self.data)
        return self

    # -- windowing ----------------------------------------------------------
    def trim(self, starttime=None, endtime=None, pad=False, fill_value=None):
        """Keep the samples from ``starttime`` to ``endtime`` (inclusive,
        rounded to the nearest sample); with ``pad`` the window is kept
        whole, samples outside the trace set to ``fill_value`` (default
        0)."""
        sr = self.stats.sampling_rate
        t0 = self.stats.starttime.timestamp
        n = len(self.data)
        i0, i1 = 0, n
        if starttime is not None:
            i0 = int(round((UTCDateTime(starttime).timestamp - t0) * sr))
        if endtime is not None:
            i1 = int(round((UTCDateTime(endtime).timestamp - t0) * sr)) + 1
        i0c, i1c = max(i0, 0), min(i1, n)
        if pad:
            new = np.full(max(i1 - i0, 0), 0.0 if fill_value is None
                          else fill_value, dtype=self.data.dtype
                          if self.data.dtype.kind == "f" else np.float64)
            if i1c > i0c:
                new[i0c - i0:i1c - i0] = self.data[i0c:i1c]
            self.data = new
            i0c = i0
        else:
            self.data = self.data[i0c:i1c] if i1c > i0c else self.data[:0]
        self.stats.starttime = UTCDateTime(t0 + i0c / sr)
        self.stats.npts = len(self.data)
        return self

    def slice(self, starttime=None, endtime=None):
        """A trimmed copy; the trace itself is left as it is."""
        return self.copy().trim(starttime, endtime)

    def split(self):
        """Split a NaN-gapped trace into contiguous segments (a Stream)."""
        data = self.data
        if data.dtype.kind != "f" or not np.isnan(data).any():
            return Stream([self.copy()])
        isn = np.isnan(data)
        out = Stream()
        # find runs of valid data
        valid = ~isn
        if not valid.any():
            return out
        edges = np.flatnonzero(np.diff(valid.astype(np.int8)))
        starts = (([0] if valid[0] else [])
                  + (edges + 1)[valid[edges + 1]].tolist())
        ends = (edges + 1)[~valid[edges + 1]].tolist() + \
            ([len(data)] if valid[-1] else [])
        sr = self.stats.sampling_rate
        t0 = self.stats.starttime.timestamp
        for a, b in zip(starts, ends):
            tr = Trace(data[a:b].copy(), self.stats.copy())
            tr.stats.starttime = UTCDateTime(t0 + a / sr)
            tr.stats.npts = b - a
            out.append(tr)
        return out


class Stream(object):
    """A list of Traces with obspy-like bulk operations."""

    def __init__(self, traces=None):
        if traces is None:
            traces = []
        if isinstance(traces, Trace):
            traces = [traces]
        self.traces = list(traces)

    # -- container protocol -------------------------------------------------
    def __len__(self):
        return len(self.traces)

    def __iter__(self):
        return iter(self.traces)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return Stream(self.traces[i])
        return self.traces[i]

    def __add__(self, other):
        if isinstance(other, Trace):
            return Stream(self.traces + [other])
        return Stream(self.traces + list(other))

    def __iadd__(self, other):
        if isinstance(other, Trace):
            self.traces.append(other)
        else:
            self.traces.extend(list(other))
        return self

    def append(self, tr):
        self.traces.append(tr)
        return self

    def __repr__(self):
        head = "%d Trace(s) in Stream:" % len(self)
        return "\n".join([head] + [repr(t) for t in self.traces])

    def copy(self):
        return Stream([t.copy() for t in self.traces])

    # -- selection ------------------------------------------------------------
    def select(self, network=None, station=None, location=None, channel=None,
               component=None):
        out = []
        for tr in self.traces:
            s = tr.stats
            if network is not None and not _wmatch(s.network, network):
                continue
            if station is not None and not _wmatch(s.station, station):
                continue
            if location is not None and not _wmatch(s.location, location):
                continue
            if channel is not None and not _wmatch(s.channel, channel):
                continue
            if component is not None:
                if len(s.channel) == 0 or s.channel[-1] != component:
                    continue
            out.append(tr)
        return Stream(out)

    def sort(self, keys=("network", "station", "location", "channel",
                         "starttime")):
        def keyfun(tr):
            vals = []
            for k in keys:
                v = getattr(tr.stats, k)
                if isinstance(v, UTCDateTime):
                    v = v.timestamp
                vals.append(v)
            return tuple(vals)
        self.traces.sort(key=keyfun)
        return self

    # -- bulk processing ------------------------------------------------------
    def detrend(self, type="linear"):
        for tr in self.traces:
            tr.detrend(type)
        return self

    def filter(self, ftype, **kw):
        for tr in self.traces:
            tr.filter(ftype, **kw)
        return self

    def decimate(self, factor):
        for tr in self.traces:
            tr.decimate(factor)
        return self

    def trim(self, starttime=None, endtime=None, pad=False, fill_value=None):
        for tr in self.traces:
            tr.trim(starttime, endtime, pad=pad, fill_value=fill_value)
        self.traces = [t for t in self.traces if len(t) > 0]
        return self

    def split(self):
        out = Stream()
        for tr in self.traces:
            out += tr.split()
        return out

    def merge(self, method=1, fill_value=None):
        """
        Merge traces sharing an id. Overlaps: later traces overwrite
        (obspy's method 1, the only ``method`` the reference calls). Gaps
        become ``fill_value`` samples, or NaN when fill_value is None
        (recoverable via split()).
        """
        groups = {}
        for tr in self.traces:
            groups.setdefault((tr.id, round(tr.stats.sampling_rate, 6)),
                              []).append(tr)
        merged = []
        for (tid, sr), trs in groups.items():
            if len(trs) == 1:
                merged.append(trs[0])
                continue
            trs.sort(key=lambda t: t.stats.starttime.timestamp)
            t0 = min(t.stats.starttime.timestamp for t in trs)
            t1 = max(t.stats.endtime.timestamp for t in trs)
            n = int(round((t1 - t0) * sr)) + 1
            fv = np.nan if fill_value is None else fill_value
            buf = np.full(n, fv, dtype=np.float64)
            for t in trs:
                off = int(round((t.stats.starttime.timestamp - t0) * sr))
                buf[off: off + len(t.data)] = t.data
            out = Trace(buf, trs[0].stats.copy())
            out.stats.starttime = UTCDateTime(t0)
            out.stats.npts = n
            merged.append(out)
        merged.sort(key=lambda t: (t.id, t.stats.starttime.timestamp))
        self.traces = merged
        return self

    def get_gaps(self):
        """List of gaps [net, sta, loc, chan, t1, t2, delta_sec, nsamples]
        between consecutive traces of one id."""
        gaps = []
        byid = {}
        for tr in self.traces:
            byid.setdefault(tr.id, []).append(tr)
        for tid, trs in byid.items():
            trs.sort(key=lambda t: t.stats.starttime.timestamp)
            for a, b in zip(trs[:-1], trs[1:]):
                dt = b.stats.starttime.timestamp - a.stats.endtime.timestamp
                sr = a.stats.sampling_rate
                if dt > 1.5 / sr:
                    s = a.stats
                    gaps.append([s.network, s.station, s.location, s.channel,
                                 a.stats.endtime, b.stats.starttime, dt,
                                 int(round(dt * sr)) - 1])
        return gaps

    def write(self, path, format="npz"):
        """Write the stream to ``path`` (data/waveio.write_stream)."""
        from detex_torch.data import waveio
        waveio.write_stream(self, path, format=format)

    def max(self):
        """The largest absolute sample of each trace (0.0 for an empty
        one), NaN gaps ignored."""
        return [float(np.nanmax(np.abs(t.data))) if len(t) else 0.0
                for t in self.traces]


def _wmatch(value, pattern):
    """Glob-ish matching for seed id fields ('*', '?' wildcards)."""
    import fnmatch
    return fnmatch.fnmatch(str(value), str(pattern))
