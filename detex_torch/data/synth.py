"""
Synthetic seismic dataset generation.

Namesake of detex_tpu/data/synth.py: a Case1 analog (template key,
station key, phase picks, event waveform directory, continuous waveform
directory with *planted* repeating events, and a ground-truth
verification file) made from the same numpy draws in the same order, so
both packages write the same arrays from the same seed. The keys are
lists of row dicts, written with the csv module in pandas' to_csv form
(floats as repr, NaN as an empty cell, "\\n" line ends).
"""
from __future__ import annotations

import os

import numpy as np

from detex_torch.core.stream import Stats, Stream, Trace
from detex_torch.core.utc import UTCDateTime
from detex_torch.data import fetcher as getdata
from detex_torch.data.keys import write_csv


def ricker(npts, sr, f0=3.0, t0=None):
    """Ricker wavelet sampled at sr, centered at t0 seconds."""
    t = np.arange(npts) / sr
    if t0 is None:
        t0 = t[npts // 2]
    a = (np.pi * f0 * (t - t0)) ** 2
    return (1.0 - 2.0 * a) * np.exp(-a)


def make_source(rng, sr, dur=8.0, f0=3.0):
    """
    A random band-limited source wavelet: white noise convolved with a
    ricker kernel (random per call, so distinct sources are uncorrelated),
    shaped by a P-onset/S-burst/coda-decay envelope.
    """
    n = int(dur * sr)
    t = np.arange(n) / sr
    kern_n = max(int(2.0 * sr / f0), 8)
    kern = ricker(kern_n, sr, f0)
    sig = np.convolve(rng.standard_normal(n), kern, mode="same")
    tP = 0.8 + float(rng.uniform(0, 0.7))   # random P onset per source
    tS = 2.5 + float(rng.uniform(0, 1.5))   # random S burst per source
    env = np.zeros(n)
    env += 0.6 * np.exp(-np.abs(t - tP - .3) * 2.0) * (t >= tP)   # P-ish
    env += 1.5 * np.exp(-np.abs(t - tS) * 1.2) * (t >= tS - .4)   # S-ish
    env += 0.5 * np.exp(-np.maximum(t - tS, 0) / 2.0) * (t >= tS)  # coda
    sig = sig * env
    norm = np.abs(sig).max()
    return sig / (norm if norm else 1.0)


class SynthCatalog(object):
    """Generated catalog + waveform factory for one or more stations."""

    def __init__(self, n_sources=3, events_per_source=4, n_singles=2,
                 n_stations=2, sr=50.0, t0="2009-04-01T00:00:00",
                 span_hours=72, seed=0, noise=0.05, f0=3.0, mag0=1.0):
        rng = np.random.default_rng(seed)
        self.rng = rng
        self.sr = sr
        self.nc = 3
        self.noise = noise
        self.t0 = UTCDateTime(t0).timestamp
        self.span = span_hours * 3600.0
        self.stations = [("TA", "S%02d" % i) for i in range(n_stations)]
        self.chans = ["BHE", "BHN", "BHZ"]

        # source wavelets: per (source, station, channel); events of the same
        # source share the wavelet up to amplitude + tiny perturbation
        self.sources = {}
        for s in range(n_sources + n_singles):
            for ista in range(n_stations):
                chans = [make_source(rng, sr, f0=f0) for _ in range(3)]
                self.sources[(s, ista)] = chans

        # schedule events: one per distinct hour slot while slots last
        # (identical draw order to before), tiling the slots when the
        # catalog asks for more events than span hours (small-span
        # miniatures; multiple events then share an hour)
        events = []
        eid = 0
        n_ev = n_sources * events_per_source + n_singles
        slots = np.arange(max(int(span_hours) - 1, 1))
        reps = -(-n_ev // len(slots))
        hours = rng.permutation(np.tile(slots, reps))
        hi = 0
        for s in range(n_sources):
            for k in range(events_per_source):
                otime = self.t0 + hours[hi] * 3600.0 + \
                    float(rng.uniform(600, 3000))
                hi += 1
                mag = mag0 + float(rng.uniform(-0.5, 1.0))
                events.append(dict(src=s, time=otime, mag=mag, eid=eid))
                eid += 1
        for s in range(n_sources, n_sources + n_singles):
            otime = self.t0 + hours[hi] * 3600.0 + float(rng.uniform(600, 3000))
            hi += 1
            events.append(dict(src=s, time=otime,
                               mag=mag0 + float(rng.uniform(-0.5, 1.0)),
                               eid=eid))
            eid += 1
        events.sort(key=lambda e: e["time"])
        self.events = events
        # per-station traveltime (seconds) for each source
        self.ttimes = {(s, i): 2.0 + 3.0 * rng.random()
                       for s in range(n_sources + n_singles)
                       for i in range(n_stations)}
        # extra *unlisted* planted events (the detection targets)
        self.hidden = []

    def add_hidden_events(self, n=4, mag=1.2, sources=None):
        """Plant extra repeats of known sources in the continuous data that
        are NOT in the template key — these are what detection must find."""
        rng = self.rng
        nsrc = len(set(e["src"] for e in self.events))
        used_hours = {int((e["time"] - self.t0) // 3600) for e in self.events}
        avail = [h for h in range(int(self.span // 3600) - 1)
                 if h not in used_hours]
        rng.shuffle(avail)
        # dense miniatures can use every hour: reuse hours with a LATE
        # in-hour offset so hidden events never overlap the scheduler's
        # 600-3000 s window (n_free tracks which slots get the early
        # offset; the free-slot path is unchanged)
        n_free = len(avail)
        if n_free < n:
            extra = list(range(int(self.span // 3600) - 1))
            rng.shuffle(extra)
            avail = avail + extra
        for k in range(n):
            src = (sources[k % len(sources)] if sources
                   else k % max(nsrc - 1, 1))
            off = float(rng.uniform(600, 3000)) if k < n_free else \
                float(rng.uniform(3100, 3500))
            otime = self.t0 + avail[k] * 3600.0 + off
            self.hidden.append(dict(src=src, time=otime,
                                    mag=mag + float(rng.uniform(-0.3, 0.5))))
        self.hidden.sort(key=lambda e: e["time"])
        return self.hidden

    # -- keys -------------------------------------------------------------
    def event_name(self, e):
        u = UTCDateTime(e["time"])
        return str(u).split(".")[0].replace(":", "-")

    TEMPLATE_COLUMNS = ["TIME", "NAME", "LAT", "LON", "MAG", "DEPTH"]
    STATION_COLUMNS = ["NETWORK", "STATION", "STARTTIME", "ENDTIME", "LAT",
                       "LON", "ELEVATION", "CHANNELS"]
    PHASE_COLUMNS = ["TimeStamp", "Station", "Event", "Phase"]

    def template_key(self):
        rows = []
        for e in self.events:
            rows.append(dict(TIME=self.event_name(e),
                             NAME=self.event_name(e),
                             LAT=40.0 + e["src"] * 0.01, LON=-111.0,
                             MAG=e["mag"], DEPTH=5.0))
        return rows

    def station_key(self):
        rows = []
        t1 = str(UTCDateTime(self.t0)).split(".")[0].replace(":", "-")
        t2 = str(UTCDateTime(self.t0 + self.span)).split(".")[0]
        t2 = t2.replace(":", "-")
        for i, (net, sta) in enumerate(self.stations):
            rows.append(dict(NETWORK=net, STATION=sta, STARTTIME=t1,
                             ENDTIME=t2, LAT=40.5 + 0.1 * i, LON=-111.2,
                             ELEVATION=2000, CHANNELS="-".join(self.chans)))
        return rows

    def phase_key(self):
        rows = []
        for e in self.events:
            for i, (net, sta) in enumerate(self.stations):
                tt = self.ttimes[(e["src"], i)]
                rows.append(dict(TimeStamp=e["time"] + tt,
                                 Station="%s.%s" % (net, sta),
                                 Event=self.event_name(e), Phase="P"))
        return rows

    def veri_file(self):
        rows = []
        for e in self.hidden:
            u = UTCDateTime(e["time"])
            rows.append(dict(TIME=str(u).split(".")[0].replace(":", "-"),
                             NAME="V-" + self.event_name(e),
                             LAT=40.0, LON=-111.0, MAG=e["mag"], DEPTH=5.0))
        return rows

    # -- waveforms ------------------------------------------------------------
    def _noise(self, n, seed_extra=0):
        rng = np.random.default_rng(
            (int(self.t0) + seed_extra) % (2 ** 31))
        return rng.standard_normal(n) * self.noise

    def _inject(self, data, chan_idx, ista, tstart, n):
        """Add every (listed+hidden) event whose wavelet lands in window."""
        sr = self.sr
        dur = None
        for e in self.events + self.hidden:
            src = e["src"]
            wav = self.sources[(src, ista)][chan_idx]
            if dur is None:
                dur = len(wav) / sr
            t_arr = e["time"] + self.ttimes[(src, ista)]
            i0 = int(round((t_arr - tstart) * sr))
            if i0 >= n or i0 + len(wav) <= 0:
                continue
            amp = 10.0 ** (e["mag"] - 1.0)
            a0 = max(i0, 0)
            a1 = min(i0 + len(wav), n)
            data[a0:a1] += amp * wav[a0 - i0: a1 - i0]
        return data

    def make_stream(self, ista, tstart, duration, seed_extra=0):
        """Continuous 3-channel stream for station index ista."""
        n = int(round(duration * self.sr))
        net, sta = self.stations[ista]
        st = Stream()
        for ci, ch in enumerate(self.chans):
            rng = np.random.default_rng(
                abs(hash((int(tstart), ista, ci, seed_extra))) % (2 ** 31))
            data = rng.standard_normal(n) * self.noise
            data = self._inject(data, ci, ista, tstart, n)
            stats = Stats(dict(network=net, station=sta, channel=ch,
                               sampling_rate=self.sr,
                               starttime=UTCDateTime(tstart)))
            st.append(Trace(data, stats))
        return st

    # -- directory materialization ----------------------------------------
    def write_directories(self, root, tb4=30, taft=120, conDatDuration=3600,
                          conBuff=120):
        """Write EventWaveForms + ContinuousWaveForms + key csvs under root.
        Returns dict of paths."""
        eved = os.path.join(root, "EventWaveForms")
        cond = os.path.join(root, "ContinuousWaveForms")
        temkey = self.template_key()
        stakey = self.station_key()
        phases = self.phase_key()
        os.makedirs(root, exist_ok=True)
        # event waveforms
        for e in self.events:
            name = self.event_name(e)
            for i, (net, sta) in enumerate(self.stations):
                t = UTCDateTime(e["time"])
                st = self.make_stream(i, (t - tb4).timestamp, tb4 + taft)
                fdir = os.path.join(eved, name)
                os.makedirs(fdir, exist_ok=True)
                fname = "%s.%s.%s.npz" % (net, sta, name)
                st.write(os.path.join(fdir, fname), "npz")
        # continuous waveforms (hour chunks + buffer)
        nhours = int(self.span // conDatDuration)
        for i, (net, sta) in enumerate(self.stations):
            netsta = "%s.%s" % (net, sta)
            for h in range(nhours):
                tstart = self.t0 + h * conDatDuration
                st = self.make_stream(i, tstart, conDatDuration + conBuff)
                path, fname = getdata._makePathFile(cond, netsta, tstart)
                os.makedirs(path, exist_ok=True)
                st.write(os.path.join(path, fname + ".npz"), "npz")
        getdata.indexDirectory(eved)
        getdata.indexDirectory(cond)
        tk = os.path.join(root, "TemplateKey.csv")
        sk = os.path.join(root, "StationKey.csv")
        pk = os.path.join(root, "PhasePicks.csv")
        vf = os.path.join(root, "veriFile.csv")
        write_csv(tk, self.TEMPLATE_COLUMNS, temkey)
        write_csv(sk, self.STATION_COLUMNS, stakey)
        write_csv(pk, self.PHASE_COLUMNS, phases)
        if self.hidden:
            write_csv(vf, self.TEMPLATE_COLUMNS, self.veri_file())
        return dict(root=root, eventDir=eved, conDir=cond, templateKey=tk,
                    stationKey=sk, phaseKey=pk, veriFile=vf)
