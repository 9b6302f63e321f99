"""
The one traffic generator: detectors, continuous records with planted
events, and the chunks a run hands to the engine, all from ``--seed``.

A configuration file gives the deployment (stations, channels, sampling
rate, chunk and template lengths, the filter, the detectors, the engine's
dtype, batch size and trigger condition); a traffic file gives the mix:
its chunk source (portbench/harness/sources/<source>.py) and its window
(portbench/harness/windows/<window>.py), found by name, how many events a
station-hour and how strong. A key that nothing reads is refused. Every
seed gets the same sizes, the same number of events in each stretch of
the span and the same spread of event strengths: only their times within
their slots, their detectors and their order change.

Generators and detector shapes follow chip_smoke.py's phase F (f_chunk,
f_detectors, f_plant), with band-limited templates so that the filtered
chunk still matches them.
"""
from __future__ import annotations

import importlib
import re

import numpy as np
import scipy.signal as sig
import torch

# start of every record: 2017-07-14T00:00:00 UTC, on an hour boundary
T0 = 1499990400.0
NOISE_COUNTS = 1000.0           # standard deviation of the record's noise
# the keys a configuration file may hold; the engine takes filt, dtype,
# batch_size, device_prep and trig_con from it
CONFIG_KEYS = {"name", "source", "deployment", "network", "stations",
               "channels", "sampling_rate", "chunk_seconds",
               "buffer_seconds", "filt", "device_prep", "template_seconds",
               "detectors", "threshold", "dtype", "batch_size", "trig_con",
               "span_hours", "assumed", "reduced"}
# the keys every traffic file may hold; its source and window modules name
# the rest (KEYS, and CHECK_KEYS under "check")
TRAFFIC_KEYS = {"name", "why", "source", "window", "events_per_station_hour",
                "event_ds", "check"}
PART = re.compile(r"^[a-z][a-z0-9_]*$")


def load_part(kind, name):
    """portbench/harness/<kind>/<name>.py: a chunk source or a window."""
    if not PART.match(str(name)):
        raise ValueError("%s name %r" % (kind, name))
    return importlib.import_module("portbench.harness.%s.%s" % (kind, name))


def _bandpass(x, filt, sr):
    """Zero-phase band-pass of x along its last axis (a template shape)."""
    if not filt:
        return x
    nyq = 0.5 * sr
    sos = sig.iirfilter(int(filt[2]), [filt[0] / nyq,
                                       min(filt[1] / nyq, 1 - 1e-6)],
                        btype="band", ftype="butter", output="sos")
    return sig.sosfiltfilt(sos, x, axis=-1)


def filtered_noise_share(filt, sr):
    """The share of white noise's power that the zero-phase band-pass keeps
    (mean of |H|^4 over the band)."""
    if not filt:
        return 1.0
    nyq = 0.5 * sr
    sos = sig.iirfilter(int(filt[2]), [filt[0] / nyq,
                                       min(filt[1] / nyq, 1 - 1e-6)],
                        btype="band", ftype="butter", output="sos")
    _, h = sig.sosfreqz(sos, worN=4096)
    return float(np.mean(np.abs(h) ** 4))


def _mux(x):
    """[..., nc, n_c] -> [..., n_c * nc] (channels interleaved)."""
    return np.swapaxes(x, -1, -2).reshape(*x.shape[:-2], -1)


class Cell(object):
    """The sizes of one configuration under one traffic mix, with the
    traffic's chunk source and window (``src``, ``win``)."""

    def __init__(self, cfg, traffic):
        self.cfg = cfg
        self.traffic = traffic
        self.src = load_part("sources", traffic["source"])
        self.win = load_part("windows", traffic["window"])
        _only(cfg, CONFIG_KEYS, "configuration %s" % cfg.get("name"))
        _only(traffic, TRAFFIC_KEYS | set(self.src.KEYS) | set(self.win.KEYS),
              "traffic %s" % traffic.get("name"))
        _only(traffic.get("check", {}), set(self.win.CHECK_KEYS),
              "traffic %s check" % traffic.get("name"))
        if cfg["dtype"] not in ("single", "double"):
            raise ValueError("dtype %r" % cfg["dtype"])
        if int(cfg.get("trig_con", 0)) != 0:
            raise ValueError("trig_con %r: the reference triggers on the DS "
                             "(trigCon 0) only" % cfg["trig_con"])
        self.sr = float(cfg["sampling_rate"])
        self.channels = list(cfg["channels"])
        self.nc = len(self.channels)
        self.chunk_s = float(cfg["chunk_seconds"])
        self.buff_s = float(cfg["buffer_seconds"])
        self.n_c = int(round(cfg["template_seconds"] * self.sr))
        self.n = self.n_c * self.nc
        self.kinds = [k for k in ("subspace", "single")
                      if cfg["detectors"].get(k, {}).get("count", 0)]
        self.span_chunks = int(round(cfg["span_hours"] * 3600.0 /
                                     self.chunk_s))
        # samples the engine scans of a chunk (conDatDuration + conBuff)
        self.pad_c = int((self.chunk_s + self.buff_s) * self.sr)
        # pass p of the span starts (p % max_passes) * shift_s later
        self.shift_s = float(traffic.get("pass_shift_seconds", 0.0))
        self.max_passes = int(traffic.get("max_passes", 1))
        # events start this far into a chunk's span and end inside it: in
        # one chunk of a pass, whatever the pass's shift
        self.event_margin_s = self.buff_s + (self.max_passes - 1) * \
            self.shift_s
        if self.chunk_s - self.event_margin_s - self.n_c / self.sr <= 0:
            raise ValueError("traffic %s: passes shift past a chunk"
                             % traffic["name"])

    def record_seconds(self):
        return self.src.record_seconds(self)

    def chunk(self, key):
        """(first record sample, samples, start time) of chunk ``key`` =
        (pass, chunk of the span); a negative pass is the warm-up's."""
        return self.src.chunk(self, key)

    def label_period(self):
        """Seconds between the start times of consecutive chunks: a row's
        chunk label is (STMP - T0) // label_period."""
        return self.src.label_period(self)

    def label(self, key):
        return self.chunk_of_time(self.chunk(key)[2])

    def chunk_of_time(self, t):
        return int(np.floor((t - T0) / self.label_period() + 1e-9))


def _only(d, allowed, what):
    extra = sorted(set(d) - set(allowed))
    if extra:
        raise ValueError("%s: keys %s are not read" % (what, extra))


class Station(object):
    def __init__(self, net, sta):
        self.net, self.sta = net, sta
        self.name = "%s.%s" % (net, sta)
        self.dets = {}          # kind -> list of detector dicts
        self.record = None      # int32 [nc, N], read-only
        self.events = []        # (kind, detector index, first sample, amp)


def make_inputs(cell, seed, device):
    """Stations with detectors and records for ``seed`` (torch's generator
    on ``device`` draws the bulk noise, numpy's the rest)."""
    cfg = cell.cfg
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    share = filtered_noise_share(cfg["filt"], cell.sr)
    # energy of the filtered noise under one template window
    e_noise = cell.n * (NOISE_COUNTS ** 2) * share
    lo, hi = cell.traffic["event_ds"]
    stations = []
    for k in range(int(cfg["stations"])):
        st = Station(cfg.get("network", "PB"), "S%02d" % (k + 1))
        for kind in cell.kinds:
            st.dets[kind] = _detectors(cell, kind, rng, gen, device, e_noise)
        st.record, st.events = _record(cell, st, rng, gen, device, e_noise,
                                       lo, hi)
        stations.append(st)
    return stations


def _detectors(cell, kind, rng, gen, device, e_noise):
    """Detectors of one kind: orthonormal bases [D, n] of band-limited,
    tapered noise (D = 1: single templates), training waveforms and
    magnitudes for the magnitude estimates, the threshold."""
    spec = cell.cfg["detectors"][kind]
    count = int(spec["count"])
    D = int(spec.get("dim", 1))
    w = torch.randn((count, D, cell.nc, cell.n_c), generator=gen,
                    device=device, dtype=torch.float64).cpu().numpy()
    w = _bandpass(w, cell.cfg["filt"], cell.sr) * np.hanning(cell.n_c)
    rows = _mux(w)                                   # [count, D, n]
    amp = np.sqrt(e_noise * 1.5)                     # a DS ~ 0.6 event
    dets = []
    prefix = "ss" if kind == "subspace" else "sg"
    for s in range(count):
        if D > 1:
            q, _ = np.linalg.qr(rows[s].T)
            U = np.ascontiguousarray(q[:, :D].T)
            c = rng.standard_normal((3, D))
            W = amp * (c / np.linalg.norm(c, axis=1, keepdims=True)) @ U
            extra = dict(mags=list(rng.uniform(0.5, 2.0, 3)),
                         events=["e0", "e1", "e2"], offsets=[0.0, 0.35, 0.7])
        else:
            U = rows[s] / np.linalg.norm(rows[s], axis=-1, keepdims=True)
            W = amp * U
            extra = dict(mags=[float(rng.uniform(0.5, 2.0))], events=["e0"],
                         offsets=[0.0])
        dets.append(dict(name="%s%04d" % (prefix, s), U=U, WFs=W,
                         threshold=float(cell.cfg["threshold"]), **extra))
    return dets


def _record(cell, st, rng, gen, device, e_noise, lo, hi):
    """The station's continuous record (int32 counts [nc, N], read-only)
    and its planted events: a fixed number a station-hour, spread evenly
    over the detectors, at seeded times (_event_starts), each with a
    strength from an even spread of target DS values [lo, hi]."""
    sr = cell.sr
    N = int(round(cell.record_seconds() * sr))
    x = torch.randn((cell.nc, N), generator=gen, device=device,
                    dtype=torch.float32) * NOISE_COUNTS
    n_ev = int(round(cell.traffic["events_per_station_hour"] *
                     cell.span_chunks * cell.chunk_s / 3600.0))
    all_dets = [(kind, i) for kind in cell.kinds
                for i in range(len(st.dets[kind]))]
    who = rng.permutation(np.arange(n_ev) % len(all_dets))
    target = rng.permutation(np.linspace(lo, hi, n_ev)) if n_ev else []
    starts = _event_starts(cell, n_ev, rng)
    events = []
    for e in range(n_ev):
        kind, i = all_dets[who[e]]
        U = st.dets[kind][i]["U"]
        c = rng.standard_normal(U.shape[0])
        w = (c / np.linalg.norm(c)) @ U                  # unit, multiplexed
        amp = np.sqrt(e_noise * target[e] / (1.0 - target[e]))
        sig_ = torch.as_tensor((amp * w).reshape(cell.n_c, cell.nc).T,
                               dtype=torch.float32, device=device)
        a = int(starts[e])
        x[:, a:a + cell.n_c] += sig_
        events.append((kind, i, a, float(amp)))
    rec = torch.round(x).to(torch.int32).cpu().numpy()
    rec.setflags(write=False)
    return rec, events


def _event_starts(cell, n_ev, rng):
    """First samples of ``n_ev`` events, one in each of n_ev equal slots of
    the span's chunk interiors laid end to end (a chunk's interior starts
    event_margin_s into it and ends a template before its end): every
    event lies in one chunk of a pass, and any stretch of the span holds
    the same number of events on every seed."""
    if not n_ev:
        return np.zeros(0, np.int64)
    inner = cell.chunk_s - cell.event_margin_s - cell.n_c / cell.sr
    slot = inner * cell.span_chunks / n_ev
    v = np.arange(n_ev) * slot + rng.uniform(0, slot, n_ev)
    c = np.minimum(np.floor(v / inner), cell.span_chunks - 1)
    t = c * cell.chunk_s + cell.event_margin_s + np.minimum(v - c * inner,
                                                            inner)
    return np.floor(t * cell.sr).astype(np.int64)


def events_in(cell, st, start, L):
    """(kind, detector index) of the events lying wholly inside record
    samples [start, start + L)."""
    return {(k, i) for k, i, a, _ in st.events
            if a >= start and a + cell.n_c <= start + L}
