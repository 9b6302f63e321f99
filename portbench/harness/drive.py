"""
One run of a cell: set-up (inputs from the seed, the chunk source's
preparation, banks and warm-up), the measured window, and what the check
needs afterwards.

The window drives detex_torch.detect.detex, the engine seam that
SubSpace.detex calls, with the arguments SubSpace.detex passes: the
subspace detectors (issubspace=True), then the single templates, over
every station. The traffic's window module (portbench/harness/windows/)
decides how the calls are made and when the window ends; its chunk source
(portbench/harness/sources/) where the chunks come from.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np

from portbench.harness import gen as _gen
from portbench.harness.trace import Spans


class Run(object):
    def __init__(self, cfg, traffic, seed, seconds, device, workdir,
                 n_cards=1):
        self.cfg = cfg
        self.cell = _gen.Cell(cfg, traffic)
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.device = device
        self.workdir = workdir
        self.n_cards = n_cards
        self.spans = Spans(False)       # on for a traced window only
        self.calls = []          # one entry a detect.detex call in the window
        self.captured = {}       # (station, chunk key) -> handed samples
        self.passes = 0
        self.chunks_scanned = 0
        self.window_s = None

    # -- inputs -------------------------------------------------------------
    def setup(self):
        from detex_torch.core.stream import Stream, Trace
        self._Stream, self._Trace = Stream, Trace
        cell = self.cell
        self.stations = _gen.make_inputs(cell, self.seed, self.device)
        self._by_name = {st.name: st for st in self.stations}
        self._det_index = {
            (st.name, kind): {d["name"]: d for d in st.dets[kind]}
            for st in self.stations for kind in cell.kinds}
        cell.src.prepare(self)
        rng = np.random.default_rng([self.seed % (1 << 63), 3])
        n_cap = int(cell.traffic["check"]["handed_chunks"])
        first = cell.win.capture_candidates(self)
        pick = rng.choice(len(first), min(n_cap, len(first)), replace=False)
        self._capture = {first[i] for i in pick}

    def station(self, name):
        return self._by_name[name]

    def dets_of(self, kind, sta):
        return self._by_name[sta].dets[kind]

    def det(self, kind, name, sta):
        return self._det_index[(sta, kind)][name]

    def _engine_stations(self, kind):
        return {st.name: dict(channels=list(self.cell.channels),
                              sr=self.cell.sr, detectors=st.dets[kind])
                for st in self.stations}

    def _engine_kw(self):
        """detect.detex's arguments as SubSpace.detex passes them, with the
        configuration's filter, dtype, batch size, device prep and
        trigger condition."""
        cfg = self.cfg
        return dict(conDatDuration=self.cell.chunk_s,
                    conBuff=self.cell.buff_s, eventCorFile="EventCors",
                    utcSaves=None, filt=cfg["filt"], decimate=None,
                    trigCon=int(cfg.get("trig_con", 0)), triggerLTATime=5,
                    triggerSTATime=0, staltaThreshold=None, calcHist=True,
                    dtype=cfg["dtype"], estimateMags=True, fillZeros=False,
                    batchSize=int(cfg["batch_size"]),
                    devicePrep=bool(cfg.get("device_prep", False)),
                    device=self.device)

    # -- chunks -------------------------------------------------------------
    def stream(self, st, key):
        """Chunk ``key`` of station ``st`` as a Stream of record views."""
        cell = self.cell
        start, L, t0 = cell.chunk(key)
        return self._Stream([self._Trace(
            st.record[c, start:start + L],
            dict(network=st.net, station=st.sta, location="",
                 channel=ch, sampling_rate=cell.sr, starttime=t0))
            for c, ch in enumerate(cell.channels)])

    def chunks(self, call, keys_of, limit=None, stop_at=None,
               capture=False):
        """chunks(sta) for one engine call, drawing from the chunk source
        over keys_of(sta): counts what it hands out, copies the samples of
        the chunks drawn for the check, spans each next() as "fetch" in a
        traced run, and stops at ``limit`` chunks or at ``stop_at`` (host
        clock)."""
        def chunks(name):
            st = self._by_name[name]
            handed = call["handed"].setdefault(name, [])
            it = self.cell.src.chunks(self, st, keys_of(name))
            while True:
                if limit is not None and len(handed) >= limit:
                    return
                if stop_at is not None and time.perf_counter() >= stop_at:
                    return
                with self.spans.span("fetch"):
                    try:
                        key, item = next(it)
                    except StopIteration:
                        return
                handed.append(key)
                if capture and (name, key) in self._capture:
                    tr = sorted(item[0], key=lambda t: t.stats.channel)
                    self.captured[(name, key)] = np.stack(
                        [np.asarray(t.data, np.float64) for t in tr])
                yield item
        return chunks

    # -- the engine ---------------------------------------------------------
    def detex(self, kind, chunks, db):
        from detex_torch import detect
        return detect.detex(self._engine_stations(kind), chunks, db,
                            issubspace=kind == "subspace", **self._engine_kw())

    def warmup(self):
        """Every shape the window uses (the window module's warm-up)."""
        self.cell.win.warmup(self)
        _sync(self.device)

    def window(self):
        """The measured window; sets window_s and chunks_scanned (the
        distinct chunks of new data handed out)."""
        t0 = time.perf_counter()
        self.cell.win.window(self)
        _sync(self.device)
        self.window_s = time.perf_counter() - t0
        self.chunks_scanned = len({(sta, k) for c in self.calls
                                   for sta, v in c["handed"].items()
                                   for k in v})


def _sync(device):
    import torch
    if str(device).startswith("cuda"):
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


@contextlib.contextmanager
def profiled(on):
    """torch.profiler over the block when ``on`` (CPU activity for the
    harness's spans, CUDA for the device's operations)."""
    if not on:
        yield None
        return
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("pb.window"):
            yield prof
