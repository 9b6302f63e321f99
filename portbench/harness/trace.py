"""
Spans, wraps and the reduction of a device trace, for the traced run
(``--trace 1``) only.

A span is a named stretch of host time: the harness times it with the
host clock and marks it with torch.profiler.record_function, so that it
lies on the same time line as the device's operations. Spans come from the
harness's own chunk iterator ("fetch") and from program functions that a
per-layer metric names: each metric file lists, under SPANS, the span and
the "module:attribute" paths it wraps. A path that no longer resolves is
skipped, and the span then reads None. Nothing is wrapped in an untraced
run.

busy_us is a copy of chip_smoke.py's busy_us (the union of device
intervals), on the profiler's raw events.
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import time
from collections import defaultdict

import torch

PREFIX = "pb."


class Spans(object):
    """Host seconds by span name; a no-op unless ``on``."""

    def __init__(self, on):
        self.on = on
        self.seconds = defaultdict(float)
        self.count = defaultdict(int)
        self.missing = set()
        self._undo = []
        self._depth = 0

    @contextlib.contextmanager
    def span(self, name):
        if not self.on or self._depth:
            yield
            return
        from torch.autograd.profiler import record_function
        self._depth += 1
        t0 = time.perf_counter()
        try:
            with record_function(PREFIX + name):
                yield
        finally:
            self.seconds[name] += time.perf_counter() - t0
            self.count[name] += 1
            self._depth -= 1

    def wrap(self, name, path):
        """Wrap the callable at "module:attr" or "module:Class.attr" in a
        span called ``name``."""
        mod, _, attr = path.partition(":")
        try:
            owner = importlib.import_module(mod)
            parts = attr.split(".")
            for p in parts[:-1]:
                owner = getattr(owner, p)
            orig = getattr(owner, parts[-1])
        except (ImportError, AttributeError):
            self.missing.add(name)
            return
        spans = self

        @functools.wraps(orig)
        def wrapped(*args, **kw):
            with spans.span(name):
                return orig(*args, **kw)
        setattr(owner, parts[-1], wrapped)
        self._undo.append((owner, parts[-1], orig))

    def unwrap(self):
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo = []

    def read(self, name):
        if name in self.missing:
            return None
        return self.seconds.get(name, 0.0)


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class DeviceTrace(object):
    """What the profiler saw over the window: per card, its busy seconds
    (the union of its kernels, copies and sets) and the window's length;
    the device operations by total time; the idle time of the first card
    named by the harness span the host was in."""

    def __init__(self, prof, n_cards, window_s):
        events = prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        dev = defaultdict(list)
        ops = defaultdict(int)
        spans = []
        win = None
        for e in events:
            if e.name().startswith(PREFIX) and e.device_type() == cuda:
                continue            # a span's mark on the device's line
            if e.device_type() == cuda:
                s = e.start_ns()
                dev[e.device_index()].append((s, s + e.duration_ns()))
                ops[e.name()] += e.duration_ns()
            elif e.name().startswith(PREFIX):
                s = e.start_ns()
                iv = (s, s + e.duration_ns(), e.name()[len(PREFIX):])
                if iv[2] == "window":
                    win = iv
                else:
                    spans.append(iv)
        self.window_s = window_s
        self.busy_s = [busy_us(dev.get(i, [])) / 1e9 for i in range(n_cards)]
        self.device_ops = sorted(([k, v / 1e9] for k, v in ops.items()),
                                 key=lambda kv: -kv[1])[:10]
        self.idle_gaps = []
        if win is not None:
            self.idle_gaps = self._gaps(dev.get(0, []), spans, win)

    @staticmethod
    def _gaps(busy, spans, win):
        """Idle seconds of the first card inside the window by the span
        the host was in ("engine" outside every harness span)."""
        gaps = []
        t = win[0]
        for s, e in _union(busy):
            if s > t:
                gaps.append((t, min(s, win[1])))
            t = max(t, e)
        if t < win[1]:
            gaps.append((t, win[1]))
        named = defaultdict(float)
        spans = sorted(spans)
        first = 0
        for g0, g1 in gaps:
            covered = 0
            while first < len(spans) and spans[first][1] <= g0:
                first += 1
            for s, e, name in spans[first:]:
                if s >= g1:
                    break
                o = min(e, g1) - max(s, g0)
                if o > 0:
                    named[name] += o
                    covered += o
            named["engine"] += (g1 - g0) - covered
        return sorted(([k, v / 1e9] for k, v in named.items() if v > 0),
                      key=lambda kv: -kv[1])[:10]

    def idle_pct(self):
        return [100.0 * (1.0 - b / self.window_s) for b in self.busy_s]
