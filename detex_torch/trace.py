"""
Spans and counters of the detection engine.

A span is a named stretch of host time at one of the engine's layer
boundaries (``fetch``, ``prep``, ``prep.wait``, ``dispatch``,
``materialize`` and their children; README.md lists them). On the batched
path ``prep`` opens on the engine's prep worker, the one thread each
batched engine call starts for its chunks' preparation and joins before
it returns; ``prep.wait`` is the engine's thread blocked on a chunk whose
prep had not ended. ``with span(name, batch=None):`` records
its name, start and end (``time.perf_counter_ns``), its parent (the span
open around it on the same thread), the thread and an optional batch id,
and opens ``torch.profiler.record_function("detex." + name)``, so that
under torch.profiler the span lies on the profiler's time line beside the
card's kernels and copies. Spans are recorded only between ``enable()``
and ``disable()``; tracing is off by default, and ``span`` then hands back
one shared object that does nothing. Recorded spans stay in memory until
``reset()``; ``snapshot()`` gives them, ``report()`` their totals by name.

Counters count whether tracing is on or off, under one lock (sharded
scans count from a host thread a card): the engine's own (``count``;
chunks, batches, chunks_gated, reverify_rows_computed,
reverify_rows_gated, rows_written, h2d_bytes, d2h_bytes; prep.fused and
prep.fallback, one a chunk prepared or re-filtered on the host, in one
native pass or by _applyFilter; prep.ahead and prep.waited, one a chunk
the batched path prepared, usable or not, as its prep had ended when the
engine took it or the engine waited for it) and the groups
registered under a prefix, ops/cuda_kernels.LAUNCHES ("launches") and
parallel/scan.ROUTE_COUNTS ("routes"). ``reset()`` keeps the counters: a
reader takes the difference of two snapshots. cuda_kernels.reset_launches()
and ROUTE_COUNTS.clear() zero their groups, so two snapshots to be
differenced must not straddle such a reset.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import Counter

from torch.autograd.profiler import record_function

PREFIX = "detex."

#: the engine's own counters by name
COUNTERS = Counter()
_GROUPS = {}
_LOCK = threading.Lock()

_on = False
_spans = []                  # (name, t0_ns, t1_ns, id, parent, thread, batch)
_ids = itertools.count()
_local = threading.local()


class _Off(object):
    """The span handed out while tracing is off: one shared instance."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span(object):
    __slots__ = ("name", "batch", "id", "parent", "t0", "_rf")

    def __init__(self, name, batch):
        self.name = name
        self.batch = batch

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        self._rf = record_function(PREFIX + self.name)
        self._rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self._rf.__exit__(*exc)
        _local.stack.pop()
        _spans.append((self.name, self.t0, t1, self.id, self.parent,
                       threading.get_ident(), self.batch))
        return False


def span(name, batch=None):
    """A context manager timing ``name`` while tracing is on."""
    if not _on:
        return _OFF
    return _Span(name, batch)


def enable():
    """Record spans from now on."""
    global _on
    _on = True


def disable():
    """Stop recording spans; those recorded are kept."""
    global _on
    _on = False


def reset():
    """Forget the recorded spans (the counters are kept)."""
    del _spans[:]


def count(name, n=1, counts=COUNTERS):
    """Add ``n`` to counter ``name`` of ``counts`` (the engine's own by
    default, or a registered group)."""
    with _LOCK:
        counts[name] += n


def counter_group(prefix, counts):
    """Register the dict ``counts`` (counted with ``count(key,
    counts=counts)``) to be reported as "<prefix>.<key>"; returns it."""
    _GROUPS[prefix] = counts
    return counts


def counters():
    """Every counter by name: the engine's and each group's keys under
    their prefix."""
    with _LOCK:
        out = dict(COUNTERS)
        for prefix, counts in _GROUPS.items():
            out.update(("%s.%s" % (prefix, k), v) for k, v in counts.items())
    return out


def snapshot():
    """{"spans": [{name, start_ns, end_ns, id, parent, thread, batch}],
    "counters": counters()}: the spans in the order they ended."""
    keys = ("name", "start_ns", "end_ns", "id", "parent", "thread", "batch")
    return {"spans": [dict(zip(keys, s)) for s in list(_spans)],
            "counters": counters()}


def report(spans=None):
    """Per span name, in order of total time: {"name", "calls",
    "total_s", "self_s"}; a span's self time is its duration less that of
    its children. Over the recorded spans, or over ``spans`` as
    snapshot() gives them."""
    if spans is None:
        spans = snapshot()["spans"]
    child = Counter()
    for s in spans:
        if s["parent"] is not None:
            child[s["parent"]] += s["end_ns"] - s["start_ns"]
    rows = {}
    for s in spans:
        dur = s["end_ns"] - s["start_ns"]
        r = rows.setdefault(s["name"], dict(name=s["name"], calls=0,
                                            total_s=0.0, self_s=0.0))
        r["calls"] += 1
        r["total_s"] += dur / 1e9
        r["self_s"] += (dur - child[s["id"]]) / 1e9
    return sorted(rows.values(), key=lambda r: -r["total_s"])
