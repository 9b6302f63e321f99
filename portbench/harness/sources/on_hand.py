"""
Chunks on hand: views of the station's record in memory, as a real-time
feed or a user's own reader hands them over, raw Streams of a chunk and
its buffer (conDatDuration + conBuff).

Chunk (p, c) is hour c of the span in pass p, which starts
(p % max_passes) * pass_shift_seconds into the record: consecutive chunks
overlap by the buffer alone, and the chunks of max_passes passes are
distinct. Its start time runs on through the passes, as a feed's does.
"""
from __future__ import annotations

import numpy as np

from portbench.harness.gen import T0

# traffic keys this source reads
KEYS = ("pass_shift_seconds", "max_passes")


def record_seconds(cell):
    return (cell.span_chunks * cell.chunk_s + cell.buff_s +
            (cell.max_passes - 1) * cell.shift_s)


def label_period(cell):
    return cell.chunk_s + cell.buff_s


def chunk(cell, key):
    p, c = key
    start = (p % cell.max_passes) * cell.shift_s + c * cell.chunk_s
    return (int(round(start * cell.sr)), cell.pad_c,
            T0 + (p * cell.span_chunks + c) * label_period(cell))


def prepare(run):
    """Nothing to write: the record is on hand."""


def chunks(run, st, keys):
    """(key, (Stream, None, None)) for each key, a view of the record."""
    for key in keys:
        yield key, (run.stream(st, key), None, None)


def handed(run, sta, key):
    """The samples of chunk ``key`` as the engine is handed them."""
    start, L, _ = chunk(run.cell, key)
    return np.asarray(run.station(sta).record[:, start:start + L],
                      np.float64)
