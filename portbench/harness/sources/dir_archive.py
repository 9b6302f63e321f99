"""
Chunks from a 'dir' archive: the benchmark writes each station's record as
npz hour files (harness/archive.py) and indexes them with the port's
indexDirectory in set-up; each engine call reads them through a new
DataFetcher('dir') and getConData(..., returnTimes=True), as
subspace._fetcher_con_chunks does.

Chunk (p, c) is hour file c in every pass p (passes re-read the same
files, from the page cache): the one file the fetcher keeps of a request
[t, t + chunk + buffer], whose last buffer seconds lie in the next file,
less than a tenth of the request. The fetcher detrends what it reads.
"""
from __future__ import annotations

import os

from portbench.harness import archive as _archive
from portbench.harness.gen import T0
from portbench.reference import engine64 as ref

KEYS = ()


def record_seconds(cell):
    # files of one chunk over the span and one more
    return (cell.span_chunks + 1) * cell.chunk_s


def label_period(cell):
    return cell.chunk_s


def chunk(cell, key):
    c = int(key[1])
    per = int(round(cell.chunk_s * cell.sr))
    return c * per, per, T0 + c * cell.chunk_s


def prepare(run):
    from detex_torch.data import fetcher
    run.archive_dir = os.path.join(run.workdir, "archive")
    run.stakey = _archive.write_archive(run.cell, run.stations,
                                        run.archive_dir)
    fetcher.indexDirectory(run.archive_dir)


def chunks(run, st, keys):
    """(key, (Stream, utc1, utc2)) as a new 'dir' DataFetcher reads them;
    the key is the one of ``keys`` that starts at the chunk's time."""
    from detex_torch.data import fetcher
    cell = run.cell
    by_time = {cell.chunk_of_time(chunk(cell, k)[2]): k for k in keys}
    fet = fetcher.DataFetcher("dir", directoryName=run.archive_dir,
                              conDatDuration=cell.chunk_s,
                              conBuff=cell.buff_s)
    rows = [r for r in run.stakey if r["STATION"] == st.sta]
    for item in fet.getConData(rows, utcstart=None, utcend=None,
                               returnTimes=True):
        yield by_time[cell.chunk_of_time(item[1].timestamp)], item


def handed(run, sta, key):
    """The record's samples of hour file c, detrended as the fetcher does."""
    start, L, _ = chunk(run.cell, key)
    return ref.detrend(run.station(sta).record[:, start:start + L]
                       .astype("float64"))
