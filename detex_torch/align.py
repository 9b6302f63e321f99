"""
Waveform alignment from the clustering linkage tree (Harris 2006 App. B).

Namesake of detex_tpu/align.py, host numpy. The reference juggles condensed
indices and a CC-keyed lag map (construct.py:710-849); this is the
equivalent invariant walk: at each single-linkage merge the two groups are
aligned by the lag of their best-correlated cross pair, adjusted by the
shifts already applied,

    lag_current(i, j) = lag_orig(i, j) + delay[i] - delay[j]

where lag_orig(i, j) (i < j, upper triangle) is the multiplexed-sample lag
of the pairwise correlation (positive: event j's signal sits later in its
trace than event i's). The group holding the larger-index event of the
best pair is shifted (the reference's ev1/ev2 orientation,
construct.py:748-758).
"""
from __future__ import annotations

import numpy as np

import detex_torch


def alignment_delays(link, cc_mat, lag_mat):
    """Per-event integer front-trim delays from a linkage tree.

    ``link`` [m-1, 4] is the scipy linkage over the m events, ``cc_mat`` /
    ``lag_mat`` [m, m] the max correlations and integer lags (upper
    triangle i < j filled). Returns delays [m] int64 with min 0: trimming
    ``delays[e]`` samples from the front of event e's multiplexed trace
    aligns the group (reference _getDelays and the delayNP normalization,
    construct.py:281-285). Of cross pairs whose cc agree within 1e-12 the
    first in row-major order wins, as the reference's first-match search
    of its dissimilarity frame does."""
    cc_mat = np.asarray(cc_mat, dtype=np.float64)
    lag_mat = np.asarray(lag_mat, dtype=np.float64)
    m = cc_mat.shape[0]
    delays = np.zeros(m, dtype=np.int64)
    members = {i: [i] for i in range(m)}
    if m == 1 or link is None or len(link) == 0:
        return delays
    for step, row in enumerate(np.asarray(link)):
        m1, m2 = members[int(row[0])], members[int(row[1])]
        best_v = -np.inf
        best = None
        for a in m1:
            for b in m2:
                i, j = (a, b) if a < b else (b, a)
                v = cc_mat[i, j]
                if np.isnan(v):
                    continue
                if v > best_v + 1e-12 or (abs(v - best_v) <= 1e-12 and
                                          best is not None and
                                          (i, j) < best):
                    best_v = v
                    best = (i, j)
        members[m + step] = m1 + m2
        if best is None:
            detex_torch.log(__name__, "no finite CC between clusters at "
                            "merge %d; leaving relative shift at 0" % step,
                            level="warning")
            continue
        i, j = best
        cur = int(np.round(lag_mat[i, j] + delays[i] - delays[j]))
        for b in (m2 if j in m2 else m1):   # the group holding ev2 (= j)
            delays[b] += cur
    return delays - delays.min()


def align_and_trim(wf_dict, event_list, delays):
    """Apply front-trim delays and cut to the common length (reference
    _alignTD, construct.py:486-504): {event: aligned array}, each
    ``len(first waveform) - max(delays)`` long. ``wf_dict`` maps event
    names to 1-D multiplexed waveforms, ``event_list`` orders them as
    ``delays``."""
    delays = np.asarray(delays, dtype=np.int64)
    tdlen = len(wf_dict[event_list[0]]) - int(delays.max())
    aligned = {}
    for ev, d in zip(event_list, delays):
        seg = wf_dict[ev][int(d):][:tdlen]
        if len(seg) == 0:
            detex_torch.log(__name__, "Alignment of multiplexed stream "
                            "failing on event %s; try raising ccreq or "
                            "widening the trim window%s"
                            % (ev, _id_align_problems(event_list, delays)),
                            level="error")
        aligned[ev] = seg
    return aligned


def _id_align_problems(event_list, delays, m=7):
    """Messages flagging shifts more than ``m`` median absolute deviations
    from the median (reference _idAlignProblems, construct.py:507-522)."""
    offsets = np.asarray(delays, dtype=np.float64)
    d = np.abs(offsets - np.median(offsets))
    mdev = np.median(d)
    s = d / mdev if mdev else np.zeros_like(d)
    return "".join("\nAlignment shift for event %s is an outlier, consider "
                   "removing it" % ev
                   for ev, out in zip(event_list, s > m) if out)
