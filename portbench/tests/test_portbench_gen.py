"""The generator is seeded: the same seed gives the same inputs, another
seed other inputs of the same sizes and the same number of events."""
import numpy as np
import pytest

from conftest import tiny_cell


def inputs(traffic, seed):
    from portbench.harness import gen
    res = tiny_cell(traffic)
    cell = gen.Cell(res["config"], res["traffic"])
    return cell, gen.make_inputs(cell, seed, "cpu")


@pytest.mark.parametrize("traffic", ["archive", "swarm", "feed"])
def test_same_seed_same_inputs(traffic):
    _, a = inputs(traffic, 2 ** 31 + 12345)
    _, b = inputs(traffic, 2 ** 31 + 12345)
    for sa, sb in zip(a, b):
        assert np.array_equal(sa.record, sb.record)
        assert sa.events == sb.events
        for kind in sa.dets:
            for da, db in zip(sa.dets[kind], sb.dets[kind]):
                assert np.array_equal(da["U"], db["U"])


@pytest.mark.parametrize("traffic", ["archive", "swarm", "feed"])
def test_other_seed_other_inputs_same_sizes(traffic):
    cell, a = inputs(traffic, 7)
    _, b = inputs(traffic, 8)
    for sa, sb in zip(a, b):
        assert sa.record.shape == sb.record.shape
        assert not np.array_equal(sa.record, sb.record)
        assert len(sa.events) == len(sb.events)
        assert sorted(round(e[3], 6) for e in sa.events) == \
            sorted(round(e[3], 6) for e in sb.events)
        assert not sa.record.flags.writeable


def test_chunks_are_distinct_and_inside_the_record():
    for traffic in ("swarm", "feed"):
        cell, sts = inputs(traffic, 3)
        N = sts[0].record.shape[1]
        keys = [(p, c) for p in range(cell.max_passes)
                for c in range(cell.span_chunks)]
        seen = set()
        for k in keys + [(-1, 0), (-1, 5)]:
            start, L, t0 = cell.chunk(k)
            assert 0 <= start and start + L <= N
            if k[0] >= 0:
                assert (start, L) not in seen
                seen.add((start, L))
            assert cell.chunk_of_time(t0 + 1.0) == k[0] * cell.span_chunks \
                + k[1]


@pytest.mark.parametrize("traffic", ["archive", "swarm", "feed"])
def test_events_stratified_one_chunk_each(traffic):
    """Each event lies in exactly one chunk of every pass, and every seed
    puts the same number of events in each stretch of the span's slots."""
    cell, sts = inputs(traffic, 2 ** 31 + 99)
    n_ev = len(sts[0].events)
    assert n_ev == round(cell.traffic["events_per_station_hour"] *
                         cell.span_chunks * cell.chunk_s / 3600.0)
    for p in (0, cell.max_passes - 1):
        for st in sts:
            hits = [0] * n_ev
            for c in range(cell.span_chunks):
                start, L, _ = cell.chunk((p, c))
                for e, (_, _, a, _) in enumerate(st.events):
                    if a < start + L and a + cell.n_c > start:
                        assert a >= start and a + cell.n_c <= start + L
                        hits[e] += 1
            assert hits == [1] * n_ev
    starts = sorted(e[2] for e in sts[0].events)
    _, other = inputs(traffic, 5)
    assert len(other[0].events) == n_ev
    assert starts != sorted(e[2] for e in other[0].events)


def test_unread_keys_are_refused():
    from portbench.harness import gen
    res = tiny_cell("feed")
    with pytest.raises(ValueError, match="not read"):
        gen.Cell(dict(res["config"], decimate=2), res["traffic"])
    with pytest.raises(ValueError, match="not read"):
        gen.Cell(res["config"], dict(res["traffic"], stride_seconds=90))
    with pytest.raises(ValueError, match="trigCon"):
        gen.Cell(dict(res["config"], trig_con=1), res["traffic"])
    with pytest.raises(ValueError):
        gen.Cell(res["config"], dict(res["traffic"], window="../x"))


def test_feed_histograms_one_detector_a_block():
    """A one-call window checks the histogram of one detector in every
    block of hist_block_rows, the last, short block included."""
    from portbench.harness import gen
    from portbench.harness.windows import one_call
    res = tiny_cell("feed")
    cfg = dict(res["config"], detectors={"single": {"count": 5}})
    cell = gen.Cell(cfg, res["traffic"])
    assert cell.traffic["check"]["hist_block_rows"] == 2
    dets = [dict(name="sg%04d" % i) for i in range(5)]
    st = gen.Station("TT", "S01")

    class StubRun(object):
        pass
    run = StubRun()
    run.cell = cell
    run.calls = [dict(kind="single",
                      handed={st.name: [(0, c) for c in range(4)]})]
    run.dets_of = lambda kind, sta: dets
    run.station = lambda sta: st
    seen = set()
    for seed in range(20):
        _, hist = one_call.plan(run, np.random.default_rng(seed))
        keys, names = hist[(0, st.name)]
        assert len(keys) == 4
        assert [int(n[2:]) // 2 for n in names] == [0, 1, 2]
        seen.update(names)
    assert len(seen) == 5
