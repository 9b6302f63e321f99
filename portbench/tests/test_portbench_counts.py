"""The yardstick's arithmetic on fixed inputs: peaks and bounds, the
scan's counted work, the device's busy and idle time, idle gaps by span."""
import math

import pytest

from portbench.harness import counts
from portbench.harness.trace import DeviceTrace, busy_us


def test_bound_and_rfft_flops():
    assert counts.rfft_flops(1024) == 2.5 * 1024 * 10
    t, by = counts.bound(3.35e12, 0)
    assert by == "bytes" and t == pytest.approx(1.0)
    t, by = counts.bound(0, 67e12 * 2)
    assert by == "operations" and t == pytest.approx(2.0)


def test_pad_rows_and_block():
    assert [counts.pad_rows(s) for s in (1, 8, 9, 12, 1000)] == \
        [8, 8, 16, 16, 1024]
    assert counts.os_block(3000, 372000) == 16384
    assert counts.os_block(100, 372000) == 16384
    assert counts.os_block(100, 1000) == 512


def test_scan_work_by_hand():
    nbytes, flops = counts.scan_work(8, 8, 8, 1, 3, 3000, 372000, False)
    W = 16384 - 3000 + 1
    frames = math.ceil((372000 - 3000 + 1) / W)
    bins = 8193
    assert nbytes == 8 * 3 * 372000 * 4 + 8 * 3 * bins * 8 + 8 * 8 * 4 + \
        8 * 400 * 4
    per = (3 * frames * counts.rfft_flops(16384) + 8 * frames * 3 * bins * 8
           + 8 * frames * counts.rfft_flops(16384))
    assert flops == pytest.approx(8 * per)
    _, f2 = counts.scan_work(8, 8, 8, 1, 3, 3000, 372000, True)
    nf = 2 ** 19
    assert f2 - flops == pytest.approx(
        8 * 3 * (2 * counts.rfft_flops(nf) + 6 * (nf // 2 + 1)))


def test_busy_union():
    assert busy_us([(0, 10), (5, 15), (20, 30)]) == 25
    assert busy_us([]) == 0


def test_idle_gaps_named_by_span():
    busy = [(10, 20), (40, 50)]
    spans = [(0, 15, "fetch"), (22, 35, "host_prep")]
    gaps = dict(DeviceTrace._gaps(busy, spans, (0, 60, "window")))
    # idle 0-10, 20-40, 50-60: fetch 10, host_prep 13, the rest engine 17
    assert gaps == {"fetch": 10e-9, "host_prep": 13e-9, "engine": 17e-9}


def test_idle_share():
    class T(DeviceTrace):
        def __init__(self):
            self.window_s = 10.0
            self.busy_s = [2.5, 5.0]
    assert T().idle_pct() == [75.0, 50.0]
