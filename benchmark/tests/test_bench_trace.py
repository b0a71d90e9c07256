"""The trace reduction on planted device and host events."""

import pytest

from benchmark.metrics.lib.trace import SPIN_NAME, Trace


def _spins(start, n=3, each=10.0):
    return [(SPIN_NAME, start + i * each, start + (i + 1) * each)
            for i in range(n)]


def test_window_busy_idle_and_kernels():
    device = _spins(0.0) + [
        ("conv", 100.0, 200.0), ("bn", 150.0, 230.0),   # overlap: 130 busy
        ("Memcpy HtoD (Pageable -> Device)", 300.0, 320.0),
        ("relu", 400.0, 500.0),
    ] + _spins(600.0)
    t = Trace(device, [], {})
    assert t.window_s == pytest.approx(570e-6)        # 30 .. 600 us
    assert t.busy_s == pytest.approx(250e-6)
    assert t.idle_pct() == pytest.approx(100 * (1 - 250 / 570))
    assert t.kernels() == 3                           # the copy is no kernel
    assert t.top_ops(2) == [["conv", pytest.approx(100e-6)],
                            ["relu", pytest.approx(100e-6)]]


def test_marks_bound_the_window_inside_a_running_loop():
    """Two spins launched alone mark the window; the loop's first and
    last items (ramp-up, drain) and the guards lie outside it."""
    device = [("ramp", 0.0, 1500.0)] + _spins(1500.0) + [
        ("step0", 1530.0, 3000.0), (SPIN_NAME, 3000.0, 3001.0),
        ("step1", 3001.0, 4000.0), ("step2", 4500.0, 6000.0),
        (SPIN_NAME, 6000.0, 6001.0), ("step3", 6001.0, 7000.0),
    ] + _spins(9000.0)
    t = Trace(device, [], {})
    assert t.window_s == pytest.approx((6000.0 - 3001.0) * 1e-6)
    assert t.busy_s == pytest.approx((999.0 + 1500.0) * 1e-6)
    assert [n for _, _, n in t.work] == ["step1", "step2"]


def test_a_lost_spin_block_falls_back_to_the_work():
    t = Trace([("k", 5.0, 15.0), ("k", 25.0, 35.0)], [], {})
    assert t.window_s == pytest.approx(30e-6)
    assert t.busy_s == pytest.approx(20e-6)


def test_idle_gaps_by_the_innermost_host_op():
    device = _spins(0.0) + [("a", 100.0, 110.0), ("b", 200.0, 210.0),
                            ("c", 250.0, 260.0)] + _spins(300.0)
    host = [("bench.step", 1, 90.0, 240.0), ("aten::item", 1, 150.0, 200.0),
            ("bench.feed", 1, 240.0, 250.0), ("other", 2, 0.0, 400.0)]
    gaps = dict((k, v) for k, v in Trace(device, host, {}).idle_gaps())
    # gaps 30..100 and 260..300 start where thread 1 runs nothing; 110..200
    # and 210..250 inside bench.step (aten::item starts after 110)
    assert gaps["bench.step"] == pytest.approx((90 + 40) * 1e-6)
    assert gaps["(no host op)"] == pytest.approx((70 + 40) * 1e-6)


def test_range_device_time_finds_nothing_as_none():
    t = Trace([("k", 0.0, 1.0)], [], {"bench.warp": [2.0, 3.0]})
    assert t.range_device_s("bench.warp") == pytest.approx(5e-6)
    assert t.range_device_s("bench.other") is None
