"""The yardstick's arithmetic against hand counts at small shapes."""

import pytest

from benchmark.metrics.lib import roofline


def test_production_dec1_warp_bound_is_0_2817_ms():
    b = roofline.warp_bytes(8, 480, 640, 96, elem_bytes=2)
    assert b["dec1"] == 2 * 8 * 480 * 640 * 96 * 2 + 8 * 6 * 4
    assert roofline.bound_s(b["dec1"]) * 1e3 == pytest.approx(0.28171, abs=1e-5)
    # each coarser level holds a quarter of the pixels and twice the
    # channels: the five served levels' bound is 1.9375 x dec1's
    assert sum(roofline.bound_s(v) for v in b.values()) * 1e3 == \
        pytest.approx(0.54581, abs=1e-5)


def test_warp_bytes_follow_the_odd_pools():
    # 240 rows pool to 120, 60, 30, 15, 7: dec5 warps the transposed
    # conv's 14 x 20 map of the 7 x 10 bottleneck
    b = roofline.warp_bytes(1, 240, 320, 4, elem_bytes=4)
    assert b["dec5"] == 2 * 14 * 20 * (4 << 4) * 4 + 6 * 4
    assert b["dec4"] == 2 * 30 * 40 * (4 << 3) * 4 + 6 * 4


def _conv(b, h, w, cin, cout, k):
    return 2 * b * h * w * cin * cout * k * k


def _dense(b, cin, cout):
    return 2 * b * cin * cout


def _film(b, c):
    return _dense(b, 4, 128) + _dense(b, 128, 256) + 2 * _dense(b, 256, c)


def _cbam(b, h, w, c):
    r = max(c // 16, 1)
    return 2 * (_dense(b, c, r) + _dense(b, r, c)) + _conv(b, h, w, 2, 1, 7)


def _hand_forward(b, hh, ww, f):
    hs, ws = [hh], [ww]
    for _ in range(5):
        hs.append(hs[-1] // 2)
        ws.append(ws[-1] // 2)
    total = _conv(b, hh, ww, 6, f, 3) + _film(b, f) + _conv(b, hh, ww, f, f, 3)
    for i in range(1, 6):          # enc2..enc5 and the bottleneck
        cin, c = f << (i - 1), f << i
        total += _conv(b, hs[i], ws[i], cin, c, 3) + _film(b, c) + \
            _conv(b, hs[i], ws[i], c, c, 3) + _cbam(b, hs[i], ws[i], c)
    for i in range(5, 0, -1):      # dec5..dec1
        cin, c = f << i, f << (i - 1)
        total += _conv(b, hs[i], ws[i], cin, c, 2)       # transposed 2x2
        total += _dense(b, c + 4, 128) + _dense(b, 128, 128) + \
            _dense(b, 128, 6)
        h, w = hs[i - 1], ws[i - 1]
        total += _conv(b, h, w, 2 * c, c, 3) + _film(b, c) + \
            _conv(b, h, w, c, c, 3) + _cbam(b, h, w, c)
    return total + _conv(b, hh, ww, f, 1, 1)


def test_forward_flops_match_a_hand_count():
    assert roofline.model_flops(4, 2, 64, 96, train=False) == \
        _hand_forward(2, 64, 96, 4)


def test_training_flops_are_about_three_forwards():
    fwd = roofline.model_flops(8, 2, 64, 96, train=False)
    train = roofline.model_flops(8, 2, 64, 96, train=True)
    # the backward takes two products a forward product, but no input
    # gradient of the first convolution
    assert 2.9 * fwd < train < 3.0 * fwd
