"""The readers of the port's spans (``metrics/lib/program_spans.py``) on
fabricated span lists."""

import importlib

import pytest

from benchmark.core import manifest
from benchmark.metrics.lib import program_spans as ps

_ids = iter(range(1, 10 ** 6))


def _span(name, session, trace=None, device_ms=None, start_ms=0.0,
          host_ms=1.0):
    start = int(start_ms * 1e6)
    return {"name": name, "id": next(_ids), "parent": None, "trace": trace,
            "thread": 1, "session": session, "start_ns": start,
            "end_ns": start + int(host_ms * 1e6), "device_ms": device_ms,
            "attrs": {}}


def _steps(session, traces, step_ms, forward_ms, norm_ms, feed_ms=1.0):
    out = []
    for t in traces:
        out += [_span("train.feed", session, t, feed_ms),
                _span("train.step", session, t, step_ms),
                _span("train.forward", session, t, forward_ms),
                _span("norm.fwd", session, t, norm_ms),
                _span("norm.fwd", session, t, norm_ms),
                _span("norm.bwd", session, t, 2 * norm_ms)]
    return out


def test_the_first_session_alone_is_read():
    spans = ([_span("setup.store", None, host_ms=2500.0)]
             + _steps(1, [10, 11, 12], 100.0, 30.0, 5.0)
             + _steps(2, [40, 41], 300.0, 90.0, 50.0))
    assert [s["session"] for s in ps.first_session(spans)] == [1] * 18
    assert ps.step_median_ms("train.forward", spans) == pytest.approx(30.0)
    # 4 x 5 ms of norms in each 100 ms step
    assert ps.norm_share_pct(spans) == pytest.approx(20.0)
    assert ps.setup_s("setup.store", spans) == pytest.approx(2.5)


def test_step_medians_sum_a_steps_spans_and_skip_the_last_feed():
    spans = _steps(3, [5, 6, 7], 100.0, 30.0, 5.0, feed_ms=2.0)
    spans[6 * 1]["device_ms"] = 7.0          # step 6's feed
    spans.append(_span("train.feed", 3, 8, 0.01))   # ends the epoch
    assert ps.step_median_ms("train.feed", spans) == pytest.approx(2.0)
    assert ps.step_median_ms(("train.feed", "train.step"), spans) == \
        pytest.approx(102.0)
    assert ps.step_median_ms("norm.fwd", spans) == pytest.approx(10.0)


def test_host_and_device_medians():
    spans = [_span("serve.pad", 1, i, None, host_ms=ms)
             for i, ms in enumerate([3.0, 1.0, 2.0, 100.0])]
    spans += [_span("serve.forward", 1, i, d)
              for i, d in enumerate([60.0, 62.0, 61.0])]
    spans += [_span("serve.pad", 2, 9, None, host_ms=500.0)]
    assert ps.median_ms("serve.pad", False, spans) == pytest.approx(2.5)
    assert ps.median_ms("serve.forward", True, spans) == pytest.approx(61.0)


def test_nothing_recorded_reads_none():
    for spans in ([], [_span("setup.model", None, host_ms=5.0)]):
        assert ps.step_median_ms("train.forward", spans) is None
        assert ps.norm_share_pct(spans) is None
        assert ps.median_ms("serve.h2d", False, spans) is None
        assert ps.setup_s("setup.store", spans) is None
    # spans without the card's time (a CPU run) read none on the card
    cpu = [dict(s, device_ms=None) for s in _steps(1, [1, 2], 1, 1, 1)]
    assert ps.step_median_ms("train.forward", cpu) is None
    assert ps.norm_share_pct(cpu) is None


def test_a_port_without_spans_reads_none(monkeypatch):
    profiling = importlib.import_module("cadepth_tpu_torch.utils.profiling")
    monkeypatch.delattr(profiling, "recorded_spans")
    assert ps.recorded() == []
    run = type("Run", (), {})()
    for m in manifest.manifest()["per_layer"]:
        if m["name"] in ("feed_device_ms.train", "forward_device_ms.train",
                         "loss_device_ms.train", "backward_device_ms.train",
                         "update_device_ms.train", "norm_device_pct.train",
                         "store_upload_s.train", "model_init_s.train",
                         "pad_host_ms.serve", "h2d_host_ms.serve",
                         "readback_host_ms.serve",
                         "forward_device_ms.serve"):
            assert manifest.metric_reader(m["name"])(run) is None, m["name"]
