"""The port's own spans (``cadepth_tpu_torch.utils.profiling``), read
after a traced run.

The port records a span at each layer boundary while a profiler session
records, and its set-up spans always. A traced run profiles a stretch of
its loop (training) or two (serving, the second one recording host ops,
which doubles the host's time), so only the spans of the run's first
session are read, and the set-up spans, which belong to none. Each
function gives None where the port records no such span: a port without
the spans, or a cell whose path has none.
"""

from __future__ import annotations

import statistics
from collections import defaultdict
from typing import Dict, List, Optional


def recorded() -> List[Dict]:
    """The port's recorded spans, or [] where the port has none."""
    try:
        from cadepth_tpu_torch.utils.profiling import recorded_spans
    except ImportError:
        return []
    return recorded_spans()


def first_session(spans: List[Dict]) -> List[Dict]:
    sessions = [s["session"] for s in spans if s["session"] is not None]
    if not sessions:
        return []
    first = min(sessions)
    return [s for s in spans if s["session"] == first]


def host_ms(s: Dict) -> float:
    return (s["end_ns"] - s["start_ns"]) * 1e-6


def _ms(s: Dict, device: bool) -> Optional[float]:
    return s["device_ms"] if device else host_ms(s)


def _median(values) -> Optional[float]:
    values = [v for v in values if v is not None]
    return statistics.median(values) if values else None


def median_ms(name: str, device: bool, spans=None) -> Optional[float]:
    """The median time of the first session's spans ``name``: the card's
    (``device``) or the host's, in ms."""
    spans = first_session(recorded() if spans is None else spans)
    return _median(_ms(s, device) for s in spans if s["name"] == name)


def step_median_ms(names, spans=None) -> Optional[float]:
    """The median over the first session's training steps (the trace ids
    of its ``train.step`` spans) of the card's time of the step's spans
    ``names`` summed, in ms."""
    names = (names,) if isinstance(names, str) else tuple(names)
    spans = first_session(recorded() if spans is None else spans)
    steps = {s["trace"] for s in spans if s["name"] == "train.step"}
    sums: Dict[int, float] = defaultdict(float)
    found = set()
    for s in spans:
        if s["name"] in names and s["trace"] in steps and \
                s["device_ms"] is not None:
            sums[s["trace"]] += s["device_ms"]
            found.add(s["trace"])
    return _median(sums[t] for t in found)


def norm_share_pct(spans=None) -> Optional[float]:
    """100 x the card's time in the norm layers (``norm.fwd`` and
    ``norm.bwd``) over that of the training steps (``train.step``),
    summed over the first session."""
    spans = first_session(recorded() if spans is None else spans)
    total = {n: sum(s["device_ms"] for s in spans
                    if s["name"] == n and s["device_ms"] is not None)
             for n in ("norm.fwd", "norm.bwd", "train.step")}
    if not total["train.step"] or not (total["norm.fwd"]
                                       or total["norm.bwd"]):
        return None
    return 100.0 * (total["norm.fwd"] + total["norm.bwd"]) / \
        total["train.step"]


def setup_s(name: str, spans=None) -> Optional[float]:
    """The host's time of set-up span ``name`` (recorded outside any
    session), summed, in s."""
    spans = recorded() if spans is None else spans
    found = [host_ms(s) for s in spans
             if s["name"] == name and s["session"] is None]
    return 1e-3 * sum(found) if found else None
