"""A layer's share of the training steps' card time, from the port's
spans (``program_spans.py``): its forward and backward spans summed over
the first profiler session, over its ``train.step`` spans summed."""

from __future__ import annotations

from typing import Optional, Sequence

from benchmark.metrics.lib.program_spans import first_session, recorded


def share_pct(names: Sequence[str], spans=None) -> Optional[float]:
    """100 x the card's time in spans ``names`` over that in
    ``train.step``; None where either is missing."""
    spans = first_session(recorded() if spans is None else spans)

    def total(wanted):
        return sum(s["device_ms"] for s in spans
                   if s["name"] in wanted and s["device_ms"] is not None)

    step, part = total(("train.step",)), total(tuple(names))
    if not step or not part:
        return None
    return 100.0 * part / step
