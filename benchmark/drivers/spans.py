"""The benchmark's own spans around the calls it makes into the port:
host-clock durations kept in memory, and, under a profiler, ranges named
``bench.<span>`` that the trace reduction reads."""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from typing import Dict, List

import torch


class Spans:
    def __init__(self):
        self.seconds: Dict[str, List[float]] = defaultdict(list)

    def median_ms(self, name: str):
        values = sorted(self.seconds.get(name, ()))
        if not values:
            return None
        mid = len(values) // 2
        return 1e3 * (values[mid] if len(values) % 2
                      else 0.5 * (values[mid - 1] + values[mid]))


class TimedCall:
    """``fn`` with each call's host time kept as span ``name``; other
    attributes read through to ``fn``."""

    def __init__(self, fn, spans: Spans, name: str):
        self._fn, self._spans, self._name = fn, spans, name

    def __call__(self, *args, **kwargs):
        with torch.profiler.record_function("bench." + self._name):
            t = time.perf_counter()
            out = self._fn(*args, **kwargs)
            self._spans.seconds[self._name].append(time.perf_counter() - t)
        return out

    def __getattr__(self, attr):
        return getattr(self._fn, attr)


class TimedIterable:
    """An iterable whose every ``next`` is timed as span ``name``; its
    length reads through."""

    def __init__(self, iterable, spans: Spans, name: str):
        self._iterable, self._spans, self._name = iterable, spans, name

    def __len__(self):
        return len(self._iterable)

    def __getattr__(self, attr):
        return getattr(self._iterable, attr)

    def __iter__(self):
        it = iter(self._iterable)
        while True:
            with torch.profiler.record_function("bench." + self._name):
                t = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                self._spans.seconds[self._name].append(
                    time.perf_counter() - t)
            yield item


def stage(name: str, t_start: float) -> None:
    """Log how far set-up has come (seconds since the process started)."""
    print(f"setup {name} {time.perf_counter() - t_start:.3f} s",
          file=sys.stderr, flush=True)
