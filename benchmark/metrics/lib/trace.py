"""Reduction of a ``torch.profiler`` session to the numbers the per-layer
metrics and the ``breakdown`` read.

A profile is a stretch of a loop that is already running (``Stretch``):
the profiler starts at one step or request, and the window is the
device's time between two single spin kernels (``torch.cuda._sleep``,
the marks) launched before the next step and before the one after the
last measured, so the loop's ramp-up and drain lie outside it. Blocks of
32 spins guard both ends of the session, where the profiler drops up to
a tenth of its records; a profile without marks falls back to the time
between the guards. The window's busy time is the union of every other
device activity's interval (kernels, copies, sets) inside it.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

SPINS = 32
SPIN_CYCLES = 1000
SPIN_NAME = "spin_kernel"
# a spin this far (us) from any other is a mark, not part of a guard
MARK_APART_US = 1000.0
# user ranges the benchmark opens on the host (never device activity)
RANGE_PREFIX = "bench."


def spin(torch, n: int = SPINS) -> None:
    for _ in range(n):
        torch.cuda._sleep(SPIN_CYCLES)


@contextlib.contextmanager
def profiled(torch, host_ops: bool = False):
    """A spin-guarded profile of the block; yields a holder whose ``prof``
    is the finished profiler. The leading guard is queued behind whatever
    the card is running, without waiting for it. Without ``host_ops``
    only the card's activity and the CUDA runtime calls are recorded:
    recording every host op about doubles the host's time a step, which
    would make a card-paced loop host-paced and its idle share read high.
    With ``host_ops`` the host ops and the benchmark's ranges are
    recorded too (the kernels' own durations are unchanged)."""
    from torch.profiler import ProfilerActivity, profile

    holder = type("Holder", (), {})()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops
                                      else [])
    with profile(activities=acts) as prof:
        spin(torch)
        yield holder
        torch.cuda.synchronize()
        spin(torch)
        torch.cuda.synchronize()
    holder.prof = prof


class Stretch:
    """The profile of a running loop's items ``skip`` .. ``skip + n + 1``:
    call ``before(i)`` ahead of handing over item i (a batch drawn, a
    request submitted); it is False once the stretch is over, so the
    loop stops there. The profiler starts at item ``skip``, a mark goes
    ahead of item ``skip + 1`` and of item ``skip + n + 1``, so the
    window holds the device work of the ``n`` items between, launched
    while the loop runs; ``finish()`` ends the session once the loop has
    returned and gives its ``Trace``."""

    def __init__(self, torch, skip: int, n: int, host_ops: bool = False):
        self.torch, self.skip, self.n = torch, skip, n
        self._stack = contextlib.ExitStack()
        self._held = None
        self._host_ops = host_ops

    def before(self, i: int) -> bool:
        if i == self.skip:
            self._held = self._stack.enter_context(
                profiled(self.torch, self._host_ops))
        if i in (self.skip + 1, self.skip + self.n + 1):
            spin(self.torch, 1)
        return i < self.skip + self.n + 2

    def finish(self) -> "Trace":
        self._stack.close()
        found = Trace.from_profile(self._held.prof, self.torch)
        found.steps = self.n
        return found


def _is_device(e, torch) -> bool:
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(("Optimizer.", RANGE_PREFIX,
                                       "ProfilerStep")))


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class Trace:
    """Device activity, host ops and the benchmark's ranges of a profile.

    Built from plain tuples so that the arithmetic is testable without a
    card: ``device`` [(name, start_us, end_us)], ``host`` [(name,
    thread, start_us, end_us)], ``ranges`` {name: [device us launched
    inside each range]}."""

    def __init__(self, device, host, ranges):
        spins = sorted((s, e) for n, s, e in device if SPIN_NAME in n)
        work = sorted(((s, e, n) for n, s, e in device
                       if SPIN_NAME not in n), key=lambda x: x[0])
        if not work:
            raise ValueError("the profile holds no device activity")
        # a mark is a spin launched alone: the guards are blocks of spins
        # launched back to back, a mark lies a step or more from any other
        marks = [(s, e) for i, (s, e) in enumerate(spins)
                 if (i == 0 or s - spins[i - 1][1] > MARK_APART_US)
                 and (i + 1 == len(spins)
                      or spins[i + 1][0] - e > MARK_APART_US)]
        first, last = work[0][0], max(e for _, e, _ in work)
        if len(marks) >= 2:
            self.start, self.end = marks[0][1], marks[-1][0]
        else:
            lead = [e for s, e in spins if e <= first]
            tail = [s for s, e in spins if s >= last]
            self.start = max(lead) if lead else first
            self.end = min(tail) if tail else last
        self.work = [(max(s, self.start), min(e, self.end), n)
                     for s, e, n in work if e > self.start and s < self.end]
        self.segments = _union([(s, e) for s, e, _ in self.work])
        self.host = host
        self.ranges = ranges
        self.steps = None

    @classmethod
    def from_profile(cls, prof, torch) -> "Trace":
        device, host = [], []
        ranges: Dict[str, List[float]] = defaultdict(list)
        for e in prof.events():
            if _is_device(e, torch):
                device.append((e.name, e.time_range.start, e.time_range.end))
            elif e.device_type == torch.autograd.DeviceType.CPU:
                host.append((e.name, e.thread, e.time_range.start,
                             e.time_range.end))
                if e.name.startswith(RANGE_PREFIX):
                    ranges[e.name].append(e.device_time_total)
        return cls(device, host, dict(ranges))

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.segments) * 1e-6

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernels(self) -> int:
        """Kernel launches in the window (copies and sets left out)."""
        return sum(1 for _, _, n in self.work
                   if not n.startswith(("Memcpy", "Memset")))

    def range_device_s(self, name: str) -> Optional[float]:
        """Device seconds of the kernels launched inside the ranges
        ``name``, or None where there are none."""
        total = sum(self.ranges.get(name, ())) * 1e-6
        return total if total > 0 else None

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = defaultdict(float)
        for s, e, name in self.work:
            by[name] += (e - s) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda x: -x[1])[:n]]

    def idle_gaps(self, n: int = 10, longest: int = 400) -> List[List]:
        """The idle time between device activity, by the innermost host op
        of the main thread running at each gap's start (the ``longest``
        gaps), most first."""
        gaps = [(self.segments[i + 1][0] - self.segments[i][1],
                 self.segments[i][1]) for i in range(len(self.segments) - 1)]
        if self.segments:
            gaps += [(self.segments[0][0] - self.start, self.start),
                     (self.end - self.segments[-1][1], self.segments[-1][1])]
        gaps = sorted((g for g in gaps if g[0] > 0), reverse=True)[:longest]
        if not gaps:
            return []
        if not self.host:
            return [["(host not recorded)", sum(g for g, _ in gaps) * 1e-6]]
        threads: Dict[int, int] = defaultdict(int)
        for _, t, _, _ in self.host:
            threads[t] += 1
        main = max(threads, key=threads.get)
        ops = [(name, s, e) for name, t, s, e in self.host if t == main]
        starts = np.array([s for _, s, _ in ops])
        ends = np.array([e for _, _, e in ops])
        by: Dict[str, float] = defaultdict(float)
        for length, at in gaps:
            inside = np.nonzero((starts <= at) & (ends >= at))[0]
            name = "(no host op)" if not len(inside) else \
                ops[inside[np.argmin(ends[inside] - starts[inside])]][0]
            by[name] += length * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda x: -x[1])[:n]]
