"""Profiling, step timing and the program's spans (port of
``cadepth_tpu.utils.profiling``, with the spans added).

``torch.profiler`` traces in place of ``jax.profiler``'s, viewable in
TensorBoard or Perfetto, and a step timer whose fence is a
``torch.cuda.synchronize`` on a card: the host enqueues steps ahead of
the card, so a clock read without it measures the host alone.

Spans. The program marks its phases with :func:`span`: the training
step's feed, forward, loss, backward and update, each norm layer's
forward and backward, the trainer's log reads and epoch end, the
predictor's padding, copies to the card, forward and read-back, and
set-up's store upload and model build. A span is recorded while a
``torch.profiler`` session records, and then only: each one is also a
``record_function`` range, so a trace shows it over the kernels it
launched, on the profiler's own clock. To see them, train with

    python -m cadepth_tpu_torch.cli.train --config <file> --profile

and open the trace written under ``<log_dir>/<experiment>/profile`` in
TensorBoard's profiler plugin or in Perfetto (ui.perfetto.dev); or
profile any block of a program with :func:`profile_trace` or
``torch.profiler.profile``. Outside a profiler a span site costs one
check of the profiler's state: no event, range, autograd node or record.
Set-up spans (``always=True``) run once a process and are recorded
always, at the cost of a clock read each.

In the same process, :func:`recorded_spans` gives the recorded spans as
dicts (a bounded ring, the newest :data:`RING` kept) and
:func:`clear_spans` empties it. Each has its ``name``, ``id``,
``parent`` (the id of the span it ran inside, or None), ``trace`` (the
training step's ``TrainStep.updates`` on entry, or the request's number
in its ``Predictor``; children take their parent's), ``thread`` (the
native thread id), ``session`` (the number of the profiler session it
was recorded in, counted from 1, None outside one), ``start_ns`` and
``end_ns`` (unix time in ns, the profiler's clock), ``device_ms`` (for a
span opened with a CUDA ``device``: the card's time between two timing
events recorded on the current stream at its start and end, idle inside
included; else None) and ``attrs`` (such as ``bytes``).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional

import torch


def hard_sync(device=None) -> None:
    """Fence: wait until the card has run everything enqueued on it (no-op
    on the CPU, whose operations have finished when they return)."""
    device = torch.device(device) if device is not None else None
    if device is None or device.type == "cuda":
        if torch.cuda.is_available():
            torch.cuda.synchronize(device)


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block (the CPU, and the
    card where there is one) into ``log_dir`` as a TensorBoard trace."""
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class StepTimer:
    """Rolling step timing with correct device fencing.

    Usage:
        timer = StepTimer()
        for batch in pipe:
            logs = train_step(batch)
            timer.step(batch_size)           # no wait on the card
        images_per_sec = timer.rate(device)  # fences + computes
    """

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._t0: Optional[float] = None
        self._items = 0
        self._steps = 0

    def step(self, num_items: int = 1) -> None:
        if self._t0 is None:
            self._t0 = time.perf_counter()
        else:
            # first step excluded: it absorbs the warm-up
            self._items += num_items
            self._steps += 1

    def rate(self, fence_device=None) -> float:
        """items/sec over the timed window (fences ``fence_device``)."""
        if self._t0 is None or self._steps == 0:
            return 0.0
        if fence_device is not None:
            hard_sync(fence_device)
        elapsed = time.perf_counter() - self._t0
        return self._items / elapsed if elapsed > 0 else 0.0

    @property
    def steps(self) -> int:
        return self._steps


def enable_nan_debugging() -> None:
    """Turn on autograd's anomaly detection, which raises at the backward
    operation that produced a NaN. Slows execution; debug only."""
    torch.autograd.set_detect_anomaly(True)


# -- spans --------------------------------------------------------------------

# spans kept, newest last; an older one is dropped when a new one closes
RING = 32768

_profiling = torch._C._autograd._profiler_enabled
# a profiler range opened and closed without the dispatcher (a
# ``record_function`` is an operator call each way, tens of us under a
# profiler)
_Range = torch._C._profiler._RecordFunctionFast
_ring: deque = deque(maxlen=RING)
_ids = itertools.count(1)
_local = threading.local()
# timing events made ahead of a session's first span on a card, and
# returned by read spans, for reuse: making one is a CUDA call, which a
# span would otherwise pay while the program runs
POOL = 4096
_event_pool: List["torch.cuda.Event"] = []
_pool_session = 0
# the profiler's state at the last span site, and the sessions counted
# (the backward's spans run on autograd's threads)
_on = False
_session = 0
_session_lock = threading.Lock()


class _Off:
    """A span site's span while no profiler records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> "_Off":
        return self

    def active(self) -> "_Off":
        return self

    def close(self) -> None:
        pass


OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
        # a system call: read once a thread
        _local.thread = threading.get_native_id()
    return stack


# a span costs its host a few Python calls: the stream objects are kept,
# not made anew each time
_streams: Dict[tuple, "torch.cuda.Stream"] = {}


def _current_stream(device) -> "torch.cuda.Stream":
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    key = torch._C._cuda_getCurrentStream(index)
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.Stream(
            stream_id=key[0], device_index=key[1], device_type=key[2])
    return stream


def _event() -> "torch.cuda.Event":
    try:
        return _event_pool.pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


def _fill_pool(stream) -> None:
    """Top the pool up to POOL events, each made by a first record."""
    while len(_event_pool) < POOL:
        event = torch.cuda.Event(enable_timing=True)
        event.record(stream)
        _event_pool.append(event)


def _start_event(device, session: int) -> "torch.cuda.Event":
    """A timing event recorded on ``device``'s current stream; the pool is
    filled first at a session's first one."""
    global _pool_session
    stream = _current_stream(device)
    if _pool_session != session:
        _pool_session = session
        _fill_pool(stream)
    event = _event()
    event.record(stream)
    return event


class Span:
    """One open span; closed by leaving its ``with`` block or by
    :meth:`close`. Inside its ``with`` block (or :meth:`active`) it is
    the parent of the spans its thread opens."""

    __slots__ = ("name", "id", "parent", "trace", "thread", "session",
                 "start_ns", "end_ns", "attrs", "device_ms", "_range",
                 "_events")

    def __init__(self, name: str, device, parent, trace, attrs: Dict,
                 session: Optional[int]):
        stack = _stack()
        if parent is None and stack:
            parent = stack[-1]
        self.name = name
        self.id = next(_ids)
        self.parent = None if parent is None else parent.id
        self.trace = trace if trace is not None or parent is None \
            else parent.trace
        self.thread = _local.thread
        self.session = session
        self.attrs = attrs
        self.device_ms = None
        self.end_ns = None
        self._range = None
        if session is not None:
            self._range = _Range(name)
            self._range.__enter__()
        self._events = None
        if session is not None and device is not None and \
                device.type == "cuda":
            self._events = (_start_event(device, session), device)
        self.start_ns = time.time_ns()

    def set(self, **attrs) -> "Span":
        """Add attributes (counts such as ``bytes``)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        _stack().append(self)
        return self

    def __exit__(self, *exc) -> bool:
        stack = _stack()
        if stack[-1] is self:
            stack.pop()
        else:
            stack.remove(self)
        self.close()
        return False

    @contextlib.contextmanager
    def active(self):
        """Make this span the parent of the spans the block opens, without
        closing it at the block's end."""
        stack = _stack()
        stack.append(self)
        try:
            yield self
        finally:
            stack.remove(self)

    def close(self) -> None:
        if self.end_ns is not None:
            return
        self.end_ns = time.time_ns()
        if self._events is not None:
            start, device = self._events
            end = _event()
            end.record(_current_stream(device))
            self._events = (start, end)
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        _ring.append(self)

    def record(self) -> Dict:
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self.device_ms = start.elapsed_time(end)
            _event_pool.extend(self._events)
            self._events = None
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "trace": self.trace, "thread": self.thread,
                "session": self.session, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "device_ms": self.device_ms,
                "attrs": dict(self.attrs)}


def span(name: str, *, device=None, parent=None, trace=None,
         always: bool = False, **attrs):
    """The span ``name`` of the block (``with span(...) as s:``), or, held
    open across calls, closed by ``s.close()``.

    Recorded only while a profiler session records, unless ``always``,
    and never as the child of an unrecorded ``parent``; otherwise this
    returns :data:`OFF`, which does nothing. ``device`` (a
    ``torch.device``) on a card adds the card's time between the span's
    start and end on the current stream, read when the span is read.
    ``parent`` (a span) is the span it belongs to, by default the
    innermost one open on this thread; ``trace`` its trace id, by
    default its parent's. ``attrs`` are kept with it."""
    global _on, _session
    if parent is OFF:
        return OFF
    if _profiling():
        if not _on:
            with _session_lock:
                if not _on:
                    _on = True
                    _session += 1
        return Span(name, device, parent, trace, attrs, _session)
    _on = False
    if always:
        return Span(name, None, parent, trace, attrs, None)
    return OFF


def recorded_spans() -> List[Dict]:
    """The recorded spans, oldest first, as dicts (the module's docstring
    lists their keys). Waits for the card where a span's end event has
    not run yet."""
    return [s.record() for s in list(_ring)]


def clear_spans() -> None:
    """Forget every recorded span."""
    _ring.clear()


class _Mark(torch.autograd.Function):
    """The identity on one or more tensors, whose backward opens (on
    outputs) or closes (on inputs) a backward span once the gradients of
    them all have arrived."""

    @staticmethod
    def forward(ctx, holder, opens, *xs):
        ctx.holder, ctx.opens = holder, opens
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.opens:
            ctx.holder.open()
        else:
            ctx.holder.close()
        return (None, None) + grads


def _marked(holder, opens: bool, x):
    """``x`` (a tensor, or a tuple or list of them) through one mark."""
    if isinstance(x, torch.Tensor):
        return _Mark.apply(holder, opens, x)[0]
    return type(x)(_Mark.apply(holder, opens, *x))


class _BackwardSpan:
    def __init__(self, name: str, device, trace):
        self.name, self.device, self.trace = name, device, trace
        self.span = OFF

    def open(self) -> None:
        self.span = span(self.name, device=self.device, trace=self.trace)

    def close(self) -> None:
        self.span.close()


def _same(y):
    return y


def backward_span(name: str, x, within: Span):
    """(x', mark): where a gradient flows back through ``x``, the
    backward from ``mark(y)``'s gradient down to ``x``'s, for a ``y``
    computed from ``x'``, is span ``name`` (trace id ``within``'s, its
    parent the innermost span open on the thread that runs it). ``x`` and
    ``y`` are each a tensor or a tuple or list of tensors (returned in
    kind): the span opens once the gradients of all of ``y`` have
    arrived and closes once those of all of ``x`` are computed. Two
    identity nodes in the autograd graph; outside grad mode, where no
    tensor of ``x`` needs a gradient, or where ``within`` is :data:`OFF`:
    ``x`` and the identity, with nothing added."""
    xs = (x,) if isinstance(x, torch.Tensor) else x
    if within is OFF or not (torch.is_grad_enabled()
                             and any(t.requires_grad for t in xs)):
        return x, _same
    holder = _BackwardSpan(name, xs[0].device, within.trace)
    return _marked(holder, False, x), lambda y: _marked(holder, True, y)
