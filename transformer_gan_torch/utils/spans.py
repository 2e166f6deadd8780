"""Named spans inside the program, on the profiler's clock.

``span(name)`` is a context manager around a stretch of host code. While a
``torch.profiler`` trace runs (the benchmark's traced window,
``TPU.profile_dir``'s steps), each span records its name, its host start
and end in ns on ``time.time_ns()`` (the clock of the profiler's events),
the enclosing span on the same thread (``parent``) and the thread's ident,
and enters ``torch.profiler.record_function(name)``, so the range shows in
an exported chrome trace. ``span(name, device=True)`` also records a
``torch.cuda.Event`` pair on the current stream: :func:`device_seconds`
reads the span's device wall time from it once the device has passed the
end event. Nothing here synchronizes while recording.

Without a trace, ``span`` returns one shared no-op context: no clock read,
no allocation, no event.

Spans are kept in memory (:data:`RECORDS`, in the order they opened) for
the life of the process; :func:`recorded` takes those of a window. The
names of the spans opened so far are in :data:`NAMES`: under a profiler
that records CPU and CUDA activity, each range also shows as a device-side
annotation with a device time, which a reader of the trace's kernels skips
by this name.

Where the program opens them (the metric or use that reads each):

* ``train.data`` (``next`` of the train iterator), ``train.h2d`` (the
  batch's chunking and copies), ``train.step``, ``train.gan``,
  ``train.log`` (the log line's wait and all-reduce), ``train.eval``:
  ``Trainer.train``.
* ``gen.call``, ``gen.setup`` (device), ``gen.readback``:
  ``Trainer._generate_tokens``; ``gen.setup`` again and ``gen.ring``
  (device, the K/V ring's copy) in ``infer/sample._fused_sample_loop``.
* ``k1f``, ``k1b``, ``k2f``, ``k2b`` (``ops/attention.py``), ``k3``
  (``ops/generate.py``), ``k4``, ``k5`` (``ops/decode.py``), ``k6``,
  ``k7`` (``ops/chain_bwd.py``): each wrapper's whole call, the plain
  route on CPU tensors included, with device events on CUDA tensors.
  K1b (and K2b) run on the autograd engine's thread on the card.
* ``gan.dis``, ``gan.gen``, ``gan.classifier`` (``train/gan_loop.py``),
  ``gan.recompute``, ``gan.critic`` (``models/gan.py``), with device
  events on the card.
"""
from __future__ import annotations

import functools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

_local = threading.local()

RECORDS: list = []
# the names of the spans opened so far
NAMES: set = set()
# the thread the idle time is put down to: the one that enqueues the work
MAIN = threading.main_thread().ident


class _Off:
    """The context ``span`` returns without a trace."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()


class Span:
    """One recorded span: ``name``, host ``start_ns`` / ``end_ns`` (None
    while open), ``parent`` (the enclosing span of ``thread``, else None)
    and ``events`` (a started and an ended ``torch.cuda.Event``, or None)."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "thread", "events",
                 "_range")

    def __init__(self, name: str, device: bool = False):
        self.name = name
        NAMES.add(name)
        self.start_ns = self.end_ns = self.parent = None
        self.thread = None
        self.events = ((torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                       if device else None)
        self._range = None

    def __enter__(self) -> "Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        self.thread = threading.get_ident()
        stack.append(self)
        RECORDS.append(self)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        if self.events is not None:
            self.events[0].record()
        # the host interval hugs the body: the range and the events are
        # entered before it and left after it
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self.events is not None:
            self.events[1].record()
        self._range.__exit__(*exc)
        self._range = None
        _local.stack.pop()
        return False


def span(name: str, device: bool = False):
    """A span named ``name`` (with CUDA events when ``device``) while a
    profiler trace runs, else the shared no-op :data:`OFF`. ``with`` gives
    the :class:`Span`, or None."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return Span(name, device)


def spanned(name: str):
    """Decorator: each call inside ``span(name)``, with device events when a
    positional argument is a CUDA tensor."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            cuda = any(isinstance(a, torch.Tensor) and a.is_cuda
                       for a in args)
            with Span(name, cuda):
                return fn(*args, **kwargs)
        return call
    return wrap


def recorded(lo: int, hi: int) -> list:
    """The closed spans that lie inside [lo, hi] (ns)."""
    return [s for s in list(RECORDS)
            if s.end_ns is not None and lo <= s.start_ns and s.end_ns <= hi]


def device_seconds(spans) -> float:
    """Summed event-timed device wall time of the spans that have events;
    waits for each end event."""
    total = 0.0
    for s in spans:
        if s.events is not None:
            s.events[1].synchronize()
            total += s.events[0].elapsed_time(s.events[1]) * 1e-3
    return total

