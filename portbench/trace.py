"""The traced window: ``torch.profiler`` (CUDA activity) around the measured
window, reduced to what the per-layer readers take.

Device time is the union of the intervals in which an operation ran on the
device (kernels, copies, sets), clipped to the window: kernels that overlap
under programmatic dependent launch count once. The window is the span of
the host range ``portbench.window``, which opens and closes on a device
synchronize, where the trace records host ranges, else the host's wall
clock read at the same two points (the profiler's clock).
"""
from __future__ import annotations

import contextlib
import re
import time

import torch

WINDOW = "portbench.window"
# device-side names that are not work: the device copy of a host
# annotation range, which spans the whole window
NOT_WORK = (WINDOW,)


def _kind(e) -> str:
    """"kernel", "copy" (memcpy / memset) or "other" of a device event."""
    name = e.name()
    if name in NOT_WORK:
        return "other"
    if hasattr(e, "activity_type"):
        kind = e.activity_type()
        return ("kernel" if kind == "kernel" else
                "copy" if kind in ("gpu_memcpy", "gpu_memset") else "other")
    return "copy" if name.startswith(("Memcpy", "Memset")) else "kernel"


class Trace:
    """Device intervals and host ops of one traced window (ns, one clock)."""

    def __init__(self, prof, lo=None, hi=None):
        """``lo`` / ``hi``: the window's bounds on the host's wall clock
        (ns), taken where the trace holds no window range."""
        dev, host = [], []
        for e in prof.profiler.kineto_results.events():
            start, end = e.start_ns(), e.end_ns()
            if e.device_type() == torch.autograd.DeviceType.CPU:
                if e.name() == WINDOW:
                    lo, hi = start, end
                else:
                    host.append((start, end, e.name()))
            elif _kind(e) != "other":
                dev.append((start, end, e.name(), _kind(e)))
        if lo is None or hi is None:
            raise RuntimeError("the trace holds no window range")
        self.lo, self.hi = lo, hi
        inside = [x for x in dev if x[1] > lo and x[0] < hi]
        self.device = sorted((max(s, lo), min(e, hi), n)
                             for s, e, n, _ in inside)
        self.kernels = sum(kind == "kernel" for *_, kind in inside)
        self.host = host
        self.merged = []
        for s, e, _ in self.device:
            if self.merged and s <= self.merged[-1][1]:
                self.merged[-1][1] = max(self.merged[-1][1], e)
            else:
                self.merged.append([s, e])

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged) * 1e-9

    def op_seconds(self, pattern: str) -> float:
        """Summed device time of the operations whose name matches
        ``pattern``."""
        rx = re.compile(pattern)
        return sum(e - s for s, e, n in self.device if rx.search(n)) * 1e-9

    def top_ops(self, n: int = 10) -> list:
        by = {}
        for s, e, name in self.device:
            key = name[:160]
            by[key] = by.get(key, 0) + (e - s)
        return [[k, v * 1e-9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest idle stretches of the device in the window, each
        named by the host's CUDA call in flight at its middle, else by the
        last one the host made before it ("after ...")."""
        edges = [self.lo] + [x for se in self.merged for x in se] + [self.hi]
        gaps = sorted(((edges[k + 1] - edges[k], edges[k])
                       for k in range(0, len(edges) - 1, 2)
                       if edges[k + 1] > edges[k]), reverse=True)[:n]
        out = []
        for length, start in gaps:
            mid = start + length // 2
            cover = [(e - s, name) for s, e, name in self.host
                     if s <= mid <= e]
            before = [(e, name) for s, e, name in self.host if e < mid]
            name = (min(cover)[1] if cover else
                    "after " + max(before)[1] if before else "(no host call)")
            out.append([name, length * 1e-9])
        return out


@contextlib.contextmanager
def window(trace: bool, sync):
    """Times the body between two ``sync()`` calls on the host clock; with
    ``trace`` under the profiler. Yields a dict that receives ``seconds``
    and, traced, ``trace`` (:class:`Trace`)."""
    box = {}
    prof = None
    if trace:
        # device activity only (with the host's CUDA calls): recording every
        # host op slows a host-bound step by ~25% and inflates the idle share
        acts = [torch.profiler.ProfilerActivity.CUDA
                if torch.cuda.is_available()
                else torch.profiler.ProfilerActivity.CPU]
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    with torch.profiler.record_function(WINDOW) if trace else \
            contextlib.nullcontext():
        sync()
        t0, lo = time.perf_counter(), time.time_ns()
        yield box
        sync()
        box["seconds"] = time.perf_counter() - t0
        hi = time.time_ns()
    if prof is not None:
        prof.stop()
        box["trace"] = Trace(prof, lo, hi)
