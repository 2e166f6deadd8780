"""The device's idle time laid against the program's spans: the arithmetic
of the ``idle_in_*`` readers, and a tool that prints a traced run's idle
time by the innermost main-thread span open over it, and outside every span
by the host's CUDA call in flight (the profiler's buffer flushes among
them). Not a metric: no entry of ``BENCHMARK.json`` names this file.

    python3 -m portbench.metrics.span_idle --workload xl_baseline.mle_b128 \\
        --seed 1618033901 --seconds 30 [--out table.json]

prints the run's result line, then one line ``TABLE {...}`` (seconds).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys


def idle(trace) -> list:
    """The stretches of the window in which no operation ran on the device:
    the gaps of ``trace.merged`` (a sorted union, clipped to the window)."""
    out, t = [], trace.lo
    for s, e in trace.merged:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < trace.hi:
        out.append((t, trace.hi))
    return out


def _cover(spans) -> list:
    """The union of the spans' host intervals, sorted."""
    out = []
    for s, e in sorted((s.start_ns, s.end_ns) for s in spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def _intersect(a, b) -> list:
    """The intersections of two sorted lists of disjoint (start, end, ...)
    intervals, each with the fields of ``b``'s interval after its end."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi) + tuple(b[j][2:]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def overlap(intervals, spans) -> float:
    """Seconds of ``intervals`` (sorted, disjoint (start, end) ns pairs, as
    :func:`idle` gives) that fall inside the host intervals of ``spans``,
    each instant counted once."""
    return sum(e - s for s, e in _intersect(intervals, _cover(spans))) / 1e9


def idle_in(trace, spans) -> float:
    """Seconds of the window's device idle time inside ``spans``."""
    return overlap(idle(trace), spans)


def attribute(intervals, named) -> dict:
    """name -> seconds of ``intervals`` (sorted, disjoint) under the
    innermost (the latest opened) of the ``named`` (start, end, name)
    ranges open there; None -> the seconds under none of them."""
    out = {}
    for s, e, name in _intersect(intervals, _segments(named)):
        out[name] = out.get(name, 0.0) + (e - s) / 1e9
    return out


def _segments(named) -> list:
    """The line cut at every start and end of the ``named`` (start, end,
    name) ranges: (start, end, innermost open name or None), sorted."""
    marks = sorted([(s, 1, k) for k, (s, _, _) in enumerate(named)]
                   + [(e, 0, k) for k, (_, e, _) in enumerate(named)])
    segs, open_, t = [], [], float("-inf")
    for when, opening, k in marks:
        if when > t:
            segs.append((t, when, named[open_[-1]][2] if open_ else None))
            t = when
        if opening:
            open_.append(k)
        else:
            open_.remove(k)
    segs.append((t, float("inf"), None))
    return segs


def table(trace, spans, main: int) -> dict:
    """The window's idle seconds by innermost span of thread ``main`` (None:
    under no span), the idle seconds under no such span by the host's CUDA
    call in flight (None: no call), and each name's count of spans and its
    spans' event-timed device seconds (names with device events)."""
    from transformer_gan_torch.utils.spans import device_seconds
    gaps = idle(trace)
    own = [s for s in spans if s.thread == main]
    named = [(s.start_ns, s.end_ns, s.name) for s in own]
    # the idle stretches under no span: None's segments of ``attribute``
    outside = [(s, e) for s, e, n in _intersect(gaps, _segments(named))
               if n is None]
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    return {"window_s": trace.window_s, "busy_s": trace.busy_s,
            "idle_s": sum(e - s for s, e in gaps) / 1e9,
            "span_counts": {n: len(v) for n, v in by_name.items()},
            "device_s_by_span": {n: device_seconds(v)
                                 for n, v in by_name.items()
                                 if any(s.events is not None for s in v)},
            "idle_by_span": attribute(gaps, named),
            "outside_by_host_call": attribute(
                outside, [(s, e, n) for s, e, n in trace.host])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None,
                    help="also write the table here (JSON)")
    args = ap.parse_args(argv)
    from portbench import run
    from portbench import trace as tr
    from transformer_gan_torch.utils import spans

    kept = []
    window = tr.window

    @contextlib.contextmanager
    def keep(trace, sync):
        with window(trace, sync) as box:
            yield box
        kept.append(box)

    tr.window = keep
    try:
        out = run.run_cell(args.workload, args.seed, args.seconds, True)
    finally:
        tr.window = window
    print(json.dumps(out), flush=True)
    t = kept[0]["trace"]
    rep = table(t, spans.recorded(t.lo, t.hi), spans.MAIN)
    rep = {k: ({str(n): s for n, s in v.items()} if isinstance(v, dict)
               else v) for k, v in rep.items()}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=1)
    print("TABLE " + json.dumps(rep), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
