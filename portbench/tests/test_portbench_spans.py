"""The readers of the program's spans on a synthetic context: the idle time
inside the data and step spans, the span rooflines (None where the spans and
the launch counter disagree) and the ring's share; None without a trace
and where the program has no span recorder. The interval arithmetic of
``metrics/span_idle.py`` (the idle readers' and the attribution table's)
on exact seconds."""
from __future__ import annotations

import sys
import types

import pytest

from portbench import run, work
from portbench.metrics import span_idle
from transformer_gan_torch.utils import spans

G = 1_000_000_000
MAIN = spans.MAIN


class Ev:
    """A recorded CUDA event's stand-in (ms on a device clock)."""

    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.ms - self.ms


def _span(name, lo, hi, device_ms=None, thread=MAIN):
    s = types.SimpleNamespace(name=name, start_ns=lo, end_ns=hi,
                              thread=thread, parent=None, events=None)
    if device_ms is not None:
        s.events = (Ev(0.0), Ev(device_ms))
    return s


def _trace(lo=0, hi=10 * G, merged=((G, 2 * G), (4 * G, 9 * G))):
    return types.SimpleNamespace(lo=lo, hi=hi, window_s=(hi - lo) / 1e9,
                                 merged=[list(m) for m in merged])


@pytest.fixture
def recorded(monkeypatch):
    box = []
    monkeypatch.setattr(spans, "RECORDS", box)
    return box


def test_idle_in_data_and_step(recorded):
    # idle: [0, 1), [2, 4), [9, 10) s of a 10 s window
    recorded += [_span("train.data", 0, G // 2),            # 0.5 idle
                 _span("train.h2d", G // 2, 3 * G // 2),    # 0.5 idle
                 _span("train.step", 3 * G // 2, 3 * G),    # 1.0 idle
                 _span("k1f", 2 * G, 5 * G // 2, 0.1),      # inside the step
                 _span("train.data", 3 * G, 5 * G),         # 1.0 idle
                 _span("train.step", 9 * G, 11 * G),        # past the window
                 _span("train.data", 9 * G, 10 * G, thread=MAIN + 1)]
    ctx = types.SimpleNamespace(trace=_trace())
    assert run.read_metric("idle_in_data.mle", ctx) == pytest.approx(20.0)
    assert run.read_metric("idle_in_step.mle", ctx) == pytest.approx(10.0)
    idle_share = 100.0 * (1 - 6.0 / 10.0)
    assert 20.0 + 10.0 <= idle_share


def _mle_ctx(n_calls):
    return types.SimpleNamespace(
        trace=_trace(), launches={"xl_attn_fwd_v2": n_calls,
                                  "xl_attn_bwd_v2": n_calls},
        shapes={"q": 128, "B": 128, "M": 1024, "H": 10, "dh": 50})


@pytest.mark.parametrize("metric,name,backward", [
    ("k1f_span_roofline", "k1f", False), ("k1b_span_roofline", "k1b", True)])
def test_attention_span_rooflines(recorded, metric, name, backward):
    recorded += [_span(name, k * G, k * G + 1000, device_ms=2.0)
                 for k in range(3)]
    recorded.append(_span("train.step", 0, G))
    bound_ms = work.bound_ms(*work.attention_work(
        128, 128, 1024, 1024, backward=backward, H=10, dh=50))
    got = run.read_metric(metric, _mle_ctx(3))
    assert got == pytest.approx(100.0 * 3 * bound_ms / (3 * 2.0))
    # the spans and the launch counter disagree
    assert run.read_metric(metric, _mle_ctx(4)) is None
    assert run.read_metric(metric, _mle_ctx(0)) is None
    untraced = _mle_ctx(3)
    untraced.trace = None
    assert run.read_metric(metric, untraced) is None


def _gen_ctx(calls, waves=2, chunks=((32, 0), (32, 32))):
    return types.SimpleNamespace(
        trace=_trace(), launches={"generate_chunk": calls}, waves=waves,
        chunks=list(chunks),
        shapes={"B": 32, "M": 2048, "L": 6, "HD": 500, "DI": 1000, "V": 310})


def test_k3_span_roofline_and_ring_share(recorded):
    recorded += [_span("k3", k * G, k * G + 1000, device_ms=20.0)
                 for k in range(4)]
    recorded += [_span("gen.ring", k * G + 2000, k * G + 3000,
                       device_ms=25.0) for k in range(4)]
    least = sum(work.bound_ms(*work.sampler_work(
        n, 32, 2048, count, L=6, HD=500, DI=1000, V=310))
        for n, count in ((32, 0), (32, 32))) * 1e-3
    got = run.read_metric("k3_span_roofline", _gen_ctx(4))
    assert got == pytest.approx(100.0 * 2 * least / 0.080)
    assert run.read_metric("k3_span_roofline", _gen_ctx(5, waves=5,
                                                         chunks=[(1, 0)])) \
        is None
    assert run.read_metric("k3_span_roofline", _gen_ctx(3)) is None
    assert run.read_metric("ring_share.gen", _gen_ctx(4)) == \
        pytest.approx(100.0 * 0.1 / 10.0)


@pytest.mark.parametrize("metric", ["idle_in_data.mle", "idle_in_step.mle",
                                    "k1f_span_roofline", "k1b_span_roofline",
                                    "k3_span_roofline", "ring_share.gen"])
def test_no_spans_no_reading(recorded, monkeypatch, metric):
    """A window without the metric's spans, and a program without the
    recorder (an older version of the program), read None."""
    ctx = types.SimpleNamespace(**vars(_mle_ctx(3)))
    ctx.launches = {**ctx.launches, "generate_chunk": 4}
    ctx.waves, ctx.chunks = 2, [(32, 0), (32, 32)]
    ctx.shapes = {**ctx.shapes, **_gen_ctx(4).shapes, "B": 128}
    assert run.read_metric(metric, ctx) is None
    recorded += [_span(n, 0, G, 1.0) for n in (
        "train.data", "train.h2d", "train.step", "k1f", "k1f", "k1f", "k1b",
        "k1b", "k1b", "k3", "k3", "k3", "k3", "gen.ring")]
    assert run.read_metric(metric, ctx) is not None
    monkeypatch.setitem(sys.modules, "transformer_gan_torch.utils.spans",
                        None)
    monkeypatch.delattr(sys.modules["transformer_gan_torch.utils"], "spans")
    assert run.read_metric(metric, ctx) is None


def test_idle_overlap_and_attribution_are_exact():
    # busy [1, 2) and [4, 9) s of a 10 s window: idle [0, 1), [2, 4), [9, 10)
    t = _trace()
    t.busy_s = 6.0
    assert span_idle.idle(t) == [(0, G), (2 * G, 4 * G), (9 * G, 10 * G)]
    assert span_idle.idle(_trace(merged=())) == [(0, 10 * G)]
    assert span_idle.idle(_trace(merged=((0, 10 * G),))) == []
    idle = span_idle.idle(t)
    outer = _span("train.step", G // 2, 3 * G)
    inner = _span("k1f", 5 * G // 2, 3 * G)
    assert span_idle.overlap(idle, [outer]) == 0.5 + 1.0
    # nested spans count each instant once
    assert span_idle.overlap(idle, [outer, inner]) == 1.5
    assert span_idle.overlap(idle, [_span("x", 8 * G, 10 * G)]) == 1.0
    assert span_idle.overlap([], [outer]) == 0.0
    assert span_idle.overlap(idle, []) == 0.0
    assert span_idle.idle_in(t, [outer, inner]) == 1.5
    # by innermost span: k1f takes its half second from train.step
    named = [(s.start_ns, s.end_ns, s.name) for s in (outer, inner)]
    assert span_idle.attribute(idle, named) == {
        None: 2.5, "train.step": 1.0, "k1f": 0.5}
    t.host = [(0, G // 4, "cudaLaunchKernel"),
              (9 * G, 10 * G, "Activity Buffer Request"),
              (3 * G, 4 * G, "cudaMemcpyAsync")]
    other = _span("train.data", 3 * G, 4 * G, thread=MAIN + 1)
    inner.events = (Ev(0.0), Ev(250.0))
    got = span_idle.table(t, [outer, inner, other], MAIN)
    assert got["idle_s"] == 4.0 and got["window_s"] == 10.0
    assert got["span_counts"] == {"train.step": 1, "k1f": 1, "train.data": 1}
    assert got["device_s_by_span"] == {"k1f": 0.25}
    assert got["idle_by_span"] == {None: 2.5, "train.step": 1.0, "k1f": 0.5}
    # outside the main thread's spans: [0, 0.5), [3, 4), [9, 10)
    assert got["outside_by_host_call"] == {
        "cudaLaunchKernel": 0.25, None: 0.25, "cudaMemcpyAsync": 1.0,
        "Activity Buffer Request": 1.0}
