"""``transformer_gan_torch.utils.spans``: off without a profiler trace (no
record, no clock read, no allocation, no event), on under one (nesting,
parents, threads, the profiler's clock), the profile tools' kernel readers
skipping the spans' ranges, and the spans a tiny CPU ``Trainer.train`` and
``Trainer._generate_tokens`` open. The ``gpu`` tests hold the span clock to
the profiler's on the card and the profile tools' counts of a traced K3
call to those without spans: ``python -m pytest tests/test_torch_spans.py
-q`` on a machine with one."""
from __future__ import annotations

import logging
import os
import threading
import tracemalloc
import types

import pytest
import torch

from transformer_gan_torch.utils import spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh():
    spans.RECORDS.clear()
    yield
    spans.RECORDS.clear()


def _profile(*acts):
    return torch.profiler.profile(
        activities=list(acts) or [torch.profiler.ProfilerActivity.CPU])


def _names(records, thread=None):
    return [s.name for s in records if thread is None or s.thread == thread]


# ---------------------------------------------------------------------------
# Off
# ---------------------------------------------------------------------------

def test_off_is_one_shared_no_op(monkeypatch):
    """No trace: the same no-op context every call, nothing recorded, no
    clock read and no CUDA event made, also with ``device=True``."""
    def refuse(*a, **k):
        raise AssertionError("read or made while spans are off")

    monkeypatch.setattr(spans.time, "time_ns", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert spans.span("a") is spans.OFF
    assert spans.span("b", device=True) is spans.OFF
    with spans.span("c", device=True) as sp:
        assert sp is None
    double = spans.spanned("d")(lambda x: 2 * x)
    assert double(3) == 6
    assert spans.RECORDS == []


def test_off_allocates_nothing():
    """The off path allocates no memory: the traced peak stays where it was
    over many spans (a recording span would take ~100 bytes each)."""
    def loop(n):
        for _ in range(n):
            with spans.span("x", device=True):
                pass

    loop(10)
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        loop(5000)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak - before < 256
    assert spans.RECORDS == []


# ---------------------------------------------------------------------------
# On
# ---------------------------------------------------------------------------

def test_on_records_nesting_parents_and_threads():
    """Under a CPU trace: each span with its name, host interval, the
    enclosing span of its own thread and its thread; a span of another
    thread has no parent there; the decorator records too."""
    seen = {}

    def other():
        with spans.span("worker") as sp:
            seen["worker"] = sp

    @spans.spanned("deco")
    def deco(x):
        return x + 1

    with _profile():
        with spans.span("outer") as outer:
            assert spans.span("inner") is not spans.OFF
            with spans.span("inner") as inner:
                t = threading.Thread(target=other)
                t.start()
                t.join(timeout=30)
                assert not t.is_alive()
                assert deco(torch.ones(2)).sum() == 4
            with spans.span("second"):
                pass
    after = spans.span("late")
    assert after is spans.OFF
    rec = spans.RECORDS
    assert _names(rec) == ["outer", "inner", "worker", "deco", "second"]
    by = {s.name: s for s in rec}
    main = threading.get_ident()
    assert main == spans.MAIN
    assert by["outer"].parent is None
    assert by["inner"].parent is outer and by["second"].parent is outer
    assert by["deco"].parent is inner
    w = seen["worker"]
    assert w.parent is None and w.thread != main
    assert all(s.thread == main for s in rec if s is not w)
    for s in rec:
        assert s.start_ns <= s.end_ns and s.events is None
    assert by["outer"].start_ns <= by["inner"].start_ns
    assert by["inner"].end_ns <= by["second"].start_ns
    assert by["second"].end_ns <= by["outer"].end_ns
    lo, hi = by["inner"].start_ns, by["inner"].end_ns
    assert _names(spans.recorded(lo, hi)) == ["inner", "worker", "deco"]
    assert spans.device_seconds(rec) == 0.0
    assert {"outer", "inner", "worker", "deco", "second"} <= spans.NAMES
    assert "late" not in spans.NAMES


def test_record_function_inside_a_span_is_inside_its_interval():
    """The spans' clock is the profiler's: a ``record_function`` range
    opened inside a span lies within the span's host interval in the trace,
    and the span's own range holds that interval."""
    with _profile() as prof:
        with spans.span("holder") as sp:
            with torch.profiler.record_function("probe.inner"):
                torch.ones(256).sum()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in ("probe.inner", "holder")}
    assert set(events) == {"probe.inner", "holder"}
    inner, own = events["probe.inner"], events["holder"]
    assert sp.start_ns <= inner.start_ns() <= inner.end_ns() <= sp.end_ns
    assert own.start_ns() <= sp.start_ns and sp.end_ns <= own.end_ns()


def test_exception_closes_the_span():
    with _profile():
        with pytest.raises(ValueError):
            with spans.span("failing"):
                raise ValueError("boom")
        with spans.span("next") as nxt:
            pass
    assert nxt.parent is None
    assert all(s.end_ns is not None for s in spans.RECORDS)


# ---------------------------------------------------------------------------
# The profile tools' kernel readers
# ---------------------------------------------------------------------------

class _Event:
    """A kineto event's stand-in (ns)."""

    def __init__(self, name, lo, hi, cuda=True):
        self._name, self._lo, self._hi, self._cuda = name, lo, hi, cuda

    def name(self):
        return self._name

    def start_ns(self):
        return self._lo

    def duration_ns(self):
        return self._hi - self._lo

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._cuda
                else torch.autograd.DeviceType.CPU)


def _fake_profile(events, extra=()):
    """A finished profile's stand-in over ``events``: the key averages sum
    each name's device time and count its events, as ``torch.profiler``'s
    do for device-side events, then list the ``extra`` rows."""
    rows = {}
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            r = rows.setdefault(e.name(), types.SimpleNamespace(
                key=e.name(), count=0, device_time_total=0.0,
                device_type=e.device_type()))
            r.count += 1
            r.device_time_total += e.duration_ns() / 1000.0
    return types.SimpleNamespace(
        key_averages=lambda: list(rows.values()) + list(extra),
        profiler=types.SimpleNamespace(kineto_results=types.SimpleNamespace(
            events=lambda: list(events))))


def test_profile_readers_skip_span_ranges(monkeypatch):
    """A span's range shows on the device as an annotation that covers its
    kernels: the profile tools' readers count the same kernels, launches
    and busy time with and without it, keep a kernel whose name only
    contains a span's name, and leave out host-side rows that carry a
    device time (the first event records of a process)."""
    from transformer_gan_torch import profile_generate as pg
    monkeypatch.setattr(spans, "NAMES", {"k3", "gen.ring"})
    us = 1000
    kernels = [_Event("tg_k3_split_attn", 10 * us, 20 * us),
               _Event("tg_tc_gemv", 30 * us, 40 * us),
               _Event("tg_tc_gemv", 60 * us, 70 * us),
               _Event("Memcpy HtoD (Pageable -> Device)", 0, 5 * us),
               _Event("aten::cat", 70 * us, 71 * us, cuda=False)]
    # a host-side runtime call that the key averages give a device time
    host_row = types.SimpleNamespace(
        key="cudaStreamIsCapturing", count=4, device_time_total=36.0,
        device_type=torch.autograd.DeviceType.CPU)
    with_spans = kernels + [_Event("k3", 0, 100 * us),
                            _Event("gen.ring", 80 * us, 90 * us)]

    def read(events):
        prof = _fake_profile(events, [host_row])
        rows = [r for r in pg._device_rows(prof) if pg._is_kernel(r[0])]
        return ({r[0]: r[1] for r in rows}, sum(r[2] for r in rows),
                pg._busy_ms(prof))

    plain = read(kernels)
    assert plain == ({"tg_k3_split_attn": 1, "tg_tc_gemv": 2}, 0.03,
                     (0.03, 0.06))
    assert read(with_spans) == plain


# ---------------------------------------------------------------------------
# Device seconds and the GAN phase lines
# ---------------------------------------------------------------------------

def _s(name, lo, hi):
    return types.SimpleNamespace(name=name, start_ns=lo, end_ns=hi,
                                 events=None)


def test_device_seconds_sums_event_pairs():
    class Ev:
        def __init__(self, t):
            self.t, self.waited = t, False

        def synchronize(self):
            self.waited = True

        def elapsed_time(self, other):
            return other.t - self.t

    a, b = _s("a", 0, 1), _s("b", 0, 1)
    a.events, b.events = (Ev(1.0), Ev(3.5)), (Ev(0.0), Ev(0.5))
    assert spans.device_seconds([a, b, _s("c", 0, 1)]) == pytest.approx(
        3e-3, abs=1e-15)
    assert a.events[1].waited and b.events[1].waited


# ---------------------------------------------------------------------------
# The program's spans on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_trainer(tmp_path_factory):
    import yaml

    from chip_smoke import write_random_corpus
    from transformer_gan_torch.config import PACKAGED_VOCAB, training_config
    from transformer_gan_torch.train.loop import Trainer
    tmp = tmp_path_factory.mktemp("spans")
    data = str(tmp / "data")
    write_random_corpus(data, PACKAGED_VOCAB, n_train=8, train_len=60,
                        n_eval=2, eval_len=20, seed=3)
    with open(os.path.join(ROOT, "training_config",
                           "experiment_baseline.yml")) as f:
        raw = yaml.safe_load(f)
    raw["MODEL"].update(num_layers=2, num_heads=2, units=16, inner_size=32)
    raw["TRAIN"].update(batch_size=2, max_step=3, log_interval=100,
                        eval_interval=100, mem_length=8, tgt_length=8,
                        batch_chunk=1)
    raw["TPU"].update(compute_dtype="float32")
    path = tmp / "cfg.yml"
    path.write_text(yaml.safe_dump(raw))
    return Trainer(training_config(str(path)), data, str(tmp / "work"),
                   device="cpu")


def test_trainer_records_data_h2d_step_each_step(tiny_trainer, monkeypatch):
    """Three CPU steps under a trace: train.data -> train.h2d -> train.step
    on the main thread, three times, the K1f / K1b wrappers' spans inside
    each step (the v2 route, as on the card; their plain versions here), no
    device events."""
    from transformer_gan_torch.models import xl
    monkeypatch.setattr(xl, "attention_route",
                        lambda core_out, mem_len: "v2" if mem_len else "v1")
    tr = tiny_trainer
    tr.train_step_num = 0
    with _profile():
        tr.train()
    assert tr.train_step_num == 3
    rec = spans.RECORDS
    top = [s.name for s in rec if s.parent is None and s.thread == spans.MAIN]
    assert top == ["train.data", "train.h2d", "train.step"] * 3
    L = tr.cfg.MODEL.num_layers
    steps = [s for s in rec if s.name == "train.step"]
    for name in ("k1f", "k1b"):
        ks = [s for s in rec if s.name == name]
        assert len(ks) == 3 * L, name
        assert all(s.parent in steps for s in ks), name
    assert all(s.events is None for s in rec)


def test_generate_tokens_records_call_setup_k3_ring(tiny_trainer):
    """A CPU ``_generate_tokens`` of 4 pieces in waves of 2 at 40 tokens (39
    sampled: chunks of 32 and 7) under a trace: one gen.call and one
    gen.readback, two gen.setup a wave (the draws, then R and the stacked
    weights), one k3 and one gen.ring a chunk, all inside gen.call."""
    with _profile():
        toks = tiny_trainer._generate_tokens(4, 2, 40)
    assert toks.shape == (4, 40)
    rec = spans.RECORDS
    counts = {}
    for s in rec:
        counts[s.name] = counts.get(s.name, 0) + 1
    assert counts == {"gen.call": 1, "gen.setup": 4, "k3": 4, "gen.ring": 4,
                      "gen.readback": 1}
    call = next(s for s in rec if s.name == "gen.call")
    assert all(s.parent is call for s in rec if s is not call)
    assert _names(rec)[-1] == "gen.readback"


def test_gan_phase_lines_say_what_they_measure(caplog):
    """The phase lines print the enqueue as "dispatched in", and the device
    seconds of each phase's span once the device has passed its end event,
    without waiting for it."""
    from transformer_gan_torch.train import gan_loop

    class Ev:
        def __init__(self, ms, done=True):
            self.ms, self.done = ms, done

        def query(self):
            return self.done

        def synchronize(self):
            if not self.done:
                raise AssertionError("the phase line waited for the device")

        def elapsed_time(self, other):
            return other.ms - self.ms

    first, second = _s("gan.gen", 0, 1), _s("gan.dis", 1, 2)
    first.events = (Ev(0.0), Ev(1250.0, done=False))
    second.events = (Ev(0.0), Ev(500.0, done=False))
    unread = []
    with caplog.at_level(logging.INFO):
        gan_loop._log_phase("dis_phase", 7, 0.123, None, unread)
        gan_loop._log_phase("gen_phase", 8, 0.5, first, unread)
        gan_loop._log_phase("gen_phase", 9, 0.5, _s("gan.gen", 0, 1), unread)
        first.events[1].done = True
        gan_loop._log_phase("dis_phase", 10, 0.25, second, unread)
        assert len(unread) == 1
        second.events[1].done = True
        gan_loop._log_phase("dis_phase", 11, 0.25, None, unread)
    assert caplog.messages == [
        "dis_phase step 7: dispatched in 0.12s",
        "gen_phase step 8: dispatched in 0.50s",
        "gen_phase step 9: dispatched in 0.50s",
        "dis_phase step 10: dispatched in 0.25s",
        "gen_phase step 8: device 1.25s",
        "dis_phase step 11: dispatched in 0.25s",
        "dis_phase step 10: device 0.50s"]
    assert unread == []


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("cpu_activity", [False, True])
def test_span_clock_holds_the_device_synchronize(cpu_activity):
    """On the card, a span around the device synchronize
    (``torch.cuda.synchronize``'s C entry, so that little host code sits
    between the span's clock reads and the call) contains the trace's
    ``cudaDeviceSynchronize`` each of five times, under CUDA activity
    alone (as the benchmark traces) and with CPU activity. The profiler's
    clock then lies at most the least start slack ahead of the spans' and
    at most the least end slack behind: both within 50 us. The device
    events time the queued work."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    A = torch.profiler.ProfilerActivity
    x = torch.randn(4096, 4096, device="cuda")
    torch.cuda.synchronize()
    acts = [A.CPU, A.CUDA] if cpu_activity else [A.CUDA]
    held = []
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(5):
            with spans.span("probe.work", device=True) as work:
                for _ in range(10):
                    x = torch.tanh(x @ x)
            with spans.span("probe.sync") as sp:
                torch._C._cuda_synchronize()
            held.append(sp)
    syncs = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "cudaDeviceSynchronize"]
    ahead, behind = [], []
    for sp in held:
        inside = [e for e in syncs if sp.start_ns <= e.start_ns()
                  and e.end_ns() <= sp.end_ns]
        assert len(inside) == 1, (sp.start_ns, sp.end_ns)
        ahead.append(inside[0].start_ns() - sp.start_ns)
        behind.append(sp.end_ns - inside[0].end_ns())
    print(f"span clock slack (ns), cpu_activity={cpu_activity}: start "
          f"{ahead}, end {behind}")
    assert min(ahead) <= 50_000 and min(behind) <= 50_000, (ahead, behind)
    assert spans.device_seconds([work]) > 0


@pytest.mark.gpu
def test_traced_k3_counts_the_same_kernels_with_and_without_spans(
        monkeypatch):
    """The profile tools' reading of a traced K3 call (each kernel's
    launches, ``profile_generate``) is the same with the spans on as with
    them held off, and the K3 span's range is in every trace with spans
    on, so the readers do meet it. The profiler now and then loses a
    device record of a traced call (never adds one), so each side's reading
    is the most that three of its calls counted, in turns on / off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from transformer_gan_torch import kernel_check as kc
    from transformer_gan_torch import profile_generate as pg
    case = kc.GenerateCase("bfloat16", 1, 256, M=256)
    g = case.noise(pg.N_TOKENS)
    case.run(pg.N_TOKENS, g)
    torch.cuda.synchronize()
    real = spans._profiler
    held_off = types.SimpleNamespace(_is_profiler_enabled=False)
    most = {"on": {}, "off": {}}
    for side in ("on", "off", "off", "on", "on", "off"):
        monkeypatch.setattr(spans, "_profiler",
                            real if side == "on" else held_off)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            case.run(pg.N_TOKENS, g)
            torch.cuda.synchronize()
        rows = pg._device_rows(prof)
        assert ("k3" in {r[0] for r in rows}) == (side == "on")
        for key, count, _ in rows:
            if pg._is_kernel(key):
                most[side][key] = max(most[side].get(key, 0), count)
    assert most["on"] == most["off"] and sum(most["on"].values()) > 0
