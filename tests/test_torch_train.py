"""MLE training of the port (transformer_gan_torch) against the JAX package,
fp32 on the CPU: ``forward_nll`` and every parameter gradient (plain route,
and the fused routes v2 / v1 forced through their autograd Functions,
against JAX's Pallas routes in interpret mode), the fused optimizer (adam,
adamw, lamb) over 5 steps of given gradients, the schedules and the plateau
tracker, the flat parameter order, and a 4-step training trajectory.

Tolerances: loss rtol 1e-5, gradients rtol 5e-4 / atol 1e-6 (those of
tests/test_xl_parity.py: fp32 sums in another order); optimizer rtol 1e-5 /
atol 1e-7; schedules rtol 1e-6 / atol 2e-7 (JAX computes the multipliers,
all at most 1, in fp32; the port in float64); the trajectory
atol 2e-5 on parameters after four adam updates at lr 2e-3 (an adam step
normalises each gradient element, so a gradient near zero turns rounding
into a step of up to lr; the bound holds a few lr * 1e-3)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_gan_torch import convert
from transformer_gan_torch.models import xl as txl
from transformer_gan_torch.train import optim as topt
from transformer_gan_torch.train import step as tstep
from transformer_gan_tpu.models import xl as jxl
from transformer_gan_tpu.train import optim as jopt
from transformer_gan_tpu.train import step as jstep

torch.set_num_threads(1)

BASE = dict(n_layer=2, n_head=2, d_model=16, d_inner=32, n_token=310,
            dropout=0.0, dropatt=0.0)


def _models(pallas=False, **over):
    kw = {**BASE, **over}
    jcfg = jxl.XLConfig(cache_kv=True, use_pallas=pallas, **kw)
    tcfg = txl.XLConfig(cache_kv=True, **kw)
    jp = jxl.init_xl_params(jcfg, seed=0, base_init=("normal", 0.1))
    return jcfg, tcfg, jp


def _flat_grads_jax(g):
    """Flat JAX gradients keyed by the port's names."""
    return {k: v.numpy() for k, v in convert.params_from_jax(g).items()}


@pytest.fixture
def interpret(monkeypatch):
    from transformer_gan_tpu.ops import pallas_attention as pa
    from transformer_gan_tpu.ops import pallas_attention_v2 as pa2
    monkeypatch.setattr(pa, "INTERPRET", True)
    monkeypatch.setattr(pa2, "INTERPRET", True)
    monkeypatch.setattr(pa2, "_FAST_BF16_SHIFT", [False])


@pytest.mark.parametrize("route,mem_len", [("plain", 24), ("v2", 24),
                                           ("v1", 0), ("plain", 0)])
def test_forward_nll_and_grads_match_jax(interpret, route, mem_len):
    """Three 16-token windows into a 24-slot ring (count 0 -> 16 partial ->
    24 full, then full again) with a reset row: per window the NLL, every
    parameter gradient and the new memories against JAX forward_nll. The
    fused routes (forced by ``route``) run the port's autograd Functions on
    the CPU; JAX runs its Pallas kernels (v2 with memory, v1 without) in
    interpret mode."""
    jcfg, tcfg, jp = _models(pallas=route != "plain")
    bsz, qlen = 2, 16
    rng = np.random.RandomState(3)
    jm = jxl.init_mems(jcfg, mem_len, bsz)
    tm = txl.init_mems(tcfg, mem_len, bsz)
    for step in range(3):
        data = rng.randint(0, 310, (qlen, bsz))
        target = rng.randint(0, 310, (qlen, bsz))
        reset = np.array([False, step == 1])

        def loss_j(p):
            nll, new = jxl.forward_nll(p, jcfg, jnp.asarray(data),
                                       jnp.asarray(target),
                                       jnp.asarray(reset), jm)
            return nll.mean(), (nll, new)

        (_, (jnll, jnew)), jg = jax.value_and_grad(loss_j, has_aux=True)(jp)
        tp = {k: v.requires_grad_() for k, v in
              convert.params_from_jax(jp).items()}
        tnll, tnew = txl.forward_nll(tp, tcfg, torch.from_numpy(data),
                                     torch.from_numpy(target),
                                     torch.from_numpy(reset), tm, route=route)
        tnll.mean().backward()
        np.testing.assert_allclose(tnll.detach().numpy(), np.asarray(jnll),
                                   rtol=1e-5, atol=1e-6)
        ref = _flat_grads_jax(jg)
        for k, v in tp.items():
            np.testing.assert_allclose(v.grad.numpy(), ref[k], rtol=5e-4,
                                       atol=1e-6, err_msg=k)
        np.testing.assert_allclose(tnew.hids.numpy(), np.asarray(jnew.hids),
                                   rtol=1e-5, atol=1e-6)
        assert tnew.count == int(jnew.count)
        assert not tnew.hids.requires_grad
        jm, tm = jnew, tnew


def test_training_forward_draws_dropout_from_the_generator():
    """With a generator the forward applies dropout (reproducibly); without
    one it is the inference forward."""
    _, tcfg, jp = _models(dropout=0.3, dropatt=0.2)
    tp = convert.params_from_jax(jp)
    rng = np.random.RandomState(0)
    data = torch.from_numpy(rng.randint(0, 310, (8, 2)))
    mems = txl.init_mems(tcfg, 8, 2)
    a = txl.xl_forward(tp, tcfg, data, mems)[0]
    b = txl.xl_forward(tp, tcfg, data, mems,
                       generator=torch.Generator().manual_seed(1))[0]
    c = txl.xl_forward(tp, tcfg, data, mems,
                       generator=torch.Generator().manual_seed(1))[0]
    assert torch.equal(b, c) and not torch.allclose(a, b)
    assert torch.equal(a, txl.xl_forward(tp, tcfg, data, mems)[0])


def test_route_argument_forces_the_attention():
    """``route`` picks every layer's attention: on CPU tensors "v2" and "v1"
    run the fused contracts' autograd Functions (their plain versions) and
    agree with the default plain route (fp32, rtol 1e-5); an unknown route
    raises."""
    _, tcfg, jp = _models()
    tp = convert.params_from_jax(jp)
    data = torch.from_numpy(np.random.RandomState(0).randint(0, 310, (8, 2)))
    for mem_len, route in ((8, "v2"), (0, "v1")):
        mems = txl.init_mems(tcfg, mem_len, 2)
        ref = txl.xl_forward(tp, tcfg, data, mems)[0]
        got = txl.xl_forward(tp, tcfg, data, mems, route=route)[0]
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        txl.xl_forward(tp, tcfg, data, mems, route="v3")


# ---------------------------------------------------------------------------
# Optimizer and schedules
# ---------------------------------------------------------------------------

def test_flat_order_is_ravel_pytree_order():
    from jax.flatten_util import ravel_pytree
    jcfg, _, jp = _models(tie_embedding=False)
    tp = convert.params_from_jax(jp)
    layout = topt.FlatLayout.of(tp)
    flat, _ = ravel_pytree(jp)
    np.testing.assert_array_equal(layout.flatten(tp).numpy(),
                                  np.asarray(flat))
    assert layout.size == flat.size
    back = layout.unflatten(layout.flatten(tp))
    assert all(torch.equal(back[k], tp[k]) for k in tp)


@pytest.mark.parametrize("name,wd", [("adam", 0.0), ("adam", 0.01),
                                     ("adamw", 0.01), ("lamb", 0.0),
                                     ("lamb", 0.01)])
def test_fused_optimizer_matches_jax(name, wd):
    """Five updates of given gradients (the third above the clip) through
    the JAX fused optimizer and the port's, with a warmup schedule; the
    moments, count and parameters agree, and the state converts both ways."""
    from jax.flatten_util import ravel_pytree
    _, _, jp = _models()
    sched_j = jopt.make_schedule("inv_sqrt", 1e-2, 100, 1e-4, 2)
    sched_t = topt.make_schedule("inv_sqrt", 1e-2, 100, 1e-4, 2)
    jo = jopt.make_fused_optimizer(name, 1e-2, sched_j, 1.0, wd)
    tp = convert.params_from_jax(jp)
    layout = topt.FlatLayout.of(tp)
    to = topt.FusedOptimizer(name, 1e-2, sched_t, 1.0, wd, layout=layout)
    flat = layout.flatten(tp)
    js, ts = jo.init(jp), to.init(flat)
    _, unravel = ravel_pytree(jp)
    rng = np.random.RandomState(1)
    for k in range(5):
        g = (rng.randn(layout.size) * (3.0 if k == 2 else 0.01)
             ).astype(np.float32)
        upd, js = jo.update(unravel(jnp.asarray(g)), js, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        ts = to.update(flat, torch.from_numpy(g), ts)
        np.testing.assert_allclose(ts.mu.numpy(), np.asarray(js.mu),
                                   rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(ts.nu.numpy(), np.asarray(js.nu),
                                   rtol=1e-5, atol=1e-12)
        np.testing.assert_allclose(flat.numpy(),
                                   np.asarray(ravel_pytree(jp)[0]),
                                   rtol=1e-5, atol=1e-7)
        assert ts.count == int(js.count)
    back = convert.opt_state_from_jax(convert.opt_state_to_jax(ts))
    assert back.count == ts.count and back.lr_scale == ts.lr_scale
    assert torch.equal(back.mu, ts.mu) and torch.equal(back.nu, ts.nu)
    from_j = convert.opt_state_from_jax(js)
    assert torch.equal(from_j.mu, torch.from_numpy(np.array(js.mu)))


@pytest.mark.parametrize("name,warmup,lr_min", [
    ("inv_sqrt", 4, 1e-4), ("inv_sqrt", 0, 1e-4), ("cosine", 4, 1e-5),
    ("cosine", 0, 0.0), ("constant", 4, 0.0), ("dev_perf", 0, 0.0)])
def test_schedules_match_jax(name, warmup, lr_min):
    sj = jopt.make_schedule(name, 4e-3, 50, lr_min, warmup)
    st = topt.make_schedule(name, 4e-3, 50, lr_min, warmup)
    for step in (0, 1, 2, 3, 4, 5, 6, 10, 49, 50, 60):
        np.testing.assert_allclose(st(step), float(sj(step)), rtol=1e-6,
                                   atol=2e-7, err_msg=f"{name} {step}")


def test_plateau_tracker_matches_jax():
    a = jopt.PlateauTracker(0.5, 2, 1e-4, 4e-3)
    b = topt.PlateauTracker(0.5, 2, 1e-4, 4e-3)
    for metric in (5.0, 4.0, 4.5, 4.2, 4.1, 4.3, 3.0, 3.5, 3.6, 3.7, 3.8,
                   3.9, 4.0, 4.1, 4.2, 4.3, 4.4):
        assert b.step(metric) == a.step(metric)
    assert b.multiplier < 1.0
    state = topt.set_lr_multiplier(topt.FusedOptimizer(
        "adam", 1.0, topt.constant_schedule(0), 1.0).init(torch.zeros(3)),
        b.multiplier)
    assert state.lr_scale == b.multiplier


# ---------------------------------------------------------------------------
# Training trajectory
# ---------------------------------------------------------------------------

def test_four_step_trajectory_matches_jax():
    """Four MLE steps at dropout 0, batch_chunk 2 (two XL memories), reset
    rows and pad targets, adam with clip and a 2-step warmup: per step the
    weighted loss, token count, pre-clip grad norm, the parameters and the
    carried memories against JAX make_mle_train_step."""
    jcfg, tcfg, jp = _models()
    C, tgt, bsz, mem = 2, 8, 4, 12
    sched_j = jopt.make_schedule("inv_sqrt", 2e-3, 100, 1e-4, 2)
    jo = jopt.make_optimizer("adam", 2e-3, sched_j, 0.25)
    jstate = jstep.init_train_state(jp, jo, jcfg, C, mem, bsz // C, 1111)
    jfn = jstep.make_mle_train_step(jcfg, jo, C, pad_id=1, donate=False)
    tp = convert.params_from_jax(jp)
    to = topt.FusedOptimizer("adam", 2e-3,
                             topt.make_schedule("inv_sqrt", 2e-3, 100, 1e-4, 2),
                             0.25, layout=topt.FlatLayout.of(tp))
    tstate = tstep.init_train_state(tp, to, tcfg, C, mem, bsz // C, 1111)
    tfn = tstep.make_mle_train_step(tcfg, to, C, pad_id=1)
    rng = np.random.RandomState(5)
    for k in range(4):
        data = rng.randint(2, 310, (tgt, bsz))
        target = rng.randint(2, 310, (tgt, bsz))
        target[-3:, k % bsz] = 1          # pad tail on one row
        reset = rng.rand(bsz) < 0.3
        args = (tstep.chunk_batch(data, C), tstep.chunk_batch(target, C),
                tstep.chunk_rows(reset, C))
        jstate, jmet = jfn(jstate, *map(jnp.asarray, args))
        tstate, tmet = tfn(tstate, *map(torch.from_numpy, args))
        np.testing.assert_allclose(float(tmet["loss_weighted"]),
                                   float(jmet["loss_weighted"]), rtol=1e-5)
        assert int(tmet["tokens"]) == int(jmet["tokens"])
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=5e-4)
        ref = convert.params_from_jax(jstate.params)
        got = tstate.params()
        for name in ref:
            np.testing.assert_allclose(got[name].detach().numpy(),
                                       ref[name].numpy(), rtol=0, atol=2e-5,
                                       err_msg=f"step {k} {name}")
        for c in range(C):
            np.testing.assert_allclose(tstate.mems[c].hids.numpy(),
                                       np.asarray(jstate.mems.hids[c]),
                                       rtol=0, atol=2e-5)
            assert tstate.mems[c].count == int(jstate.mems.count[c])
    assert tstate.step == int(jstate.step) == 4
    assert tstate.opt_state.count == int(jstate.opt_state.count)


def test_eval_step_matches_jax():
    jcfg, tcfg, jp = _models()
    rng = np.random.RandomState(2)
    data, target = rng.randint(0, 310, (8, 3)), rng.randint(0, 310, (8, 3))
    target[5:, 1] = 1
    jm, tm = jxl.init_mems(jcfg, 16, 3), txl.init_mems(tcfg, 16, 3)
    jfn = jstep.make_eval_step(jcfg, 1)
    tfn = tstep.make_eval_step(tcfg, 1)
    tp = convert.params_from_jax(jp)
    for _ in range(3):
        js, jc, jm = jfn(jp, jnp.asarray(data), jnp.asarray(target), jm)
        ts, tc, tm = tfn(tp, torch.from_numpy(data), torch.from_numpy(target),
                         tm)
        np.testing.assert_allclose(float(ts), float(js), rtol=1e-5)
        assert int(tc) == int(jc)
    tm = tstep.reset_eval_mems(tm)
    assert tm.count == 0 and int(jstep.reset_eval_mems(jm).count) == 0


def test_train_step_without_mle_keeps_params():
    _, tcfg, jp = _models()
    tp = convert.params_from_jax(jp)
    to = topt.FusedOptimizer("adam", 1e-2, topt.constant_schedule(0), 1.0)
    state = tstep.init_train_state(tp, to, tcfg, 1, 8, 2, 0)
    before = state.flat.detach().clone()
    fn = tstep.make_mle_train_step(tcfg, to, 1, pad_id=1, use_mle=False)
    d = torch.randint(2, 310, (1, 8, 2))
    state, met = fn(state, d, d, torch.zeros(1, 2, dtype=torch.bool))
    assert torch.equal(state.flat.detach(), before)
    assert float(met["grad_norm"]) > 0 and state.step == 1
    assert dataclasses.is_dataclass(state)


# ---------------------------------------------------------------------------
# Remat and the profiler trace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route,cache_kv", [("plain", True), ("v2", True),
                                            (None, False)])
def test_remat_gradients_equal_without_remat_dropout_on(route, cache_kv):
    """``remat`` (each layer recomputed in the backward) at dropout and
    attention dropout 0.1: the same loss and gradients as without it, over
    two windows into a ring with a reset row. The recompute must replay the
    generator's masks (and on the v2 route the kernel's hashed attention
    dropout). Loss exact; gradients rtol 1e-6 / atol 1e-9 (the same ops on
    the same values; only the backward's schedule differs)."""
    _, tcfg, jp = _models(dropout=0.1, dropatt=0.1)
    tcfg = dataclasses.replace(tcfg, cache_kv=cache_kv)
    rng = np.random.RandomState(4)
    out = {}
    for remat in (False, True):
        tp = {k: v.requires_grad_() for k, v in
              convert.params_from_jax(jp).items()}
        mems, losses = txl.init_mems(tcfg, 24, 2), []
        rng = np.random.RandomState(4)
        for step in range(2):
            data, target = (torch.from_numpy(rng.randint(0, 310, (16, 2)))
                            for _ in "dt")
            nll, mems = txl.forward_nll(
                tp, tcfg, data, target, torch.tensor([False, step == 1]),
                mems, generator=torch.Generator().manual_seed(step),
                route=route, remat=remat)
            nll.mean().backward()
            losses.append(nll.detach())
        out[remat] = (losses, {k: v.grad for k, v in tp.items()})
    for a, b in zip(out[False][0], out[True][0]):
        assert torch.equal(a, b)
    for k, g in out[False][1].items():
        torch.testing.assert_close(out[True][1][k], g, rtol=1e-6, atol=1e-9,
                                   msg=k)
    # the masks were drawn: the same step without a generator differs
    tp = convert.params_from_jax(jp)
    plain, _ = txl.forward_nll(tp, tcfg, data, target, None,
                               txl.init_mems(tcfg, 24, 2), route=route)
    assert not torch.equal(plain, out[True][0][0])


def test_profile_dir_writes_a_trace_on_the_cpu(tmp_path):
    """``TPU.profile_dir``: a 16-step CPU run writes a torch.profiler trace
    of steps 10 to 15 (CPU activities) into the directory, the program's
    named spans in it."""
    import json

    import yaml

    from chip_smoke import write_random_corpus
    from transformer_gan_torch.cli import train as tcli
    from transformer_gan_torch.config import PACKAGED_VOCAB
    data = tmp_path / "data"
    write_random_corpus(str(data), PACKAGED_VOCAB, n_train=8, train_len=40,
                        n_eval=2, eval_len=20, seed=1)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "training_config",
                           "experiment_baseline.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["MODEL"].update(num_layers=1, num_heads=2, units=16, inner_size=32)
    cfg["TRAIN"].update(batch_size=2, max_step=16, log_interval=8,
                        eval_interval=100, mem_length=8, tgt_length=8)
    cfg["TPU"].update(profile_dir=str(tmp_path / "prof"), remat=True)
    (tmp_path / "cfg.yml").write_text(yaml.safe_dump(cfg))
    trainer = tcli.main(["--data_dir", str(data), "--cfg",
                         str(tmp_path / "cfg.yml"), "--work_dir",
                         str(tmp_path / "w"), "--device", "cpu"])
    assert trainer.train_step_num == 16
    path = tmp_path / "prof" / "trace_rank0.json"
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    names = {e.get("name") for e in events}
    assert {"train.data", "train.h2d", "train.step"} <= names
