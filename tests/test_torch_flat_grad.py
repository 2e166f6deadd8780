"""The gradient of the flat fp32 parameter vector (``FlatLayout.unflatten``).

``unflatten`` hands out the leaves as pieces of one ``split`` of the flat
vector, so a backward gathers the leaves' gradients into the [P] gradient
with one ``cat``. The construction it replaced, one slice view a leaf, is
kept here as the oracle: its backward filled a [P] buffer with zeros for
every leaf and added them up. On the CPU, at the tiny width of
``tests/test_torch_train.py``:

* the flat gradients and the state after 3 MLE steps equal the oracle's
  (``torch.equal``) over ``batch_chunk``, tied and untied embedding, remat
  and note-status inputs; and for a GAN discriminator update, a generator
  update, an MLM step, and a loss that leaves some leaves unused;
* one MLE step's backward holds no fill and no add of P elements (but the
  accumulation of a later micro-batch into ``flat.grad``) and one gather
  of P elements a micro-batch, under ``torch.profiler``;
* the leaves are views of the flat vector's storage, also under
  ``no_grad``, and an in-place update of ``flat.data`` shows in them."""

import math
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import write_random_corpus
from transformer_gan_torch.config import PACKAGED_VOCAB, training_config
from transformer_gan_torch.data.vocab import BaseVocab
from transformer_gan_torch.models import xl as txl
from transformer_gan_torch.train import optim as topt
from transformer_gan_torch.train import step as tstep

torch.set_num_threads(1)

V = 310
BASE = dict(n_layer=2, n_head=2, d_model=16, d_inner=32, n_token=V,
            dropout=0.1, dropatt=0.1)


def slice_views(layout, flat):
    """The oracle: one slice view of ``flat`` a leaf."""
    return {n: flat[o:o + math.prod(s)].view(s)
            for n, s, o in zip(layout.names, layout.shapes, layout.offsets)}


def _recording(opt):
    """Record every flat gradient that ``opt`` is handed."""
    grads, update = [], opt.update

    def recorded(flat, grad, state):
        grads.append(grad.detach().clone())
        return update(flat, grad, state)

    opt.update = recorded
    return grads


def _vec_len() -> int:
    v = BaseVocab.from_file(PACKAGED_VOCAB)
    v.notes_mapping()
    return v.vec_len


def _mle(C, tie, remat, status):
    kw = dict(BASE, tie_embedding=tie)
    if status:
        kw.update(append_note_status=True, vec_len=_vec_len())
    cfg = txl.XLConfig(cache_kv=True, **kw)
    params = txl.init_xl_params(cfg, seed=0, base_init=("normal", 0.1))
    opt = topt.FusedOptimizer("adam", 2e-3, topt.constant_schedule(0), 0.25,
                              layout=topt.FlatLayout.of(params))
    grads = _recording(opt)
    tgt, bsz = 8, 4
    state = tstep.init_train_state(params, opt, cfg, C, 12, bsz // C, 1111)
    fn = tstep.make_mle_train_step(cfg, opt, C, pad_id=1, remat=remat)
    rng = np.random.RandomState(5)
    for k in range(3):
        data = rng.randint(2, V, (tgt, bsz))
        target = rng.randint(2, V, (tgt, bsz))
        target[-3:, k % bsz] = 1
        args = [tstep.chunk_batch(data, C), tstep.chunk_batch(target, C),
                tstep.chunk_rows(rng.rand(bsz) < 0.3, C)]
        if status:
            args.append(tstep.chunk_status(
                rng.rand(tgt, bsz, cfg.vec_len) < 0.2, C))
        state, _ = fn(state, *map(torch.from_numpy, args))
    return grads + [state.flat.detach(), state.opt_state.mu,
                    state.opt_state.nu] + [m.hids for m in state.mems]


PHASE_CFG = {
    "MODEL": {"num_layers": 2, "num_heads": 2, "units": 16, "inner_size": 32,
              "dropout": 0.1, "attention_dropout": 0.1},
    "TRAIN": {"batch_size": 8, "max_step": 100, "clip": 1.0},
    "DISCRIMINATOR": {"type": "cnn", "start_iter": 0, "dis_steps": 1,
                      "freeze_discriminator": False, "tgt_len": 16,
                      "mem_len": 16, "context_len": 3, "batch_chunk": 2,
                      "sample_chunks_mem": 2, "gen_lr": 1e-3, "dis_lr": 1e-3,
                      "CNN": {"embed_dim": 16, "num_rep": 4,
                              "learning_rate": 1e-3, "loss_type": "rsgan"}},
    "TPU": {"compute_dtype": "float32", "use_pallas_attention": False},
}


def _gan(phase):
    """One GanPhases discriminator or generator update on a tiny cnn
    config: the phase's flat gradient and both updated flat vectors."""
    from transformer_gan_torch.train import gan_loop
    cfg = training_config().merge(PHASE_CFG)
    xcfg = txl.XLConfig.from_cfg(cfg, V)
    params = txl.init_xl_params(xcfg, seed=0, base_init=("normal", 0.1))
    layout = topt.FlatLayout.of(params)
    flat = layout.flatten(params).requires_grad_(True)
    state = types.SimpleNamespace(flat=flat, layout=layout,
                                  params=lambda: layout.unflatten(state.flat))
    rng = np.random.RandomState(2)
    batches = [(rng.randint(2, V, (16, 8)), 128) for _ in range(2)]
    trainer = types.SimpleNamespace(xcfg=xcfg, vocab=list(range(V)),
                                    state=state, n_devices=1,
                                    device=torch.device("cpu"),
                                    dis_iter=lambda: iter(batches))
    ph = gan_loop.GanPhases(trainer, cfg)
    grad = ph.dis_phase(0) if phase == "dis" else ph.gen_phase(0)
    return [grad, ph.dis_flat, flat.detach()]


def _mlm(tmp_path):
    from transformer_gan_torch.bert import mlm
    data = str(tmp_path / "data")
    write_random_corpus(data, PACKAGED_VOCAB, n_train=6, train_len=70,
                        n_eval=2, eval_len=40, seed=0)
    tr = mlm.MlmTrainer(data_dir=data, output_dir=str(tmp_path / "out"),
                        vocab_file=PACKAGED_VOCAB, num_hidden_layers=2,
                        hidden_size=24, block_size=16, batch_size=4,
                        max_steps=4, seed=5, weight_decay=0.01,
                        device="cpu")
    grads = _recording(tr.optimizer)
    tr.train_step(torch.from_numpy(tr.train_blocks[:4]))
    return grads + [tr.flat, tr.opt_state.mu]


def _unused():
    """A loss of some leaves, one of them detached: the others' entries
    of the flat gradient are zero."""
    cfg = txl.XLConfig(cache_kv=True, **BASE)
    params = txl.init_xl_params(cfg, seed=0, base_init=("normal", 0.1))
    layout = topt.FlatLayout.of(params)
    flat = layout.flatten(params).requires_grad_(True)
    p = layout.unflatten(flat)
    loss = ((p["word_emb"] ** 2).sum() + p["r_w_bias"].sum()
            + (p["layers.1.ff_w1"] * p["layers.0.ff_w1"].detach()).sum())
    loss.backward()
    assert float(flat.grad.abs().sum()) > 0
    return [flat.grad]


MLE_CASES = [("mle", C, tie, remat, status)
             for C in (1, 2) for tie in (True, False)
             for remat in (False, True) for status in (False, True)]


@pytest.mark.parametrize("case", MLE_CASES + [
    ("gan_dis",), ("gan_gen",), ("mlm",), ("unused",)],
    ids=lambda c: "-".join(map(str, c)))
def test_flat_gradient_equals_slice_view_oracle(case, tmp_path, monkeypatch):
    """Flat gradients and the resulting state, bit for bit against the
    slice views (the loss only ever added exact zeros)."""
    kind = case[0]

    def run(tag):
        if kind == "mle":
            return _mle(*case[1:])
        if kind == "mlm":
            return _mlm(tmp_path / tag)
        if kind == "unused":
            return _unused()
        return _gan(kind[4:])

    got = run("split")
    with monkeypatch.context() as m:
        m.setattr(topt.FlatLayout, "unflatten", slice_views)
        ref = run("slice")
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert torch.equal(a, b), f"{case}: output {i}"


def _backward_ops(prof):
    """The profiled ops that ran inside the autograd engine, with the
    engine's node they ran under."""
    out = []
    for e in prof.events():
        p = e.cpu_parent
        while p is not None and not p.name.startswith(
                "autograd::engine::evaluate_function"):
            p = p.cpu_parent
        if p is not None:
            out.append((e, p.name))
    return out


@pytest.mark.parametrize("C", [1, 2])
def test_mle_backward_gathers_the_flat_gradient_once(C):
    """One MLE step (after a first, warm one) under the profiler: its
    backward fills no [P] buffer with zeros, adds no [P] tensors but the
    accumulation of micro-batch c > 0 into ``flat.grad``, and allocates
    the [P] gradient once a micro-batch (one ``cat``). The slice views
    held a fill of P for each of the 26 leaves and an add of P for 25 of
    them, a micro-batch, and no gather."""
    cfg = txl.XLConfig(cache_kv=True, **BASE)
    params = txl.init_xl_params(cfg, seed=0, base_init=("normal", 0.1))
    opt = topt.FusedOptimizer("adam", 2e-3, topt.constant_schedule(0), 0.25,
                              layout=topt.FlatLayout.of(params))
    state = tstep.init_train_state(params, opt, cfg, C, 12, 4 // C, 1)
    fn = tstep.make_mle_train_step(cfg, opt, C, pad_id=1)
    P = state.layout.size
    rng = np.random.RandomState(5)

    def batch():
        d, t = rng.randint(2, V, (2, 8, 4))
        return [torch.from_numpy(a) for a in (
            tstep.chunk_batch(d, C), tstep.chunk_batch(t, C),
            tstep.chunk_rows(rng.rand(4) < 0.3, C))]

    state, _ = fn(state, *batch())
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True,
                 profile_memory=True) as prof:
        fn(state, *batch())
    ops = _backward_ops(prof)
    assert ops, "no backward op recorded"

    def of_p(e):
        return any(list(s) == [P] for s in e.input_shapes
                   if isinstance(s, (list, tuple)))

    fills = [e for e, _ in ops if e.name in (
        "aten::zero_", "aten::fill_", "aten::zeros") and of_p(e)]
    adds = [(e, node) for e, node in ops
            if e.name in ("aten::add", "aten::add_") and of_p(e)]
    gathers = [e for e, _ in ops
               if e.name == "aten::cat" and e.cpu_memory_usage == 4 * P]
    assert not fills, f"{len(fills)} fills of [P]"
    assert len(adds) == C - 1, f"{len(adds)} adds of [P]"
    assert all("AccumulateGrad" in node for _, node in adds)
    assert len(gathers) == C


def test_leaves_are_views_of_the_flat_storage():
    """Every leaf shares the flat vector's storage at its offset, with
    and without autograd; an in-place update of ``flat.data`` shows in the
    views taken before and after it; under ``no_grad`` they are plain
    views with no autograd node, as the slice views were."""
    cfg = txl.XLConfig(cache_kv=True, **BASE)
    params = txl.init_xl_params(cfg, seed=0, base_init=("normal", 0.1))
    layout = topt.FlatLayout.of(params)
    flat = layout.flatten(params).requires_grad_(True)
    before = layout.unflatten(flat)
    with torch.no_grad():
        plain = layout.unflatten(flat)
    for views in (before, plain):
        for n, o in zip(layout.names, layout.offsets):
            v = views[n]
            assert v.untyped_storage().data_ptr() == \
                flat.untyped_storage().data_ptr()
            assert v.data_ptr() == flat.data_ptr() + 4 * o
            assert torch.equal(v, params[n])
    assert all(v.requires_grad and v.grad_fn is not None
               for v in before.values())
    assert not any(v.grad_fn for v in plain.values())
    with torch.no_grad():
        oracle = slice_views(layout, flat)
    assert all(plain[n].requires_grad == oracle[n].requires_grad
               for n in layout.names)
    flat.data.add_(1.0)
    after = layout.unflatten(flat)
    for n in layout.names:
        assert torch.equal(after[n], params[n] + 1.0)
        assert torch.equal(before[n], after[n])
        assert torch.equal(plain[n], after[n])
    detached = {k: v.detach() for k, v in layout.unflatten(flat).items()}
    assert all(v.data_ptr() == after[k].data_ptr()
               for k, v in detached.items())
