"""Note-status inputs (``TRAIN.append_note_status``: held-note bit-vectors
added to the embedding through ``status_emb``) in the port against the JAX
package, fp32 on the CPU at a tiny width:

* ``notes_mapping`` and ``update_status_vec`` bit for bit;
* the train and eval iterators' ``status_vec`` bit for bit;
* ``forward_nll`` with status vectors: loss and every gradient
  (``status_emb`` included) on the plain route and on the fused v2 route
  (its autograd Function, plain on the CPU, against JAX's Pallas kernel in
  interpret mode), and with the raw-hidden memory;
* a 4-step MLE trajectory with status vectors (cached and raw memory)
  against JAX ``make_mle_train_step``;
* the training CLI on a note-status run, then ``cli.generate`` from its
  run directory (unconditional, and conditional with the debug check), on
  the K/V cache and on the raw-hidden memory;
* the MLE step on 2 gloo ranks (raw memory, status vectors split by rows)
  against one process on the global batch.

Tolerances as tests/test_torch_train.py: loss rtol 1e-5, gradients rtol
5e-4 / atol 1e-6, trajectory parameters and memories atol 2e-5, grad norm
rtol 5e-4; status vectors exactly. JAX is imported inside the tests: the
rank processes import this module to find their function."""

import itertools
import os

import numpy as np
import pytest
import torch
import yaml

from chip_smoke import write_random_corpus
from transformer_gan_torch import convert
from transformer_gan_torch.cli import generate as gcli
from transformer_gan_torch.cli import train as tcli
from transformer_gan_torch.config import (PACKAGED_VOCAB, inference_config,
                                          training_config)
from transformer_gan_torch.data.dataset import MusicDataset
from transformer_gan_torch.data.vocab import BaseVocab
from transformer_gan_torch.models import xl as txl
from transformer_gan_torch.parallel import mesh as pmesh
from transformer_gan_torch.parallel import sharding as psh
from transformer_gan_torch.train import optim as topt
from transformer_gan_torch.train import step as tstep

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 310
BASE = dict(n_layer=2, n_head=2, d_model=16, d_inner=32, n_token=V,
            dropout=0.0, dropatt=0.0, append_note_status=True)


def _vec_len() -> int:
    v = BaseVocab.from_file(PACKAGED_VOCAB)
    v.notes_mapping()
    return v.vec_len


def _models(cache_kv=True, pallas=False):
    from transformer_gan_tpu.models import xl as jxl
    kw = dict(BASE, vec_len=_vec_len())
    jcfg = jxl.XLConfig(cache_kv=cache_kv, use_pallas=pallas, **kw)
    tcfg = txl.XLConfig(cache_kv=cache_kv, **kw)
    jp = jxl.init_xl_params(jcfg, seed=0, base_init=("normal", 0.1))
    assert jp["status_emb"].shape == (kw["vec_len"], 16)
    return jcfg, tcfg, jp


def _status(rng, tgt, bsz):
    return rng.rand(tgt, bsz, _vec_len()) < 0.2


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    write_random_corpus(str(d), PACKAGED_VOCAB, n_train=12, train_len=60,
                        n_eval=5, eval_len=40, seed=4)
    return str(d)


# ---------------------------------------------------------------------------
# Vocab and iterators
# ---------------------------------------------------------------------------

def test_notes_mapping_and_update_status_vec_match_jax():
    from transformer_gan_tpu.data.vocab import BaseVocab as JaxVocab
    j, t = JaxVocab.from_file(PACKAGED_VOCAB), BaseVocab.from_file(PACKAGED_VOCAB)
    assert t.vec_len == 0
    j.notes_mapping()
    t.notes_mapping()
    assert t.vec_len == j.vec_len == 88
    assert t.note_on_dic == j.note_on_dic and t.note_off_dic == j.note_off_dic
    rng = np.random.RandomState(0)
    note_ids = list(t.note_on_dic) + list(t.note_off_dic)
    data = rng.choice(note_ids + [101, 250], (40, 5))
    init = rng.rand(40, 5, 88) < 0.1
    a, b = init.copy(), init.copy()
    j.update_status_vec(data, a)
    t.update_status_vec(data, b)
    np.testing.assert_array_equal(a, b)
    assert a.any() and (a != init).any()


def _cfgs():
    from transformer_gan_tpu.config import get_default_cfg_training
    jcfg = get_default_cfg_training()
    jcfg.defrost()
    jcfg.TRAIN.append_note_status = True
    jcfg.TRAIN.mem_length = 8
    jcfg.freeze()
    tcfg = training_config()
    tcfg.TRAIN.append_note_status = True
    tcfg.TRAIN.mem_length = 8
    return jcfg, tcfg


def _same(a_iter, b_iter, n):
    count = 0
    for a, b in itertools.islice(zip(a_iter, b_iter), n):
        assert len(a) == len(b) == 5
        for x, y in zip(a, b):
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y
        count += 1
    return count


def test_iterators_status_vec_match_jax(corpus):
    """40 train batches (several epochs, reset rows clear their status) and
    every eval window of both splits: the status vectors bit for bit."""
    from transformer_gan_tpu.data.dataset import MusicDataset as JaxDataset
    jcfg, tcfg = _cfgs()
    jd, td = JaxDataset(corpus, jcfg), MusicDataset(corpus, tcfg)
    assert td.vocab.vec_len == jd.vocab.vec_len == 88
    first = next(td.get_iterator(4, 7, seed=11)())
    assert first[4].shape == (7, 4, 88) and first[4].dtype == bool
    assert _same(jd.get_iterator(4, 7, seed=11)(),
                 td.get_iterator(4, 7, seed=11)(), 40) == 40
    for split in ("valid", "test"):
        n = _same(jd.eval_iterator(2, 6, split=split)(),
                  td.eval_iterator(2, 6, split=split)(), 1000)
        assert n == len(list(td.eval_iterator(2, 6, split=split)()))


# ---------------------------------------------------------------------------
# forward_nll and the MLE step
# ---------------------------------------------------------------------------

@pytest.fixture
def interpret(monkeypatch):
    from transformer_gan_tpu.ops import pallas_attention_v2 as pa2
    monkeypatch.setattr(pa2, "INTERPRET", True)
    monkeypatch.setattr(pa2, "_FAST_BF16_SHIFT", [False])


@pytest.mark.parametrize("route,cache_kv", [("plain", True), ("v2", True),
                                            (None, False)])
def test_forward_nll_with_status_matches_jax(interpret, route, cache_kv):
    """Three 16-token windows into a 24-slot ring with a reset row: the NLL,
    every gradient (status_emb's included) and the memories."""
    import jax
    import jax.numpy as jnp
    from transformer_gan_tpu.models import xl as jxl
    jcfg, tcfg, jp = _models(cache_kv, pallas=route == "v2")
    bsz, qlen, M = 2, 16, 24
    rng = np.random.RandomState(3)
    jm, tm = jxl.init_mems(jcfg, M, bsz), txl.init_mems(tcfg, M, bsz)
    for step in range(3):
        data, target = (rng.randint(0, V, (qlen, bsz)) for _ in "dt")
        reset = np.array([False, step == 1])
        sv = _status(rng, qlen, bsz)

        def loss_j(p):
            nll, new = jxl.forward_nll(p, jcfg, jnp.asarray(data),
                                       jnp.asarray(target), jnp.asarray(reset),
                                       jm, jnp.asarray(sv))
            return nll.mean(), (nll, new)

        (_, (jnll, jnew)), jg = jax.value_and_grad(loss_j, has_aux=True)(jp)
        tp = {k: v.requires_grad_() for k, v in
              convert.params_from_jax(jp).items()}
        tnll, tnew = txl.forward_nll(tp, tcfg, torch.from_numpy(data),
                                     torch.from_numpy(target),
                                     torch.from_numpy(reset), tm,
                                     status_vec=torch.from_numpy(sv),
                                     route=route)
        tnll.mean().backward()
        np.testing.assert_allclose(tnll.detach().numpy(), np.asarray(jnll),
                                   rtol=1e-5, atol=1e-6)
        ref = convert.params_from_jax(jg)
        assert float(tp["status_emb"].grad.abs().max()) > 0
        for k, v in tp.items():
            np.testing.assert_allclose(v.grad.numpy(), ref[k].numpy(),
                                       rtol=5e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(tnew.hids.numpy(), np.asarray(jnew.hids),
                                   rtol=1e-5, atol=1e-6)
        jm, tm = jnew, tnew


@pytest.mark.parametrize("cache_kv", [True, False])
def test_four_step_trajectory_with_status_matches_jax(cache_kv):
    """Four MLE steps, batch_chunk 2, status vectors split by micro-batch
    as the tokens: losses, token counts, grad norms, parameters and
    memories against JAX make_mle_train_step."""
    import jax.numpy as jnp
    from transformer_gan_tpu.train import optim as jopt
    from transformer_gan_tpu.train import step as jstep
    jcfg, tcfg, jp = _models(cache_kv)
    C, tgt, bsz, mem = 2, 8, 4, 12
    jo = jopt.make_optimizer("adam", 2e-3, jopt.make_schedule(
        "inv_sqrt", 2e-3, 100, 1e-4, 2), 0.25)
    jstate = jstep.init_train_state(jp, jo, jcfg, C, mem, bsz // C, 1111)
    jfn = jstep.make_mle_train_step(jcfg, jo, C, pad_id=1, donate=False)
    tp = convert.params_from_jax(jp)
    to = topt.FusedOptimizer(
        "adam", 2e-3, topt.make_schedule("inv_sqrt", 2e-3, 100, 1e-4, 2),
        0.25, layout=topt.FlatLayout.of(tp))
    tstate = tstep.init_train_state(tp, to, tcfg, C, mem, bsz // C, 1111)
    tfn = tstep.make_mle_train_step(tcfg, to, C, pad_id=1)
    rng = np.random.RandomState(5)
    for k in range(4):
        data, target = (rng.randint(2, V, (tgt, bsz)) for _ in "dt")
        target[-3:, k % bsz] = 1
        reset = rng.rand(bsz) < 0.3
        sv = _status(rng, tgt, bsz)
        args = (tstep.chunk_batch(data, C), tstep.chunk_batch(target, C),
                tstep.chunk_rows(reset, C), tstep.chunk_status(sv, C))
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


def test_chunk_status_splits_rows_as_the_tokens():
    x = np.arange(3 * 4 * 2).reshape(3, 4, 2)
    got = tstep.chunk_status(x, 2)
    tok = tstep.chunk_batch(x[..., 0], 2)
    assert got.shape == (2, 3, 2, 2)
    np.testing.assert_array_equal(got[..., 0], tok)


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

def _cfg_file(tmp_path, **tpu):
    with open(os.path.join(ROOT, "training_config",
                           "experiment_baseline.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["MODEL"].update(num_layers=2, num_heads=2, units=16, inner_size=32)
    cfg["TRAIN"].update(batch_size=4, batch_chunk=2, max_step=4,
                        log_interval=2, eval_interval=2, mem_length=12,
                        tgt_length=8, warmup_step=2, append_note_status=True)
    cfg["EVALUATE"].update(batch_size=2, mem_length=16, tgt_length=8)
    cfg["TPU"].update(tpu)
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.mark.parametrize("cache_kv", [True, False])
def test_cli_trains_and_generates_with_note_status(tmp_path, corpus,
                                                   cache_kv):
    """cli.train on a note-status config (an eval, checkpoints), then
    cli.generate from the run directory: unconditional, and conditional
    with the debug check (incremental == batch memory, the prime NLL); on
    the K/V cache and on the raw-hidden memory."""
    trainer = tcli.main(["--data_dir", corpus, "--cfg",
                         _cfg_file(tmp_path, cache_kv=cache_kv),
                         "--work_dir", str(tmp_path / "w"), "--device", "cpu"])
    assert trainer.state.mems[0].hids.dim() == (6 if cache_kv else 4)
    assert trainer.train_step_num == 4 and trainer.xcfg.vec_len == 88
    params = convert.load_params(os.path.join(trainer.work_dir,
                                              "checkpoint_last.pt"))
    assert params["status_emb"].shape == (88, 16)
    with open(os.path.join(trainer.work_dir, "train_rank0.log")) as f:
        assert "Eval step 4" in f.read()
    prefix = np.load(os.path.join(corpus, "valid", sorted(os.listdir(
        os.path.join(corpus, "valid")))[0]))
    np.save(tmp_path / "prefix.npy", prefix)
    for conditional in (False, True):
        icfg = inference_config()
        icfg.MODEL.model_directory = trainer.work_dir
        icfg.MODEL.checkpoint_name = "checkpoint_last"
        icfg.MODEL.memory_length = 16
        icfg.OUTPUT.output_txt_directory = str(tmp_path / f"gen{conditional}")
        icfg.GENERATION.generation_length = 10
        icfg.INPUT.num_midi_files = 2
        if conditional:
            icfg.MODEL.debug = True
            icfg.INPUT.conditional_input_melody = str(tmp_path / "prefix.npy")
            icfg.INPUT.num_conditional_tokens = 6
        summary = gcli.main(icfg, "cpu", torch.Generator().manual_seed(0))
        assert len(summary["files"]) == 2 and summary["tokens"] == 20


# ---------------------------------------------------------------------------
# Two gloo ranks
# ---------------------------------------------------------------------------

def _mle_status_rank(mesh, params, batches, lr, world):
    """Two MLE steps on raw memory with status vectors: the rank's rows of
    each global batch (one process: all of them, with the ranks' lr)."""
    C = 2
    tcfg = txl.XLConfig(cache_kv=False, **dict(BASE, vec_len=_vec_len()))
    opt = topt.FusedOptimizer(
        "adam", lr / world, topt.make_schedule("inv_sqrt", lr, 100, 1e-4, 2),
        0.25, layout=topt.FlatLayout.of(params))
    bsz = batches[0][0].shape[1] // mesh.world
    state = tstep.init_train_state(params, opt, tcfg, C, 12, bsz // C, 1111)
    fn = tstep.make_mle_train_step(tcfg, opt, C, pad_id=1)
    out = []
    for data, target, reset, sv in batches:
        d, t, s = (psh.batch_rows(x, C) for x in (data, target, sv))
        r = psh.batch_rows(reset, C, axis=0)
        args = (tstep.chunk_batch(d, C), tstep.chunk_batch(t, C),
                tstep.chunk_rows(r, C), tstep.chunk_status(s, C))
        state, met = fn(state, *map(torch.from_numpy, args))
        out.append({"metrics": {k: float(v) for k, v in met.items()},
                    "flat": state.flat.detach().clone(),
                    "mems": [m.hids.clone() for m in state.mems]})
    return out


def test_mle_step_with_status_on_two_ranks_matches_one_process():
    from transformer_gan_tpu.models import xl as jxl
    world, bsz, lr = 2, 8, 2e-3
    jp = jxl.init_xl_params(jxl.XLConfig(**dict(BASE, vec_len=_vec_len())),
                            seed=0, base_init=("normal", 0.1))
    params = convert.params_from_jax(jp)
    rng = np.random.RandomState(5)
    batches = []
    for _ in range(2):
        data, target = (rng.randint(2, V, (8, bsz)) for _ in "dt")
        target[-3:, 0] = 1
        batches.append((data, target, rng.rand(bsz) < 0.3,
                        _status(rng, 8, bsz)))
    ranks = pmesh.spawn(_mle_status_rank, world, params, batches, lr, world)
    one = _mle_status_rank(pmesh.current(), params, batches, lr, world)
    for k in range(2):
        mets = [r[k]["metrics"] for r in ranks]
        np.testing.assert_allclose(sum(m["loss_weighted"] for m in mets),
                                   one[k]["metrics"]["loss_weighted"],
                                   rtol=1e-5)
        assert sum(m["tokens"] for m in mets) == one[k]["metrics"]["tokens"]
        for m in mets:
            np.testing.assert_allclose(m["grad_norm"],
                                       one[k]["metrics"]["grad_norm"],
                                       rtol=5e-4)
        assert torch.equal(ranks[0][k]["flat"], ranks[1][k]["flat"])
        np.testing.assert_allclose(ranks[0][k]["flat"].numpy(),
                                   one[k]["flat"].numpy(), rtol=0, atol=2e-5)
        for r, res in enumerate(ranks):
            for c in range(2):
                want = psh.rank_rows(one[k]["mems"][c], r, world, axis=2)
                np.testing.assert_allclose(res[k]["mems"][c].numpy(),
                                           want.numpy(), rtol=0, atol=2e-5)


def test_jax_note_status_checkpoint_converts_with_equal_logits(tmp_path):
    """A JAX checkpoint of a note-status model (``status_emb`` included)
    through its numpy archive into the port's parameter file: the same
    logits with status vectors (rtol 1e-5 / atol 1e-6), and back into the
    JAX tree bit for bit."""
    import jax.numpy as jnp

    from test_torch_params import write_archive
    from transformer_gan_tpu.models import xl as jxl
    from transformer_gan_tpu.train import checkpoint as jck
    jcfg, tcfg, jp = _models()
    jck.save_checkpoint(str(tmp_path), "checkpoint_last", {"params": jp})
    arrays = convert.read_archive(write_archive(str(tmp_path
                                                    / "checkpoint_last")))
    convert.save_params(str(tmp_path / "port.pt"),
                        convert.tensors_from_archive(arrays))
    tp = convert.load_params(str(tmp_path / "port.pt"))
    assert tp["status_emb"].shape == (88, 16)
    rng = np.random.RandomState(8)
    data, sv = rng.randint(0, V, (9, 2)), _status(rng, 9, 2)
    jl, _ = jxl.forward_generate(jp, jcfg, jnp.asarray(data),
                                 jxl.init_mems(jcfg, 8, 2), jnp.asarray(sv))
    tl, _ = txl.forward_generate(tp, tcfg, torch.from_numpy(data),
                                 txl.init_mems(tcfg, 8, 2),
                                 status_vec=torch.from_numpy(sv))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-6)
    back = convert.params_to_jax(tp)
    np.testing.assert_array_equal(back["status_emb"],
                                  np.asarray(jp["status_emb"]))
