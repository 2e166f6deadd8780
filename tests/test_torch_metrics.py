"""The port's quality metrics against the JAX package, on the CPU:

* BLEU and self-BLEU (``metrics/bleu.py``, the port's own copy): scores
  equal to the JAX package's on the same seeded corpora and the same
  ``random`` seed, both subset-drawing paths, portion 1 and 0.5; the
  precomputed reference profile equal to the naive sentence BLEU;
* ``generate_tokens_gumbel``: ids identical to JAX's on the same uniforms
  (fp32, cache_kv), on rings that wrap and that do not, lengths that are
  and are not multiples of the chunk, on K3's plain version (up to 32
  lanes: once against the Pallas kernel in interpret mode) and on the
  plain chunked decode (33 lanes);
* the port's linear SVM against ``sklearn.svm.LinearSVC(dual=False)``
  (skipped without scikit-learn; the port imports none): decision values
  within 1e-3 of their largest, accuracy equal, on separable and
  overlapping sets; the scaler against ``StandardScaler``;
* the classifier metric's features within 1e-5 and its accuracy, and
  ``bert_score`` within 1e-5, against the JAX package's on the same tiny
  BERT checkpoint (a JAX MLM checkpoint and its conversion);
* the Trainer's evaluation with BLEU, self-BLEU and the classifier on:
  finite scores on the log line, self-BLEU below 1, two draws that differ,
  and the wave width (the widest that divides the count and is at most
  ``gen_batch_size``, that width included)."""

import math
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from chip_smoke import write_random_corpus
from transformer_gan_torch import convert
from transformer_gan_torch.config import PACKAGED_VOCAB
from transformer_gan_torch.infer import sample as tsample
from transformer_gan_torch.metrics import bert_score as tscore
from transformer_gan_torch.metrics import bleu as tbleu
from transformer_gan_torch.metrics import classifier as tclf
from transformer_gan_torch.models import xl as txl
from transformer_gan_torch.train import loop as tloop
from transformer_gan_tpu.infer import sample as jsample
from transformer_gan_tpu.metrics import bleu as jbleu
from transformer_gan_tpu.models import xl as jxl
from transformer_gan_tpu.ops import pallas_generate as pgen

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 310


def _corpus(seed: int, n: int, lo: int, hi: int, vocab: int = 12):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, 2 + vocab, rng.randint(lo, hi)).tolist()
            for _ in range(n)]


@pytest.mark.parametrize("is_fast,portion", [(True, 1), (False, 1),
                                             (True, 0.5), (False, 0.5)])
def test_bleu_and_self_bleu_match_jax(is_fast, portion):
    hyps, refs = _corpus(0, 25, 20, 60), _corpus(1, 30, 15, 70)
    hyps2 = _corpus(2, 40, 20, 60)
    for name, gram, test, real in (("BLEU", [2, 3, 4, 5], hyps, refs),
                                   ("Self-BLEU", [2, 3, 4], hyps2, hyps)):
        scores = []
        for mod in (jbleu, tbleu):
            m = mod.BLEU(name, test_text=test, real_text=real, gram=gram,
                         portion=portion, if_use=True)
            random.seed(7)
            scores.append((m.get_score(is_fast=is_fast),
                           m.get_score(is_fast=is_fast, given_gram=3)))
        assert scores[0] == scores[1], name
        assert all(0.0 < s < 1.0 for s in scores[1][0])
    assert tbleu.BLEU("x", if_use=False).get_score() == 0


def test_bleu_profile_equals_naive_sentence_bleu():
    hyps, refs = _corpus(3, 10, 5, 40), _corpus(4, 12, 5, 40)
    profile = tbleu._RefProfile(refs, 5)
    for n in (2, 3, 4, 5):
        w = tuple(1.0 / n for _ in range(n))
        for h in hyps:
            assert profile.sentence_bleu(h, w) == tbleu.sentence_bleu(refs,
                                                                      h, w)


# ---------------------------------------------------------------------------
# generate_tokens_gumbel
# ---------------------------------------------------------------------------

BASE = dict(n_layer=2, n_head=2, d_model=16, d_inner=32, n_token=V,
            dropout=0.0, dropatt=0.0)


def _jax_gumbel(key, length: int, bsz: int) -> np.ndarray:
    """The JAX function's noise from ``key``: per step [1, bsz, V]
    uniforms turned into -log(-log(u + 1e-20) + 1e-20)."""
    def g_of(r):
        u = jax.random.uniform(r, (1, bsz, V), dtype=jnp.float32)[0]
        return -jnp.log(-jnp.log(u + 1e-20) + 1e-20)
    return np.array(jax.vmap(g_of)(jax.random.split(key, length)))


@pytest.mark.parametrize("M,seq_len,bsz,pallas", [
    (16, 33, 2, False),    # 32 tokens, two 16-token chunks, the ring wraps
    (16, 42, 3, False),    # 41: a 9-token last chunk
    (64, 64, 2, False),    # 63 = 32 + 31 on a ring that never fills
    (8, 21, 33, False),    # 33 lanes: sub-waves of 32 and 1
    (128, 41, 2, True),    # 40 = 32 + 8, JAX on the Pallas kernel
])
def test_generate_tokens_gumbel_matches_jax(M, seq_len, bsz, pallas,
                                            monkeypatch):
    if pallas:
        monkeypatch.setattr(pgen, "INTERPRET", True)
    jcfg = jxl.XLConfig(cache_kv=True, use_pallas=pallas, **BASE)
    tcfg = txl.XLConfig(cache_kv=True, **BASE)
    jp = jxl.init_xl_params(jcfg, seed=0, base_init=("normal", 0.3))
    key = jax.random.PRNGKey(seq_len)
    first = np.zeros((bsz,), np.int32)
    ref = jsample.generate_tokens_gumbel(
        jp, jcfg, 1.0, seq_len, jnp.asarray(first), jxl.init_mems(jcfg, M, bsz),
        key)
    got = tsample.generate_tokens_gumbel(
        convert.params_from_jax(jp), tcfg, seq_len,
        torch.from_numpy(first).long(), txl.init_mems(tcfg, M, bsz),
        torch.from_numpy(_jax_gumbel(key, seq_len - 1, bsz)))
    assert got.shape == (seq_len, bsz)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert len(np.unique(got.numpy())) > 20      # not a constant argmax


def test_gumbel_draws_are_seeded_and_finite():
    a = tsample.gumbel_draws(5, 3, V, torch.Generator().manual_seed(1))
    b = tsample.gumbel_draws(5, 3, V, torch.Generator().manual_seed(1))
    c = tsample.gumbel_draws(5, 3, V, torch.Generator().manual_seed(2))
    assert a.shape == (5, 3, V) and torch.equal(a, b)
    assert not torch.equal(a, c) and torch.isfinite(a).all()


# ---------------------------------------------------------------------------
# The linear SVM and the scaler
# ---------------------------------------------------------------------------

def _svm_data(separable: bool, seed: int = 0):
    """(X, y, Xe, ye): 300 training and 300 held-out rows of 12 features
    on their own scales and offsets, one of them constant and one carrying
    the label, 8 sigma apart (separable) or 1 (overlapping)."""
    rng = np.random.RandomState(seed)
    n, d = 600, 12
    y = rng.randint(0, 2, n)
    X = rng.randn(n, d) * rng.uniform(0.5, 3.0, d) + rng.randn(d) * 2
    X[:, 0] = rng.randn(n) + (4.0 if separable else 0.5) * (2 * y - 1)
    X[:, 3] = 4.25                     # a constant column
    X = X.astype(np.float32)
    return X[:300], y[:300], X[300:], y[300:]


@pytest.mark.parametrize("separable", [True, False])
def test_linear_svc_matches_sklearn(separable):
    pytest.importorskip("sklearn")
    from sklearn import svm
    from sklearn.preprocessing import StandardScaler
    X, y, Xe, ye = _svm_data(separable)
    Xs, Xes = tclf.standard_scale(X, Xe)
    scaler = StandardScaler().fit(X)
    np.testing.assert_allclose(Xs, scaler.transform(X), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(Xes, scaler.transform(Xe), rtol=1e-5,
                               atol=1e-5)
    # the JAX metric's LinearSVC stops at liblinear's tol 1e-4 (1.1e-3 of
    # the largest decision value from the optimum on the separable set);
    # the port solves to the optimum: its objective is no higher, and the
    # same LinearSVC run to tol 1e-8 is the reference of the decision
    # values
    ref = svm.LinearSVC(max_iter=10000, dual=False).fit(Xs, y)
    exact = svm.LinearSVC(max_iter=10000, dual=False, tol=1e-8).fit(Xs, y)
    w, b = tclf.fit_linear_svc(Xs, y)
    d_ref = exact.decision_function(Xes)
    d_got = Xes @ w + b
    assert np.abs(d_got - d_ref).max() <= 1e-3 * np.abs(d_ref).max()
    s = 2 * y - 1

    def objective(w, b):
        m = np.maximum(0.0, 1.0 - s * (Xs @ w + b))
        return 0.5 * (w @ w + b * b) + m @ m

    assert objective(w, b) <= objective(ref.coef_[0], ref.intercept_[0])
    acc = np.mean((d_got > 0).astype(int) == ye)
    assert acc == np.mean(ref.predict(Xes) == ye)
    assert acc == np.mean(exact.predict(Xes) == ye)
    assert (acc == 1.0) if separable else (0.55 < acc < 0.9)


# ---------------------------------------------------------------------------
# The classifier metric and bert_score on one tiny BERT checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bert_ckpts(tmp_path_factory):
    """(JAX MLM checkpoint directory, the port's conversion of it)."""
    from test_torch_params import write_archive
    from transformer_gan_tpu.bert import mlm as jmlm
    tmp = tmp_path_factory.mktemp("bert")
    data = str(tmp / "data")
    write_random_corpus(data, PACKAGED_VOCAB, n_train=4, train_len=60,
                        n_eval=2, eval_len=30, seed=1)
    jt = jmlm.MlmTrainer(data, str(tmp / "jax"), PACKAGED_VOCAB,
                         num_hidden_layers=2, hidden_size=24, block_size=16,
                         batch_size=4, max_steps=1, seed=3)
    jt.step = 2
    jt.save()
    jdir = str(tmp / "jax" / "checkpoint-2")
    tdir = convert.import_bert_archive(write_archive(jdir),
                                       str(tmp / "port" / "checkpoint-2"))
    return jdir, tdir


def _texts(seed: int, n: int, lo: int, hi: int, length: int = 40):
    rng = np.random.RandomState(seed)
    return [rng.randint(lo, hi, length) for _ in range(n)]


def test_classifier_metric_matches_jax(bert_ckpts):
    from transformer_gan_tpu.metrics import classifier as jclf
    jdir, tdir = bert_ckpts
    real, gen = _texts(0, 30, 2, 5), _texts(1, 30, 200, 300)
    kw = dict(if_use=True, seq_len=8, batch_size=7)
    jm = jclf.Classifier("c", model_name_or_path=jdir, **kw)
    tm = tclf.Classifier("c", model_name_or_path=tdir, device="cpu", **kw)
    for m in (jm, tm):
        m.reset(test_text=gen, real_text=real)
    jm._load_model()
    tm._load_model()
    assert not tm.load_failed and tm.cfg.hidden_size == 24
    blocks = [b for t in real[:3] + gen[:3] for b in tm._blocks([t], 0)[0]]
    np.testing.assert_allclose(tm.features(blocks), jm._features(blocks),
                               rtol=1e-5, atol=1e-5)
    acc = tm.get_score()
    assert acc == pytest.approx(jm.get_score(), abs=1e-12)
    assert acc > 0.9 and set(tm.last_timing) >= {"features_s", "svm_s"}
    missing = tclf.Classifier("c", model_name_or_path=tdir + "_missing",
                              device="cpu", **kw)
    missing.reset(test_text=gen, real_text=real)
    assert missing.get_score() == -1.0


def test_bert_score_matches_jax(bert_ckpts, tmp_path, capsys):
    from transformer_gan_tpu.metrics import bert_score as jscore
    jdir, tdir = bert_ckpts
    rng = np.random.RandomState(3)
    np.save(tmp_path / "a.npy", rng.randint(2, V, 530).astype(np.int32))
    np.save(tmp_path / "b.npy", rng.randint(2, V, 300).astype(np.int32))
    assert len(tscore.sent_encode(str(tmp_path / "a.npy"))) == 1
    assert tscore.sent_encode(str(tmp_path / "b.npy")) == []
    ref = jscore.run_score(jdir, str(tmp_path))
    got = tscore.main(["--model_path", tdir, "--input_dir", str(tmp_path),
                       "--device", "cpu"])
    assert math.isfinite(got) and got < 0
    assert got == pytest.approx(ref, rel=1e-5, abs=1e-5)
    assert "mean pseudo-log-likelihood over 1 files" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        tscore.run_score(str(tmp_path / "none"), str(tmp_path), device="cpu")


def test_load_bert_model_sizes_and_fills_from_the_checkpoint(bert_ckpts):
    """The one rule both metrics and the critic size a BERT by: the
    checkpoint's metadata, every leaf from the checkpoint; no checkpoint
    raises OSError."""
    from transformer_gan_torch.train import checkpoint as tckpt
    _, tdir = bert_ckpts
    cfg, params = tckpt.load_bert_model(tdir, "cpu")
    sizes = tckpt.bert_sizes(tdir)
    assert sizes["hidden_size"] == cfg.hidden_size == 24
    assert sizes["num_hidden_layers"] == cfg.num_hidden_layers == 2
    saved = tckpt.load_bert_params(tdir)
    assert set(saved) == set(params)
    assert all(torch.equal(params[k], saved[k]) for k in saved)
    with pytest.raises(OSError):
        tckpt.load_bert_model(tdir + "_missing", "cpu")


# ---------------------------------------------------------------------------
# The Trainer's evaluation
# ---------------------------------------------------------------------------

def test_wave_width_takes_the_widest_that_divides():
    assert tloop.wave_width(640, 128) == 32
    assert tloop.wave_width(2560, 128) == 32
    assert tloop.wave_width(12, 4) == 4       # gen_batch_size itself
    assert tloop.wave_width(6, 4) == 2
    assert tloop.wave_width(48, 16) == 16
    assert tloop.wave_width(7, 128) == 1


def test_trainer_eval_with_all_metrics(tmp_path, bert_ckpts):
    """The training CLI with BLEU, self-BLEU and the classifier on, at a
    tiny size: the eval line carries three finite scores, self-BLEU below
    1, and the generated pieces of two calls differ."""
    from transformer_gan_torch.cli import train as tcli
    data = str(tmp_path / "data")
    write_random_corpus(data, PACKAGED_VOCAB, n_train=12, train_len=60,
                        n_eval=4, eval_len=64, seed=0)
    with open(os.path.join(ROOT, "training_config",
                           "experiment_baseline.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["MODEL"].update(num_layers=2, num_heads=2, units=16, inner_size=32)
    cfg["TRAIN"].update(batch_size=4, batch_chunk=2, max_step=2,
                        log_interval=1, eval_interval=2, mem_length=8,
                        tgt_length=8, warmup_step=1)
    cfg["EVALUATE"].update(batch_size=2, mem_length=8, tgt_length=8)
    cfg["METRICS"] = {"use_bleu": True, "use_self_bleu": True,
                      "gen_seq_len": 24, "gen_batch_size": 4,
                      "bleu_num_samples": 4, "self_bleu_num_samples": 8,
                      "CLASSIFIER": {"use_classifier": True,
                                     "gen_batch_size": 4, "gen_seq_len": 24,
                                     "gen_num_samples": 8, "block_size": 8,
                                     "bert_batch_size": 5,
                                     "model_path": bert_ckpts[1]}}
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(cfg))
    random.seed(0)
    tr = tcli.main(["--data_dir", data, "--cfg", str(path), "--work_dir",
                    str(tmp_path / "w"), "--device", "cpu"])
    with open(os.path.join(tr.work_dir, "train_rank0.log")) as f:
        line = [l for l in f.read().splitlines() if "Eval step" in l][0]
    bleu, self_bleu = (
        [float(x) for x in line.split(f" {k}=[")[1].split("]")[0].split(",")]
        for k in ("bleu", "self_bleu"))
    acc = float(line.split("class_acc=")[1])
    assert len(bleu) == 4 and len(self_bleu) == 3, line
    assert all(0 < s < 1.0 for s in bleu + self_bleu), line
    assert math.isfinite(acc) and 0 <= acc <= 1
    assert set(tr.metrics_timing["test"]) == {"generate_bleu_s", "bleu_s"}
    assert {"generate_bleu_s", "generate_self_bleu_s",
            "generate_classifier_s", "bleu_s", "self_bleu_s",
            "classifier"} == set(tr.metrics_timing["eval"])
    assert tr._gen_wave == 5                 # eval 3, test 1, final test 1
    _, _, scores = tr.evaluate(tr.val_iter, mode="eval")
    assert len(scores) == 3 and tr._gen_wave == 8
    a = tr._generate_tokens(4, 4, 24)
    b = tr._generate_tokens(4, 4, 24)
    assert a.shape == (4, 24) and (a[:, 0] == 0).all()
    assert not np.array_equal(a, b)
    assert len({tuple(r) for r in a}) == 4    # the lanes differ too
