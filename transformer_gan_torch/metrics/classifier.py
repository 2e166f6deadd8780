"""Real-vs-generated discriminability metric.

Counterpart of ``transformer_gan_tpu/metrics/classifier.py`` (reference
model/utils/classifier.py): a pretrained BERT MLM's logits, max-pooled over
each 128-token block, are the block's features; after a standard scaling a
linear SVM learns to tell real from generated blocks, and the metric is its
held-out accuracy (near 0.5: the generator is indistinguishable from the
data). The BERT runs on the device, its weights loaded there once and kept
between evaluations.

The JAX package fits ``sklearn.svm.LinearSVC(dual=False)``. The port solves
the same problem itself, on the host in float64 (:func:`fit_linear_svc`):
liblinear's primal L2-regularized squared hinge with C = 1, the intercept a
constant feature of 1 regularized with the weights (``intercept_scaling``
1), labels mapped to -1 / +1, by Newton's method on the generalized
Hessian. :func:`standard_scale` is ``StandardScaler``'s mean and
population std, constant columns left unscaled.
"""
from __future__ import annotations

import logging
import time

import numpy as np
import torch

from .bleu import Metrics


def standard_scale(X: np.ndarray, Xe: np.ndarray):
    """(X, Xe) centred and scaled by X's mean and population std in
    float64; a column that is constant up to rounding keeps scale 1 (the
    test of sklearn's ``_is_constant_feature``)."""
    X = np.asarray(X, np.float64)
    mean, var = X.mean(0), X.var(0)
    n, eps = X.shape[0], np.finfo(np.float64).eps
    constant = var <= n * eps * var + (n * mean * eps) ** 2
    scale = np.where(constant, 1.0, np.sqrt(var))
    return (X - mean) / scale, (np.asarray(Xe, np.float64) - mean) / scale


def fit_linear_svc(X: np.ndarray, y: np.ndarray, C: float = 1.0,
                   max_iter: int = 100, tol: float = 1e-10):
    """Minimise 0.5 |w|^2 + C sum_i max(0, 1 - s_i (w x_i + b))^2 over
    (w, b), b regularized like w, s_i = +1 for label 1 and -1 otherwise:
    Newton steps on the generalized Hessian I + 2C X_A^T X_A of the active
    rows, each with a backtracking line search, until the gradient is
    ``tol`` of its first norm. Returns (w [d], b) as float64 numpy."""
    Xb = torch.cat([torch.as_tensor(np.asarray(X, np.float64)),
                    torch.ones((len(X), 1), dtype=torch.float64)], dim=1)
    s = torch.where(torch.as_tensor(np.asarray(y)) == 1, 1.0, -1.0).double()
    w = torch.zeros(Xb.shape[1], dtype=torch.float64)
    eye = torch.eye(Xb.shape[1], dtype=torch.float64)

    def objective(v):
        m = torch.clamp(1.0 - s * (Xb @ v), min=0.0)
        return 0.5 * v @ v + C * (m @ m)

    g0 = None
    for _ in range(max_iter):
        m = 1.0 - s * (Xb @ w)
        act = m > 0
        Xa = Xb[act]
        grad = w - 2.0 * C * (Xa.T @ (s[act] * m[act]))
        gnorm = float(grad.norm())
        g0 = gnorm if g0 is None else g0
        if gnorm <= tol * max(g0, 1.0):
            break
        step = torch.linalg.solve(eye + 2.0 * C * (Xa.T @ Xa), -grad)
        f0, slope, t = objective(w), float(grad @ step), 1.0
        while objective(w + t * step) > f0 + 1e-4 * t * slope and t > 1e-10:
            t *= 0.5
        w = w + t * step
    w = w.numpy()
    return w[:-1], float(w[-1])


class Classifier(Metrics):
    """The reference Classifier's interface: ``reset(test_text,
    real_text)``, then ``get_score()`` -> held-out accuracy, -1.0 when the
    BERT checkpoint fails to load. ``device``: where the BERT runs."""

    def __init__(self, name=None, test_text=None, real_text=None,
                 device=None, if_use=False, seq_len=128, batch_size=20,
                 model_name_or_path=""):
        super().__init__(name)
        self.if_use = if_use
        if not if_use:
            return
        self.test_text = test_text
        self.real_text = real_text
        self.device = device
        self.train_size = 5000
        self.eval_size = 1000
        self.batch_size = batch_size
        self.block_size = seq_len
        self.model_name_or_path = model_name_or_path
        self.params = None
        self.load_failed = False
        self.last_timing = {}

    def _load_model(self) -> None:
        """The BERT of the checkpoint (``checkpoint.load_bert_model``), on
        the device."""
        from ..train import checkpoint as ckpt
        try:
            self.cfg, self.params = ckpt.load_bert_model(
                self.model_name_or_path, self.device)
        except (OSError, ValueError, RuntimeError) as e:
            # a mistyped model_path must not yield a plausible accuracy from
            # random features
            self.load_failed = True
            logging.getLogger(__name__).error(
                "Classifier metric: FAILED to load BERT checkpoint %r (%s); "
                "scores will be reported as invalid (-1.0)",
                self.model_name_or_path, e)

    @torch.no_grad()
    def features(self, blocks) -> np.ndarray:
        """[n, vocab] per-block features: the MLM logits' max over each
        block, in batches of ``batch_size``, fetched once."""
        from ..models import bert as bert_mod
        outs = []
        for i in range(0, len(blocks), self.batch_size):
            batch = torch.from_numpy(np.stack(
                blocks[i:i + self.batch_size]).astype(np.int64)).to(self.device)
            hidden = bert_mod.bert_encode(self.params, self.cfg,
                                          input_ids=batch)
            logits = bert_mod.bert_mlm_logits(self.params, self.cfg, hidden)
            outs.append(logits.amax(dim=1))
        return torch.cat(outs).float().cpu().numpy()

    def _blocks(self, texts, label):
        xs, ys = [], []
        for seq in texts:
            seq = np.asarray(seq)
            for i in range(0, len(seq) - self.block_size + 1,
                           self.block_size):
                xs.append(seq[i:i + self.block_size])
                ys.append(label)
        return xs, ys

    def reset(self, test_text=None, real_text=None):
        if test_text is not None:
            self.test_text = [np.asarray(t) for t in test_text]
        if real_text is not None:
            self.real_text = [np.asarray(t) for t in real_text]

    def get_score(self):
        if not self.if_use:
            return 0
        timing, pc = {}, time.perf_counter
        if self.params is None and not self.load_failed:
            t0 = pc()
            self._load_model()
            timing["load_model_s"] = pc() - t0
        if self.load_failed:
            return -1.0

        t0 = pc()
        real_x, real_y = self._blocks(self.real_text, 0)
        gen_x, gen_y = self._blocks(self.test_text, 1)

        def split(xs, ys):
            k = int(0.8 * len(xs))
            return (xs[:k], ys[:k]), (xs[k:], ys[k:])

        (rtr, rtry), (rev, revy) = split(real_x, real_y)
        (gtr, gtry), (gev, gevy) = split(gen_x, gen_y)
        train_x = rtr[:self.train_size] + gtr[:self.train_size]
        train_y = rtry[:self.train_size] + gtry[:self.train_size]
        eval_x = rev[:self.eval_size] + gev[:self.eval_size]
        eval_y = revy[:self.eval_size] + gevy[:self.eval_size]
        timing["blocks_s"] = pc() - t0
        if not train_x or not eval_x:
            return 0.0

        t0 = pc()
        X, Xe = self.features(train_x), self.features(eval_x)
        timing["features_s"] = pc() - t0
        timing["n_blocks"] = len(train_x) + len(eval_x)

        t0 = pc()
        Xs, Xes = standard_scale(X, Xe)
        w, b = fit_linear_svc(Xs, np.asarray(train_y))
        pred = (Xes @ w + b > 0).astype(int)       # LinearSVC's predict
        acc = float(np.mean(pred == np.asarray(eval_y)))
        timing["svm_s"] = pc() - t0
        self.last_timing = timing
        logging.getLogger(__name__).info("classifier timing: %s", timing)
        return acc
