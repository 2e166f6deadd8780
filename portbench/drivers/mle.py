"""MLE training traffic: the program's ``Trainer.train`` on its own data
iterator, one card's rows a step.

Set-up builds one ``Trainer``, puts the benchmark's weights in it and drives
it through ``followed_steps`` steps, all through ``Trainer.train`` and the
feed the window uses; the window then runs ``Trainer.train`` on the same
object until ``--seconds`` have passed. The followed steps fill every row's
memory and run on at the window's state: all slots valid, far relative
distances, a row whose piece ends resetting its memory. The check follows
every one of them in the reference from the same weights and batches: each
step's loss, the clipped gradient of the first and of the last step (from
Adam's first moment: after one step over 1 - beta1, and between the last
two steps) and the weights' change over all of them, by leaf.

Traffic keys: ``followed_steps``, ``check_block_rows`` (rows of a reference
block), optionally ``corpus`` (sizes merged into the configuration's).
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import work
from ..reference import compare, precision
from ..reference import train as ref_train
from . import common


class Feed:
    """The iterator handed to the ``Trainer``: the program's own train
    iterator, cut at a step count or a host deadline, with a host span
    around each batch the program's iterator makes."""

    def __init__(self, make_iter):
        self.it = make_iter()
        self.steps = None
        self.deadline = None
        self.batches = []     # (data, target, reset) of every step fed
        self.data_s = []      # host seconds of each batch

    def limit(self, steps=None, deadline=None):
        self.steps, self.deadline = steps, deadline

    def __call__(self):
        n = 0
        while True:
            if self.steps is not None and n >= self.steps:
                return
            if self.deadline is not None and time.perf_counter() >= \
                    self.deadline:
                return
            t = time.perf_counter()
            batch = next(self.it)
            self.data_s.append(time.perf_counter() - t)
            self.batches.append(batch[:3])
            n += 1
            yield batch


class Driver:
    def __init__(self, cell, seed, device, tmp, overrides):
        self.cell, self.seed, self.device = cell, seed, device
        self.tmp, self.overrides = tmp, overrides
        self.traffic = cell["traffic_data"]
        self.limits = cell["limits"]
        self.attempted = self.failed = 0

    # -- set-up ------------------------------------------------------------
    def setup(self):
        tr = self.traffic
        self.trainer, self.cfg, self.dims, self.w0 = common.build_trainer(
            self.cell, self.seed, self.device, self.tmp, self.overrides)
        t = self.trainer
        self.feed = Feed(t.train_iter)
        t.train_iter = self.feed
        step_fn = t.train_step_fn
        self.step_metrics = []

        def recorded(state, *batch):
            state, metrics = step_fn(state, *batch)
            self.step_metrics.append(metrics)
            return state, metrics

        t.train_step_fn = recorded
        n = int(tr["followed_steps"])
        b1 = t.optimizer.b1

        def mu():
            return common.leaves(t.state.layout, t.state.opt_state.mu)

        self.feed.limit(steps=1)
        t.train()
        self.prog_grad1 = {k: v / (1.0 - b1) for k, v in mu().items()}
        self.feed.limit(steps=n - 2)
        t.train()
        mu_before = mu()
        self.feed.limit(steps=1)
        t.train()
        self.prog_grad_last = {k: (v - b1 * mu_before[k]) / (1.0 - b1)
                               for k, v in mu().items()}
        self.prog_w = common.leaves(t.state.layout, t.state.flat)
        self.prog_losses = [float(m["loss_weighted"]) / float(m["tokens"])
                            for m in self.step_metrics]
        self.followed = [tuple(np.array(x) for x in b)
                         for b in self.feed.batches[:n]]
        self.step_metrics.clear()
        self.mark = len(self.feed.batches)

    # -- window --------------------------------------------------------------
    def window(self, seconds):
        self.launch0 = common.launches()
        self.feed.limit(deadline=time.perf_counter() + seconds)
        self.trainer.train()
        self.launch1 = common.launches()

    def context(self, trace):
        cfg, d = self.cfg, self.dims
        batches = self.feed.batches[self.mark:]
        spans = self.feed.data_s[self.mark:]
        pad = self.trainer.vocab.pad_id
        self.attempted = len(batches)
        self.failed = sum(not math.isfinite(float(m["loss_weighted"]))
                          for m in self.step_metrics)
        q, M = cfg.TRAIN.tgt_length, cfg.TRAIN.mem_length
        B = cfg.TRAIN.batch_size
        # every row's memory is full from the followed steps on
        flops = sum(work.mle_step_flops(reset, q, M, M, L=d.L, d=d.d, H=d.H,
                                        dh=d.dh, di=d.di, V=d.V)
                    for _, _, reset in batches)
        tokens = sum(int((target != pad).sum()) for _, target, _ in batches)
        return common.context(
            trace=trace, window_s=self.window_s, chips=self.cell["chips"],
            launches={k: self.launch1[k] - self.launch0.get(k, 0)
                      for k in self.launch1},
            flops=flops, tokens=tokens, data_s=spans,
            shapes={"q": q, "B": B // cfg.TRAIN.batch_chunk, "M": M,
                    "H": d.H, "dh": d.dh})

    def full_resets(self) -> list:
        """(step, rows) of each followed step (1-based) that resets rows
        while every slot of the memory is valid."""
        q, M = self.cfg.TRAIN.tgt_length, self.cfg.TRAIN.mem_length
        return [(k + 1, int(r.sum())) for k, (_, _, r) in
                enumerate(self.followed) if k * q >= M and r.any()]

    def release(self):
        self.trainer = None
        self.feed = None
        self.step_metrics = []

    # -- check ---------------------------------------------------------------
    def spec(self):
        cfg, d = self.cfg, self.dims
        return ref_train.MleSpec(
            L=d.L, d=d.d, H=d.H, dh=d.dh, di=d.di, V=d.V,
            M=cfg.TRAIN.mem_length, dropout=cfg.MODEL.dropout,
            dropatt=cfg.MODEL.attention_dropout, run_seed=cfg.TRAIN.seed,
            lr=cfg.TRAIN.lr, warmup=cfg.TRAIN.warmup_step,
            lr_min=cfg.TRAIN.lr_min, clip=cfg.TRAIN.clip, pad_id=1)

    def _reference(self, **kw):
        dev = self.device
        batches = [(torch.from_numpy(x).to(dev).long(),
                    torch.from_numpy(y).to(dev).long(),
                    torch.from_numpy(r).to(dev).bool())
                   for x, y, r in self.followed]
        return ref_train.run_steps(
            self.w0, batches, self.spec(),
            block_rows=int(self.traffic["check_block_rows"]), **kw)

    def readings(self, losses, grad1, grad_last, weights) -> dict:
        ref = self.ref
        moving = compare.moving_leaves(ref["grad1"])
        return {
            "loss": compare.loss_gap(losses, ref["losses"]),
            "grad": compare.leaf_norm_gap(grad1, ref["grad1"]),
            "grad_last": compare.leaf_norm_gap(grad_last, ref["grad_last"]),
            "change": compare.leaf_norm_gap(
                compare.change(weights, self.w0),
                compare.change(ref["weights"], self.w0), moving)}

    def check(self):
        self.ref = self._reference()
        got = self.readings(self.prog_losses, self.prog_grad1,
                            self.prog_grad_last, self.prog_w)
        return [{"name": k, "value": v, "limit": self.limits[k]}
                for k, v in got.items()]

    def calibrate(self):
        """Readings of the control (the reference in fp8 in the program's
        place) and of the planted faults, against the same reference."""
        out = {}
        ctl = self._reference(quant=precision.fp8)
        out["control"] = self.readings(ctl["losses"], ctl["grad1"],
                                       ctl["grad_last"], ctl["weights"])
        B = self.followed[0][0].shape[1]
        half = self._reference(rows_used=B // 2)
        out["half_batch"] = self.readings(half["losses"], half["grad1"],
                                          half["grad_last"], half["weights"])
        out["unchanged"] = self.readings(self.prog_losses, self.prog_grad1,
                                         self.prog_grad_last, self.w0)
        out["resets_at_full_memory"] = self.full_resets()
        for key, prog in (("grad", self.prog_grad1),
                          ("grad_last", self.prog_grad_last)):
            gaps = compare.leaf_norm_gaps(prog, self.ref[
                "grad1" if key == "grad" else key])
            out["worst_leaves." + key] = sorted(
                gaps.items(), key=lambda kv: -kv[1])[:4]
        out["excluded_leaves"] = sorted(
            set(self.ref["grad1"]) - set(compare.moving_leaves(
                self.ref["grad1"])))
        return out
