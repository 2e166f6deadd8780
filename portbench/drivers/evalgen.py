"""Metric-eval generation traffic: ``Trainer._generate_tokens`` as the
quality metrics call it, whole calls of ``num_samples`` pieces of
``seq_len`` tokens from <S> with gumbel-argmax.

Set-up builds the ``Trainer`` with the benchmark's weights and warms up with
one call of ``warmup_samples`` pieces at the same length and wave width;
the window runs whole calls until ``--seconds`` have passed. The check runs
the reference's full forward over every piece the window produced and reads,
at every position, the gap by which the produced token's noisy logit lies
below the best: a call's mean gap, and its mean squared gap, which one
altered token among a call's 262,016 positions lifts past its limit.

Traffic keys: ``num_samples``, ``batch_size``, ``seq_len``,
``warmup_samples``, ``check_block_lanes``, optionally ``corpus`` (sizes
merged into the configuration's).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import work
from ..reference import generate as ref_gen
from ..reference import precision
from . import common


class Driver:
    def __init__(self, cell, seed, device, tmp, overrides):
        self.cell, self.seed, self.device = cell, seed, device
        self.tmp, self.overrides = tmp, overrides
        self.traffic = cell["traffic_data"]
        self.limits = cell["limits"]
        self.attempted = self.failed = 0

    def _call(self, n):
        """One call of the program; returns (step, call index, tokens
        [seq_len, n] as numpy)."""
        t = self.trainer
        tr = self.traffic
        step, call = t.train_step_num, t._gen_wave
        toks = t._generate_tokens(n, int(tr["batch_size"]),
                                  int(tr["seq_len"]))
        return step, call, np.ascontiguousarray(toks.T)

    def setup(self):
        from transformer_gan_torch.train.loop import wave_width
        self.trainer, self.cfg, self.dims, self.w0 = common.build_trainer(
            self.cell, self.seed, self.device, self.tmp, self.overrides)
        tr = self.traffic
        self.wave = wave_width(int(tr["num_samples"]), int(tr["batch_size"]))
        if wave_width(int(tr["warmup_samples"]), int(tr["batch_size"])) != \
                self.wave:
            raise ValueError("the warm-up call must run the window's waves")
        self._call(int(tr["warmup_samples"]))
        self.calls = []

    def window(self, seconds):
        self.launch0 = common.launches()
        deadline = time.perf_counter() + seconds
        while not self.calls or time.perf_counter() < deadline:
            self.calls.append(self._call(int(self.traffic["num_samples"])))
        self.launch1 = common.launches()

    def context(self, trace):
        tr = self.traffic
        n, length = int(tr["num_samples"]), int(tr["seq_len"]) - 1
        d = self.dims
        self.attempted = len(self.calls) * n
        self.failed = sum(int(((c[2] < 0) | (c[2] >= d.V)).any(0).sum())
                          for c in self.calls)
        waves = len(self.calls) * (n // self.wave)
        chunks = work.generate_chunks(length, int(tr["seq_len"]))
        flops = waves * sum(work.sampler_work(
            c_n, self.wave, int(tr["seq_len"]), count, L=d.L, HD=d.H * d.dh,
            DI=d.di, V=d.V)[1] for c_n, count in chunks)
        return common.context(
            trace=trace, window_s=self.window_s, chips=self.cell["chips"],
            launches={k: self.launch1[k] - self.launch0.get(k, 0)
                      for k in self.launch1},
            flops=flops, tokens=len(self.calls) * n * length, waves=waves,
            chunks=chunks, shapes={"B": self.wave, "M": int(tr["seq_len"]),
                                   "L": d.L, "HD": d.H * d.dh, "DI": d.di,
                                   "V": d.V})

    def release(self):
        self.trainer = None

    # -- check ---------------------------------------------------------------
    def _gaps(self, call, quant=None, alter=None):
        step, idx, toks = call
        d, tr = self.dims, self.traffic
        length = int(tr["seq_len"]) - 1
        n = toks.shape[1]
        noise = ref_gen.call_noise(ref_gen.call_seed(step, idx),
                                   n // self.wave, length, self.wave, d.V,
                                   self.device)
        toks = torch.from_numpy(toks.astype(np.int64)).to(self.device)
        if alter is not None:
            pos, lane = alter
            toks[pos, lane] = (toks[pos, lane] + 1 - 2) % (d.V - 2) + 2
        return torch.cat([ref_gen.token_gaps(
            self.w0, toks[:, k * self.wave:(k + 1) * self.wave], noise[k],
            H=d.H, dh=d.dh, block=int(tr["check_block_lanes"]), quant=quant)
            for k in range(n // self.wave)], 1)

    @staticmethod
    def readings(gaps: list) -> dict:
        """Over the calls' gap tensors [length, lanes]: the widest gap, the
        largest mean gap and mean squared gap of a call and the largest mean
        gap of a piece, and the largest share of a call's or a piece's
        positions whose token is not the reference's choice. The limits name
        the ones compared."""
        return {"gap": max(float(g.max()) for g in gaps),
                "mean_gap": max(float(g.double().mean()) for g in gaps),
                "sq_gap": max(float(g.double().square().mean())
                              for g in gaps),
                "piece_mean_gap": max(float(g.double().mean(0).max())
                                      for g in gaps),
                "flips": max(float((g > 0).double().mean()) for g in gaps),
                "piece_flips": max(float((g > 0).double().mean(0).max())
                                   for g in gaps)}

    def check(self):
        self.got = self.readings([self._gaps(c) for c in self.calls])
        return [{"name": k, "value": self.got[k], "limit": lim}
                for k, lim in self.limits.items()]

    def calibrate(self):
        """Readings of the control (the token an fp8 forward puts first) and
        of one produced token altered, on the window's first call."""
        call = self.calls[0]
        length, n = call[2].shape[0] - 1, call[2].shape[1]
        rng = np.random.default_rng(self.seed)
        alter = (int(rng.integers(1, length + 1)), int(rng.integers(0, n)))
        return {"program": self.got,
                "control": self.readings([self._gaps(call,
                                                     quant=precision.fp8)]),
                "token_altered": self.readings([self._gaps(call,
                                                           alter=alter)])}
