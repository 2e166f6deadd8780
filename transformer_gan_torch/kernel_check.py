"""Kernel-versus-plain checks and CUDA-event timing on the card.

Shared by ``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py``: each
check builds seeded operands on the device at the shapes the main path
gives a kernel, runs the kernel wrapper and its plain PyTorch version on
the same inputs and returns the errors with the tolerance they are held to.
Only for CUDA devices; float32 comparisons assume TF32 is off
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default).
"""
from __future__ import annotations

import math

import torch

from .infer.sample import SamplingConfig, gumbel_noise
from .models import gan as gan_mod
from .models import xl
from .ops import attention as attn_ops
from .ops import generate as gen_ops
from .ops.decode_params import stack_decode_params

# The baseline model (training_config/experiment_baseline.yml) and the
# shipped inference configs' memory length.
BASELINE = dict(n_token=310, n_layer=6, n_head=10, d_model=500, d_inner=1000,
                dropout=0.0, dropatt=0.0, cache_kv=True)
MEM_LEN = 4146

# Tolerances: fp32 kernels sum in another order than cuBLAS (1e-4 for the
# attention outputs, 1e-3 for staged K/V after six layers); bf16 attention
# outputs within 2e-2 of max|o|; bf16 first-step logits within 6 ulps of
# max|logit| (the CLI's debug-check rule).
ATTN_TOL_F32 = 1e-4
ATTN_REL_TOL_BF16 = 2e-2
STAGE_TOL_F32 = 1e-3
LOGIT_ULPS_BF16 = 6


def baseline_config(compute_dtype: str = "bfloat16") -> xl.XLConfig:
    return xl.XLConfig(compute_dtype=compute_dtype, **BASELINE)


def bf16_ulp(max_abs: float) -> float:
    """bf16 ulp at the binade of ``max_abs``: 2^(floor(log2 x) - 7)."""
    return 2.0 ** ((math.floor(math.log2(max_abs)) if max_abs > 0 else 0) - 7)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_in_turns(kernel_fn, plain_fn, iters: int) -> tuple[float, float]:
    """Mean ms per call of a kernel and of its plain version, timed in turns
    (plain, kernel, kernel, plain) so that drift on the card hits both."""
    p1 = time_ms(plain_fn, iters, warmup=1)
    k1 = time_ms(kernel_fn, iters, warmup=1)
    k2 = time_ms(kernel_fn, iters, warmup=0)
    p2 = time_ms(plain_fn, iters, warmup=0)
    return (k1 + k2) / 2, (p1 + p2) / 2


# ---------------------------------------------------------------------------
# K1f / K2f: XL attention forward
# ---------------------------------------------------------------------------

def attention_case(variant: str, dtype, q: int, B: int, count: int,
                   M: int = MEM_LEN, H: int = 10, dh: int = 50,
                   same_length: bool = True, reset=None, seed: int = 0,
                   device="cuda"):
    """(kernel, plain, args) for ``variant`` "v2" (K1f) or "v1" (K2f)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.5).to(dtype)

    if variant == "v2":
        rk = rnd(H, M + 2 * q, dh)
        rk[:, M + q:] = 0
        args = (rnd(H, B, q, dh), rnd(H, B, q, dh), rnd(H, B, M, dh),
                rnd(H, B, M, dh), rnd(H, B, q, dh), rnd(H, B, q, dh), rk,
                count, reset, same_length)
        return attn_ops.xl_attn_fwd_v2, attn_ops.xl_attn_fwd_v2_plain, args
    BH = B * H
    reset_bh = None if reset is None else reset.repeat_interleave(H)
    args = (rnd(BH, q, dh), rnd(BH, M + q, dh), rnd(BH, M + q, dh),
            rnd(BH, q, M + q), count, reset_bh, 1.0 / dh ** 0.5, same_length)
    return attn_ops.xl_attn_fwd_v1, attn_ops.xl_attn_fwd_v1_plain, args


def check_attention(variant: str, dtype, q: int, B: int, count: int,
                    **kw) -> dict:
    kernel, plain, args = attention_case(variant, dtype, q, B, count, **kw)
    o_k, m_k, l_k = kernel(*args)
    torch.cuda.synchronize()
    o_p, m_p, l_p = plain(*args)
    err = float((o_k - o_p).abs().max())
    scale = float(o_p.abs().max())
    if dtype == torch.float32:
        tol = ATTN_TOL_F32
    else:
        tol = ATTN_REL_TOL_BF16 * scale
    ml_err = max(float((m_k - m_p).abs().max()),
                 float(((l_k - l_p).abs() / l_p).max()))
    res = {"variant": variant, "dtype": str(dtype).split(".")[-1], "q": q,
           "B": B, "count": count, "max_abs_err": err, "max_abs_o": scale,
           "tol": tol, "ml_err": ml_err, "ok": err <= tol and ml_err <= 1e-3}
    if dtype == torch.bfloat16:
        # the tensor-core kernel's key splits and their combine against the
        # plain combine of the same number of key ranges, same tolerance
        qq = args[0]
        BH, klen = ((qq.shape[0] * qq.shape[1], args[2].shape[2] + q)
                    if variant == "v2" else (qq.shape[0], args[1].shape[1]))
        splits = attn_ops.v1_key_splits(
            BH, q, klen,
            torch.cuda.get_device_properties(qq.device).multi_processor_count)
        res["splits"] = splits
        if splits > 1:
            o_s, m_s, l_s = plain(*args, splits=splits)
            res["split_max_abs_err"] = float((o_k - o_s).abs().max())
            res["split_ml_err"] = max(float((m_k - m_s).abs().max()),
                                      float(((l_k - l_s).abs() / l_s).max()))
            res["ok"] = (res["ok"] and res["split_max_abs_err"] <= tol
                         and res["split_ml_err"] <= 1e-3)
    return res


# ---------------------------------------------------------------------------
# K1b / K2b: XL attention backward, and the forwards with dropout
# ---------------------------------------------------------------------------

# Gradient tolerances, relative to the largest magnitude of each reference
# output: fp32 sums run in another order (over up to M + q keys, and over
# the batch for drk); in bf16 dS and P_drop are rounded to bf16 on both
# sides, and an fp32 difference of order 1e-7 can move a rounding by one ulp.
GRAD_REL_TOL_F32 = 1e-4
GRAD_REL_TOL_BF16 = 2e-2


def attention_bwd_case(variant: str, dtype, q: int, B: int, count: int,
                       M: int, H: int = 10, dh: int = 50,
                       same_length: bool = False, reset=None,
                       rate: float = 0.0, seed: int = 0, device="cuda"):
    """Seeded operands of K1f/K1b ("v2") or K2f/K2b ("v1") with dropout
    ``rate``: (fwd, fwd_plain, bwd, bwd_plain, fwd_args, bwd_args(o, m, l)
    -> args, do)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.5).to(dtype)

    kw = dict(seed=1234 + seed, rate=rate)
    if variant == "v2":
        rk = rnd(H, M + 2 * q, dh)
        rk[:, M + q:] = 0
        ops = (rnd(H, B, q, dh), rnd(H, B, q, dh), rnd(H, B, M, dh),
               rnd(H, B, M, dh), rnd(H, B, q, dh), rnd(H, B, q, dh), rk)
        do = torch.randn((H, B, q, dh), generator=gen, device=device)
        fwd_args = ops + (count, reset, same_length)

        def bwd_args(o, m, l):
            return ops + (m, l, o, do, count, reset, same_length)
        return (attn_ops.xl_attn_fwd_v2, attn_ops.xl_attn_fwd_v2_plain,
                attn_ops.xl_attn_bwd_v2, attn_ops.xl_attn_bwd_v2_plain,
                fwd_args, bwd_args, kw)
    BH, klen = B * H, M + q
    reset_bh = None if reset is None else reset.repeat_interleave(H)
    ops = (rnd(BH, q, dh), rnd(BH, klen, dh), rnd(BH, klen, dh),
           rnd(BH, q, klen))
    do = torch.randn((BH, q, dh), generator=gen, device=device)
    scale = 1.0 / dh ** 0.5
    fwd_args = ops + (count, reset_bh, scale, same_length)

    def bwd_args(o, m, l):
        return ops + (m, l, o, do, count, reset_bh, scale, same_length)
    return (attn_ops.xl_attn_fwd_v1, attn_ops.xl_attn_fwd_v1_plain,
            attn_ops.xl_attn_bwd_v1, attn_ops.xl_attn_bwd_v1_plain,
            fwd_args, bwd_args, kw)


def check_attention_bwd(variant: str, dtype, q: int, B: int, count: int,
                        M: int, rate: float = 0.0, **kw) -> dict:
    """The forward with dropout (o) and every backward output against the
    plain versions on the same operands; the backward of both takes the
    kernel forward's o, m, l."""
    fwd, fwd_p, bwd, bwd_p, fwd_args, bwd_args, dkw = attention_bwd_case(
        variant, dtype, q, B, count, M, rate=rate, **kw)
    o, m, l = fwd(*fwd_args, **dkw)
    torch.cuda.synchronize()
    o_p, _, _ = fwd_p(*fwd_args, **dkw)
    f32 = dtype == torch.float32
    o_scale = float(o_p.abs().max())
    o_err = float((o - o_p).abs().max())
    o_tol = ATTN_TOL_F32 if f32 else ATTN_REL_TOL_BF16 * o_scale
    args = bwd_args(o, m, l)
    got = bwd(*args, **dkw)
    torch.cuda.synchronize()
    ref = bwd_p(*args, **dkw)
    names = (("dqrw", "dqrr", "dk_cur", "dv_cur", "drk") if variant == "v2"
             else ("dq", "dk", "dv", "dbd"))
    rel = GRAD_REL_TOL_F32 if f32 else GRAD_REL_TOL_BF16
    grads, ok = {}, o_err <= o_tol
    for name, g, r in zip(names, got, ref):
        scale = float(r.float().abs().max())
        err = float((g.float() - r.float()).abs().max())
        tol = rel * max(scale, 1e-6)
        grads[name] = {"max_abs_err": err, "max_abs": scale, "tol": tol}
        ok = ok and err <= tol
    return {"variant": variant, "dtype": str(dtype).split(".")[-1], "q": q,
            "B": B, "M": M, "count": count, "rate": rate,
            "o_max_abs_err": o_err, "o_tol": o_tol, "grads": grads,
            "max_abs_err": max([o_err] + [g["max_abs_err"]
                                          for g in grads.values()]),
            "ok": ok}


class TrainCase:
    """A seeded full-width training state, MLE step and batch (the baseline
    model with dropout at ``dtype``; the training op-point by default).
    ``fn`` is the step on the default route, ``fn_plain`` the step with
    every layer's attention on the plain ``rel_attention_kv``;
    ``steps(n, plain)`` runs n steps of one of them and returns host seconds
    per step (ending in a device sync)."""

    def __init__(self, B: int = 128, tgt: int = 128, M: int = 1024,
                 dtype: str = "bfloat16", dropout: float = 0.1,
                 device="cuda:0", seed: int = 2):
        import dataclasses

        from .train import optim as topt
        from .train import step as tstep
        cfg = dataclasses.replace(baseline_config(dtype), dropout=dropout,
                                  dropatt=dropout)
        params = xl.init_xl_params(cfg, seed=seed, base_init=("normal", 0.02))
        opt = topt.FusedOptimizer(
            "adam", 0.004, topt.make_schedule("inv_sqrt", 0.004, 100000,
                                              0.0001, 4000), 1.0,
            layout=topt.FlatLayout.of(params))
        self.state = tstep.init_train_state(params, opt, cfg, 1, M, B, 1111,
                                            device)
        self.cfg = cfg
        self.fn = tstep.make_mle_train_step(cfg, opt, 1, pad_id=1)
        self.fn_plain = tstep.make_mle_train_step(cfg, opt, 1, pad_id=1,
                                                  route="plain")
        gen = torch.Generator().manual_seed(seed)  # the same ids on any device
        self.data = torch.randint(2, cfg.n_token, (1, tgt, B),
                                  generator=gen).to(device)
        self.reset = torch.zeros((1, B), dtype=torch.bool, device=device)
        self.tokens = B * tgt

    def steps(self, n: int, plain: bool = False) -> float:
        import time
        fn = self.fn_plain if plain else self.fn
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            self.state, met = fn(self.state, self.data, self.data, self.reset)
        float(met["loss_weighted"])  # waits for the device
        return (time.perf_counter() - t0) / n

    def flat_grad(self, data, target, reset) -> torch.Tensor:
        """The flat fp32 gradient the next ``fn`` step takes, without
        stepping: the mean NLL of one chunk over the current memory, for
        targets without padding and without dropout."""
        flat = self.state.flat.detach().clone().requires_grad_(True)
        nll, _ = xl.forward_nll(self.state.layout.unflatten(flat), self.cfg,
                                data[0], target[0], reset[0],
                                self.state.mems[0])
        nll.mean().backward()
        return flat.grad


# ---------------------------------------------------------------------------
# K3: fused chunk sampling
# ---------------------------------------------------------------------------

class GenerateCase:
    """Seeded full-width operands of ``fused_generate_chunk``."""

    def __init__(self, dtype: str, B: int, count: int, M: int = MEM_LEN,
                 seed: int = 0, device="cuda"):
        self.cfg = baseline_config(dtype)
        self.scfg = SamplingConfig(technique="topk", topk=32,
                                   temperature=0.95)
        cfg, cd = self.cfg, self.cfg.cdtype
        params = {k: v.to(device) for k, v in xl.init_xl_params(
            cfg, seed, base_init=("normal", 0.02)).items()}
        self.stacked = stack_decode_params(params, cfg)
        L, HD = cfg.n_layer, cfg.n_head * cfg.d_head
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.kv = (torch.randn((L, 2, cfg.n_head, B, M, cfg.d_head),
                               generator=self.gen, device=device) * 0.5).to(cd)
        self.R = xl.precompute_r_heads(params, cfg, M + 1, device).reshape(
            L, M + 1, HD).to(cd).contiguous()
        self.ids = torch.randint(2, cfg.n_token, (B, 1), generator=self.gen,
                                 device=device, dtype=torch.int32)
        self.er = torch.zeros((B, 1), dtype=torch.int32, device=device)
        self.B, self.M, self.count, self.device = B, M, count, device

    def noise(self, n: int) -> torch.Tensor:
        return gumbel_noise((n, self.B, self.cfg.n_token), self.gen,
                            self.device)

    def run(self, n: int, g, plain: bool = False, return_logits=False):
        fn = (gen_ops.fused_generate_chunk_plain if plain
              else gen_ops.fused_generate_chunk)
        return fn(self.stacked, self.cfg, self.scfg, self.kv, self.R,
                  self.ids, self.er, g, self.count, n, same_length=True,
                  return_logits=return_logits)

    def advance(self, out, n: int) -> None:
        """Continue from a chunk's outputs: merge its staged K/V, feed its
        last token and counters."""
        self.ids, self.er = out[0], out[1]
        self.kv = torch.cat([self.kv[..., n:, :], out[3]], dim=4)
        self.count = min(self.count + n, self.M)


def first_divergence(a: torch.Tensor, b: torch.Tensor) -> list:
    """Per lane, the first step where two [n, B] id sequences differ (None
    where they agree throughout)."""
    diff = (a != b).cpu()
    return [int(diff[:, j].nonzero()[0]) if diff[:, j].any() else None
            for j in range(diff.shape[1])]


def check_generate(dtype: str, B: int, count: int, chunks=(32, 7),
                   **kw) -> dict:
    """A full chunk, then a remainder chunk continuing from the kernel's
    state; each chunk run by the kernel and by the plain version on the
    same operands and noise."""
    case = GenerateCase(dtype, B, count, **kw)
    res = {"dtype": dtype, "B": B, "count": count, "chunks": []}
    ok = True
    for n in chunks:
        g = case.noise(n)
        k_out = case.run(n, g, return_logits=True)
        torch.cuda.synchronize()
        p_out = case.run(n, g, plain=True, return_logits=True)
        ids_equal = bool(torch.equal(k_out[2], p_out[2]))
        stage_err = float((k_out[3].float() - p_out[3].float()).abs().max())
        lg_k, lg_p = k_out[4][0].float(), p_out[4][0].float()
        logit_err = float((lg_k - lg_p).abs().max())
        chunk = {"n": n, "count": case.count, "ids_equal": ids_equal,
                 "first_divergence": first_divergence(k_out[2], p_out[2]),
                 "stage_max_abs_err": stage_err,
                 "logit0_max_abs_err": logit_err}
        if dtype == "float32":
            chunk["ok"] = ids_equal and stage_err <= STAGE_TOL_F32
        else:
            ulp = bf16_ulp(float(lg_p.abs().max()))
            chunk["logit0_ulps"] = logit_err / ulp
            chunk["ok"] = logit_err <= LOGIT_ULPS_BF16 * ulp
        ok = ok and chunk["ok"]
        res["chunks"].append(chunk)
        case.advance(k_out, n)
    res["ok"] = ok
    res["max_abs_err"] = max(max(c["stage_max_abs_err"], c["logit0_max_abs_err"])
                             for c in res["chunks"])
    return res


# ---------------------------------------------------------------------------
# K4 / K5: the GAN's gumbel straight-through sampler
# ---------------------------------------------------------------------------

GAN_MEM = 64


class DecodeCase:
    """Seeded full-width operands of ``fused_decode_chunk`` /
    ``fused_decode_step`` (the GAN op-point's M 64 by default)."""

    def __init__(self, dtype: str, B: int, count: int, M: int = GAN_MEM,
                 seed: int = 0, device="cuda"):
        from .ops import decode as dec_ops
        self.ops = dec_ops
        self.cfg = baseline_config(dtype)
        cfg, cd = self.cfg, self.cfg.cdtype
        params = {k: v.to(device) for k, v in xl.init_xl_params(
            cfg, seed, base_init=("normal", 0.02)).items()}
        self.stacked = stack_decode_params(params, cfg)
        L, HD = cfg.n_layer, cfg.n_head * cfg.d_head
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.kv = (torch.randn((L, 2, cfg.n_head, B, M, cfg.d_head),
                               generator=self.gen, device=device) * 0.5).to(cd)
        self.R = xl.precompute_r_heads(params, cfg, M + 1, device).reshape(
            L, M + 1, HD).to(cd).contiguous()
        self.ids = torch.randint(2, cfg.n_token, (B, 1), generator=self.gen,
                                 device=device, dtype=torch.int32)
        self.B, self.M, self.count, self.device = B, M, count, device

    def noise(self, n: int) -> torch.Tensor:
        return gumbel_noise((n, self.B, self.cfg.n_token), self.gen,
                            self.device)

    def run(self, n: int, g, plain: bool = False):
        """K4 (or its plain version) over n tokens: (ids, one-hots, staged)."""
        fn = (self.ops.fused_decode_chunk_plain if plain
              else self.ops.fused_decode_chunk)
        return fn(self.stacked, self.cfg, self.kv, self.R, self.ids, g,
                  self.count, n)

    def run_steps(self, n: int, g, plain: bool = False):
        """K5 (or its plain version) token by token over a 32-row ring."""
        fn = (self.ops.fused_decode_step_plain if plain
              else self.ops.fused_decode_step)
        L, _, H, B, _, dh = self.kv.shape
        staged = torch.zeros((L, 2, H, B, max(n, 32), dh), dtype=self.kv.dtype,
                             device=self.device)
        ids, ohs = self.ids, []
        for t in range(n):
            ids, oh, staged = fn(self.stacked, self.cfg, self.kv, self.R,
                                 staged, ids, g[t], t, self.count)
            ohs.append(oh)
        return ids, torch.stack(ohs), staged[..., :n, :]

    def advance(self, out, n: int) -> None:
        self.ids = out[0]
        self.kv = torch.cat([self.kv[..., n:, :], out[2]], dim=4).contiguous()
        self.count = min(self.count + n, self.M)


def _compare_samples(dtype: str, k_out, p_out) -> dict:
    """Kernel against plain sampler outputs (ids, one-hots [n, B, V],
    staged [L, 2, H, B, n, dh]). fp32: ids and one-hots identical, staged
    K/V within STAGE_TOL_F32. bf16: per lane, the staged rows up to its
    first sampled-id divergence (rows computed from identical inputs)
    within ATTN_REL_TOL_BF16 of max|ref|."""
    tok_k, tok_p = k_out[1].argmax(-1), p_out[1].argmax(-1)     # [n, B]
    div = first_divergence(tok_k, tok_p)
    st_k, st_p = k_out[2].float(), p_out[2].float()
    if dtype == "float32":
        err = float((st_k - st_p).abs().max())
        ok = (bool(torch.equal(k_out[1], p_out[1]))
              and bool(torch.equal(k_out[0], p_out[0])) and err <= STAGE_TOL_F32)
        return {"ids_equal": bool(torch.equal(tok_k, tok_p)),
                "stage_max_abs_err": err, "ok": ok, "first_divergence": div}
    err, n = 0.0, st_k.shape[4]
    for b, d in enumerate(div):
        rows = n if d is None else d + 1
        err = max(err, float((st_k[:, :, :, b, :rows]
                              - st_p[:, :, :, b, :rows]).abs().max()))
    tol = ATTN_REL_TOL_BF16 * float(st_p.abs().max())
    return {"lanes_diverged": sum(d is not None for d in div),
            "first_divergence_min": min((d for d in div if d is not None),
                                        default=None),
            "stage_max_abs_err": err, "tol": tol, "ok": err <= tol}


def check_decode(dtype: str, B: int, count: int, chunks=(32, 27),
                 step: bool = False, **kw) -> dict:
    """K4 (or, with ``step``, K5) against its plain version: the GAN's
    chunks of 32 and 27 tokens, the second continuing from the kernel's
    state."""
    case = DecodeCase(dtype, B, count, **kw)
    res = {"kernel": "K5" if step else "K4", "dtype": dtype, "B": B,
           "count": count, "chunks": []}
    run = case.run_steps if step else case.run
    for n in chunks:
        g = case.noise(n)
        k_out = run(n, g)
        torch.cuda.synchronize()
        p_out = run(n, g, plain=True)
        c = {"n": n, "count": case.count, **_compare_samples(dtype, k_out,
                                                             p_out)}
        res["chunks"].append(c)
        case.advance(k_out, n)
    res["ok"] = all(c["ok"] for c in res["chunks"])
    res["max_abs_err"] = max(c["stage_max_abs_err"] for c in res["chunks"])
    return res


# ---------------------------------------------------------------------------
# K6 / K7: the reverse straight-through chain
# ---------------------------------------------------------------------------

# Q against the plain chain. bf16: every entry within 2e-2 x max|Q_ref|
# (K1b's rule; bf16 rounds each product's inputs where autograd rounds its
# own intermediates). fp32: against the plain chain in fp64, every entry
# within 1e-4 x max|Q_ref| except the rows of a ReLU kink, and the relative
# Frobenius error ||Q - Q_ref|| / ||Q_ref|| within 1e-4 over all rows. The
# chain crosses 6 layers x 1000 ReLUs for each of 58 tokens and 64 lanes,
# 22M pre-activations, and a few of them sit within fp32 rounding of zero.
# Two fp32 computations of one (a batched GEMM, a GEMV) then take opposite
# sides, and the cotangent of the token before it jumps in that lane: on an
# H100 one (token, lane) row of K6 and K7 read 4.7e-4 against the fp64
# answer (max|Q| 0.92, B 64) where the next token held a pre-activation of
# 1.3e-7, and every other row was within 1e-4. A row beyond 1e-4 passes
# only when the next token in its lane has a pre-activation within
# CHAIN_KINK_F32 of zero; a wrong kernel moves rows that have none.
CHAIN_REL_TOL_F32 = 1e-4
CHAIN_KINK_F32 = 1e-6
CHAIN_REL_TOL_BF16 = 2e-2


class ChainCase:
    """Seeded full-width operands of the chain backward at one sampled
    chunk (n tokens after M memory slots, ``count`` of them valid): the
    window pass's lane buffers and residuals, straight-through cotangents
    S and softmax outputs Y at temperature T."""

    def __init__(self, dtype: str, B: int, count: int, T: float = 1.0,
                 n: int = 59, M: int = GAN_MEM, seed: int = 0,
                 device="cuda"):
        from .ops import chain_bwd as chain_ops
        self.ops = chain_ops
        self.cfg = cfg = baseline_config(dtype)
        cd, V = cfg.cdtype, cfg.n_token
        self.params = {k: v.to(device) for k, v in xl.init_xl_params(
            cfg, seed, base_init=("normal", 0.02)).items()}
        gen = torch.Generator(device=device).manual_seed(seed)
        ids = torch.randint(2, V, (n, B), generator=gen, device=device)
        self.inputs = torch.nn.functional.one_hot(ids, V).float()
        shape = (cfg.n_layer, cfg.n_head, B, M, cfg.d_head)
        k_mem = (torch.randn(shape, generator=gen, device=device) * 0.5).to(cd)
        v_mem = (torch.randn(shape, generator=gen, device=device) * 0.5).to(cd)
        with torch.no_grad():
            logits, kf, vf, _, self.res = xl.decode_recompute_window(
                self.params, cfg, self.inputs, k_mem, v_mem, count,
                collect_residuals=True)
        self.kf, self.vf = torch.stack(kf).contiguous(), torch.stack(vf).contiguous()
        g = gumbel_noise((n, B, V), gen, device)
        self.Y = torch.softmax((logits.float() + g) / T, dim=-1)
        self.S = torch.randn((n, B, V), generator=gen, device=device)
        self.stacked = stack_decode_params(self.params, cfg)
        self.count, self.T, self.n, self.B, self.M = count, T, n, B, M

    def args(self):
        return (self.params, self.cfg, self.kf, self.vf, self.inputs, self.S,
                self.Y, self.count, self.T)

    def run(self, variant: str):
        """"res" (K6), "recompute" (K7) or "plain"."""
        if variant == "res":
            return self.ops.chain_bwd_q_res(*self.args(), self.res,
                                            stacked=self.stacked)
        if variant == "recompute":
            return self.ops.chain_bwd_q(*self.args(), stacked=self.stacked)
        return self.ops.chain_bwd_q_plain(*self.args())


def check_chain(dtype: str, B: int, count: int, T: float = 1.0, **kw) -> dict:
    """K6 and K7 against ``chain_bwd_q_plain`` on one chunk's operands (in
    fp32 against the plain chain in fp64; see ``CHAIN_REL_TOL_F32``). Rows
    [token, lane] beyond 1e-4 x max|Q_ref| are listed with the smallest
    |ff_pre| of the next token's layers in that lane (a ReLU at its kink)."""
    import dataclasses
    case = ChainCase(dtype, B, count, T, **kw)
    # [n, B]: the smallest |pre-activation| of token t + 1's layers in each
    # lane (inf for the last token, which has none after it)
    ff = case.res["ff_pre"].float().abs().amin(dim=(0, 3))        # [n, B]
    kink_next = torch.cat([ff[1:], torch.full_like(ff[:1], math.inf)])
    ref = case.run("plain")
    f32 = dtype == "float32"
    res = {"dtype": dtype, "B": B, "count": count, "T": T, "n": case.n}
    if f32:
        f64 = dataclasses.replace(case.cfg, compute_dtype="float64",
                                  softmax_dtype="float64")
        p64 = {k: v.double() for k, v in case.params.items()}
        exact = case.ops.chain_bwd_q_plain(
            p64, f64, case.kf.double(), case.vf.double(),
            case.inputs.double(), case.S.double(), case.Y.double(), case.count,
            case.T)
        res["plain_fp32_rel_err"] = float((ref.double() - exact).norm()
                                          / exact.norm())
        ref = exact
    scale = float(ref.abs().max())
    res["max_abs_q"] = scale
    res["tol"] = (f"{CHAIN_REL_TOL_F32} x max|Q| per entry outside rows at a "
                  f"ReLU kink (|pre-activation| <= {CHAIN_KINK_F32}), "
                  f"{CHAIN_REL_TOL_F32} relative Frobenius" if f32
                  else CHAIN_REL_TOL_BF16 * scale)
    ok = True
    for variant, key in (("res", "K6"), ("recompute", "K7")):
        q = case.run(variant).to(ref.dtype)
        torch.cuda.synchronize()
        err = (q - ref).abs().amax(-1)                               # [n, B]
        res[key] = float(err.max())
        res[key + "_rel_err"] = float((q - ref).norm() / ref.norm())
        beyond = err > CHAIN_REL_TOL_F32 * scale
        rows = beyond.nonzero().tolist()
        res[key + "_rows_beyond_1e-4"] = [
            {"token": t, "lane": b, "err": float(err[t, b]),
             "min_abs_ff_pre_next": (float(kink_next[t, b])
                                     if t + 1 < case.n else None)}
            for t, b in rows[:8]]
        if f32:
            unexplained = int((beyond & (kink_next > CHAIN_KINK_F32)).sum())
            res[key + "_rows_beyond_without_kink"] = unexplained
            ok = (ok and res[key + "_rel_err"] <= CHAIN_REL_TOL_F32
                  and unexplained == 0)
        else:
            ok = ok and res[key] <= CHAIN_REL_TOL_BF16 * scale
    res["ok"] = ok
    res["max_abs_err"] = max(res["K6"], res["K7"])
    return res


# ---------------------------------------------------------------------------
# The GAN phases at full width
# ---------------------------------------------------------------------------

class HostDraws(gan_mod.Draws):
    """Draws from a CPU generator, moved to the device, so that the card
    and the CPU see the same numbers."""

    def _uniform(self, shape):
        return torch.rand(shape, generator=self.generator,
                          dtype=torch.float32).to(self.device)


class GanCase:
    """``train/gan_loop.GanPhases`` at full width on a seeded generator
    (the baseline model, ``training_config/experiment_cnn.yml``'s
    discriminator and GAN settings, batch ``B``), fed seeded real batches.
    ``route`` "plain" runs the sampler and chain plain versions on the same
    device. ``host_draws``: the random numbers of :class:`HostDraws` (the
    same on the card and the CPU) in place of the phases' own generator on
    the device (what a training run draws, and what is timed)."""

    def __init__(self, dtype: str, B: int, device="cuda", route="kernel",
                 seed: int = 0, dis_steps: int = 1, chain_bwd: str = "auto",
                 host_draws: bool = True):
        import dataclasses
        import os
        import types

        import numpy as np

        from .config import training_config
        from .train import gan_loop
        from .train import optim as topt
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        cfg = training_config(os.path.join(root, "training_config",
                                           "experiment_cnn.yml"))
        cfg.merge({"TRAIN": {"batch_size": B},
                   "DISCRIMINATOR": {"dis_steps": dis_steps},
                   "TPU": {"compute_dtype": dtype, "gan_chain_bwd": chain_bwd}})
        xcfg = xl.XLConfig.from_cfg(cfg, 310)
        params = xl.init_xl_params(xcfg, seed, base_init=("normal", 0.02))
        layout = topt.FlatLayout.of(params)
        state = types.SimpleNamespace(
            flat=layout.flatten(params).to(device).requires_grad_(True),
            layout=layout)
        state.params = lambda: layout.unflatten(state.flat)
        rng = np.random.RandomState(seed)

        def batches():
            while True:
                yield rng.randint(2, 310, (cfg.DISCRIMINATOR.tgt_len, B)), 0

        trainer = types.SimpleNamespace(
            xcfg=xcfg, vocab=range(310), state=state, n_devices=1,
            device=torch.device(device), dis_iter=batches)
        self.phases = gan_loop.GanPhases(trainer, cfg)
        self.phases.gcfg = dataclasses.replace(self.phases.gcfg, route=route)
        if host_draws:
            host = torch.Generator().manual_seed(seed + 1)
            self.phases._draws = lambda: HostDraws(host, device)
        self.state, self.B, self.cfg = state, B, cfg

    def tokens_per_pass(self) -> int:
        """Tokens one sampling pass generates (all lanes, all chunks)."""
        return self.B * sum(self.phases.gcfg.chunk_lengths())


# Card kernel path against CPU plain path, one dis and one gen update in
# fp32 (check_gan_reference). Gradients: the relative Frobenius error of
# each phase's flat gradient, and of every leaf whose norm is at least 1e-6
# of its phase's. Not the largest entry of a leaf: the card and the CPU
# compute the pre-activations of ~3M ReLUs a gen update in another order,
# and one at its kink moves a weight column's gradient for that token (an
# H100 read 1.05e-4 of ff_w1's max); and under rsgan the discriminator's
# last two biases have an exact gradient of zero (the real and fake logits'
# cotangents cancel), so theirs is rounding residue. The leaf limit, 5e-5,
# sits above the worst leaf the H100 read (1.95e-5, convs.0.b) and far
# below the same update in bf16 on the card, the control each check also
# reads (it must land beyond the limit). Adam's first step moves each
# weight by about lr whatever its gradient, the sign of a vanishing one a
# coin toss: moves within lr x 1e-3 but for at most 1e-3 of the weights,
# each within 2 lr (the H100 read 1.75e-4 of the discriminator's weights
# beyond).
GAN_REF_TOL = {"loss_rel": 1e-5, "grad_rel": 1e-5, "grad_leaf_rel": 5e-5,
               "leaf_floor": 1e-6, "move_rel": 1e-3, "flip_share": 1e-3}


def _gan_update(dtype: str, B: int, device) -> dict:
    """One dis and one gen update of :class:`GanCase`: logged losses, each
    phase's flat gradient and parameter move, layouts and base lrs."""
    case = GanCase(dtype, B, device)
    ph = case.phases
    dis0 = ph.dis_flat.detach().clone()
    gen0 = case.state.flat.detach().clone()
    grads = {"dis": ph.dis_phase(0).cpu(), "gen": ph.gen_phase(0).cpu()}
    g, d = ph.pop_log_stats()
    return {"gen_loss": g, "dis_loss": d, "grads": grads,
            "moves": {"dis": (ph.dis_flat.detach() - dis0).cpu(),
                      "gen": (case.state.flat.detach() - gen0).cpu()},
            "layouts": {"dis": ph.dis_layout, "gen": case.state.layout},
            "lr": {"dis": ph.dis_opt.base_lr, "gen": ph.gen_opt.base_lr}}


def _grad_errs(ga, gb, layout, floor) -> dict:
    """Relative Frobenius error of gradient ``ga`` against ``gb``, overall
    and for the worst leaf whose norm is at least ``floor`` of the whole."""
    ga, gb = ga.double(), gb.double()
    total = float(gb.norm())
    worst, name, entry = 0.0, None, 0.0
    for leaf, off, shp in zip(layout.names, layout.offsets, layout.shapes):
        n = math.prod(shp)
        a, b = ga[off:off + n], gb[off:off + n]
        if float(b.norm()) < floor * total:
            continue
        rel = float((a - b).norm() / b.norm())
        entry = max(entry, float((a - b).abs().max() / b.abs().max()))
        if rel > worst:
            worst, name = rel, leaf
    return {"grad_rel_err": float((ga - gb).norm()) / total,
            "grad_leaf_max_rel_err": worst, "worst_leaf": name,
            "grad_leaf_max_entry_rel_err": entry}


def check_gan_reference(B: int = 8, devices=("cuda:0", "cpu")) -> dict:
    """One dis and one gen update (fp32, the GAN op-point at batch ``B``)
    of the kernel path on the card against the plain path on the CPU:
    losses, every gradient leaf, the parameters' moves (``GAN_REF_TOL``).
    The control, the same update in bf16 on the card, must read beyond the
    leaf limit."""
    k, p = (_gan_update("float32", B, dev) for dev in devices)
    control = _gan_update("bfloat16", B, devices[0])
    tol = GAN_REF_TOL
    res = {"B": B, "tol": tol,
           "kernel_losses": {"gen": k["gen_loss"], "dis": k["dis_loss"]},
           "plain_losses": {"gen": p["gen_loss"], "dis": p["dis_loss"]}}
    res["loss_rel_err"] = max(abs(k[n] - p[n]) / abs(p[n])
                              for n in ("gen_loss", "dis_loss"))
    ok = res["loss_rel_err"] <= tol["loss_rel"]
    for phase in ("dis", "gen"):
        layout = p["layouts"][phase]
        errs = _grad_errs(k["grads"][phase], p["grads"][phase], layout,
                          tol["leaf_floor"])
        ctl = _grad_errs(control["grads"][phase], p["grads"][phase], layout,
                         tol["leaf_floor"])
        lr = p["lr"][phase]
        diff = (k["moves"][phase] - p["moves"][phase]).abs()
        flips = float((diff > tol["move_rel"] * lr).float().mean())
        res[phase] = {**errs, "move_max_abs_err": float(diff.max()), "lr": lr,
                      "move_share_beyond": flips,
                      "control_bf16_grad_leaf_max_rel_err":
                          ctl["grad_leaf_max_rel_err"],
                      "control_bf16_worst_leaf": ctl["worst_leaf"]}
        ok = (ok and errs["grad_rel_err"] <= tol["grad_rel"]
              and errs["grad_leaf_max_rel_err"] <= tol["grad_leaf_rel"]
              and ctl["grad_leaf_max_rel_err"] > tol["grad_leaf_rel"]
              and flips <= tol["flip_share"] and float(diff.max()) <= 2 * lr)
    res["ok"] = ok
    return res


# ---------------------------------------------------------------------------
# Least times on the card (the bound of a kernel's work)
# ---------------------------------------------------------------------------

# One H100 SXM (NVIDIA's data sheet, dense): bf16 / fp16 tensor-core peak and
# HBM3 bandwidth; fp32 outside the tensor cores for fp32 kernels.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def bound_ms(nbytes: float, flops: float, dtype: str = "bfloat16"):
    """(least ms, "bytes" or "operations"): the larger of the bytes each
    input read once and each output written once over HBM bandwidth, and
    the operations over the peak rate of the type."""
    t_b, t_f = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def _weights(L, HD, DI, V, es):
    """Bytes of the stacked decode operands (weights, biases, layer norms
    in fp32, the two embedding copies, r_w_bias / r_r_bias)."""
    return (es * (L * (4 * HD * HD + 2 * HD * DI + DI + HD) + 2 * V * HD + V
                  + 2 * HD) + 4 * 4 * L * HD)


def _decode_keys(M: int, count: int, t: int) -> int:
    """Keys token t of a chunk attends to (big slots and staged rows)."""
    return M - min(M, max(M - count, t)) + t + 1


def sampler_work(n, B, M, count, L=6, HD=500, DI=1000, V=310, es=2, t0=0):
    """(bytes, flops) of n tokens of the decode chain from chunk step ``t0``
    (K3 / K4 at 0; K5 is one token at ``t0``): the big K/V slots its first
    token sees, the ``t0`` staged rows before it, the n rows it stages."""
    big = M - min(M, max(M - count, t0))
    nbytes = (es * (2 * L * B * big * HD + L * (M + 1) * HD)
              + _weights(L, HD, DI, V, es) + 4 * n * B * V + 8 * B
              + 4 * n * B * V + es * 2 * L * B * (t0 + n) * HD)
    flops = B * sum(L * (2 * (4 * HD * HD + 2 * HD * DI)
                         + 6 * HD * _decode_keys(M, count, t)) + 2 * HD * V
                    for t in range(t0, t0 + n))
    return nbytes, flops


def chain_work(n, B, M, count, recompute, L=6, HD=500, DI=1000, V=310, H=10,
               es=2):
    """(bytes, flops) of one chunk's reverse chain (K6, or K7 with
    ``recompute``): tokens n-1 .. 1 back through every layer, token 0's
    softmax backward only. A layer's backward takes the two FF transposes
    and five HD x HD products (the o, q, k and v transposes and the token's
    query, which K7's forward has already made)."""
    KL = M + n
    nbytes = (es * (2 * L * B * KL * HD + L * (M + 1) * HD)
              + _weights(L, HD, DI, V, es) + 4 * 3 * n * B * V)
    if recompute:
        nbytes += 4 * n * B
    else:
        nbytes += es * (3 * L * n * B * HD + L * n * B * DI) + 4 * L * B * H * n * KL
    per_layer = 4 * HD * DI + (8 if recompute else 10) * HD * HD
    fwd_layer = 4 * HD * HD + 4 * HD * DI
    flops = 0
    for t in range(1, n):
        nk = M + t - min(M, max(M - count, t)) + 1     # lanes token t sees
        layer = per_layer + 6 * HD * nk + (fwd_layer + 6 * HD * nk
                                           if recompute else 0)
        flops += B * (4 * HD * V + L * layer)
    return nbytes, flops


def attention_work(variant, q, B, M, count, same_length, backward=False,
                   H=10, dh=50, es=2):
    """(bytes, flops) of one K1f / K2f (or with ``backward`` K1b / K2b)
    call: the scores the mask leaves open are counted, not the full grid."""
    from .models.attention import build_attn_mask
    mask = build_attn_mask(q, M, count, same_length)
    nv = int((~mask).sum()) * H * B
    if bool(mask.all()):                      # same_length at M 0: uniform
        nv = mask.numel() * H * B
    nv_cur = int((~mask[..., M:]).sum()) * H * B
    klen = M + q
    if variant == "v2":
        ins = es * (4 * H * B * q * dh + 2 * H * B * M * dh + H * (M + 2 * q) * dh)
        if not backward:
            return ins + 4 * (H * B * q * dh + 2 * H * B * q), 2 * dh * 3 * nv
        ins += 4 * (2 * H * B * q + 2 * H * B * q * dh)
        outs = es * 4 * H * B * q * dh + 4 * H * (M + 2 * q) * dh
        return ins + outs, 2 * dh * (6 * nv + 2 * nv_cur)
    BH = B * H
    ins = es * (BH * q * dh + 2 * BH * klen * dh + BH * q * klen)
    if not backward:
        return ins + 4 * (BH * q * dh + 2 * BH * q), 2 * dh * 2 * nv + nv
    ins += 4 * (2 * BH * q + 2 * BH * q * dh)
    outs = es * (BH * q * dh + 2 * BH * klen * dh + BH * q * klen)
    return ins + outs, 2 * dh * 5 * nv


def v1_route_case(fwd_args, bwd_args, kw):
    """Yardstick for K1f / K1b, never called by the port: the same function
    on the same operands (``attention_bwd_case("v2", ...)``) by the v1 route,
    the position term BD built by ``torch.matmul`` and a gather, then K2f
    (and K2b, with dqrr and drk from dbd by a scatter and two products).
    Returns callables (fwd, fwd_bwd)."""
    qrw, qrr, k_mem, v_mem, k_cur, v_cur, rk, count, reset, same_length = \
        fwd_args
    H, B, q, dh = qrw.shape
    klen = k_mem.shape[2] + q
    BH = H * B
    idx = attn_ops._bd_index(q, klen, qrw.device).expand(H, B, q, klen)
    k = torch.cat([k_mem, k_cur], 2).reshape(BH, klen, dh)
    v = torch.cat([v_mem, v_cur], 2).reshape(BH, klen, dh)
    reset_bh = None if reset is None else reset.repeat(H)
    flat = qrw.reshape(BH, q, dh)
    do = bwd_args(*(None,) * 3)[10].reshape(BH, q, dh)

    def fwd():
        bd = torch.gather(qrr @ rk[:, None].transpose(-1, -2), 3, idx)
        return attn_ops.xl_attn_fwd_v1(flat, k, v, bd.reshape(BH, q, klen),
                                       count, reset_bh, 1.0, same_length,
                                       **kw), bd

    def fwd_bwd():
        (o, m, l), bd = fwd()
        bd = bd.reshape(BH, q, klen)
        _, _, _, dbd = attn_ops.xl_attn_bwd_v1(flat, k, v, bd, m, l, o, do,
                                               count, reset_bh, 1.0,
                                               same_length, **kw)
        dw = torch.zeros((H, B, q, klen + q), dtype=dbd.dtype,
                         device=dbd.device)
        dw.scatter_(3, idx, dbd.reshape(H, B, q, klen))
        return dw @ rk[:, None], torch.einsum("hbic,hbid->hcd", dw, qrr)

    return fwd, fwd_bwd


def sdpa_case(q: int, B: int, M: int, count: int, same_length: bool,
              H: int = 10, dh: int = 50, dtype=torch.bfloat16, seed: int = 0):
    """``scaled_dot_product_attention`` on K2f's function: queries q + r_w_bias
    [B, H, q, dh], keys and values [B, H, M + q, dh], the position term
    BD x scale plus the mask as a float ``attn_mask``. Returns callables
    (fwd, fwd_bwd, bwd); ``bwd`` is SDPA's backward alone, on one forward
    kept with its graph (timed beside K2f / K2b as the library yardstick;
    the port never calls it)."""
    from .models.attention import build_attn_mask
    gen = torch.Generator(device="cuda").manual_seed(seed)
    klen = M + q

    def rnd(*shape):
        return (torch.randn(shape, generator=gen, device="cuda") * 0.5).to(dtype)

    qq, k, v = rnd(B, H, q, dh), rnd(B, H, klen, dh), rnd(B, H, klen, dh)
    scale = 1.0 / dh ** 0.5
    mask = build_attn_mask(q, M, count, same_length, device="cuda")[0]
    bias = (rnd(B, H, q, klen).float() * scale).masked_fill(mask, float("-inf"))
    if bool(mask.all(-1).any()):
        bias = bias.masked_fill(mask, 0.0)   # every key masked: uniform
    bias = bias.to(dtype)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    grads = [t.detach().requires_grad_(True) for t in (qq, k, v, bias)]
    do = torch.randn_like(qq)

    def fwd():
        return sdpa(qq, k, v, attn_mask=bias, scale=scale)

    def fwd_bwd():
        o = sdpa(*grads[:3], attn_mask=grads[3], scale=scale)
        torch.autograd.grad(o, grads, do)

    kept = sdpa(*grads[:3], attn_mask=grads[3], scale=scale)

    def bwd():
        torch.autograd.grad(kept, grads, do, retain_graph=True)

    return fwd, fwd_bwd, bwd
