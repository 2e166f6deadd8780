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
    return {"variant": variant, "dtype": str(dtype).split(".")[-1], "q": q,
            "B": B, "count": count, "max_abs_err": err, "max_abs_o": scale,
            "tol": tol, "ml_err": ml_err, "ok": err <= tol and ml_err <= 1e-3}


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
