"""Decode-kernel operand layout (counterpart of
``pallas_decode.stack_decode_params``).

Per-layer weights stacked into contiguous ``[L, ...]`` tensors of the
compute type, with the qkv projection split into q/k/v. LayerNorm scales
and biases stay fp32, as the plain decode step applies the fp32 master
weights. The TPU layout's block-diagonal head mask is gone: the kernel
takes per-head dot products.

In bf16 the dict also holds the operands of the bf16 decode chain
(``csrc/decode_chain_tc.cuh``): each product's weight transposed, W^T
``[..., npad(N), kpad(K)]`` with zeros past N and K (``kpad`` a multiple of
``K_ALIGN``, ``npad`` of ``N_ALIGN``), so a GEMV block reads 16 bytes of 8
consecutive k of one column; q, k and v are one ``qkv_t`` for their shared
launch. The plain versions do not read them. They also hold the operands of
the bf16 reverse chain (``csrc/chain_bwd_tc.cu``, :func:`chain_bwd_operands`):
a backward product out[b, n] = sum_k x[b, k] W[n, k] takes the forward
weight as stored, padded alike to ``[..., npad(N), kpad(K)]``.
"""
from __future__ import annotations

import torch

from ..models.xl import XLConfig, layer_params


# W^T padding of the bf16 chain's operands, as csrc/decode_chain_tc.cuh's
# kKAlign and kGemvN fix it (ops/generate.chain_lib checks them against the
# library): K to a multiple of 32 (one 16-byte load feeds two MMA k-steps of
# 16), N to a multiple of 8 (a GEMV block's columns)
K_ALIGN = 32
N_ALIGN = 8


def kpad(k: int) -> int:
    """K of a bf16 chain operand, a multiple of ``K_ALIGN``."""
    return -(-k // K_ALIGN) * K_ALIGN


def npad(n: int) -> int:
    """N of a bf16 chain operand, a multiple of ``N_ALIGN``."""
    return -(-n // N_ALIGN) * N_ALIGN


def transpose_padded(w: torch.Tensor) -> torch.Tensor:
    """``[..., K, N]`` -> W^T ``[..., npad(N), kpad(K)]``, zeros in the
    padding."""
    K, N = w.shape[-2:]
    return torch.nn.functional.pad(w.transpose(-1, -2),
                                   (0, kpad(K) - K, 0, npad(N) - N)).contiguous()


def pad_operand(w: torch.Tensor) -> torch.Tensor:
    """``[..., N, K]`` -> ``[..., npad(N), kpad(K)]``, zeros in the padding."""
    N, K = w.shape[-2:]
    return torch.nn.functional.pad(w, (0, kpad(K) - K, 0, npad(N) - N)).contiguous()


def chain_bwd_operands(stacked: dict) -> dict[str, torch.Tensor]:
    """The bf16 reverse chain's weights from :func:`stack_decode_params`'s
    stack: each backward product's forward weight as stored, padded
    (:func:`pad_operand`). ``qkv_bwd`` takes [dq | dk | dv] in one product."""
    return {
        "qkv_bwd": pad_operand(torch.cat([stacked["q_w"], stacked["k_w"],
                                          stacked["v_w"]], dim=-1)),
        "o_bwd": pad_operand(stacked["o_w"]),
        "ff1_bwd": pad_operand(stacked["ff1"]),
        "ff2_bwd": pad_operand(stacked["ff2"]),
        "emb_t_bwd": pad_operand(stacked["emb_t"]),
        "emb_bwd": pad_operand(stacked["emb_scaled"]),
    }


def stack_decode_params(params: dict, cfg: XLConfig) -> dict[str, torch.Tensor]:
    cd = cfg.cdtype
    hd = cfg.n_head * cfg.d_head
    layers = [layer_params(params, i) for i in range(cfg.n_layer)]

    def st(key, part=None, dtype=cd):
        ws = [l[key].to(dtype) for l in layers]
        if part is not None:
            ws = [w[:, part * hd:(part + 1) * hd] for w in ws]
        return torch.stack(ws).contiguous()

    emb = params["word_emb"].to(cd)
    out = {
        "q_w": st("qkv_w", 0),
        "k_w": st("qkv_w", 1),
        "v_w": st("qkv_w", 2),
        "o_w": st("o_w"),
        "ff1": st("ff_w1"),
        "fb1": st("ff_b1"),
        "ff2": st("ff_w2"),
        "fb2": st("ff_b2"),
        "ln_as": st("attn_ln_scale", dtype=torch.float32),
        "ln_ab": st("attn_ln_bias", dtype=torch.float32),
        "ln_fs": st("ff_ln_scale", dtype=torch.float32),
        "ln_fb": st("ff_ln_bias", dtype=torch.float32),
        "rwb": params["r_w_bias"].to(cd).reshape(hd).contiguous(),
        "rrb": params["r_r_bias"].to(cd).reshape(hd).contiguous(),
        "emb_scaled": (emb * (cfg.d_model ** 0.5)).contiguous(),
        # logits weight: the embedding unless untied (crit_w present)
        "emb_t": params.get("crit_w", params["word_emb"]).to(cd).T.contiguous(),
        "crit_bias": params["crit_bias"].to(cd).contiguous(),
    }
    if cd == torch.bfloat16:
        out.update(
            qkv_t=transpose_padded(torch.cat([out["q_w"], out["k_w"],
                                              out["v_w"]], dim=-1)),
            o_t=transpose_padded(out["o_w"]), ff1_t=transpose_padded(out["ff1"]),
            ff2_t=transpose_padded(out["ff2"]),
            lg_t=transpose_padded(out["emb_t"]))
        out.update(chain_bwd_operands(out))
    return out
