"""Decode-kernel operand layout (counterpart of
``pallas_decode.stack_decode_params``).

Per-layer weights stacked into contiguous ``[L, ...]`` tensors of the
compute type, with the qkv projection split into q/k/v. LayerNorm scales
and biases stay fp32, as the plain decode step applies the fp32 master
weights. The TPU layout's block-diagonal head mask is gone: the kernel
takes per-head dot products.
"""
from __future__ import annotations

import torch

from ..models.xl import XLConfig, layer_params


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
    return {
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
