"""Relative-position multi-head attention (Transformer-XL), plain PyTorch.

Counterpart of ``transformer_gan_tpu/models/attention.py``: ``layer_norm``
and the K/V-cached ``rel_attention_kv`` (AC/BD score decomposition with the
pad-reshape relative shift, masked softmax, attention dropout drawn from an
explicit ``torch.Generator``). It is the plain version of the fused
attention kernels in ``ops/attention.py`` and the CPU training path.
"""
from __future__ import annotations

import torch

LN_EPS = 1e-5  # torch.nn.LayerNorm default, as in the reference


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm over the last axis with statistics in at least fp32."""
    acc = torch.promote_types(x.dtype, torch.float32)
    x32 = x.to(acc)
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """The pad-and-reshape relative shift. x: [bsz, n_head, qlen, klen]."""
    b, n, q, k = x.shape
    padded = torch.cat([x.new_zeros(b, n, q, 1), x], dim=3).view(b, n, k + 1, q)
    return padded[:, :, 1:].reshape(b, n, q, k)


def build_attn_mask(qlen: int, mem_len: int, count: int, same_length: bool,
                    reset=None, device=None) -> torch.Tensor:
    """True = masked, [rows, qlen, mem_len + qlen] with rows = len(reset) or
    1: the causal band, the invalid left slots of the ring, the same_length
    constant-history band and, per reset row, the whole memory."""
    klen = mem_len + qlen
    i = torch.arange(qlen, device=device)[:, None]
    j = torch.arange(klen, device=device)[None, :]
    mask = (j > mem_len + i) | (j < mem_len - count)
    if same_length:
        j_dyn = j - (mem_len - count)
        mask_len = count + qlen - mem_len
        shift = qlen - mask_len if mask_len > 0 else qlen
        mask = mask | (j_dyn <= i - shift)
    mask = mask[None]
    if reset is not None:
        mask = mask | (reset.to(device=device, dtype=torch.bool)[:, None, None]
                       & (j < mem_len)[None])
    return mask


def rel_attention_kv(w, k_mem, v_mem, r, qkv_w, r_w, r_w_bias, r_r_bias,
                     attn_mask, n_head: int, d_head: int, *,
                     softmax_dtype=torch.float32, dropatt: float = 0.0,
                     generator: torch.Generator | None = None):
    """K/V-cached XL attention.

    w: [qlen, bsz, d_model] (pre-LN applied by the caller);
    k_mem, v_mem: [n_head, bsz, mem_len, d_head] cached memory (h-major);
    r: [klen, d_model] positional embeddings (distance klen-1 .. 0) or
    pre-projected heads [klen, n_head, d_head]; attn_mask: [rows, qlen, klen]
    bool, True = masked. With a ``generator``, attention probabilities are
    kept where a uniform draw is below 1 - dropatt and scaled by
    1 / (1 - dropatt) (the JAX package's bernoulli keep).
    Returns (attn_vec [qlen, bsz, n_head*d_head], k_cur [n_head, bsz, qlen,
    d_head], v_cur likewise).
    """
    qlen, bsz = w.shape[0], w.shape[1]
    klen = k_mem.shape[2] + qlen
    scale = 1.0 / (d_head ** 0.5)

    q, k_cur, v_cur = (w @ qkv_w).chunk(3, dim=-1)
    # attention-ready [b, h, t, d]
    q = q.reshape(qlen, bsz, n_head, d_head).permute(1, 2, 0, 3)
    k_cur = k_cur.reshape(qlen, bsz, n_head, d_head).permute(1, 2, 0, 3)
    v_cur = v_cur.reshape(qlen, bsz, n_head, d_head).permute(1, 2, 0, 3)
    k = torch.cat([k_mem.transpose(0, 1), k_cur], dim=2)
    v = torch.cat([v_mem.transpose(0, 1), v_cur], dim=2)

    if r.dim() == 3:
        r_head_k = r
    else:
        r_head_k = (r @ r_w).reshape(klen, n_head, d_head)

    rw_q = q + r_w_bias.to(q.dtype)[None, :, None, :]
    ac = rw_q @ k.transpose(-1, -2)                       # [b, h, q, klen]
    rr_q = q + r_r_bias.to(q.dtype)[None, :, None, :]
    bd = rel_shift(torch.einsum("bhid,jhd->bhij", rr_q,
                                r_head_k.to(q.dtype)))

    score = (ac + bd).to(softmax_dtype) * scale
    score = score.masked_fill(attn_mask[:, None],
                              torch.finfo(softmax_dtype).min)
    prob = torch.softmax(score, dim=3)
    if generator is not None and dropatt > 0.0:
        keep = torch.rand(prob.shape, generator=generator,
                          device=prob.device) < 1.0 - dropatt
        prob = torch.where(keep, prob / (1.0 - dropatt), 0.0)
    ctx = prob.to(v.dtype) @ v                            # [b, h, q, d]
    attn_vec = ctx.permute(2, 0, 1, 3).reshape(qlen, bsz, n_head * d_head)
    return attn_vec, k_cur.transpose(0, 1), v_cur.transpose(0, 1)
