"""Fused XL attention forward on Hopper (``csrc/attention.cu``).

Ports two TPU kernels, forward only:

* ``xl_attn_fwd_v2`` replaces ``pallas_attention_v2._fwd_raw``: queries
  arrive pre-scaled, the memory K/V in its h-major storage layout
  ``[H, B, M, dh]`` beside the current K/V, and the position term
  ``BD[i, j] = qrr[i] . rk[q-1-i+j]`` is computed in the kernel.
* ``xl_attn_fwd_v1`` replaces ``pallas_attention._fused_fwd_raw``: the
  position term arrives precomputed as ``bd [BH, q, klen]``.

Both return ``o`` (fp32), the row max ``m`` and the row sum ``l`` of the
unnormalised exponentials, as the TPU kernels do. On a CUDA tensor each
wrapper launches its kernel or raises; on a CPU tensor it runs its plain
version (``*_plain``), which is also what the card checks the kernel
against. ``rel_attention_kv_fused_v2`` / ``rel_attention_kv_fused`` keep the
JAX package's drop-in contracts of ``attention.rel_attention_kv``.

The backward kernels (training) are not ported yet: inputs that require
grad and attention dropout raise.
"""
from __future__ import annotations

import torch

from .. import _native
from ..models.attention import build_attn_mask, rel_shift

NEG = -0.7 * torch.finfo(torch.float32).max


def _forward_only(*tensors) -> None:
    if any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the attention kernels are forward-only (inference); the backward "
            "kernels come with the training port")


def _check_cuda(name: str, dtype, device, **tensors) -> None:
    for key, t in tensors.items():
        if t is None:
            continue
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be a contiguous tensor on "
                             f"{device}, got {t.device} contiguous="
                             f"{t.is_contiguous()}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} is {t.dtype}, expected {dtype}")


def _reset_i32(reset, rows: int, device):
    if reset is None:
        return None
    reset = reset.to(device=device, dtype=torch.int32).contiguous()
    if reset.numel() != rows:
        raise ValueError(f"reset has {reset.numel()} rows, expected {rows}")
    return reset


# ---------------------------------------------------------------------------
# K1f: position term in the kernel (pallas_attention_v2._fwd_raw)
# ---------------------------------------------------------------------------

def xl_attn_fwd_v2(qrw, qrr, k_mem, v_mem, k_cur, v_cur, rk, count, reset,
                   same_length: bool):
    """qrw, qrr: [H, B, q, dh] (q + r_w_bias, q + r_r_bias, pre-scaled by
    1/sqrt(dh)); k_mem, v_mem: [H, B, M, dh]; k_cur, v_cur: [H, B, q, dh];
    rk: [H, M + 2q, dh] projected positions zero-padded with q rows;
    count: valid memory slots; reset: [B] or None.
    Returns (o [H, B, q, dh] fp32, m [H, B, 1, q], l [H, B, 1, q])."""
    _forward_only(qrw, qrr, k_mem, v_mem, k_cur, v_cur, rk)
    count = int(count)
    if not qrw.is_cuda:
        return xl_attn_fwd_v2_plain(qrw, qrr, k_mem, v_mem, k_cur, v_cur, rk,
                                    count, reset, same_length)
    H, B, q, dh = qrw.shape
    M = k_mem.shape[2]
    if rk.shape != (H, M + 2 * q, dh):
        raise ValueError(f"rk shape {tuple(rk.shape)} != {(H, M + 2 * q, dh)}")
    dev = qrw.device
    _check_cuda("xl_attn_fwd_v2", qrw.dtype, dev, qrw=qrw, qrr=qrr,
                k_mem=k_mem, v_mem=v_mem, k_cur=k_cur, v_cur=v_cur, rk=rk)
    reset_bh = _reset_i32(reset, B, dev)
    if reset_bh is not None:
        reset_bh = reset_bh.repeat(H)  # block index h * B + b
    o = torch.empty((H, B, q, dh), dtype=torch.float32, device=dev)
    m = torch.empty((H, B, 1, q), dtype=torch.float32, device=dev)
    l = torch.empty((H, B, 1, q), dtype=torch.float32, device=dev)
    p = _native.ptr
    rc = _native.lib().tg_xl_attn_fwd(
        _native.dtype_code(qrw.dtype), 0, p(qrw), p(qrr), p(k_mem), p(v_mem),
        M * dh, p(k_cur), p(v_cur), q * dh, p(rk), None, p(reset_bh),
        p(o), p(m), p(l), H * B, B, q, M, dh, count, 1.0, int(same_length),
        _native.stream_ptr(dev))
    _native.check(rc, "xl_attn_fwd_v2")
    _native.count_launch("xl_attn_fwd_v2")
    return o, m, l


def xl_attn_fwd_v2_plain(qrw, qrr, k_mem, v_mem, k_cur, v_cur, rk, count,
                         reset, same_length: bool):
    """Plain PyTorch version of :func:`xl_attn_fwd_v2` (the kernel's
    formulas: fp32 scores, unnormalised P rounded to the value type before
    P V, normalised after)."""
    H, B, q, dh = qrw.shape
    M = k_mem.shape[2]
    klen = M + q
    k = torch.cat([k_mem, k_cur], dim=2).float()
    v = torch.cat([v_mem, v_cur], dim=2)
    ac = qrw.float() @ k.transpose(-1, -2)                     # [H, B, q, klen]
    w_mat = torch.einsum("hbid,hcd->hbic", qrr.float(), rk.float())
    # BD[i, j] = w_mat[i, q-1-i+j]
    idx = ((q - 1 - torch.arange(q, device=qrw.device))[:, None]
           + torch.arange(klen, device=qrw.device)[None, :])
    bd = torch.gather(w_mat, 3, idx.expand(H, B, q, klen))
    mask = build_attn_mask(q, M, count, same_length, reset, qrw.device)
    s = (ac + bd).masked_fill(mask[None], NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = (p.to(v.dtype).float() @ v.float()) * (1.0 / l)
    return o, m.transpose(-1, -2), l.transpose(-1, -2)


def rel_attention_kv_fused_v2(w, k_mem, v_mem, r, qkv_w, r_w, r_w_bias,
                              r_r_bias, attn_count, reset_rows, n_head: int,
                              d_head: int, *, same_length: bool,
                              dropatt: float = 0.0):
    """Contract of ``pallas_attention_v2.rel_attention_kv_fused_v2``
    (forward): k_mem/v_mem in the h-major storage layout [h, b, M, dh].
    Returns (attn_vec [q, b, h*dh], k_cur [h, b, q, dh], v_cur)."""
    if dropatt > 0.0:
        raise NotImplementedError("attention dropout is a training feature")
    qlen, bsz = w.shape[0], w.shape[1]
    klen = k_mem.shape[2] + qlen
    scale = 1.0 / (d_head ** 0.5)

    q, k_cur, v_cur = (w @ qkv_w).chunk(3, dim=-1)
    # [q, b, h*dh] -> [h, b, q, dh]
    q = q.reshape(qlen, bsz, n_head, d_head).permute(2, 1, 0, 3)
    k_cur = k_cur.reshape(qlen, bsz, n_head, d_head).permute(2, 1, 0, 3)
    v_cur = v_cur.reshape(qlen, bsz, n_head, d_head).permute(2, 1, 0, 3)
    r_head_k = (r @ r_w).reshape(klen, n_head, d_head).transpose(0, 1)
    rk = torch.cat([r_head_k, r_head_k.new_zeros(n_head, qlen, d_head)],
                   dim=1)                                     # [h, klen+q, dh]
    # the scale is a scalar of the compute type, as in the JAX wrapper
    sc = torch.tensor(scale, dtype=q.dtype, device=q.device)
    qrw = (q + r_w_bias.to(q.dtype)[:, None, None, :]) * sc
    qrr = (q + r_r_bias.to(q.dtype)[:, None, None, :]) * sc
    k_cur, v_cur = k_cur.contiguous(), v_cur.contiguous()
    o, _, _ = xl_attn_fwd_v2(qrw.contiguous(), qrr.contiguous(),
                             k_mem.contiguous(), v_mem.contiguous(),
                             k_cur, v_cur, rk.contiguous(), attn_count,
                             reset_rows, same_length)
    attn_vec = o.permute(2, 1, 0, 3).reshape(qlen, bsz, n_head * d_head)
    return attn_vec.to(w.dtype), k_cur, v_cur


# ---------------------------------------------------------------------------
# K2f: position term precomputed (pallas_attention._fused_fwd_raw)
# ---------------------------------------------------------------------------

def xl_attn_fwd_v1(q, k, v, bd, count, reset, scale: float,
                   same_length: bool):
    """q: [BH, qlen, dh] (q + r_w_bias); k, v: [BH, klen, dh] (memory then
    current); bd: [BH, qlen, klen] (relative shift applied); reset: [BH] or
    None. Returns (o [BH, qlen, dh] fp32, m [BH, 1, qlen], l [BH, 1, qlen])."""
    _forward_only(q, k, v, bd)
    count = int(count)
    if not q.is_cuda:
        return xl_attn_fwd_v1_plain(q, k, v, bd, count, reset, scale,
                                    same_length)
    BH, qlen, dh = q.shape
    klen = k.shape[1]
    M = klen - qlen
    dev = q.device
    _check_cuda("xl_attn_fwd_v1", q.dtype, dev, q=q, k=k, v=v, bd=bd)
    if k.shape != (BH, klen, dh) or v.shape != k.shape or \
            bd.shape != (BH, qlen, klen):
        raise ValueError("xl_attn_fwd_v1: inconsistent shapes")
    reset_bh = _reset_i32(reset, BH, dev)
    o = torch.empty((BH, qlen, dh), dtype=torch.float32, device=dev)
    m = torch.empty((BH, 1, qlen), dtype=torch.float32, device=dev)
    l = torch.empty((BH, 1, qlen), dtype=torch.float32, device=dev)
    p = _native.ptr
    cur_off = M * dh * k.element_size()  # current K/V follow the memory rows
    rc = _native.lib().tg_xl_attn_fwd(
        _native.dtype_code(q.dtype), 1, p(q), None, p(k), p(v), klen * dh,
        p(k) + cur_off, p(v) + cur_off, klen * dh, None, p(bd), p(reset_bh),
        p(o), p(m), p(l), BH, 1, qlen, M, dh, count, float(scale),
        int(same_length), _native.stream_ptr(dev))
    _native.check(rc, "xl_attn_fwd_v1")
    _native.count_launch("xl_attn_fwd_v1")
    return o, m, l


def xl_attn_fwd_v1_plain(q, k, v, bd, count, reset, scale: float,
                         same_length: bool):
    """Plain PyTorch version of :func:`xl_attn_fwd_v1` (normalised P rounded
    to the value type before P V, as the TPU kernel does)."""
    BH, qlen, dh = q.shape
    M = k.shape[1] - qlen
    s = (q.float() @ k.float().transpose(-1, -2) + bd.float()) * scale
    mask = build_attn_mask(qlen, M, count, same_length, reset, q.device)
    s = s.masked_fill(mask, NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = (p / l).to(v.dtype).float() @ v.float()
    return o, m.transpose(-1, -2), l.transpose(-1, -2)


def rel_attention_kv_fused(w, k_mem, v_mem, r, qkv_w, r_w, r_w_bias,
                           r_r_bias, attn_count, reset_rows, n_head: int,
                           d_head: int, *, same_length: bool,
                           dropatt: float = 0.0):
    """Contract of ``pallas_attention.rel_attention_kv_fused`` (forward).
    Returns (attn_vec [q, b, h*dh], k_cur [h, b, q, dh], v_cur)."""
    if dropatt > 0.0:
        raise NotImplementedError("attention dropout is a training feature")
    qlen, bsz = w.shape[0], w.shape[1]
    klen = k_mem.shape[2] + qlen
    scale = 1.0 / (d_head ** 0.5)

    q, k_cur, v_cur = (w @ qkv_w).chunk(3, dim=-1)
    q = q.reshape(qlen, bsz, n_head, d_head).permute(1, 2, 0, 3)
    k_cur = k_cur.reshape(qlen, bsz, n_head, d_head).permute(1, 2, 0, 3)
    v_cur = v_cur.reshape(qlen, bsz, n_head, d_head).permute(1, 2, 0, 3)
    k = torch.cat([k_mem.transpose(0, 1), k_cur], dim=2)
    v = torch.cat([v_mem.transpose(0, 1), v_cur], dim=2)

    r_head_k = (r @ r_w).reshape(klen, n_head, d_head)
    rr_q = q + r_r_bias.to(q.dtype)[None, :, None, :]
    bd = rel_shift(torch.einsum("bhid,jhd->bhij", rr_q,
                                r_head_k.to(q.dtype)))
    q_rw = q + r_w_bias.to(q.dtype)[None, :, None, :]

    BH = bsz * n_head
    reset = (None if reset_rows is None
             else reset_rows.repeat_interleave(n_head))
    o, _, _ = xl_attn_fwd_v1(
        q_rw.reshape(BH, qlen, d_head), k.reshape(BH, klen, d_head),
        v.reshape(BH, klen, d_head), bd.reshape(BH, qlen, klen).contiguous(),
        attn_count, reset, scale, same_length)
    attn_vec = o.reshape(bsz, n_head, qlen, d_head).permute(2, 0, 1, 3)
    attn_vec = attn_vec.reshape(qlen, bsz, n_head * d_head)
    return (attn_vec.to(w.dtype), k_cur.transpose(0, 1),
            v_cur.transpose(0, 1))
