"""Fused XL attention on Hopper: forward (``csrc/attention.cu``) and backward
(``csrc/attention_bwd.cu``) kernels, with attention dropout in the kernels.

Ports four TPU kernels:

* ``xl_attn_fwd_v2`` (K1f) replaces ``pallas_attention_v2._fwd_raw`` and
  ``xl_attn_bwd_v2`` (K1b) ``pallas_attention_v2._bwd_raw``: queries arrive
  pre-scaled, the memory K/V in its h-major storage layout ``[H, B, M, dh]``
  beside the current K/V, and the position term
  ``BD[i, j] = qrr[i] . rk[q-1-i+j]`` is computed in the kernels. The
  backward gives no memory gradient (the XL memory is detached) and sums
  ``drk`` over the batch.
* ``xl_attn_fwd_v1`` (K2f) replaces ``pallas_attention._fused_fwd_raw`` and
  ``xl_attn_bwd_v1`` (K2b) ``pallas_attention._fused_bwd_raw``: the position
  term arrives precomputed as ``bd [BH, q, klen]``; the backward returns
  ``dbd = dS * scale`` and dk, dv over every key.

The forwards return ``o`` (fp32), the row max ``m`` and the row sum ``l`` of
the unnormalised exponentials, as the TPU kernels do; the backwards
recompute P from them and take ``D = rowsum(do * o)``. Dropout keeps score
(i, j) of block ``bh`` where :func:`dropout_bits` (a hash of
``(seed, bh, i, j)``, the same in the kernels) is at least ``rate * 2^32``,
so forward, backward and the plain versions draw one mask.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs its plain version (``*_plain``), which is also what the card
checks the kernel against. ``XLAttnV2`` / ``XLAttnV1`` pair each forward with
its backward for autograd, and ``rel_attention_kv_fused_v2`` /
``rel_attention_kv_fused`` keep the JAX package's drop-in contracts of
``attention.rel_attention_kv``: their own ops (q split, bias add, query
pre-scale, ``r @ r_w``, the zero pad of ``rk``) are plain torch, so autograd
carries the kernels' gradients on to the weights.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _native
from ..models.attention import build_attn_mask, rel_shift

NEG = -0.7 * torch.finfo(torch.float32).max

# K1b sums drk over the batch in this many independent splits, then adds the
# splits in order (a deterministic second pass instead of atomics).
DRK_SPLITS = 8


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


def _acc(dtype) -> torch.dtype:
    """Accumulation type of the plain versions: fp32, or fp64 for fp64."""
    return torch.promote_types(dtype, torch.float32)


def _f32(t):
    return None if t is None else t.to(torch.float32).contiguous()


# ---------------------------------------------------------------------------
# Attention dropout: one hash for kernels and plain versions
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mix(x: torch.Tensor) -> torch.Tensor:
    """``tg_mix`` of csrc/common.cuh on int64 tensors holding uint32 values
    (multipliers below 2^31, so every product is exact in int64)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x346CA68B) & _M32
    return x ^ (x >> 16)


def dropout_bits(seed: int, bh: torch.Tensor, i: torch.Tensor,
                 j: torch.Tensor) -> torch.Tensor:
    """uint32 bits (as int64) of score (i, j) of block ``bh``; the three
    index tensors broadcast. Same function as ``drop_row_key`` /
    ``drop_keep`` in csrc/common.cuh."""
    s = _mix(torch.tensor((int(seed) + 0x9E3779B9) & _M32, device=bh.device))
    k = _mix(s ^ ((bh + 0x7F4A7C15) & _M32))
    row = _mix(k ^ ((i + 0x6A09E667) & _M32))
    return _mix(row ^ ((j + 0xBB67AE85) & _M32))


def dropout_threshold(rate: float) -> int:
    """Keep where bits >= rate * 2^32 (the TPU kernels' rule)."""
    return min(int(rate * (1 << 32)), (1 << 32) - 1)


def keep_mask(seed: int, n_bh: int, q: int, klen: int, rate: float,
              device=None) -> torch.Tensor:
    """Dropout keep mask [n_bh, q, klen] of blocks 0 .. n_bh-1."""
    bh = torch.arange(n_bh, device=device, dtype=torch.int64)[:, None, None]
    i = torch.arange(q, device=device, dtype=torch.int64)[None, :, None]
    j = torch.arange(klen, device=device, dtype=torch.int64)[None, None, :]
    return dropout_bits(seed, bh, i, j) >= dropout_threshold(rate)


# ---------------------------------------------------------------------------
# K1f / K1b: position term in the kernel (pallas_attention_v2)
# ---------------------------------------------------------------------------

def _v2_scores(qrw, qrr, k_mem, k_cur, rk, count, reset, same_length):
    """Masked scores S [H, B, q, klen] of the v2 kernels (acc dtype)."""
    H, B, q, dh = qrw.shape
    M = k_mem.shape[2]
    klen = M + q
    acc = _acc(qrw.dtype)
    k = torch.cat([k_mem, k_cur], dim=2).to(acc)
    ac = qrw.to(acc) @ k.transpose(-1, -2)
    w_mat = torch.einsum("hbid,hcd->hbic", qrr.to(acc), rk.to(acc))
    # BD[i, j] = w_mat[i, q-1-i+j]
    idx = _bd_index(q, klen, qrw.device)
    bd = torch.gather(w_mat, 3, idx.expand(H, B, q, klen))
    mask = build_attn_mask(q, M, count, same_length, reset, qrw.device)
    return (ac + bd).masked_fill(mask[None], NEG)


def _bd_index(q: int, klen: int, device) -> torch.Tensor:
    return ((q - 1 - torch.arange(q, device=device))[:, None]
            + torch.arange(klen, device=device)[None, :])


def xl_attn_fwd_v2(qrw, qrr, k_mem, v_mem, k_cur, v_cur, rk, count, reset,
                   same_length: bool, *, seed: int = 0, rate: float = 0.0):
    """qrw, qrr: [H, B, q, dh] (q + r_w_bias, q + r_r_bias, pre-scaled by
    1/sqrt(dh)); k_mem, v_mem: [H, B, M, dh]; k_cur, v_cur: [H, B, q, dh];
    rk: [H, M + 2q, dh] projected positions zero-padded with q rows;
    count: valid memory slots; reset: [B] or None; dropout ``rate`` with
    ``seed``. Returns (o [H, B, q, dh] fp32, m [H, B, 1, q], l [H, B, 1, q])."""
    count = int(count)
    if not qrw.is_cuda:
        return xl_attn_fwd_v2_plain(qrw, qrr, k_mem, v_mem, k_cur, v_cur, rk,
                                    count, reset, same_length, seed=seed,
                                    rate=rate)
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
        int(seed), dropout_threshold(rate), float(rate),
        _native.stream_ptr(dev))
    _native.check(rc, "xl_attn_fwd_v2")
    _native.count_launch("xl_attn_fwd_v2")
    return o, m, l


def xl_attn_fwd_v2_plain(qrw, qrr, k_mem, v_mem, k_cur, v_cur, rk, count,
                         reset, same_length: bool, *, seed: int = 0,
                         rate: float = 0.0):
    """Plain PyTorch version of :func:`xl_attn_fwd_v2` (the kernel's
    formulas: fp32 scores, unnormalised P dropped and rounded to the value
    type before P V, normalised and keep-scaled after)."""
    H, B, q, dh = qrw.shape
    acc = _acc(qrw.dtype)
    v = torch.cat([v_mem, v_cur], dim=2)
    s = _v2_scores(qrw, qrr, k_mem, k_cur, rk, count, reset, same_length)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    if rate > 0.0:
        keep = keep_mask(seed, H * B, q, s.shape[-1], rate, qrw.device)
        p = torch.where(keep.view(H, B, q, -1), p, 0.0)
    o = (p.to(v.dtype).to(acc) @ v.to(acc)) * (1.0 / l) / (1.0 - rate)
    return o, m.transpose(-1, -2), l.transpose(-1, -2)


class _BwdArgs(ctypes.Structure):
    """Mirror of ``struct BwdArgs`` in csrc/attention_bwd.cu."""

    _fields_ = (
        [(k, ctypes.c_void_p) for k in (
            "qrw", "qrr", "kmem", "vmem", "kcur", "vcur", "rk", "bd", "reset",
            "m", "l", "o", "dout", "dq", "dqr", "dk", "dv", "dbd", "drk_part",
            "drk")]
        + [("mem_bh", ctypes.c_longlong), ("cur_bh", ctypes.c_longlong)]
        + [(k, ctypes.c_int) for k in (
            "dtype", "bd_in", "BH", "B", "q", "M", "dh", "count",
            "same_length", "n_split")]
        + [("seed", ctypes.c_uint), ("thr", ctypes.c_uint),
           ("scale", ctypes.c_float), ("rate", ctypes.c_float)])


def _launch_bwd(name: str, dev, **fields) -> None:
    lib = _native.lib()
    if ctypes.sizeof(_BwdArgs) != lib.tg_sizeof_attn_bwd_args():
        raise RuntimeError("_BwdArgs layout differs from csrc/attention_bwd.cu")
    args = _BwdArgs(**{k: (_native.ptr(v) if isinstance(v, torch.Tensor)
                           else v) for k, v in fields.items()})
    rc = lib.tg_xl_attn_bwd(ctypes.byref(args), _native.stream_ptr(dev))
    _native.check(rc, name)
    _native.count_launch(name)


def xl_attn_bwd_v2(qrw, qrr, k_mem, v_mem, k_cur, v_cur, rk, m, l, o, do,
                   count, reset, same_length: bool, *, seed: int = 0,
                   rate: float = 0.0):
    """K1b: gradients of :func:`xl_attn_fwd_v2`'s ``o`` given ``do``
    [H, B, q, dh] and the forward's ``m``, ``l`` and ``o``. Returns
    (dqrw, dqrr, dk_cur, dv_cur) in the input types and drk [H, M + 2q, dh]
    fp32 summed over the batch; no memory gradient."""
    count = int(count)
    if not qrw.is_cuda:
        return xl_attn_bwd_v2_plain(qrw, qrr, k_mem, v_mem, k_cur, v_cur, rk,
                                    m, l, o, do, count, reset, same_length,
                                    seed=seed, rate=rate)
    H, B, q, dh = qrw.shape
    M = k_mem.shape[2]
    KP = M + 2 * q
    dev = qrw.device
    if rk.shape != (H, KP, dh):
        raise ValueError(f"rk shape {tuple(rk.shape)} != {(H, KP, dh)}")
    _check_cuda("xl_attn_bwd_v2", qrw.dtype, dev, qrw=qrw, qrr=qrr,
                k_mem=k_mem, v_mem=v_mem, k_cur=k_cur, v_cur=v_cur, rk=rk)
    m, l, o, do = _f32(m), _f32(l), _f32(o), _f32(do)
    _check_cuda("xl_attn_bwd_v2", torch.float32, dev, m=m, l=l, o=o, do=do)
    reset_bh = _reset_i32(reset, B, dev)
    if reset_bh is not None:
        reset_bh = reset_bh.repeat(H)
    n_split = min(B, DRK_SPLITS)
    dqrw, dqrr = torch.empty_like(qrw), torch.empty_like(qrr)
    dk_cur, dv_cur = torch.empty_like(k_cur), torch.empty_like(v_cur)
    drk = torch.empty((H, KP, dh), dtype=torch.float32, device=dev)
    part = torch.empty((n_split, H, KP, dh), dtype=torch.float32, device=dev)
    _launch_bwd("xl_attn_bwd_v2", dev, qrw=qrw, qrr=qrr, kmem=k_mem,
                vmem=v_mem, kcur=k_cur, vcur=v_cur, rk=rk, reset=reset_bh,
                m=m, l=l, o=o, dout=do, dq=dqrw, dqr=dqrr, dk=dk_cur,
                dv=dv_cur, drk_part=part, drk=drk, mem_bh=M * dh,
                cur_bh=q * dh, dtype=_native.dtype_code(qrw.dtype), bd_in=0,
                BH=H * B, B=B, q=q, M=M, dh=dh, count=count,
                same_length=int(same_length), n_split=n_split, seed=int(seed),
                thr=dropout_threshold(rate), scale=1.0, rate=float(rate))
    return dqrw, dqrr, dk_cur, dv_cur, drk


def xl_attn_bwd_v2_plain(qrw, qrr, k_mem, v_mem, k_cur, v_cur, rk, m, l, o,
                         do, count, reset, same_length: bool, *,
                         seed: int = 0, rate: float = 0.0):
    """Plain PyTorch version of :func:`xl_attn_bwd_v2`: P from m and l, the
    forward's dropout mask, dS = P (dP - D) with D = rowsum(do * o), dS and
    P_drop rounded to the compute type before the products; dqrr and drk
    through the transpose of the relative window, dW[i, q-1-i+j] = dS[i, j]."""
    H, B, q, dh = qrw.shape
    M = k_mem.shape[2]
    klen, KP = M + q, M + 2 * q
    cd, acc = qrw.dtype, _acc(qrw.dtype)
    v = torch.cat([v_mem, v_cur], dim=2).to(acc)
    k = torch.cat([k_mem, k_cur], dim=2).to(acc)
    s = _v2_scores(qrw, qrr, k_mem, k_cur, rk, count, reset, same_length)
    p = torch.exp(s - m.transpose(-1, -2).to(acc)) / l.transpose(-1, -2).to(acc)
    do = do.to(acc)
    dp = do @ v.transpose(-1, -2)
    p_drop = p
    if rate > 0.0:
        keep = keep_mask(seed, H * B, q, klen, rate, qrw.device).view(
            H, B, q, klen)
        p_drop = torch.where(keep, p / (1.0 - rate), 0.0)
        dp = torch.where(keep, dp / (1.0 - rate), 0.0)
    D = (do * o.to(acc)).sum(-1, keepdim=True)
    ds = (p * (dp - D)).to(cd).to(acc)
    dqrw = ds @ k
    dk_cur = ds[..., M:].transpose(-1, -2) @ qrw.to(acc)
    dv_cur = p_drop.to(cd).to(acc)[..., M:].transpose(-1, -2) @ do
    dw = torch.zeros((H, B, q, KP), dtype=acc, device=qrw.device)
    dw.scatter_(3, _bd_index(q, klen, qrw.device).expand(H, B, q, klen), ds)
    dqrr = dw @ rk.to(acc)[:, None]
    drk = torch.einsum("hbic,hbid->hcd", dw, qrr.to(acc))
    return (dqrw.to(qrw.dtype), dqrr.to(qrr.dtype), dk_cur.to(k_cur.dtype),
            dv_cur.to(v_cur.dtype), drk)


class XLAttnV2(torch.autograd.Function):
    """K1f forward, K1b backward. Inputs as :func:`xl_attn_fwd_v2`; returns
    o. No gradient for the memory (the JAX wrapper stop-gradients it), the
    count, the reset rows or the dropout seed."""

    @staticmethod
    def forward(ctx, qrw, qrr, k_mem, v_mem, k_cur, v_cur, rk, count, reset,
                seed, rate, same_length):
        o, m, l = xl_attn_fwd_v2(qrw, qrr, k_mem, v_mem, k_cur, v_cur, rk,
                                 count, reset, same_length, seed=seed,
                                 rate=rate)
        ctx.save_for_backward(qrw, qrr, k_mem, v_mem, k_cur, v_cur, rk, m, l,
                              o)
        ctx.args = (count, reset, same_length, seed, rate)
        return o

    @staticmethod
    def backward(ctx, do):
        qrw, qrr, k_mem, v_mem, k_cur, v_cur, rk, m, l, o = ctx.saved_tensors
        count, reset, same_length, seed, rate = ctx.args
        dqrw, dqrr, dk_cur, dv_cur, drk = xl_attn_bwd_v2(
            qrw, qrr, k_mem, v_mem, k_cur, v_cur, rk, m, l, o, do, count,
            reset, same_length, seed=seed, rate=rate)
        return (dqrw, dqrr, None, None, dk_cur, dv_cur, drk.to(rk.dtype),
                None, None, None, None, None)


def rel_attention_kv_fused_v2(w, k_mem, v_mem, r, qkv_w, r_w, r_w_bias,
                              r_r_bias, attn_count, reset_rows, n_head: int,
                              d_head: int, *, same_length: bool,
                              dropatt: float = 0.0, seed: int | None = None):
    """Contract of ``pallas_attention_v2.rel_attention_kv_fused_v2``:
    k_mem/v_mem in the h-major storage layout [h, b, M, dh], detached.
    Attention dropout at ``dropatt`` applies when a ``seed`` is given (the
    JAX contract's ``dropatt_rng``). Returns (attn_vec [q, b, h*dh],
    k_cur [h, b, q, dh], v_cur)."""
    qlen, bsz = w.shape[0], w.shape[1]
    klen = k_mem.shape[2] + qlen
    scale = 1.0 / (d_head ** 0.5)
    rate = dropatt if seed is not None else 0.0

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
    o = XLAttnV2.apply(qrw.contiguous(), qrr.contiguous(),
                       k_mem.detach().contiguous(), v_mem.detach().contiguous(),
                       k_cur, v_cur, rk.contiguous(), int(attn_count),
                       reset_rows, int(seed or 0), float(rate), same_length)
    attn_vec = o.permute(2, 1, 0, 3).reshape(qlen, bsz, n_head * d_head)
    return attn_vec.to(w.dtype), k_cur, v_cur


# ---------------------------------------------------------------------------
# K2f / K2b: position term precomputed (pallas_attention)
# ---------------------------------------------------------------------------

def _v1_scores(q, k, bd, count, reset, scale, same_length):
    qlen = q.shape[1]
    M = k.shape[1] - qlen
    acc = _acc(q.dtype)
    s = (q.to(acc) @ k.to(acc).transpose(-1, -2) + bd.to(acc)) * scale
    mask = build_attn_mask(qlen, M, count, same_length, reset, q.device)
    return s.masked_fill(mask, NEG)


def xl_attn_fwd_v1(q, k, v, bd, count, reset, scale: float,
                   same_length: bool, *, seed: int = 0, rate: float = 0.0):
    """q: [BH, qlen, dh] (q + r_w_bias); k, v: [BH, klen, dh] (memory then
    current); bd: [BH, qlen, klen] (relative shift applied); reset: [BH] or
    None. Returns (o [BH, qlen, dh] fp32, m [BH, 1, qlen], l [BH, 1, qlen])."""
    count = int(count)
    if not q.is_cuda:
        return xl_attn_fwd_v1_plain(q, k, v, bd, count, reset, scale,
                                    same_length, seed=seed, rate=rate)
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
        int(same_length), int(seed), dropout_threshold(rate), float(rate),
        _native.stream_ptr(dev))
    _native.check(rc, "xl_attn_fwd_v1")
    _native.count_launch("xl_attn_fwd_v1")
    return o, m, l


def xl_attn_fwd_v1_plain(q, k, v, bd, count, reset, scale: float,
                         same_length: bool, *, seed: int = 0,
                         rate: float = 0.0):
    """Plain PyTorch version of :func:`xl_attn_fwd_v1` (normalised P,
    dropped and keep-scaled, rounded to the value type before P V, as the
    TPU kernel does)."""
    BH, qlen, dh = q.shape
    acc = _acc(q.dtype)
    s = _v1_scores(q, k, bd, count, reset, scale, same_length)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    p = p / l
    if rate > 0.0:
        keep = keep_mask(seed, BH, qlen, k.shape[1], rate, q.device)
        p = torch.where(keep, p / (1.0 - rate), 0.0)
    o = p.to(v.dtype).to(acc) @ v.to(acc)
    return o, m.transpose(-1, -2), l.transpose(-1, -2)


def xl_attn_bwd_v1(q, k, v, bd, m, l, o, do, count, reset, scale: float,
                   same_length: bool, *, seed: int = 0, rate: float = 0.0):
    """K2b: gradients of :func:`xl_attn_fwd_v1`'s ``o`` given ``do``
    [BH, qlen, dh]. Returns (dq, dk, dv, dbd) in the input types; dk, dv
    cover every key (memory included), dbd = dS * scale."""
    count = int(count)
    if not q.is_cuda:
        return xl_attn_bwd_v1_plain(q, k, v, bd, m, l, o, do, count, reset,
                                    scale, same_length, seed=seed, rate=rate)
    BH, qlen, dh = q.shape
    klen = k.shape[1]
    M = klen - qlen
    dev = q.device
    _check_cuda("xl_attn_bwd_v1", q.dtype, dev, q=q, k=k, v=v, bd=bd)
    if k.shape != (BH, klen, dh) or v.shape != k.shape or \
            bd.shape != (BH, qlen, klen):
        raise ValueError("xl_attn_bwd_v1: inconsistent shapes")
    m, l, o, do = _f32(m), _f32(l), _f32(o), _f32(do)
    _check_cuda("xl_attn_bwd_v1", torch.float32, dev, m=m, l=l, o=o, do=do)
    reset_bh = _reset_i32(reset, BH, dev)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbd = torch.zeros_like(bd)  # score tiles the kernel skips stay 0
    cur = M * dh * k.element_size()
    _launch_bwd("xl_attn_bwd_v1", dev, qrw=q, kmem=k, vmem=v,
                kcur=k.data_ptr() + cur, vcur=v.data_ptr() + cur, bd=bd,
                reset=reset_bh, m=m, l=l, o=o, dout=do, dq=dq, dk=dk, dv=dv,
                dbd=dbd, mem_bh=klen * dh, cur_bh=klen * dh,
                dtype=_native.dtype_code(q.dtype), bd_in=1, BH=BH, B=1, q=qlen,
                M=M, dh=dh, count=count, same_length=int(same_length),
                n_split=1, seed=int(seed), thr=dropout_threshold(rate),
                scale=float(scale), rate=float(rate))
    return dq, dk, dv, dbd


def xl_attn_bwd_v1_plain(q, k, v, bd, m, l, o, do, count, reset,
                         scale: float, same_length: bool, *, seed: int = 0,
                         rate: float = 0.0):
    """Plain PyTorch version of :func:`xl_attn_bwd_v1` (the TPU kernel's
    formulas, with D = rowsum(do * o); dbd = dS * scale rounded to the
    compute type feeds dq and dk)."""
    BH, qlen, dh = q.shape
    cd, acc = k.dtype, _acc(q.dtype)
    s = _v1_scores(q, k, bd, count, reset, scale, same_length)
    p = torch.exp(s - m.transpose(-1, -2).to(acc)) / l.transpose(-1, -2).to(acc)
    do = do.to(acc)
    dp = do @ v.to(acc).transpose(-1, -2)
    p_drop = p
    if rate > 0.0:
        keep = keep_mask(seed, BH, qlen, k.shape[1], rate, q.device)
        p_drop = torch.where(keep, p / (1.0 - rate), 0.0)
        dp = torch.where(keep, dp / (1.0 - rate), 0.0)
    D = (do * o.to(acc)).sum(-1, keepdim=True)
    dbd = (p * (dp - D) * scale).to(cd)
    dbd_a = dbd.to(acc)
    dq = dbd_a @ k.to(acc)
    dk = dbd_a.transpose(-1, -2) @ q.to(acc)
    dv = p_drop.to(cd).to(acc).transpose(-1, -2) @ do
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbd.to(bd.dtype)


class XLAttnV1(torch.autograd.Function):
    """K2f forward, K2b backward. Inputs as :func:`xl_attn_fwd_v1`; returns
    o. No gradient for the count, the reset rows or the dropout seed."""

    @staticmethod
    def forward(ctx, q, k, v, bd, count, reset, scale, same_length, seed,
                rate):
        o, m, l = xl_attn_fwd_v1(q, k, v, bd, count, reset, scale,
                                 same_length, seed=seed, rate=rate)
        ctx.save_for_backward(q, k, v, bd, m, l, o)
        ctx.args = (count, reset, scale, same_length, seed, rate)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bd, m, l, o = ctx.saved_tensors
        count, reset, scale, same_length, seed, rate = ctx.args
        dq, dk, dv, dbd = xl_attn_bwd_v1(q, k, v, bd, m, l, o, do, count,
                                         reset, scale, same_length,
                                         seed=seed, rate=rate)
        return dq, dk, dv, dbd, None, None, None, None, None, None


def rel_attention_kv_fused(w, k_mem, v_mem, r, qkv_w, r_w, r_w_bias,
                           r_r_bias, attn_count, reset_rows, n_head: int,
                           d_head: int, *, same_length: bool,
                           dropatt: float = 0.0, seed: int | None = None):
    """Contract of ``pallas_attention.rel_attention_kv_fused``; dropout as
    in :func:`rel_attention_kv_fused_v2`. Returns (attn_vec [q, b, h*dh],
    k_cur [h, b, q, dh], v_cur)."""
    qlen, bsz = w.shape[0], w.shape[1]
    klen = k_mem.shape[2] + qlen
    scale = 1.0 / (d_head ** 0.5)
    rate = dropatt if seed is not None else 0.0

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
    o = XLAttnV1.apply(
        q_rw.reshape(BH, qlen, d_head).contiguous(),
        k.reshape(BH, klen, d_head).contiguous(),
        v.reshape(BH, klen, d_head).contiguous(),
        bd.reshape(BH, qlen, klen).contiguous(), int(attn_count), reset,
        scale, same_length, int(seed or 0), float(rate))
    attn_vec = o.reshape(bsz, n_head, qlen, d_head).permute(2, 0, 1, 3)
    attn_vec = attn_vec.reshape(qlen, bsz, n_head * d_head)
    return (attn_vec.to(w.dtype), k_cur.transpose(0, 1),
            v_cur.transpose(0, 1))
