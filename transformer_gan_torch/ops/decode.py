"""The GAN's gumbel straight-through sampler on Hopper (``csrc/decode.cu``).

``fused_decode_chunk`` (K4) replaces ``pallas_decode.fused_decode_chunk``:
``n`` tokens of one sampling chunk in one call, each one embed -> all layers
against the big K/V cache plus the staged ring -> logits ->
argmax(logits + g) -> the id fed back, its one-hot row written out.
``fused_decode_step`` (K5) replaces ``pallas_decode.fused_decode_step``: one
token at chunk step ``t`` with the staged ring passed in and out. The
forward value of the straight-through gumbel-softmax is that one-hot, and
the temperature does not move the argmax, so neither takes it.

Operands follow the JAX contract except that the big K/V cache comes in,
and the chunk's staged K/V rows go out, in the XL memory's h-major layout
(``XLMems.hids`` [L, 2, H, B, M, dh]), as for the generation sampler
(``ops/generate.py``). Positions follow the distance rule of
``models/xl.decode_chunk_step`` (``same_length`` False, the GAN window).

On a CUDA tensor a wrapper launches its kernel chain or raises; on a CPU
tensor it runs its plain version, which is also what the card holds the
kernels against. The gumbel noise ``g`` is an input (``models/gan.gumbel``).
bf16 runs the split-key, lane-tiled chain of ``csrc/decode_chain_tc.cuh``
and fp32 the reference chain, as for the generation sampler; the plain
versions take the bf16 kernel's ``splits``
(``ops/generate.decode_attention_plain``).
"""
from __future__ import annotations

import ctypes
import os

import torch

from .. import _native
from ..models.attention import layer_norm
from ..utils import spans
from .generate import (_STACKED, _STACKED_F32, GenArgs, _layer_keys,
                       chain_lib, chain_tc_operands, decode_attention_plain)

MAX_CHUNK = 32


def supports_fused_decode(cfg, C: int) -> bool:
    """Features the kernels implement: the K/V-cached memory, chunks of at
    most ``MAX_CHUNK`` tokens, no note-status inputs. Any batch width."""
    return cfg.cache_kv and 1 <= C <= MAX_CHUNK and not cfg.append_note_status


def chunk_sampler_enabled() -> bool:
    """The whole-chunk sampler (K4) unless ``TGTPU_CHUNK_SAMPLER=0`` asks
    for the per-token route (K5), as in the JAX package."""
    return os.environ.get("TGTPU_CHUNK_SAMPLER") != "0"


def _launch(entry: str, stacked, cfg, kv, R, staged, ids, g, count: int,
            t0: int, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Run ``n`` tokens from chunk step ``t0`` into ``staged`` (in place).
    Returns (ids [B] int32, one-hots [n, B, V] fp32)."""
    L, _, H, B, M, dh = kv.shape
    HD, V, C = H * dh, g.shape[-1], staged.shape[4]
    dev, cd = kv.device, kv.dtype
    if not supports_fused_decode(cfg, C):
        raise ValueError(f"{entry}: unsupported (chunk {C})")
    if (kv.shape[1] != 2 or R.shape != (L, M + 1, HD)
            or staged.shape != (L, 2, H, B, C, dh) or g.shape != (n, B, V)
            or H != cfg.n_head or dh != cfg.d_head or V != cfg.n_token
            or L != cfg.n_layer or not 0 <= t0 <= C - n):
        raise ValueError(f"{entry}: inconsistent shapes")
    tensors = {"kv": kv, "R": R, "staged": staged}
    tensors.update({k: stacked[k] for k in _STACKED})
    for name, t in tensors.items():
        if t.device != dev or t.dtype != cd or not t.is_contiguous():
            raise ValueError(f"{entry}: {name} must be a contiguous {cd} "
                             f"tensor on {dev}")
    for name in _STACKED_F32:
        t = stacked[name]
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{entry}: {name} must be a contiguous float32 "
                             f"tensor on {dev}")
    tc, _keep = (chain_tc_operands(stacked, R, B, H, M, C, dev)
                 if cd == torch.bfloat16 else ({}, []))
    g = g.to(device=dev, dtype=torch.float32).contiguous()
    ids_io = ids.reshape(B).to(device=dev, dtype=torch.int32).clone()
    onehot = torch.empty((n, B, V), dtype=torch.float32, device=dev)

    def scratch(width):
        return torch.empty((B, width), dtype=cd, device=dev)

    bufs = {"x": scratch(HD), "w_in": scratch(HD), "q": scratch(HD),
            "ctx": scratch(HD), "attn": scratch(HD), "out": scratch(HD),
            "hid": scratch(cfg.d_inner), "ff": scratch(HD),
            "logits": scratch(V)}
    p = _native.ptr
    args = GenArgs(
        dtype=_native.dtype_code(cd), n=n, L=L, B=B, M=M, HD=HD,
        DI=cfg.d_inner, H=cfg.n_head, V=V, pre_lnorm=int(cfg.pre_lnorm),
        same_length=0, technique=0, topk=0, exclude_bos=0, num_empty=0,
        empty_token=0, count=int(count), t0=int(t0), C=C,
        scale=1.0 / (cfg.d_head ** 0.5), temperature=1.0,
        kv=p(kv), R=p(R), q_w=p(stacked["q_w"]), k_w=p(stacked["k_w"]),
        v_w=p(stacked["v_w"]), o_w=p(stacked["o_w"]), ff1=p(stacked["ff1"]),
        fb1=p(stacked["fb1"]), ff2=p(stacked["ff2"]), fb2=p(stacked["fb2"]),
        ln_as=p(stacked["ln_as"]), ln_ab=p(stacked["ln_ab"]),
        ln_fs=p(stacked["ln_fs"]), ln_fb=p(stacked["ln_fb"]),
        rwb=p(stacked["rwb"]), rrb=p(stacked["rrb"]),
        emb=p(stacked["emb_scaled"]), emb_t=p(stacked["emb_t"]),
        crit_bias=p(stacked["crit_bias"]), g=p(g), ids=p(ids_io), er=None,
        tokens=None, staged=p(staged), logits_out=None, onehot=p(onehot),
        **{k: p(v) for k, v in bufs.items()},
        **tc)
    lib = chain_lib()
    rc = getattr(lib, "tg_" + entry)(ctypes.byref(args), _native.stream_ptr(dev))
    _native.check(rc, entry)
    _native.count_launch(entry)
    if cd == torch.bfloat16:
        _native.count_launch(entry + "_tc")
        if tc["lane_group"]:
            _native.count_launch(entry + "_grouped")
    return ids_io, onehot


@spans.spanned("k4")
def fused_decode_chunk(stacked, cfg, kv, R, ids, g, count: int, n: int):
    """K4: sample ``n`` tokens of a chunk.

    kv: [L, 2, H, B, M, dh] big K/V cache (compute type); R: [L, M+1, HD]
    positional projections (row r = distance M - r); ids: [B, 1] int32 seed
    token; g: [n, B, V] fp32 gumbel noise; count: valid cache slots at the
    chunk start. Returns (ids' [B, 1] int32, one-hots [n, B, V] fp32,
    staged [L, 2, H, B, n, dh], the chunk's K/V rows)."""
    if not kv.is_cuda:
        return fused_decode_chunk_plain(stacked, cfg, kv, R, ids, g, count, n)
    L, _, H, B, _, dh = kv.shape
    staged = torch.zeros((L, 2, H, B, n, dh), dtype=kv.dtype, device=kv.device)
    ids_io, onehot = _launch("decode_chunk", stacked, cfg, kv, R, staged, ids,
                             g, count, 0, n)
    return ids_io.view(B, 1), onehot, staged


@spans.spanned("k5")
def fused_decode_step(stacked, cfg, kv, R, staged, ids, g, t: int, count: int):
    """K5: the token at chunk step ``t``. staged: [L, 2, H, B, C, dh], rows
    0 .. t-1 the chunk's earlier tokens; row ``t`` is written in place.
    g: [B, V]. Returns (ids' [B, 1] int32, one-hot [B, V] fp32, staged)."""
    if not kv.is_cuda:
        return fused_decode_step_plain(stacked, cfg, kv, R, staged, ids, g,
                                       t, count)
    B = kv.shape[3]
    ids_io, onehot = _launch("decode_step", stacked, cfg, kv, R, staged, ids,
                             g[None], count, t, 1)
    return ids_io.view(B, 1), onehot[0], staged


@torch.no_grad()
def fused_decode_step_plain(stacked, cfg, kv, R, staged, ids, g, t: int,
                            count: int, splits: int | None = None):
    """Plain PyTorch version of :func:`fused_decode_step` on the same
    operands, rounding where the kernel rounds (the bf16 chain with the
    kernel's ``splits``)."""
    L, _, H, B, M, dh = kv.shape
    dev = kv.device
    scale = 1.0 / (dh ** 0.5)
    jlo = min(M, max(M - int(count), t))
    # unmasked keys: big slots jlo..M-1, staged slots 0..t; R rows by
    # distance (big slot j -> row j - t, staged slot s -> row M - t + s)
    rows = torch.cat([torch.arange(jlo, M, device=dev) - t,
                      M - t + torch.arange(t + 1, device=dev)])
    nk = rows.numel()
    x = stacked["emb_scaled"][ids.reshape(B).long()]              # [B, HD]
    for l in range(L):
        if cfg.pre_lnorm:
            w_in = layer_norm(x, stacked["ln_as"][l], stacked["ln_ab"][l])
        else:
            w_in = x
        q = w_in @ stacked["q_w"][l]
        for i, w in enumerate((stacked["k_w"][l], stacked["v_w"][l])):
            staged[l, i, :, :, t] = (w_in @ w).view(B, H, dh).transpose(0, 1)
        qw = (q + stacked["rwb"]).view(B, H, dh)
        qr = (q + stacked["rrb"]).view(B, H, dh)
        keys, vals = _layer_keys(kv[l], staged[l], jlo, t)
        ctx = decode_attention_plain(keys, vals, R[l][rows].view(nk, H, dh),
                                     qw, qr, scale, splits)
        attn = ctx @ stacked["o_w"][l]
        if cfg.pre_lnorm:
            out = x + attn
            ff_in = layer_norm(out, stacked["ln_fs"][l], stacked["ln_fb"][l])
        else:
            out = layer_norm(x + attn, stacked["ln_as"][l], stacked["ln_ab"][l])
            ff_in = out
        hid = torch.relu(ff_in @ stacked["ff1"][l] + stacked["fb1"][l])
        ff = hid @ stacked["ff2"][l] + stacked["fb2"][l]
        if cfg.pre_lnorm:
            x = out + ff
        else:
            x = layer_norm(out + ff, stacked["ln_fs"][l], stacked["ln_fb"][l])
    logits = x @ stacked["emb_t"] + stacked["crit_bias"]          # [B, V]
    tok = torch.argmax(logits.float() + g.to(dev), dim=-1)        # first max
    onehot = torch.nn.functional.one_hot(tok, logits.shape[-1]).float()
    return tok.to(torch.int32).view(B, 1), onehot, staged


def fused_decode_chunk_plain(stacked, cfg, kv, R, ids, g, count: int, n: int,
                             splits: int | None = None):
    """Plain PyTorch version of :func:`fused_decode_chunk`: the plain step
    over the chunk."""
    L, _, H, B, _, dh = kv.shape
    staged = torch.zeros((L, 2, H, B, n, dh), dtype=kv.dtype, device=kv.device)
    onehots = []
    for t in range(n):
        ids, oh, staged = fused_decode_step_plain(stacked, cfg, kv, R, staged,
                                                  ids, g[t], t, count, splits)
        onehots.append(oh)
    return ids, torch.stack(onehots), staged
