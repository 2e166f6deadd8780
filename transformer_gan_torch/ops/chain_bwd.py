"""The reverse straight-through chain of the full-backprop gen phase on
Hopper (``csrc/chain_bwd.cu``).

With ``truncate_backprop`` False each sampled chunk's logits cotangents Q
come from a reverse loop over its tokens that carries only the input
cotangent chi [B, V] (``models/gan._ChunkSTFullchain``). Per token t:
q_t = y_t * (m - <m, y_t>) / T with m = s_t + chi; then dx back through the
L layers (feed-forward, the two layer norms and attention, where every
cross K/V lane is constant and only the token's own lane is live) and the
embedding gives chi for token t - 1.

* ``chain_bwd_q_res`` (K6) replaces ``pallas_chain_bwd.chain_bwd_q_res``:
  it reads the window pass's residuals (x, z1, z2, ff_pre, prob);
* ``chain_bwd_q`` (K7) replaces ``pallas_chain_bwd.chain_bwd_q``: it
  recomputes each token's forward from its input id.

Both share one plain version, :func:`chain_bwd_q_plain`, the reverse loop
of single-position VJPs through ``xl.decode_recompute_window`` (the JAX
package's ``_chain_q_jnp``). On a CUDA tensor a wrapper launches its
kernel chain or raises; on a CPU tensor it runs the plain version.

fp32 runs the CUDA-core chain of ``csrc/chain_bwd.cu``, the exact on-card
reference. bf16 runs ``csrc/chain_bwd_tc.cu``: lane-tiled tensor-core GEMVs
(the engine of ``csrc/decode_chain_tc.cuh``) on the padded weights as
stored that ``stack_decode_params`` adds in bf16, st_bwd in the head GEMV's
prologue, the LayerNorm backwards in row kernels of their own, and the
token's query from the window pass
(``res["q"]``; K7 from its own forward). Its launches count under the
plain names and under ``chain_bwd_res_tc`` / ``chain_bwd_recompute_tc``.

Operands: params, the generator's parameter dict; kf, vf [L, H, B, M+n, dh]
the window's full lane buffers [memory || window K/V]; inputs [n, B, V] the
one-hots each step saw; S [n, B, V] fp32 straight-through cotangents;
Y [n, B, V] fp32 softmax outputs; count the valid memory slots at the
window start. Returns Q [n, B, V] fp32.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _native
from ..models import xl
from ..utils import spans
from .decode_params import K_ALIGN, N_ALIGN, stack_decode_params
from .generate import r_heads_major

# the bf16 chain's largest d_head and widest row op (d_model, vocab):
# kChainMaxDh and kRowMax of csrc/chain_bwd_tc.cu (chain_lib checks them)
MAX_DHEAD = 64
MAX_ROW = 512
# the bf16 chain's operands from stack_decode_params: the backward products'
# padded weights, and K7's forward W^T copies
_TC_WEIGHTS = ("qkv_bwd", "o_bwd", "ff1_bwd", "ff2_bwd", "emb_t_bwd",
               "emb_bwd")
_TC_FORWARD = ("qkv_t", "o_t", "ff1_t", "ff2_t")


def _softmax_st_bwd(S_t, Y_t, chi, temperature) -> torch.Tensor:
    m = S_t + chi
    return Y_t * (m - (m * Y_t).sum(-1, keepdim=True)) / temperature


def chain_bwd_q_plain(params, cfg, kf, vf, inputs, S, Y, count: int,
                      temperature) -> torch.Tensor:
    """The reverse chain as a loop of single-position VJPs: token t's
    logits as a function of its input one-hot, over lanes t .. t+M-1 of the
    full lane buffers with count min(count + t, M)."""
    n, bsz, V = Y.shape
    M = kf.shape[3] - n
    params = {k: v.detach() for k, v in params.items()}
    chi = torch.zeros((bsz, V), dtype=torch.float32, device=Y.device)
    Q = torch.empty((n, bsz, V), dtype=torch.float32, device=Y.device)
    for t in range(n - 1, -1, -1):
        q = _softmax_st_bwd(S[t].float(), Y[t].float(), chi, temperature)
        Q[t] = q
        if t == 0:
            break  # chi of the token before the chunk is not needed
        x = inputs[t].detach().float().requires_grad_(True)
        with torch.enable_grad():
            lg = xl.decode_recompute_window(
                params, cfg, x[None], kf[:, :, :, t:t + M],
                vf[:, :, :, t:t + M], min(int(count) + t, M))[0][0]
            (chi,) = torch.autograd.grad(lg, x, grad_outputs=q.to(lg.dtype))
        chi = chi.float()
    return Q


class ChainArgs(ctypes.Structure):
    """Mirror of ``struct ChainArgs`` in csrc/chain_args.cuh."""

    _fields_ = (
        [(k, ctypes.c_int) for k in (
            "dtype", "n", "L", "B", "M", "HD", "DI", "H", "V", "pre_lnorm",
            "count", "recompute")]
        + [("scale", ctypes.c_float), ("temperature", ctypes.c_float)]
        + [(k, ctypes.c_void_p) for k in (
            "kf", "vf", "R", "q_w", "k_w", "v_w", "o_w", "ff1", "fb1", "ff2",
            "fb2", "ln_as", "ln_ab", "ln_fs", "ln_fb", "rwb", "rrb", "emb",
            "emb_t", "S", "Y", "ids", "res_x", "res_z1", "res_z2", "res_ff",
            "res_prob", "Q", "chi", "dx", "dz2", "dz1", "dff", "dffin", "dctx",
            "dq", "dk", "dv", "dwin", "q", "w_in", "x", "ctx", "attn", "out",
            "hid", "ff") + _TC_WEIGHTS + _TC_FORWARD + (
            "R_h", "res_q", "dx_h", "dz_h", "dff_h", "dctx_h", "dqkv_h")])


def chain_lib() -> ctypes.CDLL:
    """The kernel library, checked against this side of the reverse
    chain's contract: the ``ChainArgs`` layout, and the bf16 chain's operand
    padding, largest d_head and widest row as ``csrc/chain_bwd_tc.cu`` fixes
    them (``tg_chain_bwd_layout``)."""
    lib = _native.lib()
    if ctypes.sizeof(ChainArgs) != lib.tg_sizeof_chain_args():
        raise RuntimeError("ChainArgs layout differs from csrc/chain_args.cuh")
    got = (ctypes.c_int * 4)()
    lib.tg_chain_bwd_layout(got)
    want = (K_ALIGN, N_ALIGN, MAX_DHEAD, MAX_ROW)
    if tuple(got) != want:
        raise RuntimeError(
            f"bf16 reverse chain layout (K align, N align, max d_head, max "
            f"row): library {tuple(got)}, Python {want}")
    return lib


def chain_design(dtype) -> str:
    """Which reverse chain a dtype runs on the card."""
    if dtype == torch.bfloat16:
        return ("bf16 chain (chain_bwd_tc.cu): lane-tiled mma.sync GEMVs on "
                "the weights as stored, st_bwd in the head GEMV's prologue, "
                "the LayerNorm backwards in row kernels, one [dq|dk|dv] "
                "product, the query from the window pass; 7 launches a layer "
                "+ 2 a token (K7: + 5 a layer for the forward)")
    return "fp32 chain (chain_bwd.cu), the exact on-card reference"


_STACKED_T = ("q_w", "k_w", "v_w", "o_w", "ff1", "fb1", "ff2", "fb2", "rwb",
              "rrb", "emb_scaled", "emb_t")


def _launch(name: str, params, cfg, kf, vf, S, Y, count: int, temperature,
            ids=None, res=None, stacked=None, R=None) -> torch.Tensor:
    L, H, B, KL, dh = kf.shape
    n, _, V = S.shape
    M, HD, DI = KL - n, H * dh, cfg.d_inner
    dev, cd = kf.device, kf.dtype
    tc = cd == torch.bfloat16
    if (vf.shape != kf.shape or S.shape != (n, B, V) or Y.shape != S.shape
            or H != cfg.n_head or dh != cfg.d_head or L != cfg.n_layer
            or V != cfg.n_token or not 1 <= n <= M or dh > 128):
        raise ValueError(f"{name}: inconsistent shapes")
    if tc and (dh % 2 or dh > MAX_DHEAD or HD > MAX_ROW or V > MAX_ROW
               or DI % 2):
        raise ValueError(f"{name}: the bf16 chain takes an even d_head <= "
                         f"{MAX_DHEAD}, d_model and vocab <= {MAX_ROW} and an "
                         f"even d_inner, got {dh}, {HD}, {V}, {DI}")
    detached = None
    if stacked is None or R is None:
        detached = {k: v.detach() for k, v in params.items()}
    if stacked is None:
        stacked = stack_decode_params(detached, cfg)
    if R is None:
        R = xl.precompute_r_heads(detached, cfg, M + 1, dev).reshape(
            L, M + 1, HD).to(cd).contiguous()
    if R.shape != (L, M + 1, HD):
        raise ValueError(f"{name}: R must be [L, M + 1, HD], got "
                         f"{tuple(R.shape)}")
    tensors = {"kf": kf, "vf": vf, "R": R}
    tensors.update({k: stacked[k] for k in _STACKED_T})
    if tc:
        for key in _TC_WEIGHTS + (_TC_FORWARD if ids is not None else ()):
            if key not in stacked:
                raise ValueError(f"{name}: stacked has no {key} "
                                 "(stack_decode_params builds it in bf16)")
            tensors[key] = stacked[key]
    if res is not None:
        keys = ("x", "z1", "z2", "ff_pre") + (("q",) if tc else ())
        res = {k: (v.float() if k == "prob" else v.to(cd)).contiguous()
               for k, v in res.items()}
        tensors.update({k: res[k] for k in keys})
    for key, t in tensors.items():
        if t.device != dev or t.dtype != cd or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be a contiguous {cd} tensor "
                             f"on {dev}")
    S = S.to(device=dev, dtype=torch.float32).contiguous()
    Y = Y.to(device=dev, dtype=torch.float32).contiguous()
    Q = torch.empty((n, B, V), dtype=torch.float32, device=dev)

    def f32(width):
        return torch.empty((B, width), dtype=torch.float32, device=dev)

    def cdt(*shape):
        return torch.empty(shape, dtype=cd, device=dev)

    bufs = {"chi": f32(V), "dx": f32(HD), "dz2": f32(HD), "dz1": f32(HD),
            "dffin": f32(HD), "dwin": f32(HD)}
    if tc:
        bufs.update(dx_h=cdt(B, HD), dz_h=cdt(B, HD), dff_h=cdt(B, DI),
                    dctx_h=cdt(B, HD), dqkv_h=cdt(B, 3 * HD),
                    R_h=r_heads_major(R, H))
    else:
        bufs.update(dff=f32(DI), dctx=f32(HD), dq=f32(HD), dk=f32(HD),
                    dv=f32(HD), q=cdt(B, HD), w_in=cdt(B, HD))
    if ids is not None:
        # the recomputed forward's activations of one token, laid out as the
        # residuals with n = 1
        bufs.update(ctx=cdt(B, HD), out=cdt(B, HD), hid=cdt(B, DI))
        if not tc:
            bufs.update(x=cdt(B, HD), attn=cdt(B, HD), ff=cdt(B, HD))
        res_ptrs = {"res_x": cdt(L, 1, B, HD), "res_z1": cdt(L, 1, B, HD),
                    "res_z2": cdt(L, 1, B, HD), "res_ff": cdt(L, 1, B, DI),
                    "res_prob": torch.empty((L, B, H, 1, KL),
                                            dtype=torch.float32, device=dev)}
        if tc:
            res_ptrs["res_q"] = cdt(L, 1, B, HD)
        ids = ids.to(device=dev, dtype=torch.int32).contiguous()
    else:
        res_ptrs = {"res_x": res["x"], "res_z1": res["z1"], "res_z2": res["z2"],
                    "res_ff": res["ff_pre"], "res_prob": res["prob"]}
        if tc:
            res_ptrs["res_q"] = res["q"]
    p = _native.ptr
    fields = {k: p(v) for k, v in bufs.items()}
    fields.update({k: p(v) for k, v in res_ptrs.items()})
    if tc:
        fields.update({k: p(tensors[k]) for k in _TC_WEIGHTS})
        if ids is not None:
            fields.update({k: p(tensors[k]) for k in _TC_FORWARD})
    args = ChainArgs(
        dtype=_native.dtype_code(cd), n=n, L=L, B=B, M=M, HD=HD, DI=DI,
        H=H, V=V, pre_lnorm=int(cfg.pre_lnorm), count=int(count),
        recompute=int(ids is not None), scale=1.0 / (dh ** 0.5),
        temperature=float(temperature), kf=p(kf), vf=p(vf), R=p(R),
        q_w=p(stacked["q_w"]), k_w=p(stacked["k_w"]), v_w=p(stacked["v_w"]),
        o_w=p(stacked["o_w"]), ff1=p(stacked["ff1"]), fb1=p(stacked["fb1"]),
        ff2=p(stacked["ff2"]), fb2=p(stacked["fb2"]),
        ln_as=p(stacked["ln_as"]), ln_ab=p(stacked["ln_ab"]),
        ln_fs=p(stacked["ln_fs"]), ln_fb=p(stacked["ln_fb"]),
        rwb=p(stacked["rwb"]), rrb=p(stacked["rrb"]),
        emb=p(stacked["emb_scaled"]), emb_t=p(stacked["emb_t"]), S=p(S),
        Y=p(Y), ids=p(ids), Q=p(Q), **fields)
    lib = chain_lib()
    rc = lib.tg_chain_bwd(ctypes.byref(args), _native.stream_ptr(dev))
    _native.check(rc, name)
    _native.count_launch(name)
    if tc:
        _native.count_launch(name + "_tc")
    return Q


@spans.spanned("k6")
def chain_bwd_q_res(params, cfg, kf, vf, inputs, S, Y, count: int,
                    temperature, res, stacked=None, R=None) -> torch.Tensor:
    """K6: the reverse chain on the window's residuals ``res`` (x, z1, z2
    [L, n, B, HD], ff_pre [L, n, B, DI], prob [L, B, H, n, M+n] fp32, and in
    bf16 q [L, n, B, HD], from
    ``xl.decode_recompute_window(collect_residuals=True)``). ``stacked``
    (``stack_decode_params``) and ``R`` ([L, M+1, HD] in the compute type,
    the sampler's) are built from ``params`` when not given."""
    if not kf.is_cuda:
        return chain_bwd_q_plain(params, cfg, kf, vf, inputs, S, Y, count,
                                 temperature)
    return _launch("chain_bwd_res", params, cfg, kf, vf, S, Y, count,
                   temperature, res=res, stacked=stacked, R=R)


@spans.spanned("k7")
def chain_bwd_q(params, cfg, kf, vf, inputs, S, Y, count: int, temperature,
                stacked=None, R=None) -> torch.Tensor:
    """K7: the reverse chain recomputing each token's forward from its
    input id (argmax of ``inputs``) against the lane buffers."""
    if not kf.is_cuda:
        return chain_bwd_q_plain(params, cfg, kf, vf, inputs, S, Y, count,
                                 temperature)
    return _launch("chain_bwd_recompute", params, cfg, kf, vf, S, Y, count,
                   temperature, ids=inputs.argmax(-1), stacked=stacked, R=R)
