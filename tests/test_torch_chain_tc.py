"""The bf16 reverse straight-through chain's decomposition (K6, K7 on
``csrc/chain_bwd_tc.cu``) on the CPU in fp32, at a small width (2 layers,
4 heads, d_model 64, d_inner 96, vocab 40, B 5 and 8, n 7, odd counts).

``staged_chain`` below takes the steps the card's chain takes, in the order
it takes them: st_bwd in the head product's prologue, every backward
product against the padded weight as stored (``chain_bwd_operands``) with
its input padded and its output sliced back, the LayerNorm backwards as the
row op computes them, the ReLU mask from ff_pre, one [dq | dk | dv] product,
the query from the window pass (K6) or from the token's own forward on the
forward W^T copies (K7). It is held against the plain chain
(``chain_bwd_q_plain``) and the JAX package's K6 / K7 in interpret mode
within rtol 1e-5, atol 1e-6 (fp32 sums in another order). The padded
operands, the query residual and the layout the library is checked against
are tested alone."""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_gan_torch import _native, convert
from transformer_gan_torch.models import xl as txl
from transformer_gan_torch.models.attention import layer_norm
from transformer_gan_torch.ops import chain_bwd as tchain
from transformer_gan_torch.ops import decode_params as tparams
from transformer_gan_torch.ops.generate import r_heads_major
from transformer_gan_tpu.models import xl as jxl
from transformer_gan_tpu.ops import pallas_chain_bwd as pchain
from transformer_gan_tpu.ops import pallas_decode as pdec

torch.set_num_threads(1)

BASE = dict(n_layer=2, n_head=4, d_model=64, d_inner=96, n_token=40,
            dropout=0.0, dropatt=0.0)
L, H, DH, V, DI = 2, 4, 16, 40, 96
HD = H * DH
M, N = 10, 7
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pdec, "INTERPRET", True)
    monkeypatch.setattr(pchain, "INTERPRET", True)


def _models(pre_lnorm):
    jcfg = jxl.XLConfig(cache_kv=True, use_pallas=True, pre_lnorm=pre_lnorm,
                        **BASE)
    tcfg = txl.XLConfig(pre_lnorm=pre_lnorm, **BASE)
    jp = jxl.init_xl_params(jcfg, seed=3, base_init=("normal", 0.1))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def _dense(a):
    """[H, B, K, dh] h-major -> the JAX kernels' [B, K, HD]."""
    Hn, B, K, dh = a.shape
    return np.ascontiguousarray(a.transpose(1, 2, 0, 3).reshape(B, K, Hn * dh))


class Case:
    """One chunk's operands: the window pass over n sampled one-hots after
    an M-slot memory (count valid), S and Y at temperature T, all from a
    numpy seed, on both sides."""

    def __init__(self, B, count, T, pre_lnorm, seed=0):
        self.jcfg, self.cfg, self.jp, self.tp = _models(pre_lnorm)
        rng = np.random.RandomState(seed + 10 * B + count)
        ids = rng.randint(2, V, (N, B))
        self.inputs = np.eye(V, dtype=np.float32)[ids]
        k_mem = rng.randn(L, H, B, M, DH).astype(np.float32)
        v_mem = rng.randn(L, H, B, M, DH).astype(np.float32)
        self.jout = jxl.decode_recompute_window(
            self.jp, self.jcfg, jnp.asarray(self.inputs),
            [jnp.asarray(a) for a in k_mem], [jnp.asarray(a) for a in v_mem],
            count, collect_residuals=True)
        logits, kf, vf, _, self.res = txl.decode_recompute_window(
            self.tp, self.cfg, torch.from_numpy(self.inputs),
            torch.from_numpy(k_mem), torch.from_numpy(v_mem), count,
            collect_residuals=True)
        self.kf, self.vf = torch.stack(kf), torch.stack(vf)
        u = rng.uniform(size=(N, B, V)).astype(np.float32)
        g = -np.log(-np.log(u + 1e-20) + 1e-20)
        self.Y = torch.softmax((logits.float() + torch.from_numpy(g)) / T, -1)
        self.S = torch.from_numpy(rng.randn(N, B, V).astype(np.float32))
        self.count, self.T, self.B = count, T, B

    def plain(self):
        return tchain.chain_bwd_q_plain(
            self.tp, self.cfg, self.kf, self.vf, torch.from_numpy(self.inputs),
            self.S, self.Y, self.count, self.T)

    def jax(self, variant):
        jl, jk, jv, _, jres = self.jout
        stacked = pdec.stack_decode_params(self.jp, self.jcfg)
        r_heads = jxl.precompute_r_heads(self.jp, self.jcfg, M + 1).reshape(
            L, M + 1, HD)
        kf = jnp.stack([jnp.asarray(_dense(np.asarray(a))) for a in jk])
        vf = jnp.stack([jnp.asarray(_dense(np.asarray(a))) for a in jv])
        S, Y = jnp.asarray(self.S.numpy()), jnp.asarray(self.Y.numpy())
        if variant == "res":
            q = pchain.chain_bwd_q_res(stacked, self.jcfg, kf, vf, r_heads, S,
                                       Y, self.count, self.T, jres)
        else:
            q = pchain.chain_bwd_q(
                stacked, self.jcfg, kf, vf, r_heads,
                jnp.asarray(self.inputs.argmax(-1), jnp.int32), S, Y,
                self.count, self.T)
        return np.asarray(q)

    def staged(self, variant):
        stacked = tparams.stack_decode_params(self.tp, self.cfg)
        R = txl.precompute_r_heads(self.tp, self.cfg, M + 1).reshape(
            L, M + 1, HD)
        ids = (torch.from_numpy(self.inputs.argmax(-1))
               if variant == "recompute" else None)
        return staged_chain(stacked, self.cfg, self.kf, self.vf, R, self.res,
                            self.S, self.Y, self.count, self.T, ids)


# ---------------------------------------------------------------------------
# The staged mirror of csrc/chain_bwd_tc.cu
# ---------------------------------------------------------------------------

def product(x, w_pad, n_out):
    """One backward product on the padded operand: x [B, K] zero-padded to
    the operand's kpad(K), times its rows, sliced back to n_out columns."""
    x = torch.nn.functional.pad(x, (0, w_pad.shape[-1] - x.shape[-1]))
    return (x @ w_pad.T)[:, :n_out]


def row_ln_bwd(dy, z, scale):
    """The row op's LayerNorm backward at the normalized sum z: g = dy
    scale, zh = (z - mean) rstd, (g - mean(g) - zh mean(g zh)) rstd."""
    c = z - z.mean(-1, keepdim=True)
    rstd = torch.rsqrt(c.square().mean(-1, keepdim=True) + 1e-5)
    g, zh = dy * scale, c * rstd
    return (g - g.mean(-1, keepdim=True)
            - zh * (g * zh).mean(-1, keepdim=True)) * rstd


def row_st_bwd(S, Y, chi, T):
    m = S + chi
    return (Y * (m - (m * Y).sum(-1, keepdim=True))) / T


def attn_bwd(prob, dctx, q, rwb, k, v, r_h, t, count, scale):
    """The attention block of token t: prob [B, H, KL]; k, v [H, B, KL, dh];
    r_h [H, M+1, dh]. Returns the [dq | dk_self | dv_self] row [B, 3 HD]."""
    B = dctx.shape[0]
    jlo = min(M, max(M - count, t))
    P = prob[:, :, jlo:M + t + 1]
    kl, vl = k[:, :, jlo:M + t + 1], v[:, :, jlo:M + t + 1]
    rl = r_h[:, jlo - t:M + 1]
    dc = dctx.view(B, H, DH)
    qw = (q + rwb).view(B, H, DH)
    dP = torch.einsum("bhd,hbkd->bhk", dc, vl)
    D = (dP * P).sum(-1, keepdim=True)
    dS = P * (dP - D) * scale
    dq = (torch.einsum("bhk,hbkd->bhd", dS, kl)
          + torch.einsum("bhk,hkd->bhd", dS, rl))
    dk = dS[..., -1:] * qw
    dv = P[..., -1:] * dc
    return torch.cat([a.reshape(B, HD) for a in (dq, dk, dv)], dim=-1)


def attn_fwd(q, rwb, rrb, k, v, r_h, t, count, scale):
    """K7's attention forward of token t: (ctx [B, HD], prob [B, H, KL])."""
    B, KL = q.shape[0], k.shape[2]
    jlo = min(M, max(M - count, t))
    kl, vl = k[:, :, jlo:M + t + 1], v[:, :, jlo:M + t + 1]
    rl = r_h[:, jlo - t:M + 1]
    qw, qr = (q + rwb).view(B, H, DH), (q + rrb).view(B, H, DH)
    s = (torch.einsum("bhd,hbkd->bhk", qw, kl)
         + torch.einsum("bhd,hkd->bhk", qr, rl)) * scale
    p = torch.softmax(s, -1)
    prob = torch.zeros((B, H, KL))
    prob[:, :, jlo:M + t + 1] = p
    ctx = torch.einsum("bhk,hbkd->bhd", p, vl).reshape(B, HD)
    return ctx, prob


def forward_token(st, cfg, ids_t, k, v, r_h, t, count, scale):
    """K7's forward of one token on the forward W^T copies (the q product
    over the first HD rows of qkv_t), keeping what the backward reads."""
    pre = cfg.pre_lnorm
    x = st["emb_scaled"][ids_t]
    res = {key: [] for key in ("x", "z1", "z2", "ff_pre", "prob", "q")}
    for l in range(L):
        w_in = layer_norm(x, st["ln_as"][l], st["ln_ab"][l]) if pre else x
        q = product(w_in, st["qkv_t"][l][:tparams.npad(HD)], HD)
        ctx, prob = attn_fwd(q, st["rwb"], st["rrb"], k[l], v[l], r_h[l], t,
                             count, scale)
        z1 = x + product(ctx, st["o_t"][l], HD)
        if pre:
            h1, ff_in = z1, layer_norm(z1, st["ln_fs"][l], st["ln_fb"][l])
        else:
            h1 = ff_in = layer_norm(z1, st["ln_as"][l], st["ln_ab"][l])
        ff_pre = product(ff_in, st["ff1_t"][l], DI) + st["fb1"][l]
        z2 = h1 + product(torch.relu(ff_pre), st["ff2_t"][l], HD) + st["fb2"][l]
        for key, val in (("x", x), ("z1", z1), ("z2", z2), ("ff_pre", ff_pre),
                         ("prob", prob), ("q", q)):
            res[key].append(val)
        x = z2 if pre else layer_norm(z2, st["ln_fs"][l], st["ln_fb"][l])
    return {key: torch.stack(val) for key, val in res.items()}


@torch.no_grad()
def staged_chain(stacked, cfg, kf, vf, R, res, S, Y, count, T, ids=None):
    """Q [n, B, V] by the bf16 chain's steps (fp32 here, where rounding is
    the identity): K6 on the window's residuals ``res``, or with ``ids`` K7
    on each token's own forward."""
    st = dict(stacked)
    st.update(tparams.chain_bwd_operands(stacked))
    if ids is not None:
        st.update(qkv_t=tparams.transpose_padded(torch.cat(
            [st["q_w"], st["k_w"], st["v_w"]], -1)),
            o_t=tparams.transpose_padded(st["o_w"]),
            ff1_t=tparams.transpose_padded(st["ff1"]),
            ff2_t=tparams.transpose_padded(st["ff2"]))
    pre = cfg.pre_lnorm
    n, B, _ = S.shape
    scale = 1.0 / DH ** 0.5
    r_h = r_heads_major(R, H)
    chi = torch.zeros((B, V))
    Q = torch.empty((n, B, V))
    for t in range(n - 1, -1, -1):
        Q[t] = row_st_bwd(S[t], Y[t], chi, T)   # the head product's prologue
        if t == 0:
            break
        if ids is None:
            r = {key: val[:, t] for key, val in res.items() if key != "prob"}
            r["prob"] = res["prob"][:, :, :, t]
        else:
            r = forward_token(st, cfg, ids[t], kf, vf, r_h, t, count, scale)
        dx = product(Q[t], st["emb_t_bwd"], HD)
        for l in range(L - 1, -1, -1):
            if pre:
                dz2 = dx
            else:
                dz2 = row_ln_bwd(dx, r["z2"][l], st["ln_fs"][l])
            dff = product(dz2, st["ff2_bwd"][l], DI) * (r["ff_pre"][l] > 0)
            dffin = product(dff, st["ff1_bwd"][l], HD)
            if pre:
                dz1 = dz2 + row_ln_bwd(dffin, r["z1"][l], st["ln_fs"][l])
            else:
                dz1 = row_ln_bwd(dz2 + dffin, r["z1"][l], st["ln_as"][l])
            dctx = product(dz1, st["o_bwd"][l], HD)
            dqkv = attn_bwd(r["prob"][l], dctx, r["q"][l], st["rwb"], kf[l],
                            vf[l], r_h[l], t, count, scale)
            dwin = product(dqkv, st["qkv_bwd"][l], HD)
            if pre:
                dx = dz1 + row_ln_bwd(dwin, r["x"][l], st["ln_as"][l])
            else:
                dx = dz1 + dwin
        chi = product(dx, st["emb_bwd"], V)
    return Q


# ---------------------------------------------------------------------------
# The mirror against the plain chain and the Pallas kernels
# ---------------------------------------------------------------------------

CASES = [
    (5, 5, 1.0, False),    # lanes not a multiple of 16, part of the memory
    (8, 3, 0.7, False),    # sharper softmax
    (8, 9, 1.0, True),     # pre-LN
    (5, 7, 0.7, True),     # pre-LN, 5 lanes
]


@pytest.mark.parametrize("variant", ["res", "recompute"])
@pytest.mark.parametrize("B,count,T,pre", CASES)
def test_staged_chain_matches_plain(variant, B, count, T, pre):
    case = Case(B, count, T, pre)
    np.testing.assert_allclose(case.staged(variant).numpy(),
                               case.plain().numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("variant", ["res", "recompute"])
@pytest.mark.parametrize("B,count,T,pre", CASES[1:3])
def test_staged_chain_matches_jax_kernel(variant, B, count, T, pre):
    case = Case(B, count, T, pre, seed=1)
    np.testing.assert_allclose(case.staged(variant).numpy(), case.jax(variant),
                               rtol=RTOL, atol=ATOL)


def test_staged_chain_reads_the_window_query():
    """K6 takes q from the window pass: a wrong residual q moves Q."""
    case = Case(8, 3, 1.0, False)
    good = case.staged("res")
    case.res["q"] = case.res["q"] * 1.01
    assert not torch.allclose(case.staged("res"), good, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# Operands, residuals, layout
# ---------------------------------------------------------------------------

def test_chain_bwd_operands_pad_the_weights_as_stored():
    cfg = txl.XLConfig(compute_dtype="bfloat16", **BASE)
    params = txl.init_xl_params(cfg, seed=0)
    st = tparams.stack_decode_params(params, cfg)
    qkv = torch.cat([st["q_w"], st["k_w"], st["v_w"]], -1)
    want = {"qkv_bwd": qkv, "o_bwd": st["o_w"], "ff1_bwd": st["ff1"],
            "ff2_bwd": st["ff2"], "emb_t_bwd": st["emb_t"],
            "emb_bwd": st["emb_scaled"]}
    for name, w in want.items():
        got = st[name]
        rows, cols = w.shape[-2:]
        assert got.dtype == torch.bfloat16 and got.is_contiguous(), name
        assert got.shape[-2:] == (tparams.npad(rows), tparams.kpad(cols)), name
        assert torch.equal(got[..., :rows, :cols], w), name
        assert not got[..., rows:, :].any() and not got[..., :, cols:].any(), name
    assert st["qkv_bwd"].shape == (L, 64, 192)
    assert st["emb_bwd"].shape == (40, 64)


def test_chain_bwd_operands_only_in_bf16():
    cfg = txl.XLConfig(**BASE)
    st = tparams.stack_decode_params(txl.init_xl_params(cfg, seed=0), cfg)
    assert not any(k.endswith("_bwd") for k in st)


@pytest.mark.parametrize("pre", [False, True])
def test_window_query_residual_is_the_recomputed_query(pre):
    case = Case(8, 3, 1.0, pre)
    st = tparams.stack_decode_params(case.tp, case.cfg)
    for l in range(L):
        x = case.res["x"][l]
        w_in = layer_norm(x, st["ln_as"][l], st["ln_ab"][l]) if pre else x
        np.testing.assert_allclose(case.res["q"][l].numpy(),
                                   (w_in @ st["q_w"][l]).numpy(), rtol=1e-5,
                                   atol=1e-6)
    assert case.res["q"].shape == (L, N, 8, HD)


def _cxx_constants(name) -> dict:
    src = (_native.CSRC / name).read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def test_chain_layout_constants_match_the_cuda_source():
    tc = _cxx_constants("chain_bwd_tc.cu")
    engine = _cxx_constants("decode_chain_tc.cuh")
    assert (engine["kKAlign"], engine["kGemvN"], tc["kChainMaxDh"],
            tc["kRowMax"]) == (tparams.K_ALIGN, tparams.N_ALIGN,
                               tchain.MAX_DHEAD, tchain.MAX_ROW)


def test_chain_args_mirror_the_cuda_struct():
    src = (_native.CSRC / "chain_args.cuh").read_text()
    body = src[src.index("struct ChainArgs {"):src.index("};")]
    decls = re.findall(r"^\s*(?:const\s+)?\w+\s*\*?\s*([\w\s,]+);", body,
                       re.M)
    names = [v.strip() for d in decls for v in d.split(",")]
    assert names == [f[0] for f in tchain.ChainArgs._fields_]


class _FakeLib:
    """What chain_lib reads of the library, with a chosen layout."""

    def __init__(self, layout, size=None):
        self.layout, self.size = layout, size

    def tg_sizeof_chain_args(self):
        return self.size or ctypes.sizeof(tchain.ChainArgs)

    def tg_chain_bwd_layout(self, out):
        for i, v in enumerate(self.layout):
            out[i] = v


@pytest.mark.parametrize("layout, size, ok", [
    ((32, 8, 64, 512), None, True),
    ((16, 8, 64, 512), None, False),   # K padding drifted
    ((32, 16, 64, 512), None, False),  # N padding drifted
    ((32, 8, 128, 512), None, False),  # d_head cap drifted
    ((32, 8, 64, 1024), None, False),  # row width drifted
    ((32, 8, 64, 512), 8, False),      # ChainArgs drifted
])
def test_chain_lib_checks_the_layout(monkeypatch, layout, size, ok):
    monkeypatch.setattr(_native, "lib", lambda: _FakeLib(layout, size))
    if ok:
        tchain.chain_lib()
    else:
        with pytest.raises(RuntimeError):
            tchain.chain_lib()


def test_bf16_chain_refuses_shapes_it_does_not_take():
    """d_head 15 (odd) in bf16: the wrapper raises before any launch."""
    cfg = txl.XLConfig(n_layer=1, n_head=2, d_model=30, d_inner=32,
                       n_token=20, compute_dtype="bfloat16")
    kf = torch.zeros((1, 2, 3, 6, 15), dtype=torch.bfloat16)
    S = torch.zeros((2, 3, 20))
    with pytest.raises(ValueError, match="d_head"):
        tchain._launch("chain_bwd_res", txl.init_xl_params(cfg), cfg, kf, kf,
                       S, S, 0, 1.0, res={})


def test_chain_design_names_both_chains():
    assert "chain_bwd_tc.cu" in tchain.chain_design(torch.bfloat16)
    assert "reference" in tchain.chain_design(torch.float32)
