"""The tile algebra of K1f / K1b's tensor-core kernels on the CPU, fp32,
against the JAX package (``pallas_attention_v2._fwd_raw`` / ``_bwd_raw`` in
interpret mode, exact fp32 shifts) and the port's plain versions.

* ``xl_attn_fwd_v2_plain(splits=)`` (partial (o, m, l) per key range, merged
  as the combine kernel merges them) against the unsplit plain version and
  the Pallas forward: reset rows, count 0, same_length, the every-key-masked
  window, splits that see no open key, ragged q and an M that is no
  multiple of 64.
* The position term as the kernels build it: per block of TQ query rows and
  key tile of TK keys, rk streams through a ring of TK-row segments; each
  warp of WQ rows takes W = Qrr RK_win^T over its WQ + TK window rows
  starting at q-1-(iw0+WQ-1)+j0 and skews BD[r, jj] = W[r, WQ-1-r+jj]. It
  matches ``_v2_scores``' gather, and the attention built on it matches the
  Pallas forward.
* Its transposes: the row pass writes dS skewed into each warp's dW for
  dqrr and copies it to dW in rk-row order in device memory (every entry
  written: the band, and zeros where no tile reaches), which equals the
  plain version's scatter of dS; the drk pass sums dW^T Qrr per batch
  split over rk row tiles, skipping the tiles of dW the mask leaves zero,
  and adds the splits in order. dqrr and drk match ``xl_attn_bwd_v2_plain``
  and the Pallas backward.

Without memory the Pallas v2 kernels do not run in interpret mode (zero-size
memory blocks): the forward is then held against the v1 Pallas kernel fed
the position term as BD, the backward against the plain version alone.

Tiles: the kernels' (TQ, WQ, TK) = (64, 16, 64) and smaller ones (the ring
needs TQ <= TK). Tolerances: atol 1e-5 on forward outputs and scores, rtol
1e-5 on l (fp32 sums in another order; nothing is rounded in fp32), atol
2e-5 on gradients (as tests/test_torch_attention_bwd.py: the port takes
D = rowsum(do * o) where the TPU kernel sums dP * P)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_gan_torch.models.attention import build_attn_mask
from transformer_gan_torch.ops import attention as tops

torch.set_num_threads(1)

H, B, DH = 2, 3, 8
ATOL, RTOL_L, ATOL_GRAD = 1e-5, 1e-5, 2e-5
TILES = [(64, 16, 64), (16, 4, 16), (8, 8, 16), (8, 4, 8)]


@pytest.fixture
def pallas(monkeypatch):
    from transformer_gan_tpu.ops import pallas_attention as pa
    from transformer_gan_tpu.ops import pallas_attention_v2 as pa2
    monkeypatch.setattr(pa, "INTERPRET", True)
    monkeypatch.setattr(pa2, "INTERPRET", True)
    monkeypatch.setattr(pa2, "_FAST_BF16_SHIFT", [False])
    return pa2


def _ops(q, M, seed):
    """qrw, qrr, k_mem, v_mem, k_cur, v_cur, rk (zero pad) and do, numpy."""
    rng = np.random.RandomState(seed)

    def a(*shape, s=0.5):
        return (rng.randn(*shape) * s).astype(np.float32)

    ops = [a(H, B, q, DH), a(H, B, q, DH), a(H, B, M, DH), a(H, B, M, DH),
           a(H, B, q, DH), a(H, B, q, DH), a(H, M + 2 * q, DH)]
    ops[6][:, M + q:] = 0.0
    return ops, a(H, B, q, DH, s=1.0)


def _reset(reset):
    return np.array([0, 1, 0] if reset else [0] * B, np.int32)


def _pallas_fwd(pa2, ops, count, rs, same_length):
    """(o, m, l) of the Pallas forward. Without memory the v2 kernel's
    zero-size memory blocks do not run in interpret mode, so the position
    term goes through the v1 kernel (``pallas_attention._fused_fwd_raw``)
    as a precomputed BD (the gather of qrr . rk), at scale 1."""
    jc, jr, js = (jnp.asarray([count], jnp.int32), jnp.asarray(rs),
                  jnp.zeros((1,), jnp.int32))
    if ops[2].shape[2] > 0:
        return pa2._fwd_raw(*map(jnp.asarray, ops), jc, jr, js, 1.0,
                            same_length, 0.0)
    from transformer_gan_tpu.ops import pallas_attention as pa
    qrw, qrr, _, _, k_cur, v_cur, rk = ops
    q = qrw.shape[2]
    w_mat = np.einsum("hbid,hcd->hbic", qrr, rk)
    idx = (q - 1 - np.arange(q))[:, None] + np.arange(q)[None, :]
    bd = np.take_along_axis(w_mat, np.broadcast_to(idx, w_mat.shape[:2]
                                                   + idx.shape), 3)
    flat = [x.reshape(H * B, q, -1) for x in (qrw, k_cur, v_cur, bd)]
    o, m, l = pa._fused_fwd_raw(*map(jnp.asarray, flat), jc,
                                jnp.asarray(np.tile(rs, H)), js, 1.0,
                                same_length, 0.0)
    return (np.asarray(o).reshape(H, B, q, DH),
            np.asarray(m).reshape(H, B, 1, q), np.asarray(l).reshape(H, B, 1, q))


def _close(got, ref, atol=ATOL):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   atol=atol, rtol=0)


# (q, M, count, same_length, reset rows)
GRID = [(16, 12, 12, False, False), (16, 12, 5, True, False),
        (16, 12, 0, False, False), (16, 40, 17, True, True),
        (9, 0, 0, True, False), (9, 0, 0, False, False),
        (50, 70, 70, False, True), (77, 100, 64, True, False)]


@pytest.mark.parametrize("splits", [2, 5])
@pytest.mark.parametrize("q,M,count,same_length,reset", GRID)
def test_split_forward_matches_unsplit_and_pallas(pallas, q, M, count,
                                                  same_length, reset, splits):
    ops, _ = _ops(q, M, seed=q + M + count)
    rs = _reset(reset)
    t = [torch.from_numpy(x) for x in ops]
    args = (count, torch.from_numpy(rs), same_length)
    got = tops.xl_attn_fwd_v2_plain(*t, *args, splits=splits)
    whole = tops.xl_attn_fwd_v2_plain(*t, *args)
    ref = _pallas_fwd(pallas, ops, count, rs, same_length)
    for other in (whole, ref):
        _close(got[:2], other[:2])
        np.testing.assert_allclose(got[2].numpy(), np.asarray(other[2]),
                                   rtol=RTOL_L, atol=0)


def test_split_forward_with_dropout_and_empty_splits():
    """count 0 at M 40: the first of 6 splits sees only masked memory keys
    (m = -inf, l = 0) and drops out of the merge; dropout draws the same
    (seed, bh, i, j) mask in every split and scales o once."""
    q, M = 16, 40
    ops, _ = _ops(q, M, seed=4)
    t = [torch.from_numpy(x) for x in ops]
    mask = build_attn_mask(q, M, 0, False)
    assert bool(mask[..., torch.arange(M + q).tensor_split(6)[0]].all())
    kw = dict(seed=9, rate=0.2)
    got = tops.xl_attn_fwd_v2_plain(*t, 0, None, False, splits=6, **kw)
    whole = tops.xl_attn_fwd_v2_plain(*t, 0, None, False, **kw)
    _close(got[:2], whole[:2])
    np.testing.assert_allclose(got[2].numpy(), whole[2].numpy(), rtol=RTOL_L)


# ---------------------------------------------------------------------------
# The kernels' tile algebra, written out in torch
# ---------------------------------------------------------------------------

def _rows(x, first, n):
    """Rows first .. first+n-1 of x [..., R, d] along dim -2, zero outside
    [0, R) (the loaders' zero fill)."""
    R = x.shape[-2]
    idx = torch.arange(first, first + n)
    ok = (idx >= 0) & (idx < R)
    out = x[..., idx.clamp(0, R - 1), :]
    return torch.where(ok[:, None], out, 0.0)


def _skew(w, off, width):
    """out[..., r, x + off(r)] = w[..., r, x] where 0 <= x + off(r) < width
    (the kernels' skew: a scatter that drops what falls outside; x ->
    x + off(r) is one to one, so it is the gather written here)."""
    R, X = w.shape[-2], w.shape[-1]
    src = (torch.arange(width)[None, :]
           - torch.tensor([off(r) for r in range(R)])[:, None])
    ok = (src >= 0) & (src < X)
    out = torch.gather(w, -1, src.clamp(0, X - 1).expand(w.shape[:-1] + (width,)))
    return torch.where(ok, out, 0.0)


def _jlo(M, count, TK):
    return max(M - count, 0) // TK * TK


def tiled_bd(qrr, rk, q, klen, jlo, tiles):
    """BD [H, B, q, klen] as K1f's blocks build it (columns before jlo stay
    NaN: no tile reads them): the ring of TK-row rk segments, each warp's
    window product and skew."""
    TQ, WQ, TK = tiles
    nq = -(-q // TQ)
    n_t = -(-(klen - jlo) // TK)
    out = torch.full(qrr.shape[:2] + (nq * TQ, jlo + n_t * TK), float("nan"))
    qp = _rows(qrr, 0, nq * TQ)
    for qi in range(nq):
        i0 = qi * TQ
        cb0 = q - 1 - (i0 + TQ - 1) + jlo   # ring segment u: rows cb0 + TK u
        seg = [_rows(rk, cb0 + u * TK, TK) for u in range(n_t + 1)]
        for u in range(n_t):
            j0 = jlo + u * TK
            window = torch.cat([seg[u], seg[u + 1]], dim=1)  # block window
            assert torch.equal(window,
                               _rows(rk, q - 1 - (i0 + TQ - 1) + j0, 2 * TK))
            for w in range(TQ // WQ):
                iw0 = i0 + w * WQ
                wr0 = TQ - WQ * (w + 1)
                win = window[:, wr0:wr0 + WQ + TK]   # rows from q-1-(iw0+WQ-1)+j0
                wm = torch.einsum("hbrd,hxd->hbrx", qp[:, :, iw0:iw0 + WQ],
                                  win)
                out[:, :, iw0:iw0 + WQ, j0:j0 + TK] = _skew(
                    wm, lambda r: r - (WQ - 1), TK)
    return out[:, :, :q, :klen]


def _valid(q, M, count, same_length, reset):
    """Open scores [B or 1, q, klen] (the every-key-masked window opens every
    key)."""
    mask = build_attn_mask(q, M, count, same_length,
                           None if reset is None else torch.from_numpy(reset))
    if same_length and M == 0:
        return torch.ones_like(mask)
    return ~mask


TILE_GRID = [(16, 12, 12, False, False), (16, 40, 17, True, True),
             (50, 70, 70, False, True), (77, 100, 64, True, False),
             (9, 0, 0, True, False), (37, 0, 0, False, False)]


@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("q,M,count,same_length,reset", TILE_GRID)
def test_tiled_position_term_matches_gather_and_pallas(
        pallas, tiles, q, M, count, same_length, reset):
    ops, _ = _ops(q, M, seed=2 * q + M)
    rs = _reset(reset)
    qrw, qrr, k_mem, v_mem, k_cur, v_cur, rk = map(torch.from_numpy, ops)
    klen = M + q
    uniform = same_length and M == 0
    jlo = 0 if uniform else _jlo(M, count, tiles[2])
    if reset:
        jlo = 0   # a block without reset rows starts at the count
    bd = tiled_bd(qrr, rk, q, klen, jlo, tiles)
    w_mat = torch.einsum("hbid,hcd->hbic", qrr, rk)
    ref = torch.gather(w_mat, 3, tops._bd_index(q, klen, qrr.device)
                       .expand(H, B, q, klen))
    open_ = _valid(q, M, count, same_length, rs)[None].expand(H, B, q, klen)
    torch.testing.assert_close(bd[open_], ref[open_], atol=ATOL, rtol=0)

    # the attention on these scores, against the Pallas forward
    k = torch.cat([k_mem, k_cur], 2)
    v = torch.cat([v_mem, v_cur], 2)
    s = (qrw @ k.transpose(-1, -2) + bd).masked_fill(~open_, tops.NEG)
    if uniform:
        s = torch.full_like(s, tops.NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = (p @ v) / l
    ro, rm, rl = _pallas_fwd(pallas, ops, count, rs, same_length)
    _close([o, m.transpose(-1, -2)], [ro, rm])
    np.testing.assert_allclose(l.transpose(-1, -2).numpy(), np.asarray(rl),
                               rtol=RTOL_L)


def _grads_in(q, M, count, same_length, reset, seed):
    """Operands, the plain forward's m, l, o and dS (fp32) of a case."""
    ops, do = _ops(q, M, seed)
    t = [torch.from_numpy(x) for x in ops]
    treset = torch.from_numpy(reset)
    o, m, l = tops.xl_attn_fwd_v2_plain(*t, count, treset, same_length)
    s = tops._v2_scores(*t[:3], t[4], t[6], count, treset, same_length)
    p = torch.exp(s - m.transpose(-1, -2)) / l.transpose(-1, -2)
    v = torch.cat([t[3], t[5]], 2)
    dpt = torch.from_numpy(do) @ v.transpose(-1, -2)
    D = (torch.from_numpy(do) * o).sum(-1, keepdim=True)
    return ops, do, t, (o, m, l), p * (dpt - D)


def tiled_row_pass(ds, qrr, rk, q, M, jlo, uniform, tiles):
    """The row pass's position-term sums: each warp writes dS skewed into
    its dW (WQ x (WQ + TK), zero off the band) and adds dW RK_win to dqrr;
    it also copies the band to dW in rk-row order in device memory, row i
    of a tile at columns q-1-i+j0 .., and zeroes the columns no tile of its
    block covers. Returns (dqrr, dW [H, B, q, M + 2q])."""
    TQ, WQ, TK = tiles
    klen, KP = M + q, M + 2 * q
    nq = -(-q // TQ)
    dsp = torch.zeros(ds.shape[:2] + (nq * TQ, klen + TK))
    dsp[:, :, :q, :klen] = ds
    dqrr = torch.zeros(qrr.shape[:2] + (nq * TQ, qrr.shape[-1]))
    dw_mem = torch.full(ds.shape[:3] + (KP,), float("nan"))
    for qi in range(nq):
        i0 = qi * TQ
        jhi = klen if uniform else min(klen, M + min(i0 + TQ, q))
        nt = -(-(jhi - jlo) // TK)
        for i in range(i0, min(i0 + TQ, q)):
            lo = q - 1 - i + jlo
            dw_mem[:, :, i, :lo] = 0.0
            dw_mem[:, :, i, min(KP, lo + nt * TK):] = 0.0
        for u in range(nt):
            j0 = jlo + u * TK
            for w in range(TQ // WQ):
                iw0 = i0 + w * WQ
                dw = _skew(dsp[:, :, iw0:iw0 + WQ, j0:j0 + TK],
                           lambda r: WQ - 1 - r, WQ + TK)
                win = _rows(rk, q - 1 - (iw0 + WQ - 1) + j0, WQ + TK)
                dqrr[:, :, iw0:iw0 + WQ] += torch.einsum("hbrx,hxd->hbrd",
                                                         dw, win)
                for r in range(min(WQ, q - iw0)):
                    c = q - 1 - (iw0 + r) + j0
                    n = min(TK, KP - c)
                    dw_mem[:, :, iw0 + r, c:c + n] = dw[:, :, r, WQ - 1 - r:
                                                         WQ - 1 - r + n]
    return dqrr[:, :, :q], dw_mem


def tiled_drk(dw_mem, qrr, q, M, count, same_length, reset, tiles, n_split):
    """The drk pass: per rk row tile of TK rows and batch split, the split's
    (batch, query tile) items in order, skipping those whose score band has
    no open key (their tile of dW must be zero), drk += dW^T Qrr; the splits
    added in order."""
    TQ, _, TC = tiles
    klen, KP = M + q, M + 2 * q
    uniform = same_length and M == 0
    b_per = -(-B // n_split)
    nq = -(-q // TQ)
    parts = torch.zeros(n_split, H, -(-KP // TC) * TC, DH)
    for c0 in range(0, KP, TC):
        for sp in range(n_split):
            for b in range(sp * b_per, min(B, (sp + 1) * b_per)):
                for qi in range(nq):
                    i0 = qi * TQ
                    jb = c0 - (q - 1) + i0
                    open_lo = 0 if uniform else (M if reset[b] else
                                                 max(M - count, 0))
                    open_hi = klen - 1 if uniform else M + min(i0 + TQ, q) - 1
                    tile = _rows(dw_mem[:, b, :, c0:c0 + TC], i0, TQ)
                    if jb > open_hi or jb + 2 * TC - 2 < open_lo:
                        assert bool((tile == 0).all())
                        continue
                    tile = torch.nn.functional.pad(
                        tile, (0, TC - tile.shape[-1]))
                    parts[sp, :, c0:c0 + TC] += torch.einsum(
                        "hic,hid->hcd", tile, _rows(qrr[:, b], i0, TQ))
    drk = parts[0].clone()
    for sp in range(1, n_split):
        drk += parts[sp]
    return drk[:, :KP]


BWD_GRID = [(16, 12, 12, False, False), (16, 40, 17, True, True),
            (50, 70, 70, False, True), (77, 100, 64, True, False),
            (9, 0, 0, True, False)]


@pytest.mark.parametrize("tiles", TILES[:2])
@pytest.mark.parametrize("q,M,count,same_length,reset", BWD_GRID)
def test_tiled_position_gradients_match_plain_and_pallas(
        pallas, tiles, q, M, count, same_length, reset):
    rs = _reset(reset)
    ops, do, t, (o, m, l), ds = _grads_in(q, M, count, same_length, rs,
                                          seed=3 * q + M)
    klen = M + q
    uniform = same_length and M == 0
    plain = tops.xl_attn_bwd_v2_plain(*t, m, l, o, torch.from_numpy(do),
                                      count, torch.from_numpy(rs),
                                      same_length)
    refs = [plain]
    if M > 0:   # the v2 kernel's zero-size memory blocks need M > 0
        jc, jr, js = (jnp.asarray([count], jnp.int32), jnp.asarray(rs),
                      jnp.zeros((1,), jnp.int32))
        jargs = [jnp.asarray(x) for x in ops]
        _, jm, jl = pallas._fwd_raw(*jargs, jc, jr, js, 1.0, same_length,
                                    0.0)
        refs.append(pallas._bwd_raw(*jargs, jm, jl, jc, jr, js,
                                    jnp.asarray(do), 1.0, same_length, 0.0))

    jlo = 0 if (uniform or reset) else _jlo(M, count, tiles[2])
    dqrr, dw_mem = tiled_row_pass(ds, t[1], t[6], q, M, jlo, uniform, tiles)
    dw_ref = torch.zeros_like(dw_mem).scatter_(
        3, tops._bd_index(q, klen, ds.device).expand(H, B, q, klen), ds)
    torch.testing.assert_close(dw_mem, dw_ref, atol=0, rtol=0)
    drk = tiled_drk(dw_mem, t[1], q, M, count, same_length, rs, tiles,
                    n_split=2)
    for ref in refs:
        _close([dqrr, drk], [ref[1], ref[4]], atol=ATOL_GRAD)
