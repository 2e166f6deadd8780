"""The split-key algebra of K2f's tensor-core kernel on the CPU: the plain
version with ``splits`` (partial (o, m, l) per key range, merged as the
combine kernel merges them) against the unsplit plain version and against
the JAX Pallas kernel ``pallas_attention._fused_fwd_raw`` in interpret mode,
fp32. Covers reset rows, count 0 (the whole memory masked), the same_length
window without memory (every key masked: a uniform average) and splits that
see no open key. Tolerance: atol 1e-5 on o and m, rtol 1e-5 on l (fp32 sums
in another order; the split rounds nothing in fp32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_gan_torch.models.attention import build_attn_mask
from transformer_gan_torch.ops import attention as tops

torch.set_num_threads(1)

BH, DH = 4, 8
ATOL, RTOL_L = 1e-5, 1e-5


@pytest.fixture
def pallas(monkeypatch):
    from transformer_gan_tpu.ops import pallas_attention as pa
    monkeypatch.setattr(pa, "INTERPRET", True)
    return pa


def _ops(q, M, seed):
    rng = np.random.RandomState(seed)
    klen = M + q

    def a(*shape):
        return (rng.randn(*shape) * 0.5).astype(np.float32)

    return [a(BH, q, DH), a(BH, klen, DH), a(BH, klen, DH), a(BH, q, klen)]


def _close(got, ref):
    (o, m, l), (ro, rm, rl) = got, ref
    np.testing.assert_allclose(o.numpy(), np.asarray(ro), atol=ATOL, rtol=0)
    np.testing.assert_allclose(m.numpy(), np.asarray(rm), atol=ATOL, rtol=0)
    np.testing.assert_allclose(l.numpy(), np.asarray(rl), rtol=RTOL_L, atol=0)


# (q, M, count, same_length, reset rows)
GRID = [(16, 12, 12, False, False), (16, 12, 5, True, False),
        (16, 12, 0, False, False), (16, 12, 7, True, True),
        (9, 0, 0, True, False), (9, 0, 0, False, False),
        (16, 40, 40, False, True)]


@pytest.mark.parametrize("splits", [2, 3, 7])
@pytest.mark.parametrize("q,M,count,same_length,reset", GRID)
def test_split_plain_matches_unsplit_and_pallas(pallas, q, M, count,
                                                same_length, reset, splits):
    ops = _ops(q, M, seed=q + M + count)
    rs = np.array([0, 1, 0, 0] if reset else [0] * BH, np.int32)
    scale = 1.0 / DH ** 0.5
    t = [torch.from_numpy(x) for x in ops]
    args = (count, torch.from_numpy(rs), scale, same_length)
    got = tops.xl_attn_fwd_v1_plain(*t, *args, splits=splits)
    _close(got, tops.xl_attn_fwd_v1_plain(*t, *args))
    ref = pallas._fused_fwd_raw(
        *map(jnp.asarray, ops), jnp.asarray([count], jnp.int32),
        jnp.asarray(rs), jnp.zeros((1,), jnp.int32), scale, same_length, 0.0)
    _close(got, ref)


def test_split_with_no_open_key_adds_nothing():
    """count 0 at M 12: every memory key is masked, so the first splits of a
    cut into 4 see no open key (m = -inf, l = 0) and drop out of the merge."""
    q, M = 8, 12
    t = [torch.from_numpy(x) for x in _ops(q, M, seed=3)]
    mask = build_attn_mask(q, M, 0, False)
    idx = torch.arange(M + q).tensor_split(4)[0]
    assert bool(mask[..., idx].all())
    got = tops.xl_attn_fwd_v1_plain(*t, 0, None, 0.3, False, splits=4)
    _close(got, tops.xl_attn_fwd_v1_plain(*t, 0, None, 0.3, False))


def test_combine_merges_in_split_order_and_skips_empty_splits():
    """combine_splits_plain on hand-made partials: an empty split (m -inf,
    l 0, o 0) changes nothing, and the merge is the softmax of the union."""
    rng = np.random.RandomState(0)
    s = torch.from_numpy(rng.randn(3, 10).astype(np.float32))
    v = torch.from_numpy(rng.randn(10, DH).astype(np.float32))
    parts = []
    for idx in (torch.arange(0, 4), torch.arange(4, 10)):
        m_s = s[:, idx].amax(-1)
        p = torch.exp(s[:, idx] - m_s[:, None])
        parts.append((p @ v[idx], m_s, p.sum(-1)))
    parts.insert(1, (torch.zeros(3, DH), torch.full((3,), float("-inf")),
                     torch.zeros(3)))
    o, m, l = tops.combine_splits_plain(
        *(torch.stack(x) for x in zip(*parts)), rate=0.0)
    ref = torch.softmax(s, -1) @ v
    torch.testing.assert_close(o, ref, atol=ATOL, rtol=0)
    torch.testing.assert_close(m, s.amax(-1))
    torch.testing.assert_close(l, torch.exp(s - s.amax(-1, keepdim=True))
                               .sum(-1))


def test_split_with_dropout_matches_unsplit():
    """Dropout: the keep mask is the same (seed, bh, i, j) hash in every
    split, and o is scaled by 1 / (1 - rate) once, in the merge."""
    q, M = 16, 24
    t = [torch.from_numpy(x) for x in _ops(q, M, seed=5)]
    args = (M, None, 0.35, False)
    got = tops.xl_attn_fwd_v1_plain(*t, *args, seed=9, rate=0.2, splits=5)
    _close(got, tops.xl_attn_fwd_v1_plain(*t, *args, seed=9, rate=0.2))


@pytest.mark.parametrize("BH_,qlen,klen,n_sm,expect", [
    (10, 128, 4274, 132, 14),   # generation's prime shape: 20 query tiles
    (1280, 128, 128, 132, 1),   # the training shape at M 0: no split
    (10, 50, 350, 132, 3),      # few key tiles: at least two a split
    (80, 37, 37, 132, 1),       # one key tile: nothing to split
    (1, 64, 64 * 200, 132, 32),  # capped
])
def test_key_splits_fill_the_card(BH_, qlen, klen, n_sm, expect):
    assert tops.v1_key_splits(BH_, qlen, klen, n_sm) == expect
