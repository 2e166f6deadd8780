"""The bf16 decode chain's plain counterparts on the CPU (fp32 unless
named, tiny widths): split-key decode attention against the unsplit plain
version, the chunk samplers' plain versions with ``splits`` against the JAX
package's Pallas kernels in interpret mode (ids identical, staged K/V and
memories within 1e-5 / 1e-4), the split rule and bounds, and the bf16
chain's operand layouts (W^T copies, h-major R).

The bf16 kernel (csrc/decode_chain_tc.cuh) rounds each split's
probabilities before P V; ``splits`` makes the plain versions round there
too, so the card can hold the kernel against them. In fp32 the split and
unsplit versions differ only in the order of fp32 sums."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_gan_torch import convert
from transformer_gan_torch.infer import sample as tsample
from transformer_gan_torch.models import xl as txl
from transformer_gan_torch.ops import decode as tdec
from transformer_gan_torch.ops import decode_params as tparams
from transformer_gan_torch.ops import generate as tgen
from transformer_gan_tpu.infer import sample as jsample
from transformer_gan_tpu.models import xl as jxl
from transformer_gan_tpu.ops import pallas_decode as pdec
from transformer_gan_tpu.ops import pallas_generate as pgen

torch.set_num_threads(1)

V = 310
BASE = dict(n_layer=2, n_head=2, d_model=16, d_inner=32, n_token=V,
            dropout=0.0, dropatt=0.0)
L, H, DH = 2, 2, 8
HD = H * DH


def _attn_operands(nk, B=3, seed=0, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=gen).to(dtype)
    return (r(H, B, nk, DH), r(H, B, nk, DH), r(nk, H, DH), r(B, H, DH),
            r(B, H, DH))


# ---------------------------------------------------------------------------
# Split-key decode attention against the unsplit plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nk,splits", [
    (1, 1),      # t = 0 on an empty ring: the current key alone
    (1, 5),      # four empty splits
    (20, 1),     # one split: the split rounding, no combine
    (20, 3),     # ragged ranges (7, 7, 6)
    (20, 20),    # a key a split
    (21, 27),    # more splits than keys: the last six empty
    (97, 7),
])
def test_split_attention_matches_unsplit(nk, splits):
    keys, vals, r_rows, qw, qr = _attn_operands(nk)
    ref = tgen.decode_attention_plain(keys, vals, r_rows, qw, qr, 0.35)
    out = tgen.decode_attention_plain(keys, vals, r_rows, qw, qr, 0.35,
                                      splits=splits)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("splits", [1, 4])
def test_split_attention_bf16_rounds_within_the_bf16_rule(splits):
    """In bf16 the split version rounds each split's unnormalised p (the
    kernel's rounding point); it stays within the bf16 attention rule of
    kernel_check (2e-2 x max|o|) of the unsplit one."""
    keys, vals, r_rows, qw, qr = _attn_operands(60, dtype=torch.bfloat16)
    ref = tgen.decode_attention_plain(keys, vals, r_rows, qw, qr, 0.35).float()
    out = tgen.decode_attention_plain(keys, vals, r_rows, qw, qr, 0.35,
                                      splits=splits).float()
    assert out.dtype == ref.dtype
    assert float((out - ref).abs().max()) <= 2e-2 * float(ref.abs().max())


@pytest.mark.parametrize("n_keys,splits", [(1, 1), (1, 27), (4178, 27),
                                           (4178, 17), (96, 1), (332, 5),
                                           (33, 64)])
def test_split_bounds_are_tensor_split_ranges(n_keys, splits):
    """The kernel's ranges (lo = s * (n // S) + min(s, n % S)) are the ones
    torch.tensor_split cuts, which the plain version uses."""
    want = [(int(p[0]) if p.numel() else None, p.numel())
            for p in torch.arange(n_keys).tensor_split(splits)]
    got = tgen.split_bounds(n_keys, splits)
    assert [n for _, n in got] == [n for _, n in want]
    assert all(g[0] == w[0] for g, w in zip(got, want) if w[1])
    assert sum(n for _, n in got) == n_keys


@pytest.mark.parametrize("B,n_keys,want", [
    (1, 4146 + 32, 27),   # K3 at B 1, M 4146: two waves of 132 SMs
    (3, 4146 + 32, 17),   # a split holds at most KEY_TILE keys
    (8, 4146 + 32, 17),
    (64, 64 + 32, 1),     # K4 at B 64, M 64: 640 blocks already fill the card
    (1, 300 + 32, 5),     # at least MIN_SPLIT_KEYS keys a split
    (5, 64 + 32, 1),
    (1, 40000, 64),       # capped at MAX_DECODE_SPLITS
])
def test_decode_key_splits(B, n_keys, want):
    S = tgen.decode_key_splits(10, B, n_keys, 132)
    assert S == want
    assert 1 <= S <= tgen.MAX_DECODE_SPLITS
    if S < tgen.MAX_DECODE_SPLITS:
        assert max(n for _, n in tgen.split_bounds(n_keys, S)) <= tgen.KEY_TILE


# The route of the bf16 decode attention, from H, B, the keys and the SMs
# (132: the H100). evalgen: H 10, B 32, M 2048, C 32; K4's GAN shapes: B 64
# at M 64, B 32 at M 128; the CLI's K3: B 1 and B 8 at M 4146.
ROUTES = [
    (32, 2048 + 32, (8, 6)),    # evalgen: 4 groups x 6 splits x 10 heads
    (32, 2048 + 7, (8, 6)),     # its remainder chunk
    (16, 2048 + 32, (8, 13)),   # the metrics' narrower waves
    (8, 2048 + 32, (8, 26)),
    (64, 64 + 32, (0, 1)),      # K4, B 64, M 64: unsplit
    (32, 128 + 32, (0, 1)),     # K4, B 32, M 128: unsplit
    (8, 128 + 32, (0, 2)),      # K4 / K5 at B 8, M 128: split, but a grouped
                                # grid of 20 blocks, under a block an SM
    (8, 64 + 32, (0, 1)),       # K4 at B 8, M 64: unsplit
    (8, 1024 + 32, (8, 16)),    # B 8, M 1024: 160 grouped blocks
    (8, 4146 + 32, (8, 26)),    # the CLI at B 8: lane groups
    (1, 4146 + 32, (0, 27)),    # the CLI at B 1: fewer lanes than a group
    (7, 4146 + 32, (0, 17)),
    (12, 4146 + 32, (8, 13)),   # a ragged last group
    (32, 33000, (0, 64)),       # past GROUP_MAX_KEYS x MAX_DECODE_SPLITS
]


@pytest.mark.parametrize("B,n_keys,want", ROUTES)
def test_decode_route(B, n_keys, want):
    assert tgen.decode_route(10, B, n_keys, 132) == want
    if want[0] == 0:
        assert want[1] == tgen.decode_key_splits(10, B, n_keys, 132)


@pytest.mark.parametrize("B,n_keys,want",
                         [r for r in ROUTES if r[2][0]])
def test_grouped_split_bounds(B, n_keys, want):
    """The grouped route's splits: each at most GROUP_MAX_KEYS keys (its
    scores in shared memory) and at least MIN_SPLIT_KEYS at full length,
    the tensor_split ranges, and the (h, group, split) grid within one wave
    of GROUP_BLOCKS_PER_SM blocks a multiprocessor."""
    S = tgen.grouped_key_splits(10, B, n_keys, 132)
    assert S == want[1] <= tgen.MAX_DECODE_SPLITS
    sizes = [n for _, n in tgen.split_bounds(n_keys, S)]
    assert sum(sizes) == n_keys and max(sizes) - min(sizes) <= 1
    assert tgen.MIN_SPLIT_KEYS <= max(sizes) <= tgen.GROUP_MAX_KEYS
    assert 10 * -(-B // tgen.LANE_GROUP) * S <= tgen.GROUP_BLOCKS_PER_SM * 132


def test_launches_per_token_by_route():
    from transformer_gan_torch import kernel_check as kc
    assert kc.chain_launches_per_token(6, 6, tgen.LANE_GROUP) == 32
    assert kc.chain_launches_per_token(6, 27) == 38
    assert kc.chain_launches_per_token(6, 1) == 32


@pytest.mark.parametrize("count,n", [(0, 7), (40, 32), (64, 32)])
def test_generate_chunk_plain_with_route_splits_within_bf16_rule(count, n):
    """The plain version with the evalgen route's splits (6; the kernel's
    rounding) against the unsplit plain version, bf16 at tiny widths,
    B 8, M 64: the first step's logits within kernel_check's
    LOGIT_ULPS_BF16 ulps of max|logit|, layer 0's staged K/V of step 0
    (no attention before it) equal."""
    from transformer_gan_torch import kernel_check as kc
    cfg = txl.XLConfig(compute_dtype="bfloat16", cache_kv=True, **BASE)
    params = txl.init_xl_params(cfg, seed=5, base_init=("normal", 0.1))
    st = tparams.stack_decode_params(params, cfg)
    B, M = 8, 64
    gen = torch.Generator().manual_seed(count + n)
    kv = (torch.randn((L, 2, H, B, M, DH), generator=gen) * 0.5).to(
        torch.bfloat16)
    R = txl.precompute_r_heads(params, cfg, M + 1).reshape(
        L, M + 1, HD).to(torch.bfloat16).contiguous()
    ids = torch.randint(2, V, (B, 1), generator=gen, dtype=torch.int32)
    er = torch.zeros((B, 1), dtype=torch.int32)
    g = tsample.gumbel_noise((n, B, V), gen, "cpu")
    S = tgen.decode_route(10, 32, 2048 + 32, 132)[1]
    outs = [tgen.fused_generate_chunk_plain(
        st, cfg, tsample.GUMBEL_ARGMAX, kv, R, ids, er, g, count, n,
        same_length=False, return_logits=True, splits=splits)
        for splits in (None, S)]
    ref, got = outs[0][4][0].float(), outs[1][4][0].float()
    ulp = kc.bf16_ulp(float(ref.abs().max()))
    assert float((got - ref).abs().max()) <= kc.LOGIT_ULPS_BF16 * ulp
    assert torch.equal(outs[0][3][0, ..., 0, :], outs[1][3][0, ..., 0, :])


# ---------------------------------------------------------------------------
# The chunk samplers' plain versions with splits against the JAX package
# ---------------------------------------------------------------------------

def _gen_models():
    jcfg = jxl.XLConfig(cache_kv=True, use_pallas=False, **BASE)
    tcfg = txl.XLConfig(cache_kv=True, **BASE)
    jp = jxl.init_xl_params(jcfg, seed=0, base_init=("normal", 0.1))
    return jcfg, tcfg, jp, convert.params_from_jax(jp)


def _g_all(key, length, bsz):
    def g_of(step_rng):
        rs = jax.random.split(step_rng, bsz)
        return jax.vmap(lambda r: jax.random.gumbel(r, (V,), jnp.float32))(rs)
    return np.array(jax.vmap(g_of)(jax.random.split(key, length)))


@pytest.mark.parametrize("splits", [3, 40])
def test_generate_loop_with_splits_matches_pallas_interpret(monkeypatch,
                                                            splits):
    """Prime 100 tokens into a 128-slot ring, then the fused sampling loop
    (a chunk of 32, then 8, into the full ring, where the same_length window
    drops the oldest slots; t from 0 to n - 1; at 40 splits the early
    tokens leave most splits empty and every split boundary moves across
    the big cache / ring seam) on the plain version with ``splits``, against
    JAX's loop on the Pallas kernel in interpret mode, same noise. M is a
    multiple of 128 (see test_torch_generate for the front-padding defect
    of the JAX kernel)."""
    monkeypatch.setattr(pgen, "INTERPRET", True)
    monkeypatch.setattr(tgen, "fused_generate_chunk", functools.partial(
        tgen.fused_generate_chunk_plain, splits=splits))
    jcfg, tcfg, jp, tp = _gen_models()
    js = jsample.SamplingConfig(technique="topk", topk=5, temperature=0.9)
    ts = tsample.SamplingConfig(technique="topk", topk=5, temperature=0.9)
    bsz, M, length = 2, 128, 40
    prime = np.random.RandomState(4).randint(2, V, (100, bsz)).astype(np.int32)
    _, jm = jsample.make_prime_step(jcfg)(jp, jnp.asarray(prime),
                                          jxl.init_mems(jcfg, M, bsz))
    _, tm = tsample.make_prime_step(tcfg)(tp, torch.from_numpy(prime).long(),
                                          txl.init_mems(tcfg, M, bsz))
    g_all = _g_all(jax.random.PRNGKey(7), length, bsz)
    first = np.full((bsz,), 2, np.int32)
    jt, jK, jV, jc = jsample._fused_sample_loop(
        jp, jcfg, js, jnp.asarray(first), jm, length, jnp.asarray(g_all),
        jnp.zeros((bsz,), jnp.int32), same_length=True)
    tt, thids, tc = tsample._fused_sample_loop(
        tp, tcfg, ts, torch.from_numpy(first).long(), tm, length,
        torch.from_numpy(g_all), torch.zeros(bsz, dtype=torch.long),
        same_length=True)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))

    def heads(x):  # JAX's dense [L, b, M, h*dh] -> the port's [L, h, b, M, dh]
        return np.asarray(x).reshape(L, bsz, M, H, DH).transpose(0, 3, 1, 2, 4)
    np.testing.assert_allclose(thids[:, 0].numpy(), heads(jK), atol=1e-4)
    np.testing.assert_allclose(thids[:, 1].numpy(), heads(jV), atol=1e-4)
    assert tc == int(jc) == M


def _dec_models(pre_lnorm=False):
    jcfg = jxl.XLConfig(cache_kv=True, use_pallas=True, pre_lnorm=pre_lnorm,
                        **BASE)
    tcfg = txl.XLConfig(pre_lnorm=pre_lnorm, **BASE)
    # weights of 0.2: logits far enough apart that fp32 sums in another
    # order cannot flip an argmax
    jp = jxl.init_xl_params(jcfg, seed=0, base_init=("normal", 0.2))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def _dense(a):
    """[L, H, B, M, dh] h-major -> the JAX kernels' [L, B, M, HD]."""
    Ln, Hn, B, M, dh = a.shape
    return np.ascontiguousarray(a.transpose(0, 2, 3, 1, 4).reshape(Ln, B, M,
                                                                   Hn * dh))


def _gumbel(rng, shape):
    u = rng.uniform(size=shape).astype(np.float32)
    return -np.log(-np.log(u + 1e-20) + 1e-20)


@pytest.mark.parametrize("B,n,count,splits,pre", [
    (8, 5, 0, 4, False),     # count 0: only the ring; empty splits at t < 3
    (8, 7, 9, 3, False),     # partly filled ring: splits across the seam
    (16, 16, 16, 5, False),  # full ring, chunk = M (sliding window)
    (8, 6, 11, 2, True),     # pre-LN
])
def test_decode_chunk_plain_with_splits_matches_jax_kernel(monkeypatch, B, n,
                                                           count, splits, pre):
    monkeypatch.setattr(pdec, "INTERPRET", True)
    jcfg, tcfg, jp, tp = _dec_models(pre)
    M = 16
    rng = np.random.RandomState(B + n + count)
    kv = rng.randn(L, 2, H, B, M, DH).astype(np.float32)
    R = np.asarray(jxl.precompute_r_heads(jp, jcfg, M + 1)).reshape(L, M + 1,
                                                                     HD)
    ids = rng.randint(2, V, (B, 1)).astype(np.int32)
    g = _gumbel(rng, (n, B, V))
    ji, joh, jsk, jsv = pdec.fused_decode_chunk(
        pdec.stack_decode_params(jp, jcfg), jcfg, jnp.asarray(_dense(kv[:, 0])),
        jnp.asarray(_dense(kv[:, 1])), jnp.asarray(R), jnp.asarray(ids),
        jnp.asarray(g), count, n)
    ti, toh, staged = tdec.fused_decode_chunk_plain(
        tparams.stack_decode_params(tp, tcfg), tcfg, torch.from_numpy(kv),
        torch.from_numpy(R.copy()), torch.from_numpy(ids), torch.from_numpy(g),
        count, n, splits=splits)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(toh.numpy(), np.asarray(joh))
    np.testing.assert_allclose(_dense(staged[:, 0].numpy()),
                               np.asarray(jsk)[:, :, :n], atol=1e-5)
    np.testing.assert_allclose(_dense(staged[:, 1].numpy()),
                               np.asarray(jsv)[:, :, :n], atol=1e-5)


@pytest.mark.parametrize("t,count,splits", [(0, 0, 3), (7, 16, 4)])
def test_decode_step_plain_with_splits_matches_jax_kernel(monkeypatch, t,
                                                          count, splits):
    """K5's plain version with splits: t = 0 on an empty ring, and the last
    row of an 8-row ring on a full one."""
    monkeypatch.setattr(pdec, "INTERPRET", True)
    jcfg, tcfg, jp, tp = _dec_models()
    B, M, C = 8, 16, 8
    rng = np.random.RandomState(t + count)
    kv = rng.randn(L, 2, H, B, M, DH).astype(np.float32)
    staged = rng.randn(L, 2, H, B, C, DH).astype(np.float32)
    R = np.asarray(jxl.precompute_r_heads(jp, jcfg, M + 1)).reshape(L, M + 1,
                                                                     HD)
    ids = rng.randint(2, V, (B, 1)).astype(np.int32)
    g = _gumbel(rng, (B, V))
    ji, joh, jsk, jsv = pdec.fused_decode_step(
        pdec.stack_decode_params(jp, jcfg), jcfg, jnp.asarray(_dense(kv[:, 0])),
        jnp.asarray(_dense(kv[:, 1])), jnp.asarray(R),
        jnp.asarray(_dense(staged[:, 0])), jnp.asarray(_dense(staged[:, 1])),
        jnp.asarray(ids), jnp.asarray(g), jnp.asarray([t, count], jnp.int32))
    ti, toh, st = tdec.fused_decode_step_plain(
        tparams.stack_decode_params(tp, tcfg), tcfg, torch.from_numpy(kv),
        torch.from_numpy(R.copy()), torch.from_numpy(staged.copy()),
        torch.from_numpy(ids), torch.from_numpy(g), t, count, splits=splits)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(toh.numpy(), np.asarray(joh))
    np.testing.assert_allclose(_dense(st[:, 0].numpy()), np.asarray(jsk),
                               atol=1e-5)
    np.testing.assert_allclose(_dense(st[:, 1].numpy()), np.asarray(jsv),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# The bf16 chain's operand layouts
# ---------------------------------------------------------------------------

def test_stack_decode_params_adds_padded_transposes_in_bf16():
    tcfg = txl.XLConfig(compute_dtype="bfloat16", cache_kv=True, **BASE)
    params = txl.init_xl_params(tcfg, seed=3)
    st = tparams.stack_decode_params(params, tcfg)
    Kh, Kd = tparams.kpad(HD), tparams.kpad(BASE["d_inner"])
    assert (Kh, tparams.npad(3 * HD), tparams.npad(V)) == (32, 48, 312)
    qkv = torch.cat([st["q_w"], st["k_w"], st["v_w"]], dim=-1)
    for name, w, K in (("qkv_t", qkv, Kh), ("o_t", st["o_w"], Kh),
                       ("ff1_t", st["ff1"], Kh), ("ff2_t", st["ff2"], Kd),
                       ("lg_t", st["emb_t"], Kh)):
        t = st[name]
        Kw, Nw = w.shape[-2:]
        assert t.dtype == torch.bfloat16 and t.is_contiguous()
        assert t.shape[-2:] == (tparams.npad(Nw), K)
        assert torch.equal(t[..., :Nw, :Kw], w.transpose(-1, -2))
        assert not t[..., Nw:, :].any() and not t[..., :, Kw:].any()
    f32 = tparams.stack_decode_params(
        params, txl.XLConfig(cache_kv=True, **BASE))
    assert "qkv_t" not in f32


def test_r_heads_major_rows():
    R = torch.randn(L, 17, HD)
    Rh = tgen.r_heads_major(R, H)
    assert Rh.shape == (L, H, 17, DH) and Rh.is_contiguous()
    for h in range(H):
        assert torch.equal(Rh[:, h], R[:, :, h * DH:(h + 1) * DH])


# ---------------------------------------------------------------------------
# One layout contract: the C++ constants, the Python ones and chain_lib's check
# ---------------------------------------------------------------------------

def _cxx_constants() -> dict:
    import re
    src = (tgen._native.CSRC / "decode_chain_tc.cuh").read_text()
    return {name: int(v) for name, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def test_chain_layout_constants_match_the_cuda_source():
    c = _cxx_constants()
    assert (c["kKAlign"], c["kGemvN"], c["kKeyTile"], c["kMaxSplits"],
            c["kLaneGroup"], c["kGroupMaxKeys"]) == (
        tparams.K_ALIGN, tparams.N_ALIGN, tgen.KEY_TILE,
        tgen.MAX_DECODE_SPLITS, tgen.LANE_GROUP, tgen.GROUP_MAX_KEYS)


@pytest.mark.parametrize("dh", [50, 64])
def test_grouped_attention_shared_memory_fits_its_blocks(dh):
    """grouped_attn_smem (csrc/decode_chain_tc.cuh) at a split of
    GROUP_MAX_KEYS keys: GROUP_BLOCKS_PER_SM blocks fit a multiprocessor's
    228 KB (1 KB reserved a block) at the baseline's d_head 50, one block
    (the grid then takes two waves) up to the chain's d_head cap of 64; a
    block is one warp a lane of the group, and the merge's weights fit the
    stage ring it reuses."""
    c = _cxx_constants()
    tile = (c["kGroupTile"] * dh * 2 + 39 + 15) // 16 * 16
    ring = c["kGroupStages"] * (c["kLaneGroup"] + 1) * tile
    smem = 16 * c["kLaneGroup"] * 32 + ring + 4 * (
        c["kLaneGroup"] * tgen.GROUP_MAX_KEYS + 4)
    blocks = tgen.GROUP_BLOCKS_PER_SM if dh == 50 else 1
    assert blocks * (smem + 1024) <= 228 * 1024
    assert smem <= 227 * 1024
    assert 4 * 2 * c["kMaxSplits"] * c["kLaneGroup"] <= ring
    assert c["kGroupTile"] == 32 and c["kGroupStages"] >= 2


def test_gen_args_mirror_the_cuda_struct():
    """GenArgs lists the fields of struct GenArgs (csrc/decode_chain.cuh)
    in order, the lane group and the arrival counts included."""
    import re
    src = (tgen._native.CSRC / "decode_chain.cuh").read_text()
    body = src[src.index("struct GenArgs {"):]
    body = re.sub(r"//[^\n]*", "", body[:body.index("};")])
    decls = re.findall(r"^\s*(?:const\s+)?\w+\s*\*?\s*([\w\s,]+);", body,
                       re.M)
    names = [v.strip() for d in decls for v in d.split(",")]
    assert names == [f[0] for f in tgen.GenArgs._fields_]
    assert names.index("lane_group") == names.index("splits") + 1
    assert names[-1] == "arrive"


class _FakeLib:
    """What chain_lib reads of the library, with a chosen layout."""

    def __init__(self, layout, size=None):
        self.layout, self.size = layout, size

    def tg_sizeof_gen_args(self):
        import ctypes
        return self.size or ctypes.sizeof(tgen.GenArgs)

    def tg_decode_chain_layout(self, out):
        for i, v in enumerate(self.layout):
            out[i] = v


@pytest.mark.parametrize("layout, size, ok", [
    ((32, 8, 256, 64, 8, 512), None, True),
    ((16, 8, 256, 64, 8, 512), None, False),   # W^T K padding drifted
    ((32, 8, 128, 64, 8, 512), None, False),   # key tile drifted
    ((32, 8, 256, 64, 8, 512), 8, False),      # GenArgs layout drifted
    ((32, 8, 256, 64, 16, 512), None, False),  # lane group drifted
    ((32, 8, 256, 64, 8, 256), None, False),   # grouped split's keys drifted
])
def test_chain_lib_checks_the_library_layout(monkeypatch, layout, size, ok):
    fake = _FakeLib(layout, size)
    monkeypatch.setattr(tgen._native, "lib", lambda: fake)
    if ok:
        assert tgen.chain_lib() is fake
    else:
        with pytest.raises(RuntimeError):
            tgen.chain_lib()


def test_profile_generate_ablation_edits_match_the_sources():
    from transformer_gan_torch import profile_generate as pg
    for edits in pg.ABLATIONS.values():
        for name, old, _ in edits:
            assert (tgen._native.CSRC / name).read_text().count(old) == 1
