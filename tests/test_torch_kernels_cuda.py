"""The port's CUDA kernels against their plain PyTorch versions on the card
(``gpu`` marker; skipped where CUDA is absent). Run on a machine with an
H100: ``python -m pytest tests/test_torch_kernels_cuda.py -q``.

Shapes are the baseline model's (H 10, d_head 50, HD 500, DI 1000, V 310)
at a shortened memory, plus one case at the full M 4146; the tolerances are
those of transformer_gan_torch.kernel_check. The backward kernels (K1b, K2b)
and the forwards with dropout are checked with and without dropout and
reset rows, in fp32 and bf16; the same_length window without memory; the
bf16 tensor-core K2f / K2b at ragged shapes, with split keys at M 4146 and
at the training batch; the bf16 tensor-core K1f / K1b at the MLE step's
shape, the cnn config's, ragged q at M 4146 and the prime shape with split
keys; the GAN sampler (K4, K5) and reverse chain (K6, K7) at M 64, B 8, 24 and 64,
with an odd count; the bf16 decode chain of K3 / K4 / K5 (split-key decode
attention, lane-tiled GEMVs) at B 1, 3 and 8 with M 4146 and ragged M, at
the GAN op-point and narrower lane tiles, K5 at step 5, determinism and its
launch counters; the bf16 reverse chain of K6 / K7 (csrc/chain_bwd_tc.cu)
at B 72, 64, 40, 8 and 5, n 59 and 27, full and odd counts, post- and pre-norm,
determinism and its launch counters; K4 / K5 and K6 / K7 at the spanbert
op-point's shapes (B 32, M 128, n 59 and 64), fp32 and bf16; K3 on the
quality metrics' gumbel-argmax route (same_length off) at B 8, 16 and 32,
M 2048, and the metrics' generation on the card against the CPU."""

import pytest
import torch

from transformer_gan_torch import _native
from transformer_gan_torch import kernel_check as kc
from transformer_gan_torch.ops import generate as gen_ops

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("variant", ["v2", "v1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q,B,count,same_length", [
    (50, 1, 0, True), (128, 3, 200, True), (9, 2, 300, False),
    (128, 1, 300, False),
])
def test_attention_kernel_matches_plain(cuda, variant, dtype, q, B, count,
                                        same_length):
    res = kc.check_attention(variant, dtype, q, B, count, M=300,
                             same_length=same_length)
    assert res["ok"], res


@pytest.mark.parametrize("variant", ["v2", "v1"])
def test_attention_kernel_reset_rows_full_memory(cuda, variant):
    reset = torch.tensor([0, 1, 0], device=cuda, dtype=torch.int32)
    res = kc.check_attention(variant, torch.float32, 128, 3, kc.MEM_LEN,
                             reset=reset)
    assert res["ok"], res


@pytest.mark.parametrize("B,count", [(1, 0), (3, 100), (8, 300)])
def test_generate_kernel_fp32_ids_identical(cuda, B, count):
    res = kc.check_generate("float32", B, count, M=300)
    assert res["ok"], res


def test_generate_kernel_bf16_first_logits(cuda):
    res = kc.check_generate("bfloat16", 2, 300, M=300)
    assert res["ok"], res


def test_wrappers_count_launches(cuda):
    _native.reset_launches()
    kc.check_attention("v2", torch.float32, 16, 1, 0, M=64)
    kc.check_generate("float32", 1, 0, chunks=(3,), M=64)
    assert _native.LAUNCHES["xl_attn_fwd_v2"] == 1
    assert _native.LAUNCHES["generate_chunk"] == 1


@pytest.mark.parametrize("variant", ["v2", "v1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q,B,M,count,rate,same_length", [
    (128, 2, 300, 200, 0.0, False), (128, 2, 300, 300, 0.1, False),
    (16, 3, 40, 17, 0.3, True), (128, 1, 0, 0, 0.1, False),
    # B 17 > the 8 drk batch splits: splits of 3 batches, the last two empty
    (128, 17, 300, 300, 0.1, False),
])
def test_attention_bwd_kernel_matches_plain(cuda, variant, dtype, q, B, M,
                                            count, rate, same_length):
    res = kc.check_attention_bwd(variant, dtype, q, B, count, M, rate=rate,
                                 same_length=same_length)
    assert res["ok"], res


@pytest.mark.parametrize("variant", ["v2", "v1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_bwd_kernel_reset_rows(cuda, variant, dtype):
    reset = torch.tensor([0, 1, 0], device=cuda, dtype=torch.int32)
    res = kc.check_attention_bwd(variant, dtype, 128, 3, 256, 256, rate=0.1,
                                 reset=reset)
    assert res["ok"], res


def test_backward_wrappers_count_launches(cuda):
    _native.reset_launches()
    kc.check_attention_bwd("v2", torch.float32, 16, 1, 8, 8)
    kc.check_attention_bwd("v1", torch.float32, 16, 1, 0, 8)
    assert _native.LAUNCHES["xl_attn_bwd_v2"] == 1
    assert _native.LAUNCHES["xl_attn_bwd_v1"] == 1
    assert _native.LAUNCHES["xl_attn_fwd_v2"] == 1
    assert _native.LAUNCHES["xl_attn_fwd_v1"] == 1


@pytest.mark.parametrize("variant", ["v2", "v1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_average_a_window_with_every_key_masked(cuda, variant, dtype):
    """same_length with no memory masks every key. Like the JAX kernels and
    the plain versions, the kernels average all values uniformly, forward
    and backward."""
    fwd = kc.check_attention(variant, dtype, 37, 3, 0, M=0, same_length=True)
    assert fwd["ok"], fwd
    res = kc.check_attention_bwd(variant, dtype, 37, 3, 0, 0, same_length=True)
    assert res["ok"], res


# ---------------------------------------------------------------------------
# K2f / K2b in bf16: the tensor-core kernels (split-key forward)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("q,B,M,count,same_length", [
    (50, 2, 300, 300, False),   # klen 350: not a multiple of 64
    (77, 2, 300, 120, True),    # odd klen 377: 2-byte loads, ragged rows
    (77, 3, 0, 0, False),       # no memory, one ragged query tile
])
def test_tc_attention_ragged_shapes(cuda, q, B, M, count, same_length, rate):
    fwd = kc.check_attention("v1", torch.bfloat16, q, B, count, M=M,
                             same_length=same_length)
    assert fwd["ok"], fwd
    res = kc.check_attention_bwd("v1", torch.bfloat16, q, B, count, M,
                                 rate=rate, same_length=same_length)
    assert res["ok"], res


@pytest.mark.parametrize("B,count,reset", [
    (1, 0, None), (1, 2000, None), (1, kc.MEM_LEN, None),
    (3, kc.MEM_LEN, [0, 1, 0]),
])
def test_tc_forward_splits_the_keys_at_the_prime_shape(cuda, B, count, reset):
    """M 4146 at B 1 and 3 leaves the card under-filled: the keys are split
    and merged by the combine kernel, checked against the plain version and
    the plain combine of as many key ranges."""
    if reset is not None:
        reset = torch.tensor(reset, device=cuda, dtype=torch.int32)
    res = kc.check_attention("v1", torch.bfloat16, 128, B, count,
                             reset=reset)
    assert res["splits"] > 1, res
    assert res["ok"], res


def test_tc_split_forward_is_deterministic(cuda):
    kernel, _, args = kc.attention_case("v1", torch.bfloat16, 128, 1,
                                        kc.MEM_LEN)
    first = kernel(*args)
    again = kernel(*args)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_tc_backward_at_the_training_shape(cuda):
    """B 128, M 0, dropatt 0.1: the shape the MLE step at mem 0 runs."""
    res = kc.check_attention_bwd("v1", torch.bfloat16, 128, 128, 0, 0,
                                 rate=0.1)
    assert res["ok"], res


def test_bf16_k2_runs_the_tensor_core_kernels(cuda):
    _native.reset_launches()
    kc.check_attention_bwd("v1", torch.bfloat16, 16, 1, 0, 8)
    kc.check_attention_bwd("v1", torch.float32, 16, 1, 0, 8)
    assert _native.LAUNCHES["xl_attn_fwd_v1"] == 2
    assert _native.LAUNCHES["xl_attn_bwd_v1"] == 2
    assert _native.LAUNCHES["xl_attn_fwd_v1_tc"] == 1
    assert _native.LAUNCHES["xl_attn_bwd_v1_tc"] == 1


# ---------------------------------------------------------------------------
# K1f / K1b in bf16: the tensor-core kernels (position term in the tiles)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q,B,M,count,rate,same_length", [
    (128, 128, 1024, 1024, 0.1, False),   # the MLE step
    (512, 16, 128, 128, 0.1, False),      # the cnn config's MLE step
    (128, 3, 300, 200, 0.1, True),        # count < M, same_length
    (50, 2, kc.MEM_LEN, 3000, 0.1, False),   # ragged q: windows below row 0
    (77, 2, kc.MEM_LEN, kc.MEM_LEN, 0.0, True),
    (37, 3, 0, 0, 0.1, False),            # no memory, one ragged tile
])
def test_tc_k1_matches_plain(cuda, q, B, M, count, rate, same_length):
    _native.reset_launches()
    res = kc.check_attention_bwd("v2", torch.bfloat16, q, B, count, M,
                                 rate=rate, same_length=same_length)
    assert res["ok"], res
    assert _native.LAUNCHES["xl_attn_fwd_v2_tc"] == 1
    assert _native.LAUNCHES["xl_attn_bwd_v2_tc"] == 1


@pytest.mark.parametrize("q,B,count,reset", [
    (128, 1, kc.MEM_LEN, None), (128, 1, 0, None), (50, 1, 2000, None),
    (128, 3, kc.MEM_LEN, [0, 1, 0]), (77, 8, kc.MEM_LEN, None),
])
def test_tc_k1_forward_splits_the_keys_at_the_prime_shape(cuda, q, B, count,
                                                          reset):
    """M 4146 at B 1-8: the keys are split and merged by the combine kernel,
    checked against the plain version and the plain combine of as many key
    ranges (count 0: the splits over the memory see no open key)."""
    if reset is not None:
        reset = torch.tensor(reset, device=cuda, dtype=torch.int32)
    res = kc.check_attention("v2", torch.bfloat16, q, B, count, reset=reset)
    assert res["splits"] > 1, res
    assert res["ok"], res


def test_tc_k1_reset_rows_and_masked_window(cuda):
    reset = torch.tensor([0, 1, 0], device=cuda, dtype=torch.int32)
    res = kc.check_attention_bwd("v2", torch.bfloat16, 128, 3, 1024, 1024,
                                 rate=0.1, reset=reset)
    assert res["ok"], res
    for q in (128, 37):   # same_length without memory: every key masked
        fwd = kc.check_attention("v2", torch.bfloat16, q, 8, 0, M=0,
                                 same_length=True)
        assert fwd["ok"], fwd
        res = kc.check_attention_bwd("v2", torch.bfloat16, q, 8, 0, 0,
                                     same_length=True)
        assert res["ok"], res


def test_tc_k1_split_forward_and_drk_are_deterministic(cuda):
    kernel, _, args = kc.attention_case("v2", torch.bfloat16, 128, 1,
                                        kc.MEM_LEN)
    for a, b in zip(kernel(*args), kernel(*args)):
        assert torch.equal(a, b)
    fwd, _, bwd, _, fa, ba, kw = kc.attention_bwd_case(
        "v2", torch.bfloat16, 128, 17, 300, 300, rate=0.1)
    args = ba(*fwd(*fa, **kw))
    for a, b in zip(bwd(*args, **kw), bwd(*args, **kw)):
        assert torch.equal(a, b)


def test_bf16_k1_runs_the_tensor_core_kernels(cuda):
    """bf16 K1f / K1b launch the tensor-core kernels; fp32 keeps the
    CUDA-core kernels (the exact on-card reference)."""
    _native.reset_launches()
    kc.check_attention_bwd("v2", torch.bfloat16, 16, 1, 8, 8)
    kc.check_attention_bwd("v2", torch.float32, 16, 1, 8, 8)
    assert _native.LAUNCHES["xl_attn_fwd_v2"] == 2
    assert _native.LAUNCHES["xl_attn_bwd_v2"] == 2
    assert _native.LAUNCHES["xl_attn_fwd_v2_tc"] == 1
    assert _native.LAUNCHES["xl_attn_bwd_v2_tc"] == 1


# ---------------------------------------------------------------------------
# K4 / K5: the GAN's gumbel sampler; K6 / K7: its reverse chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [False, True], ids=["K4", "K5"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,count", [(8, 0), (64, 37), (24, 64)])
def test_decode_kernels_match_plain(cuda, step, dtype, B, count):
    res = kc.check_decode(dtype, B, count, chunks=(32, 27), step=step)
    assert res["ok"], res


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,count,T", [(8, 0, 1.0), (8, 64, 0.5),
                                       (64, 37, 1.0)])
def test_chain_kernels_match_plain(cuda, dtype, B, count, T):
    res = kc.check_chain(dtype, B, count, T, n=27)
    assert res["ok"], res


def test_gan_wrappers_count_launches(cuda):
    _native.reset_launches()
    case = kc.DecodeCase("float32", 8, 10)
    g = case.noise(3)
    case.run(3, g)
    case.run_steps(3, g)
    chain = kc.ChainCase("float32", 8, 10, n=4)
    chain.run("res")
    chain.run("recompute")
    chain.run("plain")
    assert _native.LAUNCHES["decode_chunk"] == 1
    assert _native.LAUNCHES["decode_step"] == 3
    assert _native.LAUNCHES["chain_bwd_res"] == 1
    assert _native.LAUNCHES["chain_bwd_recompute"] == 1


# ---------------------------------------------------------------------------
# The bf16 decode chain (K3, K4, K5: csrc/decode_chain_tc.cuh): split-key
# decode attention, lane-tiled GEMVs; held against the plain versions with
# the kernel's splits and without (kernel_check.check_generate / check_decode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,M,count", [
    (1, kc.MEM_LEN, kc.MEM_LEN),   # the op-point: front-padded, full, 27 splits
    (3, kc.MEM_LEN, 2000),         # partly filled: splits cross the ring seam
    (8, kc.MEM_LEN, kc.MEM_LEN),
    (1, 77, 0),                    # ragged M, empty cache: only the ring
    (3, 77, 40),
    (8, 300, 300),
    (1, 20000, 20000),             # 64 splits of ~313 keys: two tiles a split
])
def test_bf16_chain_generate_matches_plain(cuda, B, M, count):
    res = kc.check_generate("bfloat16", B, count, M=M)
    assert res["ok"], res


@pytest.mark.parametrize("B,M,count,kw", [
    (32, 2048, 0, {"technique": "gumbel", "same_length": False}),
    (32, 2048, 256, {"technique": "gumbel", "same_length": False}),
    (32, 2048, 1024, {"technique": "gumbel", "same_length": False}),
    (32, 2048, 2016, {"technique": "gumbel", "same_length": False}),
    (12, kc.MEM_LEN, kc.MEM_LEN, {}),   # a ragged last lane group
])
def test_bf16_chain_generate_grouped_matches_plain(cuda, B, M, count, kw):
    """K3 on the lane-grouped decode attention (the metrics eval's wave,
    B 32 at M 2048): the route's splits, one generate_chunk_grouped count a
    call (check_generate holds both)."""
    res = kc.check_generate("bfloat16", B, count, M=M, **kw)
    assert res["ok"], res
    assert all(c["lane_group"] == gen_ops.LANE_GROUP for c in res["chunks"])


def test_bf16_chain_generate_forced_grouped_at_one_lane(cuda):
    """The grouped kernel with a group of one lane (B 1, M 4146), which the
    route leaves to split_attn_kernel, against the plain version."""
    with kc.forced_route(gen_ops.LANE_GROUP):
        res = kc.check_generate("bfloat16", 1, kc.MEM_LEN)
    assert res["ok"], res


def test_bf16_chain_counts_grouped_launches(cuda):
    """The "_grouped" counters count the calls on lane groups: K3 at
    evalgen's shape, not at B 2; K4 and K5 not at the GAN's shapes (B 64 at
    M 64, B 32 at M 128, B 8 at M 128), but at B 8, M 1024, where the
    grouped grid fills the card."""
    _native.reset_launches()
    case = kc.GenerateCase("bfloat16", 32, 100, M=2048)
    case.run(2, case.noise(2))
    small = kc.GenerateCase("bfloat16", 2, 10, M=64)
    small.run(3, small.noise(3))
    for B, M in ((64, kc.GAN_MEM), (32, 128), (8, 128)):
        dec = kc.DecodeCase("bfloat16", B, M, M=M)
        dec.run(3, dec.noise(3))
        dec.run_steps(2, dec.noise(2))
    assert _native.LAUNCHES["generate_chunk_tc"] == 2
    assert _native.LAUNCHES["generate_chunk_grouped"] == 1
    assert _native.LAUNCHES["decode_chunk_tc"] == 3
    assert _native.LAUNCHES["decode_step_tc"] == 6
    assert _native.LAUNCHES["decode_chunk_grouped"] == 0
    assert _native.LAUNCHES["decode_step_grouped"] == 0
    dec = kc.DecodeCase("bfloat16", 8, 1024, M=1024)
    dec.run(3, dec.noise(3))
    dec.run_steps(2, dec.noise(2))
    assert _native.LAUNCHES["decode_chunk_grouped"] == 1
    assert _native.LAUNCHES["decode_step_grouped"] == 2


@pytest.mark.parametrize("step", [False, True])
def test_bf16_chain_decode_grouped_matches_plain(cuda, step):
    """K4 (and K5) at B 8, M 1024, where the route takes lane groups (no
    GAN caller does), against the plain version with its splits;
    check_decode holds each launch's grouped count against the route."""
    res = kc.check_decode("bfloat16", 8, 1024, M=1024, step=step)
    assert res["ok"], res
    assert all(c["lane_group"] == gen_ops.LANE_GROUP for c in res["chunks"])


@pytest.mark.parametrize("B,count", [(64, 0), (64, 37), (64, kc.GAN_MEM),
                                     (5, 30), (40, kc.GAN_MEM)])
def test_bf16_chain_decode_chunk_matches_plain(cuda, B, count):
    """K4 at the GAN op-point (B 64, M 64), a narrow lane tile (B 5) and
    three m-tiles (B 40)."""
    res = kc.check_decode("bfloat16", B, count)
    assert res["ok"], res


def test_bf16_chain_decode_step_at_step_5(cuda):
    """K5 at chunk step 5 of a 32-row ring holding five earlier rows: the
    staged row it writes against the plain step with the kernel's splits
    and without, within ATTN_REL_TOL_BF16 x max|ref|."""
    case = kc.DecodeCase("bfloat16", 64, kc.GAN_MEM)
    L, _, H, B, _, dh = case.kv.shape
    gen = torch.Generator(device="cuda").manual_seed(3)
    ring = (torch.randn((L, 2, H, B, 32, dh), generator=gen, device="cuda")
            * 0.5).to(case.kv.dtype)
    ring[..., 5:, :] = 0
    g = case.noise(1)[0]
    out = case.ops.fused_decode_step(case.stacked, case.cfg, case.kv, case.R,
                                     ring.clone(), case.ids, g, 5, case.count)
    for splits in (case.splits(32), None):
        ref = case.ops.fused_decode_step_plain(
            case.stacked, case.cfg, case.kv, case.R, ring.clone(), case.ids, g,
            5, case.count, splits)
        row, ref_row = out[2][..., 5, :].float(), ref[2][..., 5, :].float()
        assert torch.equal(out[2][..., :5, :], ring[..., :5, :])
        err = float((row - ref_row).abs().max())
        assert err <= kc.ATTN_REL_TOL_BF16 * float(ref_row.abs().max()), err
        assert torch.equal(out[1].argmax(-1).view(B, 1), out[0].long())


def test_bf16_chain_is_deterministic(cuda):
    """The fixed-order split combine and K-split sums: two runs give
    bitwise-equal ids and staged rows."""
    gen_case = kc.GenerateCase("bfloat16", 1, kc.MEM_LEN)
    g = gen_case.noise(32)
    a, b = gen_case.run(32, g), gen_case.run(32, g)
    assert torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])
    dec = kc.DecodeCase("bfloat16", 64, kc.GAN_MEM)
    g = dec.noise(32)
    a, b = dec.run(32, g), dec.run(32, g)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(a[2], b[2])


def test_bf16_chain_counts_launches(cuda):
    _native.reset_launches()
    for dtype in ("float32", "bfloat16"):
        case = kc.GenerateCase(dtype, 2, 10, M=64)
        case.run(3, case.noise(3))
    dec = kc.DecodeCase("bfloat16", 8, 10)
    g = dec.noise(3)
    dec.run(3, g)
    dec.run_steps(3, g)
    assert _native.LAUNCHES["generate_chunk"] == 2
    assert _native.LAUNCHES["generate_chunk_tc"] == 1
    assert _native.LAUNCHES["decode_chunk"] == _native.LAUNCHES["decode_chunk_tc"] == 1
    assert _native.LAUNCHES["decode_step"] == _native.LAUNCHES["decode_step_tc"] == 3


# ---------------------------------------------------------------------------
# K6 / K7 in bf16 on the reverse chain of csrc/chain_bwd_tc.cu: lane-tiled
# GEMVs with the LayerNorm backwards in their prologues; held against the
# plain chain within CHAIN_REL_TOL_BF16 x max|Q_ref| (kernel_check.check_chain)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,n,count,T,pre", [
    (64, 59, kc.GAN_MEM, 1.0, False),  # the op-point
    (64, 59, 37, 0.7, False),          # odd count: the window's left edge moves
    (8, 27, 0, 1.0, False),            # empty memory
    (5, 27, 37, 0.7, False),           # one narrow lane tile
    (40, 59, kc.GAN_MEM, 1.0, False),  # three m-tiles
    (72, 27, 37, 1.0, False),          # two lane tiles, the second of 8
    (64, 27, 37, 1.0, True),           # pre-LN
    (5, 59, kc.GAN_MEM, 0.7, True),
])
def test_bf16_reverse_chain_matches_plain(cuda, B, n, count, T, pre):
    res = kc.check_chain("bfloat16", B, count, T, n=n, pre_lnorm=pre)
    assert res["ok"], res


def test_bf16_reverse_chain_is_deterministic(cuda):
    """Fixed-order sums, no atomics: two calls give bitwise-equal Q."""
    chain = kc.ChainCase("bfloat16", 64, kc.GAN_MEM)
    for variant in ("res", "recompute"):
        assert torch.equal(chain.run(variant), chain.run(variant)), variant


def test_bf16_reverse_chain_counts_launches(cuda):
    """The _tc counters move for bf16 only; the plain names count both."""
    _native.reset_launches()
    for dtype in ("float32", "bfloat16"):
        chain = kc.ChainCase(dtype, 8, 10, n=4)
        chain.run("res")
        chain.run("recompute")
    assert _native.LAUNCHES["chain_bwd_res"] == 2
    assert _native.LAUNCHES["chain_bwd_recompute"] == 2
    assert _native.LAUNCHES["chain_bwd_res_tc"] == 1
    assert _native.LAUNCHES["chain_bwd_recompute_tc"] == 1


# ---------------------------------------------------------------------------
# The spanbert op-point: 32 GAN lanes, M 128, chunks of 59 and 64 tokens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [False, True], ids=["K4", "K5"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("count", [0, 4])
def test_decode_kernels_at_the_spanbert_shape(cuda, step, dtype, count):
    """A micro-batch's four calls on one ring: 32 and 27 tokens (chunk 0),
    then 32 and 32 (chunk 1, counts above 0); the bf16 GEMVs on two
    m-tiles."""
    res = kc.check_decode(dtype, 32, count, chunks=(32, 27, 32, 32),
                          step=step, M=128)
    assert res["ok"], res


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,count", [(59, 4), (64, 63), (64, 128)])
def test_chain_kernels_at_the_spanbert_shape(cuda, dtype, n, count):
    """K6 / K7 at n 59 (chunk 0 after the prime) and n 64, the largest
    chunk the chain takes at M 128 (KL 192)."""
    res = kc.check_chain(dtype, 32, count, 1.0, n=n, M=128)
    assert res["ok"], res


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,count", [(8, 0), (16, 32), (32, 2016)])
def test_generate_kernel_gumbel_route_at_the_metrics_shape(cuda, dtype, B,
                                                           count):
    res = kc.check_generate(dtype, B, count, chunks=(32, 31), M=2048,
                            technique="gumbel", same_length=False)
    assert res["ok"], res


def test_generate_tokens_gumbel_card_matches_cpu(cuda):
    """fp32 gumbel-argmax generation at full width (B 4, 100 tokens on a
    48-slot ring that wraps): K3 on the card, its plain version on the CPU,
    the same noise; ids identical."""
    from transformer_gan_torch.infer import sample as sampling
    from transformer_gan_torch.models import xl
    cfg = kc.baseline_config("float32")
    params = xl.init_xl_params(cfg, seed=2, base_init=("normal", 0.02))
    g = sampling.gumbel_draws(99, 4, cfg.n_token,
                              torch.Generator().manual_seed(3))
    out = {}
    _native.reset_launches()
    for dev in ("cuda", "cpu"):
        p = {k: v.to(dev) for k, v in params.items()}
        out[dev] = sampling.generate_tokens_gumbel(
            p, cfg, 100, torch.zeros(4, dtype=torch.long, device=dev),
            xl.init_mems(cfg, 48, 4, device=dev), g.to(dev)).cpu()
    assert torch.equal(out["cuda"], out["cpu"])
    assert _native.LAUNCHES["generate_chunk"] == 4       # 99 = 3 x 32 + 3


def test_generate_tokens_gumbel_splits_a_wide_wave_into_k3_sub_waves(cuda):
    """A 64-lane bf16 wave at full width runs as two 32-lane sub-waves, each
    on K3's tensor-core route (one 32-token chunk each), never on the plain
    decode; each sub-wave's ids equal a direct 32-lane call's."""
    from transformer_gan_torch.infer import sample as sampling
    from transformer_gan_torch.models import xl
    cfg = kc.baseline_config("bfloat16")
    params = {k: v.cuda() for k, v in xl.init_xl_params(
        cfg, seed=2, base_init=("normal", 0.02)).items()}
    g = sampling.gumbel_draws(32, 64, cfg.n_token,
                              torch.Generator().manual_seed(3)).cuda()
    first = torch.zeros(64, dtype=torch.long, device="cuda")
    mems = xl.init_mems(cfg, 64, 64, device="cuda")
    _native.reset_launches()
    wide = sampling.generate_tokens_gumbel(params, cfg, 33, first, mems, g)
    assert _native.LAUNCHES["generate_chunk_tc"] == 2
    assert _native.LAUNCHES["generate_chunk"] == 2
    assert wide.shape == (33, 64)
    for s in (0, 32):
        half = sampling.generate_tokens_gumbel(
            params, cfg, 33, first[s:s + 32],
            xl.init_mems(cfg, 64, 32, device="cuda"), g[:, s:s + 32])
        assert torch.equal(wide[:, s:s + 32], half)
