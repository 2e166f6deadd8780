"""Fused chunk sampling for generation on Hopper (``csrc/generate.cu``).

``fused_generate_chunk`` replaces ``pallas_generate.fused_generate_chunk``:
``n`` tokens sampled in one call, each one embed -> all layers against the
big K/V cache plus the staged ring -> logits -> surgery -> softmax -> top-k
-> floor -> gumbel argmax -> feedback. Operands and returns follow the JAX
contract, except that the big K/V cache comes in, and the chunk's staged
K/V rows go out, in the XL memory's h-major layout (``XLMems.hids``), so the
chunk loop converts no layout. On a CUDA tensor it launches the kernel
chain or raises; on a CPU tensor it runs :func:`fused_generate_chunk_plain`,
which is also what the card checks the kernel against.

fp32 runs the chain of ``csrc/decode_chain.cuh``, the exact on-card
reference. bf16 runs ``csrc/decode_chain_tc.cuh``: decode attention with
the keys split across blocks and merged in split order (:func:`decode_route`
picks the kernel and the splits by shape: lane groups that share each R row
where there are enough lanes and keys to fill the card, one block a lane
otherwise), and GEMVs that
read each weight once for all lanes, from the W^T copies
``stack_decode_params`` adds in bf16. Its plain counterpart is
:func:`fused_generate_chunk_plain` with ``splits``, which rounds where the
split kernel rounds (:func:`decode_attention_plain`).

The gumbel noise ``g [n, B, V]`` is an input: the caller draws it (from an
explicit ``torch.Generator``), so both versions, and the JAX package, can
be fed the same numbers.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _native
from ..models.attention import layer_norm
from ..utils import spans
from .attention import combine_splits_plain
from .decode_params import K_ALIGN, N_ALIGN

MAX_CHUNK = 32
MAX_LANES = 32
TECHNIQUES = {"topk": 0, "random": 1, "gumbel": 2}

# bf16 decode attention splits each token's keys across blocks when H x B
# would leave the card under-filled (enough (h, b, split) blocks for about
# two waves, at least MIN_SPLIT_KEYS keys a split) and so that a split fits
# one KEY_TILE-key shared tile; the combine takes up to MAX_DECODE_SPLITS
# (kKeyTile and kMaxSplits of csrc/decode_chain_tc.cuh: chain_lib checks
# them against the library)
MIN_SPLIT_KEYS = 64
KEY_TILE = 256
MAX_DECODE_SPLITS = 64
# the lane-grouped decode attention (grouped_split_attn_kernel; kLaneGroup,
# kGroupMaxKeys): a block takes LANE_GROUP lanes of one head and one split
# of at most GROUP_MAX_KEYS keys, and GROUP_BLOCKS_PER_SM of them fit a
# multiprocessor at d_head 50 (~103-108 KB of shared memory each)
LANE_GROUP = 8
GROUP_MAX_KEYS = 512
GROUP_BLOCKS_PER_SM = 2
# the bf16 chain's W^T operands (ops/decode_params.stack_decode_params)
_STACKED_TC = ("qkv_t", "o_t", "ff1_t", "ff2_t", "lg_t")


def decode_key_splits(H: int, B: int, n_keys: int, n_sm: int) -> int:
    """Key splits of the bf16 decode attention for ``H`` heads, ``B`` lanes
    and up to ``n_keys`` keys a token on a card of ``n_sm`` streaming
    multiprocessors (1: each block takes every key of its (h, b))."""
    blocks = H * B
    fill = (1 if blocks >= 2 * n_sm
            else min(-(-2 * n_sm // blocks), n_keys // MIN_SPLIT_KEYS))
    return max(1, min(max(fill, -(-n_keys // KEY_TILE)), MAX_DECODE_SPLITS))


def grouped_key_splits(H: int, B: int, n_keys: int, n_sm: int) -> int:
    """Key splits of the lane-grouped decode attention: as many (h, lane
    group, split) blocks as the card holds at once (GROUP_BLOCKS_PER_SM a
    multiprocessor, so the grid is one wave), at least MIN_SPLIT_KEYS keys a
    split, and at most GROUP_MAX_KEYS (the split's scores stay in shared
    memory)."""
    blocks = H * -(-B // LANE_GROUP)
    fill = min(GROUP_BLOCKS_PER_SM * n_sm // blocks, n_keys // MIN_SPLIT_KEYS,
               MAX_DECODE_SPLITS)
    return max(1, -(-n_keys // GROUP_MAX_KEYS), fill)


def decode_route(H: int, B: int, n_keys: int, n_sm: int) -> tuple[int, int]:
    """(lane group, key splits) of the bf16 decode attention for ``H`` heads,
    ``B`` lanes and up to ``n_keys`` keys a token on a card of ``n_sm``
    multiprocessors. Where the keys are split (:func:`decode_key_splits` >
    1), there are at least LANE_GROUP lanes and the lane-grouped grid
    (heads x lane groups x :func:`grouped_key_splits`) has a block for each
    multiprocessor, the lane-grouped kernel (group LANE_GROUP); else
    ``split_attn_kernel`` (group 0) with :func:`decode_key_splits`. A
    thinner grouped grid lost on the H100: 20 blocks at B 8, 160 keys."""
    splits = decode_key_splits(H, B, n_keys, n_sm)
    if (splits > 1 and B >= LANE_GROUP
            and n_keys <= GROUP_MAX_KEYS * MAX_DECODE_SPLITS):
        grouped = grouped_key_splits(H, B, n_keys, n_sm)
        if H * -(-B // LANE_GROUP) * grouped >= n_sm:
            return LANE_GROUP, grouped
    return 0, splits


def split_bounds(n_keys: int, splits: int) -> list[tuple[int, int]]:
    """(first key, keys) of each split of a token's ``n_keys`` keys: the
    ranges ``torch.tensor_split`` cuts and ``split_attn_kernel`` takes
    (``lo = s * (n // S) + min(s, n % S)``)."""
    base, rem = divmod(n_keys, splits)
    return [(s * base + min(s, rem), base + (1 if s < rem else 0))
            for s in range(splits)]


def r_heads_major(R: torch.Tensor, n_head: int) -> torch.Tensor:
    """R [L, M+1, HD] -> [L, H, M+1, dh]: each head's position rows one run
    of bytes, as the bf16 decode attention copies them."""
    L, rows, HD = R.shape
    return R.view(L, rows, n_head, HD // n_head).permute(0, 2, 1, 3).contiguous()


def chain_route(H: int, B: int, n_keys: int, device) -> tuple[int, int]:
    """:func:`decode_route` on ``device``'s card."""
    return decode_route(H, B, n_keys, torch.cuda.get_device_properties(
        device).multi_processor_count)


def chain_lib() -> ctypes.CDLL:
    """The kernel library, checked against this side of the decode chain's
    contract: the ``GenArgs`` layout, and the bf16 chain's W^T padding, key
    tile, split cap, lane group and grouped split's key cap as
    ``csrc/decode_chain_tc.cuh`` fixes them (``tg_decode_chain_layout``)."""
    lib = _native.lib()
    if ctypes.sizeof(GenArgs) != lib.tg_sizeof_gen_args():
        raise RuntimeError("GenArgs layout differs from csrc/decode_chain.cuh")
    got = (ctypes.c_int * 6)()
    lib.tg_decode_chain_layout(got)
    want = (K_ALIGN, N_ALIGN, KEY_TILE, MAX_DECODE_SPLITS, LANE_GROUP,
            GROUP_MAX_KEYS)
    if tuple(got) != want:
        raise RuntimeError(
            f"bf16 decode chain layout (K align, N align, key tile, max "
            f"splits, lane group, grouped split keys): library "
            f"{tuple(got)}, Python {want}")
    return lib


def chain_design(dtype) -> str:
    """Which decode chain a dtype runs on the card."""
    if dtype == torch.bfloat16:
        return ("bf16 chain (decode_chain_tc.cuh): split-key decode attention "
                "(lane groups of 8 sharing each R row through a pipelined "
                "stage ring, the last split's block merging in split order, "
                "at >= 8 lanes where that grid fills the card; else a block "
                "a lane and a fixed-order combine kernel), lane-tiled mma.sync GEMVs with LayerNorm "
                "prologues and residual epilogues, 5 launches a layer (6 "
                "with split keys below 8 lanes) + 2 a token")
    return "fp32 chain (decode_chain.cuh), the exact on-card reference"


def decode_attention_plain(keys, vals, r_rows, qw, qr, scale: float,
                           splits: int | None = None) -> torch.Tensor:
    """One token's attention over its unmasked keys: keys, vals
    [H, B, nk, dh]; r_rows [nk, H, dh] (the position rows by distance); qw,
    qr [B, H, dh] (q + r_w_bias, q + r_r_bias). Returns ctx [B, H * dh] in
    the compute type.

    ``splits`` None rounds the probabilities (softmax over all keys) to the
    compute type before P V. With ``splits`` S the keys are cut into the S
    ranges of :func:`split_bounds`, each keeping its own max
    m_s, p = exp(s - m_s) rounded before P V and l_s = sum p unrounded,
    merged by :func:`combine_splits_plain` and rounded once: what the bf16
    kernel does (an empty range adds nothing)."""
    H, B, nk, dh = keys.shape
    cd = keys.dtype
    ac = torch.einsum("hbkd,bhd->bhk", keys, qw)
    bd = torch.einsum("khd,bhd->bhk", r_rows, qr)
    s = (ac + bd).float() * scale
    if splits is None:
        prob = torch.softmax(s, dim=-1).to(cd)
        return torch.einsum("bhk,hbkd->bhd", prob, vals).reshape(B, H * dh)
    vf = vals.float()
    parts = []
    for lo, n in split_bounds(nk, splits):
        if n == 0:
            parts.append((s.new_zeros((B, H, dh)),
                          s.new_full((B, H), float("-inf")), s.new_zeros((B, H))))
            continue
        ss = s[..., lo:lo + n]
        m_s = ss.amax(-1)
        p = torch.exp(ss - m_s[..., None])
        o_s = torch.einsum("bhk,hbkd->bhd", p.to(cd).float(),
                           vf[:, :, lo:lo + n])
        parts.append((o_s, m_s, p.sum(-1)))
    o, _, _ = combine_splits_plain(*(torch.stack(x) for x in zip(*parts)))
    return o.to(cd).reshape(B, H * dh)


def _layer_keys(kv_l, staged_l, jlo: int, t: int):
    """The unmasked keys and values of a token at chunk step ``t``:
    [H, B, nk, dh] each, big slots jlo..M-1 then staged slots 0..t."""
    return (torch.cat([kv_l[i, :, :, jlo:], staged_l[i, :, :, :t + 1]], dim=2)
            for i in (0, 1))


def chain_tc_operands(stacked, R, B: int, H: int, M: int, C: int,
                      device) -> tuple[dict, list]:
    """The bf16 chain's fields of :class:`GenArgs` for a call on ``device``
    with ``B`` lanes, an ``M``-slot cache and a ``C``-row ring: the decode
    attention's route and key splits (:func:`chain_route`), the W^T
    operands, R with each head's rows contiguous (``R_h [L, H, M+1, dh]``,
    so a split's position rows are one run of bytes), the split scratch and,
    for lane groups, the zeroed arrival counts; and the tensors the fields
    point into, which the caller keeps until the launch."""
    dh = R.shape[2] // H
    if dh % 2 or dh > 64:
        raise ValueError(f"bf16 decode chain: d_head must be even and <= 64, "
                         f"got {dh}")
    for name in _STACKED_TC:
        if name not in stacked:
            raise ValueError(f"bf16 chain: stacked has no {name} "
                             "(stack_decode_params builds it in bf16)")
    group, splits = chain_route(H, B, M + C, device)
    HD = R.shape[2]
    R_h = r_heads_major(R, H)
    keep = [R_h]
    fields = {"splits": splits, "lane_group": group, "R_h": R_h.data_ptr()}
    if splits > 1 or group:
        opart = torch.empty((splits, B, HD), dtype=torch.float32, device=device)
        ml = torch.empty((splits, B, H, 2), dtype=torch.float32, device=device)
        keep += [opart, ml]
        fields.update(opart=opart.data_ptr(), ml=ml.data_ptr())
    if group:
        # the last block of each (h, lane group) sets its count back to 0
        arrive = torch.zeros((H, -(-B // group)), dtype=torch.int32,
                             device=device)
        keep.append(arrive)
        fields["arrive"] = arrive.data_ptr()
    fields.update({k: _native.ptr(stacked[k]) for k in _STACKED_TC})
    return fields, keep


def supports_fused_generate(cfg, scfg, bsz: int, C: int) -> bool:
    """Sampling techniques the kernel implements (nucleus keeps the plain
    chunked path, as in the JAX package), lane and chunk bounds."""
    return (cfg.cache_kv
            and scfg.technique in TECHNIQUES
            and 1 <= bsz <= MAX_LANES
            and 1 <= C <= MAX_CHUNK
            and not cfg.append_note_status)


class GenArgs(ctypes.Structure):
    """Mirror of ``struct GenArgs`` in csrc/decode_chain.cuh (the chain of
    K3, K4 and K5)."""

    _fields_ = (
        [(k, ctypes.c_int) for k in (
            "dtype", "n", "L", "B", "M", "HD", "DI", "H", "V", "pre_lnorm",
            "same_length", "technique", "topk", "exclude_bos", "num_empty",
            "empty_token", "count", "t0", "C", "splits", "lane_group")]
        + [("scale", ctypes.c_float), ("temperature", ctypes.c_float)]
        + [(k, ctypes.c_void_p) for k in (
            "kv", "R", "q_w", "k_w", "v_w", "o_w", "ff1", "fb1", "ff2",
            "fb2", "ln_as", "ln_ab", "ln_fs", "ln_fb", "rwb", "rrb", "emb",
            "emb_t", "crit_bias", "g", "ids", "er", "tokens", "staged",
            "logits_out", "x", "w_in", "q", "ctx", "attn", "out", "hid", "ff",
            "logits", "onehot", "qkv_t", "o_t", "ff1_t", "ff2_t", "lg_t",
            "opart", "ml", "R_h", "arrive")])


_STACKED = {"q_w", "k_w", "v_w", "o_w", "ff1", "fb1", "ff2", "fb2", "rwb",
            "rrb", "emb_scaled", "emb_t", "crit_bias"}
_STACKED_F32 = {"ln_as", "ln_ab", "ln_fs", "ln_fb"}


@spans.spanned("k3")
def fused_generate_chunk(stacked, cfg, scfg, kv, R, ids, er, g, count,
                         n: int, same_length: bool = True,
                         return_logits: bool = False):
    """Sample ``n`` tokens.

    kv: [L, 2, H, B, M, dh] big K/V cache in the XL memory's h-major layout
    (``XLMems.hids``; compute type); R: [L, M+1, HD] positional projections
    (row r = distance M - r); ids, er: [B, 1] int32 first token and
    empty-run counters; g: [n, B, V] fp32 gumbel noise; count: valid cache
    slots. Returns (ids' [B, 1], er' [B, 1], tokens [n, B], staged
    [L, 2, H, B, n, dh], the chunk's K/V rows), plus the logits [n, B, V] of
    each step when ``return_logits``.
    """
    if not kv.is_cuda:
        return fused_generate_chunk_plain(stacked, cfg, scfg, kv, R, ids, er,
                                          g, count, n, same_length,
                                          return_logits)
    L, _, H, B, M, dh = kv.shape
    HD = H * dh
    V = g.shape[2]
    dev, cd = kv.device, kv.dtype
    if not supports_fused_generate(cfg, scfg, B, n):
        raise ValueError(f"fused_generate_chunk: unsupported (technique "
                         f"{scfg.technique!r}, B {B}, n {n})")
    if (kv.shape[1] != 2 or R.shape != (L, M + 1, HD)
            or g.shape != (n, B, V) or H != cfg.n_head or dh != cfg.d_head
            or V != cfg.n_token or L != cfg.n_layer):
        raise ValueError("fused_generate_chunk: inconsistent shapes")
    tensors = {"kv": kv, "R": R}
    tensors.update({k: stacked[k] for k in _STACKED})
    for name, t in tensors.items():
        if t.device != dev or t.dtype != cd or not t.is_contiguous():
            raise ValueError(f"fused_generate_chunk: {name} must be a "
                             f"contiguous {cd} tensor on {dev}")
    for name in _STACKED_F32:
        t = stacked[name]
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"fused_generate_chunk: {name} must be a "
                             f"contiguous float32 tensor on {dev}")
    tc, _keep = (chain_tc_operands(stacked, R, B, H, M, n, dev)
                 if cd == torch.bfloat16 else ({}, []))
    g = g.to(device=dev, dtype=torch.float32).contiguous()
    ids_io = ids.reshape(B).to(device=dev, dtype=torch.int32).clone()
    er_io = er.reshape(B).to(device=dev, dtype=torch.int32).clone()
    tokens = torch.empty((n, B), dtype=torch.int32, device=dev)
    staged = torch.zeros((L, 2, H, B, n, dh), dtype=cd, device=dev)
    logits_out = (torch.empty((n, B, V), dtype=cd, device=dev)
                  if return_logits else None)

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
        same_length=int(same_length), technique=TECHNIQUES[scfg.technique],
        topk=int(scfg.topk), exclude_bos=int(scfg.exclude_bos),
        num_empty=int(scfg.num_empty_to_ignore),
        empty_token=int(scfg.empty_token), count=int(count), t0=0, C=n,
        scale=1.0 / (cfg.d_head ** 0.5), temperature=float(scfg.temperature),
        kv=p(kv), R=p(R), q_w=p(stacked["q_w"]),
        k_w=p(stacked["k_w"]), v_w=p(stacked["v_w"]), o_w=p(stacked["o_w"]),
        ff1=p(stacked["ff1"]), fb1=p(stacked["fb1"]), ff2=p(stacked["ff2"]),
        fb2=p(stacked["fb2"]), ln_as=p(stacked["ln_as"]),
        ln_ab=p(stacked["ln_ab"]), ln_fs=p(stacked["ln_fs"]),
        ln_fb=p(stacked["ln_fb"]), rwb=p(stacked["rwb"]),
        rrb=p(stacked["rrb"]), emb=p(stacked["emb_scaled"]),
        emb_t=p(stacked["emb_t"]), crit_bias=p(stacked["crit_bias"]),
        g=p(g), ids=p(ids_io), er=p(er_io), tokens=p(tokens),
        staged=p(staged), logits_out=p(logits_out),
        **{k: p(v) for k, v in bufs.items()},
        **tc)
    lib = chain_lib()
    rc = lib.tg_generate_chunk(ctypes.byref(args), _native.stream_ptr(dev))
    _native.check(rc, "generate_chunk")
    _native.count_launch("generate_chunk")
    if cd == torch.bfloat16:
        _native.count_launch("generate_chunk_tc")
        if tc["lane_group"]:
            _native.count_launch("generate_chunk_grouped")
    out = (ids_io.view(B, 1), er_io.view(B, 1), tokens, staged)
    return out + (logits_out,) if return_logits else out


@torch.no_grad()
def fused_generate_chunk_plain(stacked, cfg, scfg, kv, R, ids, er, g,
                               count, n: int, same_length: bool = True,
                               return_logits: bool = False,
                               splits: int | None = None):
    """Plain PyTorch version of :func:`fused_generate_chunk` on the same
    operands, rounding where the kernel rounds: the fp32 chain with
    ``splits`` None, the bf16 chain with the kernel's ``splits``
    (:func:`decode_attention_plain`)."""
    from ..infer.sample import _filter_and_sample

    L, _, H, B, M, dh = kv.shape
    cd, dev = kv.dtype, kv.device
    scale = 1.0 / (dh ** 0.5)
    sl = 1 if same_length else 0
    ids = ids.reshape(B).long()
    er = er.reshape(B).to(torch.int32)
    staged = torch.zeros((L, 2, H, B, n, dh), dtype=cd, device=dev)
    toks, logits_all = [], []
    for t in range(n):
        jlo = min(M, max(M - int(count), t + sl))
        # unmasked keys: big slots jlo..M-1, staged slots 0..t; R rows by
        # distance (big slot j -> row j - t, staged slot s -> row M - t + s)
        rows = torch.cat([torch.arange(jlo, M, device=dev) - t,
                          M - t + torch.arange(t + 1, device=dev)])
        nk = rows.numel()
        x = stacked["emb_scaled"][ids]                           # [B, HD]
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
            ctx = decode_attention_plain(keys, vals,
                                         R[l][rows].view(nk, H, dh), qw, qr,
                                         scale, splits)
            attn = ctx @ stacked["o_w"][l]
            if cfg.pre_lnorm:
                out = x + attn
                ff_in = layer_norm(out, stacked["ln_fs"][l],
                                   stacked["ln_fb"][l])
            else:
                out = layer_norm(x + attn, stacked["ln_as"][l],
                                 stacked["ln_ab"][l])
                ff_in = out
            hid = torch.relu(ff_in @ stacked["ff1"][l] + stacked["fb1"][l])
            ff = hid @ stacked["ff2"][l] + stacked["fb2"][l]
            if cfg.pre_lnorm:
                x = out + ff
            else:
                x = layer_norm(out + ff, stacked["ln_fs"][l],
                               stacked["ln_fb"][l])
        logits = x @ stacked["emb_t"] + stacked["crit_bias"]     # [B, V]
        tok = _filter_and_sample(logits, scfg, er, g[t].to(dev))
        er = torch.where(tok == scfg.empty_token, er + 1, 0).to(torch.int32)
        ids = tok.long()
        toks.append(tok.to(torch.int32))
        logits_all.append(logits)
    out = (ids.to(torch.int32).view(B, 1), er.view(B, 1), torch.stack(toks),
           staged)
    return out + (torch.stack(logits_all),) if return_logits else out
