"""Transformer-XL language model, as functions on tensors.

Counterpart of ``transformer_gan_tpu/models/xl.py`` for MLE training and
generation: the K/V-cached memory layout (``cache_kv``), the batch forward
(training with dropout and per-row memory resets, or priming memory for
generation), the NLL and logits heads, and the two-level chunked decode
(big read-only K/V cache plus a per-chunk staging ring) that the fused
sampling kernel runs.

Parameters are a flat ``dict[str, Tensor]`` of fp32 master weights with the
JAX tree's names (``word_emb``, ``layers.3.qkv_w``, ...); see ``convert.py``.
Which attention runs follows :func:`attention_route`: CUDA windows of at
least ``FUSED_MIN_QLEN`` tokens take the fused kernels, CPU tensors the plain
path; the forwards' ``route`` argument overrides it. Dropout draws from
explicit generators (see :func:`xl_forward`).

Not ported yet: the raw-hidden memory path (``cache_kv=False``), remat,
note-status inputs, soft one-hot inputs and the gumbel heads.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops.attention import rel_attention_kv_fused, rel_attention_kv_fused_v2
from .attention import build_attn_mask, layer_norm, rel_attention_kv

# Windows at least this long take the fused attention kernels on CUDA (the
# JAX package's qlen >= 8 rule for its fused branch).
FUSED_MIN_QLEN = 8


@dataclasses.dataclass(frozen=True)
class XLConfig:
    """Static model hyperparameters."""

    n_token: int = 310
    n_layer: int = 6
    n_head: int = 10
    d_model: int = 500
    d_inner: int = 1000
    dropout: float = 0.1
    dropatt: float = 0.1
    pre_lnorm: bool = False
    clamp_len: int = -1
    tie_embedding: bool = True
    append_note_status: bool = False
    vec_len: int = 0
    compute_dtype: str = "float32"
    softmax_dtype: str = "float32"
    cache_kv: bool = True  # memory holds projected K/V (the only layout here)

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_head

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def sdtype(self) -> torch.dtype:
        return getattr(torch, self.softmax_dtype)

    @classmethod
    def from_cfg(cls, cfg, n_token: int, vec_len: int = 0) -> "XLConfig":
        """From a training config tree (``config.training_config``)."""
        return cls(
            n_token=n_token,
            n_layer=cfg.MODEL.num_layers,
            n_head=cfg.MODEL.num_heads,
            d_model=cfg.MODEL.units,
            d_inner=cfg.MODEL.inner_size,
            dropout=cfg.MODEL.dropout,
            dropatt=cfg.MODEL.attention_dropout,
            pre_lnorm=cfg.MODEL.pre_lnorm,
            clamp_len=cfg.MODEL.clamp_len,
            tie_embedding=cfg.MODEL.tie_embedding,
            append_note_status=cfg.TRAIN.append_note_status,
            vec_len=vec_len,
            compute_dtype=cfg.TPU.compute_dtype,
            softmax_dtype=cfg.TPU.softmax_dtype,
            cache_kv=cfg.TPU.cache_kv,
        )


def _require_cache_kv(cfg: XLConfig) -> None:
    if not cfg.cache_kv:
        raise NotImplementedError(
            "the port runs the K/V-cached memory layout only "
            "(TPU.cache_kv: true); the raw-hidden path is not ported yet")


class XLMems(NamedTuple):
    """Segment-recurrence state: ``hids`` [n_layer, 2, n_head, bsz, mem_len,
    d_head] projected K/V (h-major), valid slots at the tail, and ``count``,
    the number of valid slots (a Python int: the host always knows it)."""

    hids: torch.Tensor
    count: int


def init_mems(cfg: XLConfig, mem_len: int, bsz: int, dtype=None,
              device=None) -> XLMems:
    _require_cache_kv(cfg)
    buf = torch.zeros((cfg.n_layer, 2, cfg.n_head, bsz, mem_len, cfg.d_head),
                      dtype=dtype or cfg.cdtype, device=device)
    return XLMems(hids=buf, count=0)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

LAYER_KEYS = ("qkv_w", "r_w", "o_w", "attn_ln_scale", "attn_ln_bias",
              "ff_w1", "ff_b1", "ff_w2", "ff_b2", "ff_ln_scale", "ff_ln_bias")


def init_xl_params(cfg: XLConfig, seed: int = 0,
                   base_init=("normal", 0.01),
                   embed_init=("normal", 0.01)) -> dict[str, torch.Tensor]:
    """The JAX package's ``init_xl_params`` bit for bit: the same numpy
    ``RandomState`` draws in the same order, as fp32 CPU tensors."""
    for name, (kind, _) in (("base_init", tuple(base_init)),
                            ("embed_init", tuple(embed_init))):
        if kind not in ("normal", "uniform"):
            raise ValueError(f"INITIALIZER.{name}[0] must be 'normal' or "
                             f"'uniform', got {kind!r}")
    rng = np.random.RandomState(seed)
    init_kind, init_scale = base_init[0], float(base_init[1])

    def f32(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32))

    def weight(shape):
        if init_kind == "uniform":
            return f32(rng.uniform(-init_scale, init_scale, size=shape))
        return f32(rng.normal(0.0, init_scale, size=shape))

    def normal(shape, mean=0.0):
        return f32(rng.normal(mean, init_scale, size=shape))

    def zeros(shape):
        return torch.zeros(shape, dtype=torch.float32)

    d, h, dh, di = cfg.d_model, cfg.n_head, cfg.d_head, cfg.d_inner
    params = {"word_emb": weight((cfg.n_token, d)),
              "crit_bias": zeros((cfg.n_token,))}
    if not cfg.tie_embedding:
        params["crit_w"] = weight((cfg.n_token, d))
    params["r_w_bias"] = weight((h, dh))
    params["r_r_bias"] = weight((h, dh))
    if cfg.append_note_status:
        params["status_emb"] = weight((cfg.vec_len, d))
    for i in range(cfg.n_layer):
        p = f"layers.{i}."
        params[p + "qkv_w"] = weight((d, 3 * h * dh))
        params[p + "r_w"] = weight((d, h * dh))
        params[p + "o_w"] = weight((h * dh, d))
        params[p + "attn_ln_scale"] = normal((d,), mean=1.0)
        params[p + "attn_ln_bias"] = zeros((d,))
        params[p + "ff_w1"] = weight((d, di))
        params[p + "ff_b1"] = zeros((di,))
        params[p + "ff_w2"] = weight((di, d))
        params[p + "ff_b2"] = zeros((d,))
        params[p + "ff_ln_scale"] = normal((d,), mean=1.0)
        params[p + "ff_ln_bias"] = zeros((d,))
    return params


def layer_params(params: dict, i: int) -> dict[str, torch.Tensor]:
    """The weights of decoder layer ``i`` under their short names."""
    return {k: params[f"layers.{i}.{k}"] for k in LAYER_KEYS}


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def positional_embedding(cfg: XLConfig, klen: int, device=None) -> torch.Tensor:
    """Sinusoidal embedding of relative distances klen-1 .. 0 (fp32)."""
    pos_seq = torch.arange(klen - 1, -1, -1.0, dtype=torch.float32,
                           device=device)
    if cfg.clamp_len > 0:
        pos_seq = pos_seq.clamp(max=float(cfg.clamp_len))
    inv_freq = 1.0 / (10000.0 ** (torch.arange(
        0.0, cfg.d_model, 2.0, dtype=torch.float32, device=device)
        / cfg.d_model))
    sinusoid = torch.outer(pos_seq, inv_freq)
    return torch.cat([sinusoid.sin(), sinusoid.cos()], dim=-1)


def embed_input(params, cfg: XLConfig, inp: torch.Tensor) -> torch.Tensor:
    """Token embedding of int ids [q, b] -> [q, b, d_model]."""
    emb_w = params["word_emb"].to(cfg.cdtype)
    return emb_w[inp] * (cfg.d_model ** 0.5)


def attention_route(core_out: torch.Tensor, mem_len: int) -> str:
    """Which attention a layer runs: "v2" (K1f/K1b) or "v1" (K2f/K2b) on
    CUDA windows of at least ``FUSED_MIN_QLEN`` tokens, by whether there is
    memory (the JAX package's ``supports_v2`` without its TPU alignment
    gates), else "plain"."""
    if core_out.is_cuda and core_out.shape[0] >= FUSED_MIN_QLEN:
        return "v2" if mem_len > 0 else "v1"
    return "plain"


def _dropout(x: torch.Tensor, rate: float, gen) -> torch.Tensor:
    """Keep where a uniform draw is below 1 - rate, scaled by 1 / (1 - rate)
    (the JAX package's bernoulli keep); identity without a generator."""
    if gen is None or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def decoder_layer(layer, cfg: XLConfig, core_out, mems_i, pos_emb,
                  r_w_bias, r_r_bias, attn_mask, attn_count: int,
                  same_length: bool = False, reset=None, gen=None,
                  attn_seed: int | None = None, route: str | None = None):
    """One decoder layer (attention + position-wise FF). ``gen`` (a
    generator on the activations' device) turns dropout on; the fused
    kernels draw attention dropout from ``attn_seed``, the plain path from
    ``gen``. ``route`` ("plain", "v2", "v1") overrides
    :func:`attention_route`."""
    cd = cfg.cdtype
    if cfg.pre_lnorm:
        w_in = layer_norm(core_out, layer["attn_ln_scale"],
                          layer["attn_ln_bias"])
    else:
        w_in = core_out
    route = route or attention_route(core_out, mems_i.shape[-2])
    if route == "plain":
        attn_vec, k_cur, v_cur = rel_attention_kv(
            w_in, mems_i[0], mems_i[1], pos_emb, layer["qkv_w"].to(cd),
            layer["r_w"].to(cd), r_w_bias, r_r_bias, attn_mask,
            cfg.n_head, cfg.d_head, softmax_dtype=cfg.sdtype,
            dropatt=cfg.dropatt, generator=gen)
    else:
        fused = (rel_attention_kv_fused_v2 if route == "v2"
                 else rel_attention_kv_fused)
        attn_vec, k_cur, v_cur = fused(
            w_in, mems_i[0], mems_i[1], pos_emb, layer["qkv_w"].to(cd),
            layer["r_w"].to(cd), r_w_bias, r_r_bias, attn_count, reset,
            cfg.n_head, cfg.d_head, same_length=same_length,
            dropatt=cfg.dropatt, seed=attn_seed if gen is not None else None)
    attn_out = _dropout(attn_vec @ layer["o_w"].to(cd), cfg.dropout, gen)
    if cfg.pre_lnorm:
        out = core_out + attn_out
        ff_in = layer_norm(out, layer["ff_ln_scale"], layer["ff_ln_bias"])
    else:
        out = layer_norm(core_out + attn_out, layer["attn_ln_scale"],
                         layer["attn_ln_bias"])
        ff_in = out
    h = torch.relu(ff_in @ layer["ff_w1"].to(cd) + layer["ff_b1"].to(cd))
    h = _dropout(h, cfg.dropout, gen)
    h = _dropout(h @ layer["ff_w2"].to(cd) + layer["ff_b2"].to(cd),
                 cfg.dropout, gen)
    if cfg.pre_lnorm:
        return out + h, (k_cur, v_cur)
    return layer_norm(out + h, layer["ff_ln_scale"],
                      layer["ff_ln_bias"]), (k_cur, v_cur)


# ---------------------------------------------------------------------------
# Core forward
# ---------------------------------------------------------------------------

def xl_forward(params, cfg: XLConfig, inp: torch.Tensor, mems: XLMems,
               reset_mems=None, *, same_length: bool = False, pos_emb=None,
               generator: torch.Generator | None = None,
               route: str | None = None):
    """Run the decoder stack over ids [q, b]; ``reset_mems`` [b] bool masks
    the whole memory of those rows. Returns (core_out [q, b, d], new_mems):
    the ring keeps the newest mem_len K/V slots, detached.

    Training: ``generator``, a CPU generator (the step's), turns dropout on.
    It draws one seed per layer for the fused kernels' attention dropout and
    one that seeds a generator on the activations' device for the other
    dropout masks (and the plain path's attention dropout). Without it the
    forward is the inference forward; callers that need no gradient wrap it
    in ``torch.no_grad()``. ``route`` forces every layer's attention:
    "plain" (``rel_attention_kv``), "v2" or "v1" (the fused contracts); None
    follows :func:`attention_route`."""
    _require_cache_kv(cfg)
    if route not in (None, "plain", "v2", "v1"):
        raise ValueError(f"unknown attention route {route!r}")
    qlen = inp.shape[0]
    mem_len = mems.hids.shape[4]
    cd = cfg.cdtype
    gen, seeds = None, [None] * cfg.n_layer
    if generator is not None:
        seeds = torch.randint(0, 2 ** 31 - 1, (cfg.n_layer + 1,),
                              generator=generator).tolist()
        gen = torch.Generator(device=inp.device).manual_seed(seeds.pop())
    core_out = _dropout(embed_input(params, cfg, inp), cfg.dropout, gen)
    attn_mask = build_attn_mask(qlen, mem_len, mems.count, same_length,
                                reset_mems, device=inp.device)
    if pos_emb is None:
        pos_emb = positional_embedding(cfg, mem_len + qlen,
                                       inp.device).to(cd)
    pos_emb = _dropout(pos_emb, cfg.dropout, gen)
    r_w_bias = params["r_w_bias"].to(cd)
    r_r_bias = params["r_r_bias"].to(cd)

    kvs = []
    for i in range(cfg.n_layer):
        core_out, kv = decoder_layer(
            layer_params(params, i), cfg, core_out, mems.hids[i].to(cd),
            pos_emb, r_w_bias, r_r_bias, attn_mask, mems.count, same_length,
            reset_mems, gen, seeds[i], route)
        kvs.append(kv)
    core_out = _dropout(core_out, cfg.dropout, gen)

    if mem_len == 0:
        return core_out, mems
    stacked = torch.stack([torch.stack(kv) for kv in kvs]).detach().to(
        mems.hids.dtype)                                  # [L, 2, h, b, q, dh]
    new_hids = torch.cat([mems.hids, stacked], dim=4)[..., -mem_len:, :]
    return core_out, XLMems(hids=new_hids.contiguous(),
                            count=min(mems.count + qlen, mem_len))


def compute_logits(params, cfg: XLConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Softmax logits, tied to the token embedding unless the params carry
    a separate ``crit_w``."""
    w = params.get("crit_w", params["word_emb"]).to(cfg.cdtype)
    return hidden @ w.T + params["crit_bias"].to(cfg.cdtype)


def forward_nll(params, cfg: XLConfig, data: torch.Tensor,
                target: torch.Tensor, reset_mems, mems: XLMems, *,
                same_length: bool = False,
                generator: torch.Generator | None = None,
                route: str | None = None):
    """Per-token NLL head with an fp32 log-softmax. Returns (nll [q, b] fp32,
    new_mems); ``generator`` and ``route`` as :func:`xl_forward`."""
    hidden, new_mems = xl_forward(params, cfg, data, mems, reset_mems,
                                  same_length=same_length,
                                  generator=generator, route=route)
    logp = torch.log_softmax(compute_logits(params, cfg, hidden).float(),
                             dim=-1)
    return -torch.gather(logp, -1, target[..., None])[..., 0], new_mems


def forward_generate(params, cfg: XLConfig, data: torch.Tensor, mems: XLMems,
                     *, same_length: bool = False, pos_emb=None):
    """Logits head for incremental decoding. Returns (logits [q, b, V],
    new_mems)."""
    hidden, new_mems = xl_forward(params, cfg, data, mems,
                                  same_length=same_length, pos_emb=pos_emb)
    return compute_logits(params, cfg, hidden), new_mems


# ---------------------------------------------------------------------------
# Chunked two-level incremental decoding
# ---------------------------------------------------------------------------
#
# The big K/V cache [b, M, h*dh] per layer is read-only within a chunk; the
# chunk's own K/V go to a staging ring [b, C, h*dh] and are merged into the
# big cache once per chunk. Big slot j is at distance M - j + t from the
# token at chunk step t, staged slot s at t - s. The positional projections
# r_heads [L, M+1, h, dh] are distance-reversed: row r holds distance M - r.


class DecodeState(NamedTuple):
    """Big decode cache: ``kv`` per layer (k [b, M, h*dh], v same), ``count``
    valid tail slots (a Python int) and ``r_heads`` [L, M+1, h, dh]."""

    kv: tuple
    count: int
    r_heads: torch.Tensor


def precompute_r_heads(params, cfg: XLConfig, R: int, device=None) -> torch.Tensor:
    """Per-layer positional projections [L, R, h, dh], row j = distance
    R-1-j."""
    cd = cfg.cdtype
    pos = positional_embedding(cfg, R, device).to(cd)
    return torch.stack([
        (pos @ params[f"layers.{i}.r_w"].to(cd)).reshape(R, cfg.n_head,
                                                         cfg.d_head)
        for i in range(cfg.n_layer)])


def decode_state_from_mems(params, cfg: XLConfig, mems: XLMems) -> DecodeState:
    """cache_kv memory [L, 2, h, b, M, dh] -> per-layer dense K, V [b, M, hd]."""
    _require_cache_kv(cfg)
    b, M = mems.hids.shape[3], mems.hids.shape[4]
    hd = cfg.n_head * cfg.d_head

    def dense(x):  # [h, b, M, dh] -> [b, M, h*dh]
        return x.permute(1, 2, 0, 3).reshape(b, M, hd)

    kv = tuple((dense(mems.hids[i, 0]), dense(mems.hids[i, 1]))
               for i in range(cfg.n_layer))
    return DecodeState(kv=kv, count=int(mems.count),
                       r_heads=precompute_r_heads(params, cfg, M + 1,
                                                  mems.hids.device))


def mems_from_decode_state(cfg: XLConfig, state: DecodeState) -> XLMems:
    """Inverse of :func:`decode_state_from_mems`."""
    b, M, _ = state.kv[0][1].shape

    def heads(x):  # [b, M, h*dh] -> [h, b, M, dh]
        return x.reshape(b, M, cfg.n_head, cfg.d_head).permute(2, 0, 1, 3)

    hids = torch.stack([torch.stack([heads(k), heads(v)])
                        for k, v in state.kv])
    return XLMems(hids=hids.contiguous(), count=state.count)


def init_decode_stage(cfg: XLConfig, chunk: int, bsz: int, dtype=None,
                      device=None) -> tuple:
    """Per-layer (k, v) staging buffers [bsz, chunk, n_head*d_head]."""
    hd = cfg.n_head * cfg.d_head
    return tuple(
        (torch.zeros((bsz, chunk, hd), dtype=dtype or cfg.cdtype,
                     device=device),
         torch.zeros((bsz, chunk, hd), dtype=dtype or cfg.cdtype,
                     device=device))
        for _ in range(cfg.n_layer))


def merge_decode_state(cfg: XLConfig, state: DecodeState, stage: tuple,
                       n: int) -> DecodeState:
    """Fold the first ``n`` staged tokens into the big cache (shift left,
    append)."""
    M = state.kv[0][1].shape[1]
    if n > M:
        raise ValueError(f"merge of {n} staged tokens exceeds the {M}-slot "
                         "ring; cap the decode chunk at mem_len")
    kv = tuple((torch.cat([k[:, n:], sk[:, :n]], dim=1),
                torch.cat([v[:, n:], sv[:, :n]], dim=1))
               for (k, v), (sk, sv) in zip(state.kv, stage))
    return DecodeState(kv=kv, count=min(state.count + n, M),
                       r_heads=state.r_heads)


@torch.no_grad()
def decode_chunk_step(params, cfg: XLConfig, inp: torch.Tensor,
                      state: DecodeState, stage: tuple, t: int, *,
                      same_length: bool = True):
    """One-token forward at chunk step ``t`` for ids [bsz]. Writes this
    token's K/V into row ``t`` of ``stage`` in place and returns
    (logits [bsz, V], stage)."""
    b, M, hd = state.kv[0][1].shape
    C = stage[0][0].shape[1]
    h, dh = cfg.n_head, cfg.d_head
    cd = cfg.cdtype
    sdt = cfg.sdtype
    dev = inp.device
    scale = 1.0 / (dh ** 0.5)

    sl = 1 if same_length else 0
    mask_big = torch.arange(M, device=dev) < max(M - state.count, t + sl)
    mask_st = torch.arange(C, device=dev) > t
    mask = torch.cat([mask_big, mask_st])[None, None, :]

    x = embed_input(params, cfg, inp[None])[0]                  # [b, hd]
    r_w_bias = params["r_w_bias"].to(cd)
    r_r_bias = params["r_r_bias"].to(cd)
    for i in range(cfg.n_layer):
        layer = layer_params(params, i)
        if cfg.pre_lnorm:
            w_in = layer_norm(x, layer["attn_ln_scale"], layer["attn_ln_bias"])
        else:
            w_in = x
        q, k, v = (w_in @ layer["qkv_w"].to(cd)).chunk(3, dim=-1)
        sk, sv = stage[i]
        sk[:, t] = k.to(sk.dtype)
        sv[:, t] = v.to(sv.dtype)
        k_big, v_big = state.kv[i]
        qw = q.reshape(b, h, dh) + r_w_bias
        qr = q.reshape(b, h, dh) + r_r_bias
        ac_big = torch.einsum("bmhd,bhd->bhm", k_big.reshape(b, M, h, dh).to(cd),
                              qw)
        ac_st = torch.einsum("bchd,bhd->bhc", sk.reshape(b, C, h, dh).to(cd), qw)
        bd_rev = torch.einsum("jhd,bhd->bhj", state.r_heads[i].to(cd), qr)
        # align the distance-indexed position term to the slots
        bd_big = torch.roll(bd_rev[..., :M], t, dims=-1)
        bd_ext = torch.cat([bd_rev, bd_rev.new_zeros(b, h, C - 1)], dim=-1)
        bd_st = bd_ext[..., M - t:M - t + C]
        score = torch.cat([ac_big + bd_big, ac_st + bd_st], dim=-1).to(sdt)
        score = (score * scale).masked_fill(mask, torch.finfo(sdt).min)
        prob = torch.softmax(score, dim=-1).to(cd)               # [b, h, M+C]
        ctx = (torch.einsum("bhm,bmhd->bhd", prob[..., :M],
                            v_big.reshape(b, M, h, dh).to(cd))
               + torch.einsum("bhc,bchd->bhd", prob[..., M:],
                              sv.reshape(b, C, h, dh).to(cd)))
        attn_out = ctx.reshape(b, hd) @ layer["o_w"].to(cd)
        if cfg.pre_lnorm:
            out = x + attn_out
            ff_in = layer_norm(out, layer["ff_ln_scale"], layer["ff_ln_bias"])
        else:
            out = layer_norm(x + attn_out, layer["attn_ln_scale"],
                             layer["attn_ln_bias"])
            ff_in = out
        ff = torch.relu(ff_in @ layer["ff_w1"].to(cd) + layer["ff_b1"].to(cd))
        ff = ff @ layer["ff_w2"].to(cd) + layer["ff_b2"].to(cd)
        if cfg.pre_lnorm:
            x = out + ff
        else:
            x = layer_norm(out + ff, layer["ff_ln_scale"], layer["ff_ln_bias"])
    return compute_logits(params, cfg, x), stage
