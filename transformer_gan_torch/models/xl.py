"""Transformer-XL language model, as functions on tensors.

Counterpart of ``transformer_gan_tpu/models/xl.py`` for MLE training and
generation: both memory layouts (``cache_kv``: projected K/V, the layout
the attention kernels read; without it the raw hidden states of every
layer's input, QKV re-projected over [memory; segment] each call, the
reference's own semantics), the batch forward (training with dropout and
per-row memory resets, or priming memory for generation), note-status
inputs, per-layer recompute (``remat``), the NLL and logits heads, and the
two-level chunked decode (big read-only K/V cache plus a per-chunk staging
ring) that the fused sampling kernel runs.

The two layouts give the same forward. Their gradients differ: the raw
path re-projects the detached memory hiddens through ``qkv_w``, so the
memory's K/V pass gradient to it; the cached path stores them as
constants.

Parameters are a flat ``dict[str, Tensor]`` of fp32 master weights with the
JAX tree's names (``word_emb``, ``layers.3.qkv_w``, ...); see ``convert.py``.
Which attention runs follows :func:`attention_route`: CUDA windows of at
least ``FUSED_MIN_QLEN`` tokens take the fused kernels, CPU tensors the plain
path; the forwards' ``route`` argument overrides it. Dropout draws from
explicit generators (see :func:`xl_forward`).

The GAN phases add soft one-hot inputs, the differentiable decode step
(``detach_kv_writes``), the batched window recompute of a sampled chunk
(:func:`decode_recompute_window`) and the straight-through gumbel head.

The raw layout runs plain torch ops only, as the JAX package routes it
(its fused attention needs ``cache_kv``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.utils.checkpoint

from ..ops.attention import rel_attention_kv_fused, rel_attention_kv_fused_v2
from .attention import (build_attn_mask, layer_norm, rel_attention,
                        rel_attention_kv)

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
    cache_kv: bool = True  # memory holds projected K/V, else raw hiddens

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


class XLMems(NamedTuple):
    """Segment-recurrence state: ``hids``, valid slots at the tail, and
    ``count``, the number of valid slots (a Python int: the host always
    knows it). ``hids`` is [n_layer, 2, n_head, bsz, mem_len, d_head]
    projected K/V (h-major) under ``cache_kv``, else [n_layer + 1, mem_len,
    bsz, d_model] raw hiddens (entry i is layer i's input, entry 0 the
    embedding after its dropout)."""

    hids: torch.Tensor
    count: int

    @property
    def batch_axis(self) -> int:
        return 3 if self.hids.dim() == 6 else 2

    @property
    def mem_len(self) -> int:
        return self.hids.shape[4 if self.hids.dim() == 6 else 1]

    def rows(self, lo: int, hi: int) -> "XLMems":
        """The memory of batch rows [lo, hi)."""
        return XLMems(hids=self.hids.narrow(self.batch_axis, lo, hi - lo),
                      count=self.count)


def init_mems(cfg: XLConfig, mem_len: int, bsz: int, dtype=None,
              device=None) -> XLMems:
    """Empty memory in the layout of ``cfg.cache_kv``."""
    shape = ((cfg.n_layer, 2, cfg.n_head, bsz, mem_len, cfg.d_head)
             if cfg.cache_kv else (cfg.n_layer + 1, mem_len, bsz, cfg.d_model))
    return XLMems(hids=torch.zeros(shape, dtype=dtype or cfg.cdtype,
                                   device=device), count=0)


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


def embed_input(params, cfg: XLConfig, inp: torch.Tensor,
                status_vec=None) -> torch.Tensor:
    """Token embedding of int ids [q, b] or soft one-hots [q, b, V] (which
    carry the straight-through gradients) -> [q, b, d_model]; with
    note-status inputs, plus ``status_vec`` [q, b, vec_len] (held-note bits)
    times ``status_emb``."""
    cd = cfg.cdtype
    emb_w = params["word_emb"].to(cd)
    emb = inp.to(cd) @ emb_w if inp.is_floating_point() else emb_w[inp]
    if cfg.append_note_status and status_vec is not None:
        emb = emb + status_vec.to(cd) @ params["status_emb"].to(cd)
    return emb * (cfg.d_model ** 0.5)


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
    :func:`attention_route`. ``mems_i``: the layer's cached K/V [2, h, b, M,
    dh], or under raw memory its input hiddens [M, b, d] (plain attention
    over [memory; segment]). Returns (out, [k_cur, v_cur] or None under raw
    memory)."""
    cd = cfg.cdtype
    if cfg.pre_lnorm:
        w_in = layer_norm(core_out, layer["attn_ln_scale"],
                          layer["attn_ln_bias"])
    else:
        w_in = core_out
    kv = None
    if cfg.cache_kv:
        route = route or attention_route(core_out, mems_i.shape[-2])
    if not cfg.cache_kv:
        cat = torch.cat([mems_i, core_out], dim=0)
        cat_in = (layer_norm(cat, layer["attn_ln_scale"],
                             layer["attn_ln_bias"]) if cfg.pre_lnorm else cat)
        attn_vec = rel_attention(
            w_in, cat_in, pos_emb, layer["qkv_w"].to(cd), layer["r_w"].to(cd),
            r_w_bias, r_r_bias, attn_mask, cfg.n_head, cfg.d_head,
            softmax_dtype=cfg.sdtype, dropatt=cfg.dropatt, generator=gen)
    elif route == "plain":
        attn_vec, *kv = rel_attention_kv(
            w_in, mems_i[0], mems_i[1], pos_emb, layer["qkv_w"].to(cd),
            layer["r_w"].to(cd), r_w_bias, r_r_bias, attn_mask,
            cfg.n_head, cfg.d_head, softmax_dtype=cfg.sdtype,
            dropatt=cfg.dropatt, generator=gen)
    else:
        fused = (rel_attention_kv_fused_v2 if route == "v2"
                 else rel_attention_kv_fused)
        attn_vec, *kv = fused(
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
        return out + h, kv
    return layer_norm(out + h, layer["ff_ln_scale"], layer["ff_ln_bias"]), kv


# ---------------------------------------------------------------------------
# Core forward
# ---------------------------------------------------------------------------

def _layer_remat(layer, cfg, core_out, mems_i, pos_emb, *args, gen=None,
                 **kw):
    """:func:`decoder_layer` with its activations recomputed in the
    backward (``torch.utils.checkpoint``). The recompute restores ``gen`` to
    its state before the layer, so it draws the forward's dropout masks
    again; the fused kernels' dropout is a hash of its seed and replays by
    itself."""
    state = gen.get_state() if gen is not None else None

    def run(core_out, mems_i, pos_emb):
        if state is not None:
            gen.set_state(state)
        return decoder_layer(layer, cfg, core_out, mems_i, pos_emb, *args,
                             gen=gen, **kw)

    return torch.utils.checkpoint.checkpoint(
        run, core_out, mems_i, pos_emb, use_reentrant=False,
        preserve_rng_state=False)


def xl_forward(params, cfg: XLConfig, inp: torch.Tensor, mems: XLMems,
               reset_mems=None, *, status_vec=None, same_length: bool = False,
               pos_emb=None, generator: torch.Generator | None = None,
               route: str | None = None, remat: bool = False):
    """Run the decoder stack over ids [q, b]; ``reset_mems`` [b] bool masks
    the whole memory of those rows; ``status_vec`` [q, b, vec_len] the
    note-status inputs (with ``cfg.append_note_status``). Returns (core_out
    [q, b, d], new_mems): the ring keeps the newest mem_len slots (K/V, or
    each layer's input hiddens under raw memory), detached.

    Training: ``generator``, a CPU generator (the step's), turns dropout on.
    It draws one seed per layer for the fused kernels' attention dropout and
    one that seeds a generator on the activations' device for the other
    dropout masks (and the plain path's attention dropout). Without it the
    forward is the inference forward; callers that need no gradient wrap it
    in ``torch.no_grad()``. ``route`` forces every layer's attention:
    "plain" (``rel_attention_kv``), "v2" or "v1" (the fused contracts); None
    follows :func:`attention_route`. Raw memory runs ``rel_attention`` on
    any device (route None or "plain"), as the JAX package does: its fused
    attention needs the K/V cache. ``remat`` recomputes each layer in the
    backward (:func:`_layer_remat`)."""
    if route not in (None, "plain", "v2", "v1"):
        raise ValueError(f"unknown attention route {route!r}")
    if not cfg.cache_kv and route not in (None, "plain"):
        raise ValueError(f"raw-hidden memory has no {route!r} attention")
    qlen = inp.shape[0]
    mem_len = mems.mem_len
    cd = cfg.cdtype
    gen, seeds = None, [None] * cfg.n_layer
    if generator is not None:
        seeds = torch.randint(0, 2 ** 31 - 1, (cfg.n_layer + 1,),
                              generator=generator).tolist()
        gen = torch.Generator(device=inp.device).manual_seed(seeds.pop())
    core_out = _dropout(embed_input(params, cfg, inp, status_vec),
                        cfg.dropout, gen)
    attn_mask = build_attn_mask(qlen, mem_len, mems.count, same_length,
                                reset_mems, device=inp.device)
    if pos_emb is None:
        pos_emb = positional_embedding(cfg, mem_len + qlen,
                                       inp.device).to(cd)
    pos_emb = _dropout(pos_emb, cfg.dropout, gen)
    r_w_bias = params["r_w_bias"].to(cd)
    r_r_bias = params["r_r_bias"].to(cd)

    layer_fn = _layer_remat if remat else decoder_layer
    hids, kvs = [core_out], []
    for i in range(cfg.n_layer):
        core_out, kv = layer_fn(
            layer_params(params, i), cfg, core_out, mems.hids[i].to(cd),
            pos_emb, r_w_bias, r_r_bias, attn_mask, mems.count, same_length,
            reset_mems, gen=gen, attn_seed=seeds[i], route=route)
        hids.append(core_out)
        kvs.append(kv)
    core_out = _dropout(core_out, cfg.dropout, gen)

    if mem_len == 0:
        return core_out, mems
    if cfg.cache_kv:
        stacked = torch.stack([torch.stack(kv) for kv in kvs])  # [L, 2, h, b, q, dh]
        axis = 4
    else:
        stacked, axis = torch.stack(hids), 1                    # [L+1, q, b, d]
    new_hids = torch.cat([mems.hids, stacked.detach().to(mems.hids.dtype)],
                         dim=axis).narrow(axis, qlen, mem_len)
    return core_out, XLMems(hids=new_hids.contiguous(),
                            count=min(mems.count + qlen, mem_len))


def compute_logits(params, cfg: XLConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Softmax logits, tied to the token embedding unless the params carry
    a separate ``crit_w``."""
    w = params.get("crit_w", params["word_emb"]).to(cfg.cdtype)
    return hidden @ w.T + params["crit_bias"].to(cfg.cdtype)


def forward_nll(params, cfg: XLConfig, data: torch.Tensor,
                target: torch.Tensor, reset_mems, mems: XLMems, *,
                status_vec=None, same_length: bool = False,
                generator: torch.Generator | None = None,
                route: str | None = None, remat: bool = False):
    """Per-token NLL head with an fp32 log-softmax. Returns (nll [q, b] fp32,
    new_mems); the keywords as :func:`xl_forward`."""
    hidden, new_mems = xl_forward(params, cfg, data, mems, reset_mems,
                                  status_vec=status_vec,
                                  same_length=same_length,
                                  generator=generator, route=route,
                                  remat=remat)
    logp = torch.log_softmax(compute_logits(params, cfg, hidden).float(),
                             dim=-1)
    return -torch.gather(logp, -1, target[..., None])[..., 0], new_mems


def forward_generate(params, cfg: XLConfig, data: torch.Tensor, mems: XLMems,
                     *, status_vec=None, same_length: bool = False,
                     pos_emb=None):
    """Logits head for incremental decoding. Returns (logits [q, b, V],
    new_mems)."""
    hidden, new_mems = xl_forward(params, cfg, data, mems,
                                  status_vec=status_vec,
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
    if not cfg.cache_kv:
        raise ValueError("the chunked decode needs the cache_kv memory layout")
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


def _stage_write(buf: torch.Tensor, t: int, row: torch.Tensor) -> torch.Tensor:
    """Row ``t`` of a staging buffer [b, C, hd] set to ``row``: in place when
    no graph is recorded (generation), else on a copy, since an earlier
    step's graph may hold the buffer."""
    if torch.is_grad_enabled():
        buf = buf.clone()
    buf[:, t] = row.to(buf.dtype)
    return buf


def decode_chunk_step(params, cfg: XLConfig, inp: torch.Tensor,
                      state: DecodeState, stage: tuple, t: int, *,
                      same_length: bool = True, status_vec=None,
                      detach_kv_writes: bool = False):
    """One-token forward at chunk step ``t`` for ids [bsz] or soft one-hots
    [bsz, V] (``status_vec`` [bsz, vec_len]: the note-status input). Writes
    this token's K/V into row ``t`` of ``stage`` and returns (logits [bsz,
    V], stage); in place unless autograd records the step.

    ``detach_kv_writes``: the staged K/V are written detached while this
    step's own attention sees the live projections (the GAN sampling scan:
    memory is detached after each step, gradients reach a token's K/V only
    through its own attention)."""
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

    sv = status_vec[None] if status_vec is not None else None
    x = embed_input(params, cfg, inp[None], sv)[0]              # [b, hd]
    r_w_bias = params["r_w_bias"].to(cd)
    r_r_bias = params["r_r_bias"].to(cd)
    new_stage = []
    for i in range(cfg.n_layer):
        layer = layer_params(params, i)
        if cfg.pre_lnorm:
            w_in = layer_norm(x, layer["attn_ln_scale"], layer["attn_ln_bias"])
        else:
            w_in = x
        q, k, v = (w_in @ layer["qkv_w"].to(cd)).chunk(3, dim=-1)
        sk, sv = stage[i]
        sk = _stage_write(sk, t, k.detach() if detach_kv_writes else k)
        sv = _stage_write(sv, t, v.detach() if detach_kv_writes else v)
        new_stage.append((sk, sv))
        if detach_kv_writes:
            # the step's own slot sees the live K/V
            sk = torch.cat([sk[:, :t], k[:, None].to(sk.dtype), sk[:, t + 1:]], 1)
            sv = torch.cat([sv[:, :t], v[:, None].to(sv.dtype), sv[:, t + 1:]], 1)
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
    return compute_logits(params, cfg, x), tuple(new_stage)


def decode_recompute_window(params, cfg: XLConfig, inp: torch.Tensor, k_mem,
                            v_mem, count: int, *, status_vec=None,
                            collect_residuals: bool = False):
    """Batched recompute of ``n`` sequential :func:`decode_chunk_step`
    forwards (``detach_kv_writes`` semantics) in one parallel pass.

    inp: [n, bsz, V] one-hot inputs the steps saw (n <= mem_len); k_mem,
    v_mem: per-layer [n_head, bsz, M, d_head] cache K/V at the window start
    (detached); count: valid tail slots; status_vec [n, bsz, vec_len]: the
    note-status inputs. Queries are live, every K/V lane
    detached but each query's own, the position term live; query i sees big
    lanes j >= max(M - count, i) and window lanes s <= i (the GAN's window,
    ``same_length`` off).

    Returns (logits [n, bsz, V], k_full, v_full, new_count): per-layer lane
    buffers [n_head, bsz, M + n, d_head] = [mem || window K/V] (detached).
    ``collect_residuals`` appends a dict of detached activations for the
    chain backward: x / z1 / z2 [L, n, bsz, hd], ff_pre [L, n, bsz, d_inner],
    prob [L, bsz, n_head, n, M + n] fp32, q [L, n, bsz, hd] (w_in @ q_w, the
    queries before the biases, which the bf16 chain takes off its serial
    path)."""
    n, bsz, _ = inp.shape
    h, dh = cfg.n_head, cfg.d_head
    M = k_mem[0].shape[2]
    if n > M:
        raise ValueError(f"recompute window n={n} exceeds mem_len={M}")
    cd = cfg.cdtype
    dev = inp.device
    x = embed_input(params, cfg, inp, status_vec)               # [n, b, hd]

    i_q = torch.arange(n, device=dev)[:, None]
    mask_big = torch.arange(M, device=dev)[None, :] < torch.clamp(
        i_q, min=M - int(count))
    mask_cur = torch.arange(n, device=dev)[None, :] > i_q        # n <= M
    attn_mask = torch.cat([mask_big, mask_cur], dim=1)[None]
    pos = positional_embedding(cfg, M + n, dev).to(cd)
    r_w_bias = params["r_w_bias"].to(cd)
    r_r_bias = params["r_r_bias"].to(cd)

    new_k, new_v = [], []
    res = {k: [] for k in ("x", "z1", "z2", "ff_pre", "prob", "q")}
    for i in range(cfg.n_layer):
        layer = layer_params(params, i)
        if cfg.pre_lnorm:
            w_in = layer_norm(x, layer["attn_ln_scale"], layer["attn_ln_bias"])
        else:
            w_in = x
        attn = rel_attention_kv(
            w_in, k_mem[i], v_mem[i], pos, layer["qkv_w"].to(cd),
            layer["r_w"].to(cd), r_w_bias, r_r_bias, attn_mask, h, dh,
            softmax_dtype=cfg.sdtype, detach_kv_cross=True,
            with_prob=collect_residuals)
        attn_vec, k_cur, v_cur = attn[:3]
        z1 = x + attn_vec @ layer["o_w"].to(cd)
        if cfg.pre_lnorm:
            out = z1
            ff_in = layer_norm(out, layer["ff_ln_scale"], layer["ff_ln_bias"])
        else:
            out = layer_norm(z1, layer["attn_ln_scale"], layer["attn_ln_bias"])
            ff_in = out
        ff_pre = ff_in @ layer["ff_w1"].to(cd) + layer["ff_b1"].to(cd)
        z2 = out + torch.relu(ff_pre) @ layer["ff_w2"].to(cd) + layer["ff_b2"].to(cd)
        if collect_residuals:
            for key, val in (("x", x), ("z1", z1), ("z2", z2),
                             ("ff_pre", ff_pre), ("prob", attn[3]),
                             ("q", attn[4])):
                res[key].append(val.detach())
        if cfg.pre_lnorm:
            x = z2
        else:
            x = layer_norm(z2, layer["ff_ln_scale"], layer["ff_ln_bias"])
        new_k.append(torch.cat([k_mem[i], k_cur.detach().to(k_mem[i].dtype)], 2))
        new_v.append(torch.cat([v_mem[i], v_cur.detach().to(v_mem[i].dtype)], 2))

    logits = compute_logits(params, cfg, x)
    out = (logits, new_k, new_v, min(int(count) + n, M))
    if collect_residuals:
        out = out + ({k: torch.stack(v) for k, v in res.items()},)
    return out


def gumbel_softmax_st(logits: torch.Tensor, temperature, g: torch.Tensor):
    """Straight-through gumbel-softmax with the noise ``g`` (the caller's
    draws, see ``models/gan.gumbel``): forward value the one-hot of
    argmax(y), gradient that of y = softmax((logits + g) / T)."""
    y = torch.softmax((logits.float() + g) / temperature, dim=-1)
    hard = torch.nn.functional.one_hot(y.argmax(-1), y.shape[-1]).to(y.dtype)
    return (hard - y).detach() + y
