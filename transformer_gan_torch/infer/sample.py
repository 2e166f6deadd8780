"""Autoregressive sampling with cached XL memories.

Counterpart of ``transformer_gan_tpu/infer/sample.py``: prefix priming in
windows of batch forwards, single-step decoding for the duration-based host
loop, fixed-length generation in chunks (the fused sampling kernel for
top-k / random, the plain chunked decode for nucleus and for models with
note-status inputs, which the kernel does not take), and the quality
metrics' gumbel-argmax generation (:func:`generate_tokens_gumbel`). Under
raw-hidden memory (``cache_kv`` off) both run the rolling loop of one-token
forwards over the memory ring, as the JAX package does: that layout has no
chunked decode and no kernel.

Random numbers: every sampling function takes the gumbel noise ``g`` as an
input. :func:`gumbel_noise` draws it from an explicit ``torch.Generator``;
tests hand the same numpy noise to this port and to the JAX package, whose
``jax.random.categorical`` adds exactly such noise.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models import xl
from ..ops import generate as gen_ops
from ..ops.decode_params import stack_decode_params
from ..utils import spans


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Static sampling parameters."""

    technique: str = "topk"      # topk | nucleus | random ("gumbel": argmax
                                 # of l / T + g without softmax or floor)
    topk: int = 32
    nucleus_p: float = 0.95
    temperature: float = 0.95
    exclude_bos: bool = True
    num_empty_to_ignore: int = 0  # suppress TIME_SHIFT_100 after N repeats
    empty_token: int = 101        # TIME_SHIFT_100 id

    @classmethod
    def from_cfg(cls, inference_cfg, empty_token: int) -> "SamplingConfig":
        s = inference_cfg.SAMPLING
        technique = s.technique
        topk, p = 32, 0.95
        if technique == "topk":
            topk = int(s.threshold) if s.threshold else 32
        elif technique == "nucleus":
            p = float(s.threshold) if s.threshold else 0.95
        elif technique != "random":
            raise NotImplementedError(
                "Other sampling strategies are yet to be implemented")
        return cls(technique=technique, topk=topk, nucleus_p=p,
                   temperature=float(s.temperature),
                   exclude_bos=bool(inference_cfg.INPUT.exclude_bos_token),
                   num_empty_to_ignore=int(
                       inference_cfg.INPUT.num_empty_tokens_to_ignore),
                   empty_token=empty_token)


NEG = -1e30

# Tokens per decode chunk: the big K/V cache is rewritten once per chunk.
DECODE_CHUNK = 32


def gumbel_noise(shape, generator: torch.Generator, device=None) -> torch.Tensor:
    """Standard gumbel noise, fp32, from ``generator`` (on its device).
    ``u`` is kept inside (0, 1) so the double log stays finite."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    tiny = torch.finfo(torch.float32).tiny
    u = u.clamp_(min=tiny, max=1.0 - 2.0 ** -24)
    return -torch.log(-torch.log(u))


def _filter_and_sample(logits: torch.Tensor, scfg: SamplingConfig,
                       empty_run: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Logit surgery + filtering + gumbel draw over the last axis.

    logits [..., V]; empty_run [...] int; g [..., V] fp32 noise. Returns
    int64 ids [...]. Ties go to the lowest index (``torch.argmax``)."""
    l = logits.float()
    V = l.shape[-1]
    vocab = torch.arange(V, device=l.device)
    if scfg.exclude_bos:
        l = l.masked_fill(vocab == 0, NEG)
    if scfg.num_empty_to_ignore > 0:
        suppress = (empty_run >= scfg.num_empty_to_ignore)[..., None]
        l = l.masked_fill(suppress & (vocab == scfg.empty_token), NEG)

    if scfg.temperature == 0:
        return l.argmax(-1)
    l = l / scfg.temperature
    if scfg.technique == "gumbel":
        return (l + g).argmax(-1)
    probs = torch.softmax(l, dim=-1)

    if scfg.technique == "topk":
        kth = torch.topk(probs, scfg.topk, dim=-1).values[..., -1:]
        probs = torch.where(probs >= kth, probs, 0.0)
    elif scfg.technique == "nucleus":
        sorted_probs = torch.sort(probs, dim=-1).values.flip(-1)
        csum = torch.cumsum(sorted_probs, dim=-1)
        # keep tokens while the exclusive cumulative prob < p, always >= 1
        rank = torch.argsort(torch.argsort(-probs, dim=-1, stable=True),
                             dim=-1, stable=True)
        keep_sorted = torch.cat(
            [torch.ones_like(csum[..., :1], dtype=torch.bool),
             csum[..., :-1] < scfg.nucleus_p], dim=-1)
        probs = torch.where(torch.gather(keep_sorted, -1, rank), probs, 0.0)
    elif scfg.technique != "random":
        raise NotImplementedError(scfg.technique)
    return (torch.log(probs.clamp(min=1e-38)) + g).argmax(-1)


def _next_empty(tok: torch.Tensor, empty_run: torch.Tensor,
                scfg: SamplingConfig) -> torch.Tensor:
    return torch.where(tok == scfg.empty_token, empty_run + 1,
                       torch.zeros_like(empty_run))


def make_decode_step(xcfg: xl.XLConfig, scfg: SamplingConfig):
    """(params, mems, token [bsz], empty_run [bsz], g [bsz, V]) ->
    (next_token [bsz], new_mems, new_empty_run): one-token forward for the
    duration-based host loop."""

    @torch.no_grad()
    def step(params, mems, token, empty_run, g):
        logits, new_mems = xl.forward_generate(params, xcfg, token[None, :],
                                               mems, same_length=True)
        next_tok = _filter_and_sample(logits[-1], scfg, empty_run, g)
        return next_tok, new_mems, _next_empty(next_tok, empty_run, scfg)

    return step


PRIME_WINDOW = 128


def make_prime_step(xcfg: xl.XLConfig, window: int = PRIME_WINDOW):
    """Batch prefix forward filling the XL memory, as a host loop of
    <= ``window``-token forwards (exact for window <= mem_len under
    same_length). Returned logits cover only the final window."""

    @torch.no_grad()
    def prime_chunked(params, context, mems):
        w = max(1, min(window, mems.mem_len))
        logits = None
        for s in range(0, context.shape[0], w):
            logits, mems = xl.forward_generate(params, xcfg, context[s:s + w],
                                               mems, same_length=True)
        return logits, mems

    return prime_chunked


@torch.no_grad()
def sample_scan(params, xcfg: xl.XLConfig, scfg: SamplingConfig,
                first_token: torch.Tensor, mems: xl.XLMems, length: int,
                g_all: torch.Tensor):
    """Generate ``length`` tokens after ``first_token`` [bsz].

    g_all: [length, bsz, V] fp32 gumbel noise. Returns (tokens [length,
    bsz], final mems). Top-k, random and gumbel run on the fused sampling
    kernel (its plain version on the CPU); nucleus and note-status models on
    the plain chunked decode; raw-hidden memory on the rolling loop."""
    if not xcfg.cache_kv:
        return _rolling_sample_loop(params, xcfg, scfg, first_token, mems,
                                    length, g_all, same_length=True)
    bsz = first_token.shape[0]
    C = min(DECODE_CHUNK, length, mems.mem_len)
    empty0 = torch.zeros_like(first_token)
    if gen_ops.supports_fused_generate(xcfg, scfg, bsz, C):
        tokens, hids, count = _fused_sample_loop(
            params, xcfg, scfg, first_token, mems, length, g_all, empty0,
            same_length=True)
        return tokens, xl.XLMems(hids=hids, count=count)

    tokens, state = _chunked_sample_loop(params, xcfg, scfg, first_token,
                                         mems, length, g_all, same_length=True)
    return tokens, xl.mems_from_decode_state(xcfg, state)


def _rolling_sample_loop(params, xcfg: xl.XLConfig, scfg: SamplingConfig,
                         first_token, mems: xl.XLMems, length: int, g_all, *,
                         same_length: bool):
    """``length`` one-token forwards over the memory ring (the layout's
    own), each memory shifted by one slot. Returns (tokens [length, bsz],
    final mems)."""
    pos_emb = xl.positional_embedding(xcfg, mems.mem_len + 1,
                                      first_token.device).to(xcfg.cdtype)
    token, empty_run = first_token, torch.zeros_like(first_token)
    pieces = []
    for t in range(length):
        logits, mems = xl.forward_generate(params, xcfg, token[None], mems,
                                           same_length=same_length,
                                           pos_emb=pos_emb)
        token = _filter_and_sample(logits[-1], scfg, empty_run, g_all[t])
        empty_run = _next_empty(token, empty_run, scfg)
        pieces.append(token)
    return torch.stack(pieces), mems


def _chunked_sample_loop(params, xcfg: xl.XLConfig, scfg: SamplingConfig,
                         first_token, mems: xl.XLMems, length: int, g_all, *,
                         same_length: bool):
    """The plain chunked decode: ``length`` tokens, one ``decode_chunk_step``
    each, the staged rows merged once a chunk. Returns (tokens [length,
    bsz], decode state)."""
    bsz = first_token.shape[0]
    C = min(DECODE_CHUNK, length, mems.mem_len)
    state = xl.decode_state_from_mems(params, xcfg, mems)
    token, empty_run = first_token, torch.zeros_like(first_token)
    pieces = []
    for s in range(0, length, C):
        n = min(C, length - s)
        stage = xl.init_decode_stage(xcfg, C, bsz, dtype=state.kv[0][0].dtype,
                                     device=first_token.device)
        for t in range(n):
            logits, stage = xl.decode_chunk_step(params, xcfg, token, state,
                                                 stage, t,
                                                 same_length=same_length)
            token = _filter_and_sample(logits, scfg, empty_run, g_all[s + t])
            empty_run = _next_empty(token, empty_run, scfg)
            pieces.append(token)
        state = xl.merge_decode_state(xcfg, state, stage, n)
    return torch.stack(pieces), state


# The metrics' sampler: argmax of l + g, no temperature, no logit surgery
# (K3's "gumbel" technique)
GUMBEL_ARGMAX = SamplingConfig(technique="gumbel", temperature=1.0,
                               exclude_bos=False, num_empty_to_ignore=0)


def gumbel_draws(length: int, bsz: int, V: int, generator: torch.Generator,
                 device=None) -> torch.Tensor:
    """[length, bsz, V] fp32 noise of :func:`generate_tokens_gumbel`, from
    [1, bsz, V] uniforms a step: -log(-log(u + 1e-20) + 1e-20), the JAX
    package's straight-through gumbel draw (``models.gan.gumbel``)."""
    from ..models.gan import gumbel
    return gumbel(torch.rand((length, 1, bsz, V), generator=generator,
                             dtype=torch.float32, device=device)[:, 0])


@torch.no_grad()
def generate_tokens_gumbel(params, xcfg: xl.XLConfig, seq_len: int,
                           first_token: torch.Tensor, mems: xl.XLMems,
                           g_all: torch.Tensor) -> torch.Tensor:
    """Gumbel-argmax generation of the quality metrics (reference
    generate_tokens): ``seq_len - 1`` tokens after ``first_token`` [bsz],
    each the argmax of its logits plus ``g_all`` [seq_len - 1, bsz, V]
    (:func:`gumbel_draws`; a positive temperature does not move the
    argmax), with same_length off: on the chunked memory ``mems`` on K3's
    gumbel technique (its plain version for CPU tensors), or the plain
    chunked decode for a model K3 does not take (note-status inputs, as the
    JAX package gates its kernel); on raw-hidden memory the rolling loop. A
    wave wider than ``ops.generate.MAX_LANES`` runs as sub-waves of at most
    that many lanes. Returns the tokens [seq_len, bsz], ``first_token``
    first."""
    length = seq_len - 1
    if length <= 0:
        return first_token[None]
    bsz = first_token.shape[0]
    W = gen_ops.MAX_LANES
    if bsz > W:
        return torch.cat([generate_tokens_gumbel(
            params, xcfg, seq_len, first_token[s:s + W],
            mems.rows(s, min(s + W, bsz)), g_all[:, s:s + W])
            for s in range(0, bsz, W)], dim=1)
    if not xcfg.cache_kv:
        tokens, _ = _rolling_sample_loop(params, xcfg, GUMBEL_ARGMAX,
                                         first_token, mems, length, g_all,
                                         same_length=False)
    elif gen_ops.supports_fused_generate(
            xcfg, GUMBEL_ARGMAX, bsz, min(DECODE_CHUNK, length, mems.mem_len)):
        tokens, _, _ = _fused_sample_loop(
            params, xcfg, GUMBEL_ARGMAX, first_token, mems, length, g_all,
            torch.zeros_like(first_token), same_length=False)
    else:
        tokens, _ = _chunked_sample_loop(params, xcfg, GUMBEL_ARGMAX,
                                         first_token, mems, length, g_all,
                                         same_length=False)
    return torch.cat([first_token[None].to(tokens.dtype), tokens])


@torch.no_grad()
def _fused_sample_loop(params, xcfg: xl.XLConfig, scfg: SamplingConfig,
                       first_token, mems: xl.XLMems, length: int, g_all,
                       empty0, *, same_length: bool):
    """Chunked loop over the fused sampling kernel. Returns (tokens
    [length, bsz] int32, hids [L, 2, h, bsz, M, dh] memory, count)."""
    L = xcfg.n_layer
    hd = xcfg.n_head * xcfg.d_head
    bsz = first_token.shape[0]
    hids = mems.hids.contiguous()
    M, dev = hids.shape[4], hids.device
    C = min(DECODE_CHUNK, length, M)   # a chunk must fit the ring

    with spans.span("gen.setup", device=hids.is_cuda):
        R = xl.precompute_r_heads(params, xcfg, M + 1, dev).reshape(
            L, M + 1, hd).to(hids.dtype).contiguous()
        stacked = stack_decode_params(
            {k: v.to(dev) for k, v in params.items()}, xcfg)
    count = int(mems.count)
    ids = first_token.to(torch.int32).reshape(bsz, 1)
    er = empty0.to(torch.int32).reshape(bsz, 1)
    g_all = g_all.to(device=dev, dtype=torch.float32)

    pieces = []
    for s in range(0, length, C):
        n = min(C, length - s)
        ids, er, toks, staged = gen_ops.fused_generate_chunk(
            stacked, xcfg, scfg, hids, R, ids, er,
            g_all[s:s + n].contiguous(), count, n, same_length=same_length)
        with spans.span("gen.ring", device=hids.is_cuda):
            hids = torch.cat([hids[..., n:, :], staged], dim=4)
        count = min(count + n, M)
        pieces.append(toks)
    return torch.cat(pieces), hids, count
