"""Transformer-GAN composite: gumbel straight-through sampling and the
discriminator losses of one GAN batch (RelGAN CNN discriminator or BERT
critic).

Counterpart of ``transformer_gan_tpu/models/gan.py`` for ``dis_type: cnn``
and ``bert``, PPO included:

* context priming with no gradient; chunk 0 carries the real context
  one-hots at its head, later chunks seed from the detached last sample;
* forward-only sampling (the dis phase, and the gen phase's trajectory) on
  the fused sampler: K4 per 32-token chunk, or K5 per token
  (``ops/decode.py``; their plain versions for CPU tensors);
* the differentiable gen phase as in the JAX package: sample forward-only,
  recompute each chunk's logits in one batched window pass
  (``xl.decode_recompute_window``) and rebuild the straight-through
  one-hots from the same noise. With full backprop through the sample
  chain (``truncate_backprop`` False) the chunk goes through
  :class:`_ChunkSTFullchain`, whose backward gets the logits cotangents Q
  from the reverse chain (K6 on the window's residuals, K7 recomputing,
  or the plain loop of single-position VJPs) and all parameter gradients
  from one ``torch.autograd.grad`` over the window;
* :func:`gen_scan_chunked`, the sequential differentiable sampler, is the
  oracle path (``TPU.gan_fused_decode: off`` or ``TPU.gan_chain_bwd: off``);
* :func:`gen_scan`, the rolling sampler (one ``xl.forward_generate`` a
  token over the memory ring), runs under ``TPU.gan_decode_cache: rolling``
  and under raw-hidden memory (``TPU.cache_kv`` off), where there is no
  chunked cache. Its backward keeps every step's memory, which is why the
  chunked cache is the default.

The fused sampler and the window recompute (with its reverse chain) run
only on the chunked cache and not under note-status inputs, the JAX
package's gates: there the sequential sampler takes every phase, plain
torch ops on any device.

The BERT critic scores soft one-hots padded with a zero ``[MASK]`` column
times its fp32 word embeddings, real ids through the embedding rows, both in
one batched call; its gradient penalty takes one-hot interpolates over
V + 1.

PPO (``loss_type`` ppo / ppo-gp) replaces the fakes' scores in the
generator's loss by a clipped surrogate: an auxiliary classifier ``dis_D``
(a BERT on the argmax ids, or a RelGAN CNN on the one-hots) gives each row
a ratio P1 / (D1 P0) against a snapshot P0 of its earlier odds
(:func:`compute_P0`), clipped to 1 +- ``clip_param``
(:func:`ppo_surrogate`); ``dis_D`` trains on real against fake by BCE
(:func:`classifier_loss_for_batch`). Its scores are taken to fp32 before
the sigmoid.

Random numbers are inputs: a :class:`Draws` object hands out the gumbel
noise of each sampled chunk, the discriminator's dropout draws and the
gradient penalty's interpolation weights, from an explicit
``torch.Generator``; tests hand in other numbers (the JAX package's).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..ops import chain_bwd as chain_ops
from ..ops import decode as dec_ops
from ..ops.decode_params import stack_decode_params
from ..train.losses import get_losses, gradient_penalty
from ..utils import spans
from . import bert as bert_mod
from . import discriminator as disc_mod
from . import xl

# Tokens per sampling chunk: the big K/V cache is merged once per chunk.
GEN_DECODE_CHUNK = 32
GUMBEL_EPS = 1e-20


@dataclasses.dataclass(frozen=True)
class GanConfig:
    """Static GAN-phase parameters (from cfg.DISCRIMINATOR / cfg.PPO /
    cfg.TPU)."""

    dis_type: str = "cnn"
    loss_type: str = "rsgan"
    tgt_len: int = 64
    mem_len: int = 64
    context_len: int = 5
    sample_chunks_mem: int = 1
    truncate_backprop: bool = False
    gen_loss_factor: float = 30.0
    dis_loss_factor: float = 1.0
    batch_chunk: int = 1
    ppo: bool = False
    ppo_dis_type: str = "bert"       # dis_D: "bert" | "cnn"
    clip_param: float = 0.4
    n_token: int = 310
    # full-chain gen phase: "auto" / "kernel" the reverse chain on the
    # window residuals (K6), "kernel_recompute" recomputing each token's
    # forward (K7), "jnp" the plain loop of single-position VJPs, "off" the
    # sequential sampler's own backward
    chain_bwd: str = "auto"
    # "auto" / "on": forward-only sampling on the fused sampler (K4 / K5);
    # "off": the sequential sampler in every phase
    fused_sampler: str = "auto"
    # "kernel": the sampler and chain wrappers (their kernels on CUDA
    # tensors); "plain": their plain versions on any device, the yardstick
    # the kernel path is timed against (not a configuration key)
    route: str = "kernel"
    # sampling memory: "auto" / "chunked" the two-level chunked decode cache
    # under cache_kv, else the rolling sampler; "rolling" forces the latter
    decode_cache: str = "auto"

    def __post_init__(self):
        if self.dis_type not in ("cnn", "bert"):
            raise NotImplementedError(
                f"DISCRIMINATOR.type {self.dis_type!r} is not ported (the "
                "port runs the RelGAN CNN and the BERT critic)")
        if self.ppo_dis_type not in ("bert", "cnn"):
            raise NotImplementedError(
                f"PPO.dis_D_type {self.ppo_dis_type!r} is not ported (bert "
                "and cnn are)")
        if self.chain_bwd not in ("auto", "kernel", "kernel_recompute", "jnp",
                                  "off"):
            raise ValueError(f"unknown TPU.gan_chain_bwd {self.chain_bwd!r}")
        if self.route not in ("kernel", "plain"):
            raise ValueError(f"unknown route {self.route!r}")
        if self.decode_cache not in ("auto", "chunked", "rolling"):
            raise ValueError(
                f"unknown TPU.gan_decode_cache {self.decode_cache!r}")
        if self.fused_sampler not in ("auto", "on", "off"):
            raise ValueError(
                f"unknown TPU.gan_fused_decode {self.fused_sampler!r}")
        if (self.fused_sampler == "off"
                and self.chain_bwd in ("kernel", "kernel_recompute")):
            raise ValueError(
                "fused_sampler='off' forces the sequential sampler in every "
                "phase, so the chain-backward kernel that chain_bwd="
                f"{self.chain_bwd!r} asks for can never run")

    @property
    def sample_len(self) -> int:
        return self.tgt_len // self.sample_chunks_mem

    @property
    def has_gp(self) -> bool:
        return "gp" in self.loss_type

    def chunk_lengths(self) -> list[int]:
        """Tokens sampled per chunk (chunk 0 starts after the context)."""
        return ([self.sample_len - self.context_len]
                + [self.sample_len] * (self.sample_chunks_mem - 1))

    @classmethod
    def from_cfg(cls, cfg, n_token: int) -> "GanConfig":
        d = cfg.DISCRIMINATOR
        loss_type = d.BERT.loss_type if d.type == "bert" else d.CNN.loss_type
        return cls(
            dis_type=d.type, loss_type=loss_type, tgt_len=d.tgt_len,
            mem_len=d.mem_len, context_len=d.context_len,
            sample_chunks_mem=d.sample_chunks_mem,
            truncate_backprop=d.truncate_backprop,
            gen_loss_factor=float(d.gen_loss_factor),
            dis_loss_factor=float(d.dis_loss_factor),
            batch_chunk=d.batch_chunk, ppo="ppo" in loss_type,
            ppo_dis_type=str(cfg.PPO.dis_D_type),
            clip_param=float(cfg.PPO.clip_param), n_token=n_token,
            fused_sampler=str(cfg.TPU.gan_fused_decode),
            chain_bwd=str(cfg.TPU.gan_chain_bwd),
            decode_cache=str(cfg.TPU.gan_decode_cache))


# ---------------------------------------------------------------------------
# Random numbers
# ---------------------------------------------------------------------------

def gumbel(u: torch.Tensor) -> torch.Tensor:
    """Gumbel noise from uniform draws, -log(-log(u + eps) + eps)."""
    return -torch.log(-torch.log(u + GUMBEL_EPS) + GUMBEL_EPS)


class Draws:
    """The random numbers of one GAN micro-batch, drawn in order from
    ``generator`` (on ``device``). ``chunk`` names the sampled chunk a draw
    belongs to; this class ignores it, a subclass reproducing another
    stream (the tests' JAX keys) uses it."""

    def __init__(self, generator: torch.Generator, device=None):
        self.generator = generator
        self.device = device

    def _uniform(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator,
                          dtype=torch.float32, device=self.device)

    def gumbel(self, chunk: int, n: int, bsz: int, V: int) -> torch.Tensor:
        """[n, bsz, V] fp32 noise of the chunk's n sampling steps."""
        return gumbel(self._uniform((n, bsz, V)))

    def dropout_u(self, chunk: int, shape) -> torch.Tensor:
        """Uniform draws of the discriminator's dropout on the chunk (the
        BERT critic's: one call per dropout site, in ``models/bert`` order)."""
        return self._uniform(shape)

    def gp_alpha(self, chunk: int, bsz: int) -> torch.Tensor:
        """[bsz, 1, 1] interpolation weights of the gradient penalty."""
        return self._uniform((bsz, 1, 1))


class RecordedDraws(Draws):
    """The random numbers of one GAN micro-batch with its gumbel noise from
    recorded uniforms ``u`` [n_steps, bsz, V]: the sampling steps of the
    micro-batch's chunks in order, what the JAX package's ``noise=``
    injects on its rolling sampler. The discriminator's dropout draws and
    the penalty weights come from ``generator``, a CPU generator (seed 0 by
    default), so that every device sees the same numbers."""

    def __init__(self, u, device=None, generator: torch.Generator | None = None):
        super().__init__(generator or torch.Generator().manual_seed(0), device)
        self.u = torch.as_tensor(u, dtype=torch.float32)
        self.pos = 0

    def _uniform(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator,
                          dtype=torch.float32).to(self.device)

    def gumbel(self, chunk: int, n: int, bsz: int, V: int) -> torch.Tensor:
        u = self.u[self.pos:self.pos + n]
        if tuple(u.shape) != (n, bsz, V):
            raise ValueError(f"recorded noise {tuple(self.u.shape)} has no "
                             f"[{n}, {bsz}, {V}] block at step {self.pos}")
        self.pos += n
        return gumbel(u.to(self.device))


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def _detached(params: dict) -> dict:
    return {k: v.detach() for k, v in params.items()}


@torch.no_grad()
def prime_context(gen_params, xcfg: xl.XLConfig, gcfg: GanConfig,
                  data: torch.Tensor) -> xl.XLMems:
    """No-grad context prime: the sampling memory after the first
    context_len - 1 real tokens."""
    mems = xl.init_mems(xcfg, gcfg.mem_len, data.shape[1], device=data.device)
    if gcfg.context_len > 1:
        _, mems = xl.forward_generate(_detached(gen_params), xcfg,
                                      data[:gcfg.context_len - 1], mems)
    return mems


def prime_context_state(gen_params, xcfg: xl.XLConfig, gcfg: GanConfig,
                        data: torch.Tensor) -> xl.DecodeState:
    """:func:`prime_context` as a decode state; its positional rows come
    from the live parameters, so r_w gradients flow from every step."""
    return xl.decode_state_from_mems(gen_params, xcfg,
                                     prime_context(gen_params, xcfg, gcfg, data))


def gen_scan(gen_params, xcfg: xl.XLConfig, temperature, mems: xl.XLMems,
             prev_onehot: torch.Tensor, detach_flags, g: torch.Tensor):
    """Sequential straight-through sampling of len(detach_flags) tokens on
    the rolling memory (either layout), differentiable: one
    ``xl.forward_generate`` a token, the memory detached after each step
    (so gradients reach a token's K/V through its own attention only).
    ``detach_flags[t]`` stops the gradient through step t's input; g: [n,
    bsz, V] noise (the JAX package's ``noise=`` uniforms u give g =
    :func:`gumbel` (u)). Returns (samples [n, bsz, V], mems, last one-hot)."""
    V = prev_onehot.shape[-1]
    prev, samples = prev_onehot, []
    for t, detach in enumerate(detach_flags):
        hard = F.one_hot(prev.argmax(-1), V).to(prev.dtype).detach()
        logits, mems = xl.forward_generate(gen_params, xcfg,
                                           (hard if detach else prev)[None],
                                           mems)
        prev = xl.gumbel_softmax_st(logits[0], temperature, g[t])
        samples.append(prev)
    return torch.stack(samples), mems, prev


def gen_scan_chunked(gen_params, xcfg: xl.XLConfig, temperature,
                     state: xl.DecodeState, prev_onehot: torch.Tensor,
                     detach_flags, g: torch.Tensor):
    """Sequential straight-through sampling of len(detach_flags) tokens on
    the chunked decode cache, differentiable (the oracle path).
    ``detach_flags[t]`` stops the gradient through step t's input; g:
    [n, bsz, V] noise. Returns (samples [n, bsz, V], state, last one-hot)."""
    n_steps = len(detach_flags)
    bsz, V = prev_onehot.shape
    C = min(GEN_DECODE_CHUNK, n_steps)
    prev, samples = prev_onehot, []
    for s in range(0, n_steps, C):
        n = min(C, n_steps - s)
        stage = xl.init_decode_stage(xcfg, C, bsz, dtype=state.kv[0][1].dtype,
                                     device=prev.device)
        for t in range(n):
            hard = F.one_hot(prev.argmax(-1), V).to(prev.dtype).detach()
            inp = hard if detach_flags[s + t] else prev
            logits, stage = xl.decode_chunk_step(
                gen_params, xcfg, inp, state, stage, t, same_length=False,
                detach_kv_writes=True)
            prev = xl.gumbel_softmax_st(logits, temperature, g[s + t])
            samples.append(prev)
        state = xl.merge_decode_state(xcfg, state, stage, n)
    return torch.stack(samples), state, prev


def _sampler_operands(gen_params, xcfg: xl.XLConfig, mems: xl.XLMems):
    """The fused sampler's operands: stacked weights, the big cache in the
    memory's own layout, the positional projections [L, M+1, HD]."""
    params = _detached(gen_params)
    M = mems.hids.shape[4]
    hd = xcfg.n_head * xcfg.d_head
    R = xl.precompute_r_heads(params, xcfg, M + 1, mems.hids.device)
    return (stack_decode_params(params, xcfg),
            mems.hids.to(xcfg.cdtype).contiguous(),
            R.reshape(xcfg.n_layer, M + 1, hd).to(xcfg.cdtype).contiguous())


@torch.no_grad()
def gen_scan_chunked_fused(stacked, xcfg: xl.XLConfig, kv: torch.Tensor,
                           R: torch.Tensor, count: int, ids: torch.Tensor,
                           g: torch.Tensor, plain: bool = False):
    """Forward-only sampling of len(g) tokens on the fused sampler: one K4
    call per chunk of up to 32 tokens, or one K5 call per token when the
    chunk sampler is off (``TGTPU_CHUNK_SAMPLER=0``); their plain versions
    with ``plain``. The staged rows merge into the cache after each chunk.
    kv [L, 2, H, B, M, dh]; ids [B, 1]. Returns (one-hots [n, B, V], kv,
    count, ids)."""
    n_steps = g.shape[0]
    L, _, H, B, M, dh = kv.shape
    C = min(GEN_DECODE_CHUNK, n_steps)
    if C > M:
        raise ValueError(f"sampling chunk {C} exceeds mem_len {M}")
    chunk_fn = (dec_ops.fused_decode_chunk_plain if plain
                else dec_ops.fused_decode_chunk)
    step_fn = (dec_ops.fused_decode_step_plain if plain
               else dec_ops.fused_decode_step)
    pieces = []
    for s in range(0, n_steps, C):
        n = min(C, n_steps - s)
        if dec_ops.chunk_sampler_enabled():
            ids, oh, staged = chunk_fn(stacked, xcfg, kv, R, ids, g[s:s + n],
                                       count, n)
        else:
            staged = torch.zeros((L, 2, H, B, C, dh), dtype=kv.dtype,
                                 device=kv.device)
            ohs = []
            for t in range(n):
                ids, oh_t, staged = step_fn(stacked, xcfg, kv, R, staged, ids,
                                            g[s + t], t, count)
                ohs.append(oh_t)
            oh = torch.stack(ohs)
        kv = torch.cat([kv[..., n:, :], staged[..., :n, :]], dim=4).contiguous()
        count = min(count + n, M)
        pieces.append(oh)
    return torch.cat(pieces), kv, count, ids


def _sample_fake_chunks_fused(gen_params, xcfg: xl.XLConfig, gcfg: GanConfig,
                              data: torch.Tensor, noise, mems=None,
                              operands=None):
    """Forward-only :func:`sample_fake_chunks` on the fused sampler
    (``operands``: :func:`_sampler_operands` of ``mems``, built when not
    given)."""
    if mems is None:
        mems = prime_context(gen_params, xcfg, gcfg, data)
    stacked, kv, R = operands or _sampler_operands(gen_params, xcfg, mems)
    V, ctx, L_s = gcfg.n_token, gcfg.context_len, gcfg.sample_len
    count = mems.count
    ids = data[ctx - 1].to(torch.int32)[:, None]
    chunks = []
    for c, g in enumerate(noise):
        samples, kv, count, ids = gen_scan_chunked_fused(
            stacked, xcfg, kv, R, count, ids, g, plain=gcfg.route == "plain")
        if c == 0:
            real_ctx = F.one_hot(data[:ctx], V).float()
            chunks.append((torch.cat([real_ctx, samples]), data[0:L_s]))
        else:
            chunks.append((samples, data[c * L_s:(c + 1) * L_s]))
    return chunks


def _window_st(params, xcfg: xl.XLConfig, inputs, k_mem, v_mem, count: int,
               g, hard, temperature, collect_residuals: bool = False):
    """Batched window forward and straight-through rebuild of one chunk:
    (st, y, k_full, v_full, new_count[, residuals])."""
    out = xl.decode_recompute_window(params, xcfg, inputs, k_mem, v_mem, count,
                                     collect_residuals=collect_residuals)
    y = torch.softmax((out[0].float() + g) / temperature, dim=-1)
    st = (hard - y).detach() + y
    return (st, y) + tuple(out[1:])


class _ChunkSTFullchain(torch.autograd.Function):
    """One chunk of straight-through samples with full backprop through the
    sample chain, computed batched.

    The K/V cache is detached every step, so the only sequential gradient
    path is the straight-through chain input_{t+1} = hard_t + y_t - sg(y_t).
    The backward therefore splits: the reverse chain carrying only the
    input cotangent chi [b, V] gives each step's logits cotangent q_t
    (softmax backward of m_t = s_t + chi_t; chi_{t-1} = J_t^T q_t with J_t
    the single-position Jacobian d logits_t / d input_t), and all parameter
    gradients come from one autograd pass over the window with
    grad_outputs = Q."""

    @staticmethod
    def forward(ctx, xcfg, chain_impl, names, chain_operands, inputs, k_mem,
                v_mem, count, g, hard, temperature, *flat_params):
        params = dict(zip(names, flat_params))
        st, y, kf, vf, _ = _window_st(params, xcfg, inputs, k_mem, v_mem,
                                      count, g, hard, temperature)
        kf, vf = torch.stack(kf), torch.stack(vf)
        ctx.xcfg, ctx.chain_impl, ctx.names = xcfg, chain_impl, names
        ctx.chain_operands = chain_operands
        ctx.count, ctx.temperature = count, temperature
        ctx.save_for_backward(inputs, k_mem, v_mem, g, hard, y, *flat_params)
        ctx.mark_non_differentiable(kf, vf)
        return st, kf, vf

    @staticmethod
    def backward(ctx, dst, _dkf, _dvf):
        inputs, k_mem, v_mem, g, hard, y, *flat = ctx.saved_tensors
        xcfg, impl = ctx.xcfg, ctx.chain_impl
        leaves = [p.detach().requires_grad_() for p in flat]
        params = dict(zip(ctx.names, leaves))
        dst = dst.float()
        with torch.enable_grad():
            res = impl in ("auto", "kernel")
            with spans.span("gan.recompute", device=inputs.is_cuda):
                out = xl.decode_recompute_window(params, xcfg, inputs, k_mem,
                                                 v_mem, ctx.count,
                                                 collect_residuals=res)
            logits, kf, vf = out[0], torch.stack(out[1]), torch.stack(out[2])
            args = (params, xcfg, kf, vf, inputs, dst, y, ctx.count,
                    ctx.temperature)
            # the sampler's stacked weights and R: a gen update stacks once
            stacked, R = ctx.chain_operands
            if impl == "jnp":
                Q = chain_ops.chain_bwd_q_plain(*args)
            elif impl == "kernel_recompute":
                Q = chain_ops.chain_bwd_q(*args, stacked=stacked, R=R)
            else:
                Q = chain_ops.chain_bwd_q_res(*args, out[4], stacked=stacked,
                                              R=R)
            grads = torch.autograd.grad(logits, leaves,
                                        grad_outputs=Q.to(logits.dtype),
                                        allow_unused=True)
        return (None,) * 11 + tuple(torch.zeros_like(p) if g is None else g
                                    for p, g in zip(leaves, grads))


def _sample_fake_chunks_recompute(gen_params, xcfg: xl.XLConfig,
                                  gcfg: GanConfig, data: torch.Tensor,
                                  temperature, noise):
    """Differentiable :func:`sample_fake_chunks`: sample forward-only, then
    recompute each chunk's logits batched and rebuild the straight-through
    one-hots from the same noise (exact for truncate_backprop; the chain
    terms through :class:`_ChunkSTFullchain` otherwise)."""
    V, ctx, M = gcfg.n_token, gcfg.context_len, gcfg.mem_len
    mems = prime_context(gen_params, xcfg, gcfg, data)
    operands = _sampler_operands(gen_params, xcfg, mems)
    hard_chunks = _sample_fake_chunks_fused(gen_params, xcfg, gcfg, data,
                                            noise, mems=mems,
                                            operands=operands)
    k_mem = mems.hids[:, 0].to(xcfg.cdtype)          # [L, h, b, M, dh]
    v_mem = mems.hids[:, 1].to(xcfg.cdtype)
    count = mems.count
    names = tuple(gen_params)
    chain_impl = "jnp" if gcfg.route == "plain" else gcfg.chain_bwd
    chunks = []
    prev_hard = F.one_hot(data[ctx - 1], V).float()
    for c, g in enumerate(noise):
        hard = hard_chunks[c][0][ctx:] if c == 0 else hard_chunks[c][0]
        inputs = torch.cat([prev_hard[None], hard[:-1]])
        with spans.span("gan.recompute", device=data.is_cuda):
            if gcfg.truncate_backprop:
                st, _, kf, vf, _ = _window_st(gen_params, xcfg, inputs, k_mem,
                                              v_mem, count, g, hard,
                                              temperature)
                kf, vf = torch.stack(kf), torch.stack(vf)
            else:
                st, kf, vf = _ChunkSTFullchain.apply(
                    xcfg, chain_impl, names, (operands[0], operands[2]),
                    inputs, k_mem, v_mem, count, g, hard, float(temperature),
                    *gen_params.values())
        count = min(count + hard.shape[0], M)
        k_mem, v_mem = kf[..., -M:, :], vf[..., -M:, :]
        if c == 0:
            st = torch.cat([F.one_hot(data[:ctx], V).float(), st])
        chunks.append((st, hard_chunks[c][1]))
        prev_hard = hard[-1]
    return chunks


def sample_fake_chunks(gen_params, xcfg: xl.XLConfig, gcfg: GanConfig,
                       data: torch.Tensor, temperature, noise,
                       forward_only: bool = False):
    """The per-chunk fakes of one GAN batch.

    data: [tgt_len, bsz] real ids; noise: per chunk [n_c, bsz, V] gumbel
    noise (:meth:`GanConfig.chunk_lengths`). Returns a list of (fake
    [sample_len, bsz, V], real ids [sample_len, bsz]); chunk boundaries
    detached. ``forward_only``: the caller does not differentiate through
    the samples (the dis phase).

    Routes as the JAX package: the chunked cache under ``cache_kv`` unless
    ``decode_cache`` is "rolling", else :func:`gen_scan`; on the chunked
    cache without note-status inputs, the fused sampler for forward-only
    callers and the window recompute for differentiable ones (unless
    ``fused_sampler`` is "off"), else :func:`gen_scan_chunked`."""
    chunked = xcfg.cache_kv and gcfg.decode_cache != "rolling"
    fused = chunked and gcfg.fused_sampler != "off"
    if fused and xcfg.append_note_status:
        if gcfg.fused_sampler == "on" and forward_only:
            raise ValueError("fused_sampler='on' but the fused sampler does "
                             "not take note-status inputs")
        fused = False
    if fused:
        if forward_only:
            return _sample_fake_chunks_fused(gen_params, xcfg, gcfg, data, noise)
        if (gcfg.sample_len <= gcfg.mem_len
                and gcfg.sample_len - gcfg.context_len >= 1
                and (gcfg.truncate_backprop or gcfg.chain_bwd != "off")):
            return _sample_fake_chunks_recompute(gen_params, xcfg, gcfg, data,
                                                 temperature, noise)
    V, ctx, L_s = gcfg.n_token, gcfg.context_len, gcfg.sample_len
    if chunked:
        mems, scan = (prime_context_state(gen_params, xcfg, gcfg, data),
                      gen_scan_chunked)
    else:
        mems, scan = prime_context(gen_params, xcfg, gcfg, data), gen_scan
    real_ctx = F.one_hot(data[:ctx], V).float()
    last = real_ctx[-1]
    chunks = []
    for c, g in enumerate(noise):
        flags = [bool(gcfg.truncate_backprop)] * g.shape[0]
        if c > 0:
            flags[0] = True
            last = last.detach()
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not forward_only):
            samples, mems, last = scan(gen_params, xcfg, temperature, mems,
                                       last, flags, g)
        if c == 0:
            chunks.append((torch.cat([real_ctx, samples]), data[0:L_s]))
        else:
            chunks.append((samples, data[c * L_s:(c + 1) * L_s]))
    return chunks


# ---------------------------------------------------------------------------
# Discriminator scoring and losses
# ---------------------------------------------------------------------------

def _bert_embed(dis_params, soft: torch.Tensor) -> torch.Tensor:
    """[bsz, len, V + 1] one-hots or soft distributions times the critic's
    word embeddings, in fp32 (``bert_encode`` casts)."""
    return torch.einsum("ve,bcv->bce", dis_params["word_embeddings"], soft)


def score_chunk(dis_params, dis_cfg, gcfg: GanConfig, real_ids, fake_soft, *,
                train: bool = False, dropout_u=None):
    """(d_out_real, d_out_fake) of one chunk, real and fake scored in one
    discriminator call over [2b] rows. real_ids: [len, bsz];
    fake_soft: [len, bsz, V]. ``dropout_u``: the RelGAN's draws (a tensor of
    ``dropout_shape``) or the BERT critic's (``shape -> draws``)."""
    if gcfg.dis_type == "bert":
        bsz = real_ids.shape[1]
        # zero column for [MASK]
        fake = F.pad(fake_soft.transpose(0, 1), (0, 1))
        emb_fake = _bert_embed(dis_params, fake)
        emb_real = dis_params["word_embeddings"][real_ids.T]
        both = torch.cat([emb_real.to(emb_fake.dtype), emb_fake])
        d_both = bert_mod.bert_discriminator_score(
            dis_params, dis_cfg, both, train=train, dropout_u=dropout_u)
        return d_both[:bsz], d_both[bsz:]
    real_soft = F.one_hot(real_ids.T, gcfg.n_token).to(fake_soft.dtype)
    both = torch.cat([real_soft, fake_soft.transpose(0, 1)])
    d_both = disc_mod.relgan_logits(dis_params, dis_cfg, both, train=train,
                                    dropout_u=dropout_u)
    half = d_both.shape[0] // 2            # num_rep scores per row
    return d_both[:half], d_both[half:]


def chunk_gradient_penalty(dis_params, dis_cfg, gcfg: GanConfig, real_ids,
                           fake_soft, alpha):
    """WGAN-GP on one-hot interpolates of one chunk (over V + 1 for the BERT
    critic, whose embedding product takes them)."""
    fake = fake_soft.transpose(0, 1).detach()
    if gcfg.dis_type == "bert":
        real = F.one_hot(real_ids.T, gcfg.n_token + 1).float()
        return gradient_penalty(
            lambda x: bert_mod.bert_discriminator_score(
                dis_params, dis_cfg, _bert_embed(dis_params, x)),
            real, F.pad(fake, (0, 1)), alpha)
    real = F.one_hot(real_ids.T, gcfg.n_token).float()
    return gradient_penalty(
        lambda x: disc_mod.relgan_logits(dis_params, dis_cfg, x), real, fake,
        alpha)


def _chunk_noise(gcfg: GanConfig, draws: Draws, bsz: int) -> list:
    return [draws.gumbel(c, n, bsz, gcfg.n_token)
            for c, n in enumerate(gcfg.chunk_lengths())]


def gan_losses_for_batch(gen_params, dis_params, dis_cfg, xcfg, gcfg: GanConfig,
                         data: torch.Tensor, temperature, draws: Draws, *,
                         train_dis: bool, disD_params=None, disD_cfg=None,
                         P0=None, update_P0: bool = False) -> dict:
    """Sample the fakes of one batch (noise from ``draws``) and score every
    chunk. Returns summed (over chunks) gen_loss, dis_loss and gp_loss, and
    P0; the dis phase scores detached fakes with discriminator dropout.
    Under PPO the gen phase scores the fakes through
    :func:`ppo_surrogate` with ``dis_D`` (``disD_params``), and with
    ``update_P0`` re-snapshots P0 from each chunk's fake before use; the
    returned P0 is the last one used."""
    bsz = data.shape[1]
    chunks = sample_fake_chunks(gen_params, xcfg, gcfg, data, temperature,
                                _chunk_noise(gcfg, draws, bsz),
                                forward_only=train_dis)
    zero = torch.zeros((), dtype=torch.float32, device=data.device)
    gen_loss, dis_loss, gp_loss = zero, zero, zero
    for c, (fake, real_ids) in enumerate(chunks):
        u = None
        if train_dis:
            fake = fake.detach()
            if gcfg.dis_type == "bert":
                u = (lambda shape, c=c: draws.dropout_u(c, shape))
            else:
                u = draws.dropout_u(c, disc_mod.dropout_shape(dis_cfg, 2 * bsz))
        with spans.span("gan.critic", device=data.is_cuda):
            d_real, d_fake = score_chunk(dis_params, dis_cfg, gcfg, real_ids,
                                         fake, train=train_dis, dropout_u=u)
            if gcfg.ppo and not train_dis:
                if update_P0:
                    P0 = compute_P0(disD_params, disD_cfg, gcfg, fake)
                d_fake = ppo_surrogate(disD_params, disD_cfg, gcfg, fake,
                                       d_fake, P0)
        g, d = get_losses(d_real, d_fake, gcfg.loss_type)
        gen_loss, dis_loss = gen_loss + g, dis_loss + d
        if train_dis and gcfg.has_gp:
            gp_loss = gp_loss + chunk_gradient_penalty(
                dis_params, dis_cfg, gcfg, real_ids, fake,
                draws.gp_alpha(c, bsz))
    return {"gen_loss": gen_loss, "dis_loss": dis_loss, "gp_loss": gp_loss,
            "P0": P0}


# ---------------------------------------------------------------------------
# PPO: the auxiliary classifier dis_D
# ---------------------------------------------------------------------------

def dis_D_forward(disD_params, disD_cfg, gcfg: GanConfig,
                  chunk: torch.Tensor) -> torch.Tensor:
    """dis_D's scores [bsz] of a chunk, [len, bsz] ids or [len, bsz, V]
    one-hots, without dropout: the BERT on the embeddings of the ids (the
    one-hots' argmax, which passes no gradient), or the RelGAN CNN on the
    one-hots (which does)."""
    data = chunk.T if chunk.ndim == 2 else chunk.transpose(0, 1)
    if gcfg.ppo_dis_type == "bert":
        if data.ndim == 3:
            data = data.argmax(-1)
        emb = disD_params["word_embeddings"][data]
        return bert_mod.bert_discriminator_score(disD_params, disD_cfg, emb)
    if data.ndim == 2:
        data = F.one_hot(data, gcfg.n_token).float()
    return disc_mod.relgan_logits(disD_params, disD_cfg, data)


def ppo_surrogate(disD_params, disD_cfg, gcfg: GanConfig, fake_chunk,
                  d_out_fake: torch.Tensor, P0: torch.Tensor) -> torch.Tensor:
    """The PPO-clipped target that replaces d_out_fake in the generator's
    loss: ratio = (1 - D1) / max(D1 P0, 1e-7) with D1 = sigmoid(dis_D),
    clipped to 1 +- clip_param, the pessimistic of the two products. A main
    discriminator with num_rep scores a row (the RelGAN) gets each row's
    ratio num_rep times (the reference ran PPO only with the BERT critic,
    one score a row)."""
    D1 = torch.sigmoid(dis_D_forward(disD_params, disD_cfg, gcfg,
                                     fake_chunk).float())
    ratio = (1.0 - D1) / torch.clamp(D1 * P0, min=1e-7)
    ratio_clipped = torch.clamp(ratio, 1.0 - gcfg.clip_param,
                                1.0 + gcfg.clip_param)
    if d_out_fake.shape[0] != ratio.shape[0]:
        rep = d_out_fake.shape[0] // ratio.shape[0]
        ratio = ratio.repeat_interleave(rep)
        ratio_clipped = ratio_clipped.repeat_interleave(rep)
    surr1, surr2 = ratio * d_out_fake, ratio_clipped * d_out_fake
    return torch.where(d_out_fake > 0, torch.minimum(surr1, surr2),
                       torch.maximum(surr1, surr2))


@torch.no_grad()
def compute_P0(disD_params, disD_cfg, gcfg: GanConfig,
               fake_chunk) -> torch.Tensor:
    """The P0 snapshot [bsz], (1 - D0) / max(D0, 1e-7)."""
    D0 = torch.sigmoid(dis_D_forward(_detached(disD_params), disD_cfg, gcfg,
                                     fake_chunk.detach()).float())
    return (1.0 - D0) / torch.clamp(D0, min=1e-7)


def classifier_loss_for_batch(gen_params, disD_params, disD_cfg, xcfg,
                              gcfg: GanConfig, data: torch.Tensor, temperature,
                              draws: Draws) -> torch.Tensor:
    """dis_D's BCE on one batch, real -> 1 and fake -> 0 (probabilities
    clamped to [1e-7, 1 - 1e-7]), summed over chunks and scaled by
    1 / (batch_chunk * sample_chunks_mem). The fakes are sampled forward
    only from the detached generator (noise from ``draws``)."""
    chunks = sample_fake_chunks(_detached(gen_params), xcfg, gcfg, data,
                                temperature,
                                _chunk_noise(gcfg, draws, data.shape[1]),
                                forward_only=True)
    eps = 1e-7
    total = torch.zeros((), dtype=torch.float32, device=data.device)
    for fake, real_ids in chunks:
        pr = torch.sigmoid(dis_D_forward(disD_params, disD_cfg, gcfg,
                                         real_ids).float())
        pf = torch.sigmoid(dis_D_forward(disD_params, disD_cfg, gcfg,
                                         fake.detach()).float())
        total = total + (-torch.log(torch.clamp(pr, eps, 1 - eps)).mean()
                         - torch.log(torch.clamp(1 - pf, eps, 1 - eps)).mean())
    return total / (gcfg.batch_chunk * gcfg.sample_chunks_mem)
