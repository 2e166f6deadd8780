"""MLE training and evaluation steps.

Counterpart of ``transformer_gan_tpu/train/step.py``. The JAX step is one
jitted program (a ``lax.scan`` over micro-chunks, then the fused optimizer);
here it is a Python loop over the chunks, each a forward and a backward into
the gradient of one flat fp32 parameter vector, then the fused optimizer on
that vector. Loss semantics match the reference: each chunk's loss is its
pad-masked mean NLL divided by ``batch_chunk`` (0 when no token counts), and
gradients are summed over chunks.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import xl
from .optim import FlatLayout, FusedOptimizer, FusedOptState, global_grad_norm

# Per-step generators are seeded from (run seed, step), so a restarted run
# draws the same dropout masks as an uninterrupted one.
_SEED_STRIDE = 1_000_003


@dataclasses.dataclass
class TrainState:
    """flat: [P] fp32 master parameters (``layout`` names them); mems: one
    ``XLMems`` per micro-chunk; seed: the run seed; step: updates so far."""

    flat: torch.Tensor
    layout: FlatLayout
    opt_state: FusedOptState
    mems: list
    seed: int
    step: int

    def params(self) -> dict:
        """Views of the master weights under their names."""
        return self.layout.unflatten(self.flat)


def init_train_state(params: dict, optimizer: FusedOptimizer,
                     xcfg: xl.XLConfig, batch_chunk: int, mem_len: int,
                     bsz_chunk: int, seed: int, device=None) -> TrainState:
    layout = optimizer.layout or FlatLayout.of(params)
    flat = layout.flatten(params).to(device).requires_grad_(True)
    mems = [xl.init_mems(xcfg, mem_len, bsz_chunk, device=device)
            for _ in range(batch_chunk)]
    return TrainState(flat=flat, layout=layout, opt_state=optimizer.init(
        flat.detach()), mems=mems, seed=int(seed), step=0)


def chunk_batch(x: np.ndarray, batch_chunk: int) -> np.ndarray:
    """[tgt, bsz] -> [chunk, tgt, bsz/chunk] (a contiguous split of the
    batch axis, like torch.chunk)."""
    tgt, bsz = x.shape[0], x.shape[1]
    return x.reshape(tgt, batch_chunk, bsz // batch_chunk).swapaxes(0, 1)


def chunk_rows(x: np.ndarray, batch_chunk: int) -> np.ndarray:
    """[bsz] per-row flags -> [chunk, bsz/chunk]."""
    return x.reshape(batch_chunk, -1)


def step_generator(seed: int, step: int) -> torch.Generator:
    """The step's CPU generator (dropout seeds, see ``xl.xl_forward``)."""
    return torch.Generator().manual_seed(
        (int(seed) * _SEED_STRIDE + int(step)) % (2 ** 63))


def make_mle_train_step(xcfg: xl.XLConfig, optimizer: FusedOptimizer,
                        batch_chunk: int, pad_id: int, use_mle: bool = True,
                        same_length: bool = False, route: str | None = None):
    """fn(state, data [C, tgt, bsz_c], target [C, tgt, bsz_c],
    reset [C, bsz_c]) -> (state, metrics); inputs are tensors on the
    state's device, chunked with ``chunk_batch`` / ``chunk_rows``. Metrics
    are device scalars: ``loss_weighted`` (sum over chunks of mean * tokens),
    ``tokens`` and the pre-clip ``grad_norm``. Dropout is drawn from
    generators seeded by (state.seed, state.step) (see ``xl.xl_forward``);
    ``route`` forces the attention route (``xl.xl_forward``)."""

    def train_step(state: TrainState, data_c, target_c, reset_c):
        gen = step_generator(state.seed, state.step)
        chunk_seeds = torch.randint(0, 2 ** 62, (batch_chunk,),
                                    generator=gen).tolist()
        state.flat.grad = None
        loss_w = torch.zeros((), dtype=torch.float32, device=state.flat.device)
        tokens = torch.zeros((), dtype=torch.int64, device=state.flat.device)
        new_mems = []
        for c in range(batch_chunk):
            params = state.params()
            chunk_gen = torch.Generator().manual_seed(chunk_seeds[c])
            nll, mems_c = xl.forward_nll(
                params, xcfg, data_c[c], target_c[c], reset_c[c],
                state.mems[c], same_length=same_length, generator=chunk_gen,
                route=route)
            mask = target_c[c] != pad_id
            cnt = mask.sum()
            # pad-masked mean; 0 (and no gradient) when no token counts
            mean = torch.where(mask, nll, 0.0).sum() / cnt.clamp(min=1)
            (mean / batch_chunk).backward()
            loss_w = loss_w + mean.detach() * cnt
            tokens = tokens + cnt
            new_mems.append(mems_c)
        grad = state.flat.grad
        grad_norm = global_grad_norm(grad)
        opt_state = state.opt_state
        if use_mle:
            opt_state = optimizer.update(state.flat.data, grad, opt_state)
        state.flat.grad = None
        new_state = dataclasses.replace(state, opt_state=opt_state,
                                        mems=new_mems, step=state.step + 1)
        return new_state, {"loss_weighted": loss_w, "tokens": tokens,
                           "grad_norm": grad_norm}

    return train_step


def make_eval_step(xcfg: xl.XLConfig, pad_id: int):
    """(params, data, target, mems) -> (nll_sum, token_count, new_mems):
    one evaluation window with same_length masking and no dropout."""

    @torch.no_grad()
    def eval_step(params, data, target, mems):
        nll, new_mems = xl.forward_nll(params, xcfg, data, target, None, mems,
                                       same_length=True)
        mask = target != pad_id
        return torch.where(mask, nll, 0.0).sum(), mask.sum(), new_mems

    return eval_step


def reset_eval_mems(mems: xl.XLMems) -> xl.XLMems:
    """The equivalent of no memory at a new batch of pieces: every slot
    masked."""
    return xl.XLMems(hids=mems.hids, count=0)
