"""MLE training and evaluation steps.

Counterpart of ``transformer_gan_tpu/train/step.py``. The JAX step is one
jitted program (a ``lax.scan`` over micro-chunks, then the fused optimizer);
here it is a Python loop over the chunks, each a forward and a backward into
the gradient of one flat fp32 parameter vector, then the fused optimizer on
that vector. Loss semantics match the reference: each chunk's loss is its
pad-masked mean NLL divided by ``batch_chunk`` (0 when no token counts), and
gradients are summed over chunks.

Data parallel (``parallel/mesh``), each rank holds its rows of every
micro-batch and the step keeps the JAX package's semantics on a mesh: a
micro-batch's masked NLL sum is divided by the token count of the whole
global micro-batch (the counts are all-reduced before the backward; a mean
of per-rank means, what the reference's DDP computes, differs under pads),
and the flat gradient is all-reduced once before the norm and the clip.
Each rank draws its dropout from its own stream.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import xl
from ..parallel import mesh as pmesh
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


def chunk_seeds(seed: int, step: int, batch_chunk: int) -> list[int]:
    """The dropout seeds of the step's micro-chunks on this rank, from the
    step's generator of the rank's seed (``parallel/mesh.rank_seed``): every
    rank has its own stream, and rank 0's is the one-process run's."""
    return torch.randint(0, 2 ** 62, (batch_chunk,), generator=step_generator(
        pmesh.rank_seed(seed), step)).tolist()


def chunk_status(status_vec: np.ndarray, batch_chunk: int) -> np.ndarray:
    """[tgt, bsz, vec_len] note-status vectors -> [chunk, tgt, bsz/chunk,
    vec_len], split along the batch axis as :func:`chunk_batch` splits the
    tokens."""
    tgt, bsz, n = status_vec.shape
    return status_vec.reshape(tgt, batch_chunk, bsz // batch_chunk,
                              n).swapaxes(0, 1)


def make_mle_train_step(xcfg: xl.XLConfig, optimizer: FusedOptimizer,
                        batch_chunk: int, pad_id: int, use_mle: bool = True,
                        same_length: bool = False, route: str | None = None,
                        remat: bool = False):
    """fn(state, data [C, tgt, bsz_c], target [C, tgt, bsz_c],
    reset [C, bsz_c], status_c=None) -> (state, metrics); inputs are tensors
    on the state's device, chunked with ``chunk_batch`` / ``chunk_rows`` /
    :func:`chunk_status` (the rank's rows when data parallel); ``status_c``
    [C, tgt, bsz_c, vec_len], the note-status inputs. Metrics are device
    scalars of the rank's rows: ``loss_weighted`` (the masked NLL sum),
    ``tokens`` and the pre-clip ``grad_norm`` of the all-reduced gradient.
    Dropout is drawn from generators seeded by (state.seed, state.step,
    rank) (:func:`chunk_seeds`, ``xl.xl_forward``); ``route`` forces the
    attention route and ``remat`` recomputes each layer in the backward
    (``xl.xl_forward``)."""

    def train_step(state: TrainState, data_c, target_c, reset_c,
                   status_c=None):
        seeds = chunk_seeds(state.seed, state.step, batch_chunk)
        # every micro-batch's token count over all ranks, before any backward
        counts = pmesh.all_reduce_sum_((target_c != pad_id).sum(dim=(1, 2)))
        state.flat.grad = None
        loss_w = torch.zeros((), dtype=torch.float32, device=state.flat.device)
        tokens = torch.zeros((), dtype=torch.int64, device=state.flat.device)
        new_mems = []
        for c in range(batch_chunk):
            params = state.params()
            chunk_gen = torch.Generator().manual_seed(seeds[c])
            nll, mems_c = xl.forward_nll(
                params, xcfg, data_c[c], target_c[c], reset_c[c],
                state.mems[c],
                status_vec=None if status_c is None else status_c[c],
                same_length=same_length, generator=chunk_gen, route=route,
                remat=remat)
            mask = target_c[c] != pad_id
            cnt = counts[c]
            # pad-masked mean over the global micro-batch; 0 (and no
            # gradient) when no token counts
            mean = torch.where(mask, nll, 0.0).sum() / cnt.clamp(min=1)
            (mean / batch_chunk).backward()
            loss_w = loss_w + mean.detach() * cnt
            tokens = tokens + mask.sum()
            new_mems.append(mems_c)
        grad = pmesh.all_reduce_sum_(state.flat.grad)
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


def make_eval_step(xcfg: xl.XLConfig, pad_id: int, route: str | None = None):
    """(params, data, target, mems, status_vec=None) -> (nll_sum,
    token_count, new_mems): one evaluation window with same_length masking
    and no dropout; ``route`` forces the attention route
    (``xl.xl_forward``)."""

    @torch.no_grad()
    def eval_step(params, data, target, mems, status_vec=None):
        nll, new_mems = xl.forward_nll(params, xcfg, data, target, None, mems,
                                       status_vec=status_vec,
                                       same_length=True, route=route)
        mask = target != pad_id
        return torch.where(mask, nll, 0.0).sum(), mask.sum(), new_mems

    return eval_step


def reset_eval_mems(mems: xl.XLMems) -> xl.XLMems:
    """The equivalent of no memory at a new batch of pieces: every slot
    masked."""
    return xl.XLMems(hids=mems.hids, count=0)
