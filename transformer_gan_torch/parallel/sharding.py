"""Which rows each rank holds, and what every rank holds alike
(counterpart of ``transformer_gan_tpu/parallel/sharding.py``).

A global micro-batch of b rows is split over the N ranks of the ``data``
axis as GSPMD splits it: rank r takes rows ``[r b / N, (r + 1) b / N)``.
A batch of ``batch_chunk`` micro-batches is split micro-batch by
micro-batch, so that ``train/step.chunk_batch`` of rank r's batch gives
rank r's rows of every global micro-batch. The XL memory ring, the eval
memory, the GAN batch and PPO's P0 ([rows]) follow their rows. Every
helper reads the process's mesh (``mesh.current``), the one the
all-reduces follow.

A training step's random numbers are each rank's own, drawn at the rank's
shape from a stream seeded by ``mesh.rank_seed``. :class:`GanRowDraws` and
:class:`MlmRowDraws` instead hand a rank its rows of numbers drawn at the
global shape, so that N ranks see the numbers one device would: for draws
replayed from a record or from the host (the tests against the JAX
package, ``kernel_check.GanCase``) and for the MLM evaluation's masks,
which then do not depend on the world size.

Parameters and optimizer states are replicated: :func:`broadcast_state`
copies rank 0's into every rank after init and after a restore.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import gan as gan_mod
from ..models import xl
from . import mesh as pmesh


def rank_rows(x, rank: int, world: int, axis: int = 0, groups: int = 1):
    """Rank ``rank``'s rows of ``x`` (a tensor or an array) along ``axis``,
    which holds ``groups`` consecutive blocks (micro-batches, or the real
    and fake halves the critic scores together), each split into ``world``
    equal parts: the rank's part of every block, in block order."""
    n = x.shape[axis]
    if n % (groups * world):
        raise ValueError(f"{n} rows in {groups} block(s) do not split over "
                         f"{world} ranks")
    shape = tuple(x.shape)
    blocked = x.reshape(shape[:axis] + (groups, world, n // (groups * world))
                        + shape[axis + 1:])
    idx = (slice(None),) * (axis + 1) + (rank,)
    part = blocked[idx]
    out_shape = shape[:axis] + (n // world,) + shape[axis + 1:]
    if isinstance(part, np.ndarray):
        return np.ascontiguousarray(part).reshape(out_shape)
    return part.reshape(out_shape).contiguous()


def local_rows(x, axis: int = 0, groups: int = 1):
    """This rank's rows of ``x`` (:func:`rank_rows` on the process's
    mesh)."""
    mesh = pmesh.current()
    return rank_rows(x, mesh.rank, mesh.world, axis=axis, groups=groups)


def batch_rows(x, batch_chunk: int = 1, axis: int = 1):
    """The rank's rows of a global ``[tgt, bsz]`` batch (``[bsz]`` flags with
    ``axis`` 0; the note-status vectors ``[tgt, bsz, vec_len]`` as the
    tokens) of ``batch_chunk`` micro-batches."""
    return local_rows(x, axis=axis, groups=batch_chunk)


def mems_rows(mems: xl.XLMems) -> xl.XLMems:
    """The rank's rows of an XL memory: K/V ``[L, 2, H, B, M, dh]`` or raw
    hiddens ``[L + 1, M, B, d]``."""
    return xl.XLMems(hids=local_rows(mems.hids, axis=mems.batch_axis),
                     count=mems.count)


def broadcast_state(*states) -> None:
    """Rank 0's flat parameters and optimizer states into every rank:
    tensors broadcast in place; ``FusedOptState`` moments too."""
    for s in states:
        if s is None:
            continue
        if isinstance(s, torch.Tensor):
            with torch.no_grad():
                pmesh.broadcast_(s.data)
        else:                                   # a FusedOptState
            pmesh.broadcast_(s.mu, s.nu)


class GanRowDraws(gan_mod.Draws):
    """The rank's rows of the global draws of ``inner`` (a ``Draws`` asked
    at the global shape): the gumbel noise's batch axis, the critic's
    dropout rows (the real half, then the fake half) and the gradient
    penalty's weights."""

    def __init__(self, inner: gan_mod.Draws):
        self.inner, self.world = inner, pmesh.current().world

    def gumbel(self, chunk, n, bsz, V):
        return local_rows(self.inner.gumbel(chunk, n, bsz * self.world, V),
                          axis=1)

    def dropout_u(self, chunk, shape):
        glob = (shape[0] * self.world,) + tuple(shape[1:])
        return local_rows(self.inner.dropout_u(chunk, glob), groups=2)

    def gp_alpha(self, chunk, bsz):
        return local_rows(self.inner.gp_alpha(chunk, bsz * self.world))


class MlmRowDraws:
    """The rank's rows of the global draws of ``inner`` (an ``MlmDraws``
    asked at the global shape): the masking draws and every dropout site,
    rows first."""

    def __init__(self, inner):
        self.inner, self.world = inner, pmesh.current().world

    def _glob(self, shape):
        return (shape[0] * self.world,) + tuple(shape[1:])

    def mask(self, shape, vocab_size: int):
        return tuple(local_rows(d) for d in
                     self.inner.mask(self._glob(shape), vocab_size))

    def dropout_u(self, shape):
        return local_rows(self.inner.dropout_u(self._glob(shape)))
