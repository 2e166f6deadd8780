"""The reference's check of gumbel-argmax generation.

A generated token is the argmax of its position's logits plus gumbel noise.
The reference recomputes the noise from the stated seeding, runs its own
full causal forward (no memory, no cache, no dropout) over each produced
sequence, and reads at every position how far the produced token's noisy
logit lies below the best one: 0 where it is the reference's own choice.
"""
from __future__ import annotations

import numpy as np
import torch

from . import xl

GUMBEL_EPS = 1e-20


def call_seed(step: int, call: int) -> int:
    """The seed of the noise stream of generation call ``call`` at training
    step ``step``."""
    seq = np.random.SeedSequence((1234 + step, call))
    return int(seq.generate_state(1)[0])


def call_noise(seed: int, waves: int, length: int, lanes: int, V: int,
               device) -> list:
    """Gumbel noise [length, lanes, V] of each wave of a call, drawn in
    order from one device generator: -log(-log(u + eps) + eps)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(waves):
        u = torch.rand((length, 1, lanes, V), generator=gen,
                       dtype=torch.float32, device=device)[:, 0]
        out.append(-torch.log(-torch.log(u + GUMBEL_EPS) + GUMBEL_EPS))
    return out


@torch.no_grad()
def token_gaps(w: dict, tokens: torch.Tensor, noise: torch.Tensor, *, H: int,
               dh: int, block: int, quant=None) -> torch.Tensor:
    """[length, lanes] gaps of the produced ``tokens`` [length + 1, lanes]
    (the first is the start token) under ``noise`` [length, lanes, V]; with
    ``quant`` the gap of the token a lower precision puts first instead."""
    length, lanes = noise.shape[0], noise.shape[1]
    out = []
    for lo in range(0, lanes, block):
        rows = slice(lo, min(lo + block, lanes))
        inp = tokens[:-1, rows]
        score = xl.logits(w, xl.forward(w, inp, None, 0, None, H=H,
                                        dh=dh)[0]) + noise[:, rows]
        if quant is None:
            chosen = tokens[1:, rows]
        else:
            low = xl.logits(w, xl.forward(w, inp, None, 0, None, H=H, dh=dh,
                                          quant=quant)[0], quant)
            chosen = (low + noise[:, rows]).argmax(-1)
        best = score.max(-1).values
        out.append(best - torch.gather(score, -1, chosen[..., None])[..., 0])
        del score
    return torch.cat(out, 1)
