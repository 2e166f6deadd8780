"""The reference's MLE steps: the configuration's training step in plain
float32, followed for the first steps of a run.

Each step: the dropout draws of the step (``xl.step_seeds``), the forward
over the memory, the pad-masked mean NLL over the batch, its gradient, the
clip by global norm, then Adam under the inverse-square-root schedule with
warmup. Rows are run in blocks (the loss of a block is its NLL sum over the
token count of the whole batch), so the gradient is the whole batch's.
"""
from __future__ import annotations

import dataclasses

import torch

from . import xl


@dataclasses.dataclass
class MleSpec:
    """What the configuration states about a step."""

    L: int
    d: int
    H: int
    dh: int
    di: int
    V: int
    M: int
    dropout: float
    dropatt: float
    run_seed: int
    lr: float
    warmup: int
    lr_min: float
    clip: float
    pad_id: int
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


def inv_sqrt(step: int, spec: MleSpec) -> float:
    """The lr multiplier of update ``step`` (0-based)."""
    if spec.warmup == 0:
        return 1.0 if step == 0 else max(0.0, spec.lr_min / spec.lr)
    if step > spec.warmup:
        return max(spec.warmup ** 0.5 / max(step, 1) ** 0.5,
                   spec.lr_min / spec.lr)
    return step / spec.warmup


def run_steps(w0: dict, batches: list, spec: MleSpec, *, block_rows: int,
              quant=None, rows_used: int | None = None) -> dict:
    """Follow ``batches`` ((data [q, B], target [q, B], reset [B]) tensors on
    the reference's device) from weights ``w0``. Returns the loss of each
    step, the clipped gradients of the first and of the last, and the
    weights after the last.
    ``quant`` rounds the products' operands (the control); ``rows_used`` runs
    the steps on the first rows only (a planted fault)."""
    w = {k: v.detach().clone() for k, v in w0.items()}
    mu = {k: torch.zeros_like(v) for k, v in w.items()}
    nu = {k: torch.zeros_like(v) for k, v in w.items()}
    q, B = batches[0][0].shape
    B_used = rows_used or B
    dev = batches[0][0].device
    mem = xl.empty_memory(spec.L, B, spec.H, spec.M, spec.dh, dev)
    count = 0
    losses, grad1 = [], None
    for step, (data, target, reset) in enumerate(batches):
        chunk_seed = xl.step_seeds(spec.run_seed, step, 1)[0]
        attn_seeds, gen_seed = xl.dropout_seeds(chunk_seed, spec.L)
        masks = xl.Masks(gen_seed, xl.mask_shapes(q, B, spec.M + q, spec.L,
                                                  spec.d, spec.di),
                         spec.dropout, dev)
        tokens = (target[:, :B_used] != spec.pad_id).sum().clamp(min=1)
        for t in w.values():
            t.requires_grad_(True)
            t.grad = None
        nll_sum = 0.0
        new_kv = []
        for lo in range(0, B, block_rows):
            rows = slice(lo, min(lo + block_rows, B))
            mem_b = [(k[rows], v[rows]) for k, v in mem]
            with torch.set_grad_enabled(lo < B_used):
                h, kv = xl.forward(w, data[:, rows], mem_b, count,
                                   reset[rows], H=spec.H, dh=spec.dh,
                                   masks=masks, attn_seeds=attn_seeds,
                                   rate_att=spec.dropatt, rows=rows,
                                   B_full=B, quant=quant)
            new_kv.append(kv)
            if lo >= B_used:
                continue
            logp = torch.log_softmax(xl.logits(w, h, quant), -1)
            nll = -torch.gather(logp, -1, target[:, rows, None])[..., 0]
            keep = target[:, rows] != spec.pad_id
            if rows.stop > B_used:
                keep[:, B_used - lo:] = False
            part = torch.where(keep, nll, 0.0).sum()
            (part / tokens).backward()
            nll_sum += float(part.detach())
        losses.append(nll_sum / float(tokens))
        with torch.no_grad():
            grads = {k: v.grad for k, v in w.items()}
            gnorm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
            scale = 1.0 if float(gnorm) < spec.clip else spec.clip / gnorm
            n = step + 1
            lr = inv_sqrt(step, spec) * spec.lr
            for k in w:
                g = grads[k] * scale
                mu[k].mul_(spec.b1).add_((1 - spec.b1) * g)
                nu[k].mul_(spec.b2).add_((1 - spec.b2) * g * g)
                m_hat = mu[k] / (1 - spec.b1 ** n)
                v_hat = nu[k] / (1 - spec.b2 ** n)
                w[k] = (w[k] - lr * m_hat / (v_hat.sqrt() + spec.eps)).detach()
            grad_last = {k: grads[k] * scale for k in w}
            if step == 0:
                grad1 = grad_last
        kv_all = [(torch.cat([blk[li][0] for blk in new_kv]),
                   torch.cat([blk[li][1] for blk in new_kv]))
                  for li in range(spec.L)]
        mem, count = xl.roll_memory(mem, kv_all, count)
    return {"losses": losses, "grad1": grad1, "grad_last": grad_last,
            "weights": {k: v.detach() for k, v in w.items()}}
