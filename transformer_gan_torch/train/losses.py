"""Adversarial losses, temperature schedules and the gradient penalty.

Counterpart of ``transformer_gan_tpu/train/losses.py``: ``get_losses`` over
the eight families (standard, JS, KL, hinge, wgan(-gp), tv, rsgan(-gp),
ppo(-gp)), the beta annealing policies ``get_fixed_temperature`` and the
WGAN-GP ``gradient_penalty``, whose double backward is
``torch.autograd.grad(create_graph=True)``.

Data parallel, each rank holds an equal share of the rows and every loss
is a mean over its rows, so the mean of the ranks' losses (and of their
gradients, which the phases average) is the loss over all rows. Only
PPO's weights W, a softmax over the rows, read the other ranks' rows
(:func:`row_softmax_weights`). The gradient penalty is per row, and so are
PPO's ratio and P0.
"""
from __future__ import annotations

import numpy as np
import torch

from ..parallel import mesh as pmesh


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on logits, in fp32."""
    logits = logits.float()
    return torch.mean(torch.clamp(logits, min=0) - logits * targets
                      + torch.log1p(torch.exp(-logits.abs())))


def row_softmax_weights(d: torch.Tensor) -> torch.Tensor:
    """n * softmax(d) over the rows (axis 0) of every rank, detached, in
    fp32; n counts them all."""
    d = d.detach().float()
    world = pmesh.current().world
    if world == 1:
        return d.shape[0] * torch.softmax(d, 0)
    top = pmesh.all_reduce_max_(d.amax(0))
    e = torch.exp(d - top)
    total = pmesh.all_reduce_sum_(e.sum(0))
    return (d.shape[0] * world) * e / total


def get_losses(d_out_real: torch.Tensor, d_out_fake: torch.Tensor,
               loss_type: str = "JS"):
    """(g_loss, d_loss) of one loss family."""
    ones_r = torch.ones_like(d_out_real)
    zeros_f = torch.zeros_like(d_out_fake)
    ones_f = torch.ones_like(d_out_fake)
    if loss_type == "standard":      # non-saturating
        d_loss = (bce_with_logits(d_out_real, ones_r)
                  + bce_with_logits(d_out_fake, zeros_f))
        g_loss = bce_with_logits(d_out_fake, ones_f)
    elif loss_type == "JS":          # vanilla GAN
        d_loss_fake = bce_with_logits(d_out_fake, zeros_f)
        d_loss = bce_with_logits(d_out_real, ones_r) + d_loss_fake
        g_loss = -d_loss_fake
    elif loss_type == "KL":
        d_loss = (bce_with_logits(d_out_real, ones_r)
                  + bce_with_logits(d_out_fake, zeros_f))
        g_loss = torch.mean(-d_out_fake)
    elif loss_type == "hinge":
        d_loss = (torch.mean(torch.relu(1.0 - d_out_real))
                  + torch.mean(torch.relu(1.0 + d_out_fake)))
        g_loss = -torch.mean(d_out_fake)
    elif "wgan" in loss_type:        # wgan / wgan-gp
        d_loss = -torch.mean(d_out_real) + torch.mean(d_out_fake)
        g_loss = -torch.mean(d_out_fake)
    elif loss_type == "tv":          # total variation
        d_loss = torch.mean(torch.tanh(d_out_fake) - torch.tanh(d_out_real))
        g_loss = torch.mean(-torch.tanh(d_out_fake))
    elif "rsgan" in loss_type:       # relativistic standard GAN
        d_loss = bce_with_logits(d_out_real - d_out_fake, ones_r)
        g_loss = bce_with_logits(d_out_fake - d_out_real, ones_f)
    elif "ppo" in loss_type:
        W = row_softmax_weights(d_out_fake)
        d_loss = torch.mean(W * d_out_fake - d_out_real)
        g_loss = -torch.mean(d_out_fake)
    else:
        raise NotImplementedError(f"Divergence '{loss_type}' is not implemented")
    return g_loss, d_loss


def get_fixed_temperature(temper: float, i: int, N: int, adapt: str) -> float:
    """Beta annealing policies; the generator's temperature is 1 / beta."""
    if adapt == "no":
        return 1.0
    if adapt == "lin":
        return 1 + i / (N - 1) * (temper - 1)
    if adapt == "exp":
        return temper ** (i / N)
    if adapt == "log":
        return 1 + (temper - 1) / np.log(N) * np.log(i + 1)
    if adapt == "sigmoid":
        return (temper - 1) * 1 / (1 + np.exp((N / 2 - i) * 20 / N)) + 1
    if adapt == "quad":
        return (temper - 1) / (N - 1) ** 2 * i ** 2 + 1
    if adapt == "sqrt":
        return (temper - 1) / np.sqrt(N - 1) * np.sqrt(i) + 1
    raise ValueError(f"Unknown adapt type: {adapt}")


def gradient_penalty(disc_fn, real_data: torch.Tensor, fake_data: torch.Tensor,
                     alpha: torch.Tensor, lam: float = 10.0) -> torch.Tensor:
    """WGAN-GP on interpolates alpha * real + (1 - alpha) * fake (alpha
    [bsz, 1, 1], the caller's draws): lam * mean((||dD/dx||_2 - 1)^2) per
    sample, differentiable in the discriminator's parameters."""
    bsz = real_data.shape[0]
    x = (alpha * real_data + (1 - alpha) * fake_data).detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(disc_fn(x).float().sum(), x,
                                   create_graph=True)
    slopes = torch.sqrt(grads.reshape(bsz, -1).float().square().sum(1) + 1e-12)
    return torch.mean(torch.square(slopes - 1.0)) * lam
