"""LR schedules and the fused flat optimizer.

Counterpart of ``transformer_gan_tpu/train/optim.py``:

* schedules ``inv_sqrt``, ``cosine``, ``constant`` and ``dev_perf`` return an
  LR *multiplier*; update k (0-based) uses ``schedule(k)``, the reference's
  LambdaLR step semantics;
* ``PlateauTracker``: the host-side ReduceLROnPlateau of ``dev_perf``;
* ``FusedOptimizer``: clip-by-global-norm, then adam / adamw / lamb, the
  schedule and the mutable LR multiplier, as a few ops over ONE fp32 ``[P]``
  vector of the parameters. The flat order is the JAX tree's
  ``ravel_pytree`` order (:func:`flat_names`), so ``mu``/``nu`` carry over
  between the two packages by plain copy (``convert.opt_state_*_jax``).
  The JAX package has no Pallas kernel for the update; it is plain torch.
* the GAN phases' optimizers (``make_gan_optimizers``): clip, Adam, the base
  lr, then a multiplier the host sets from the phase's schedule before each
  phase (``set_lr_multiplier``), over the generator's and the
  discriminator's flat vectors. The BERT critic's adds weight decay after
  Adam (its decay mask) and the exact freeze of the JAX package's
  ``_masked``: a frozen leaf's gradient is zeroed before the clip and its
  update after the chain (the optimizer's ``trainable`` mask). PPO's
  auxiliary classifier ``dis_D`` has its own (``make_disD_optimizer``):
  clip, Adam, ``PPO.dis_D_lr``, with no schedule and no frozen leaf.
"""
from __future__ import annotations

import dataclasses
import math

import torch


def _tree_key(name: str):
    return tuple(int(p) if p.isdigit() else p for p in name.split("."))


def flat_names(names) -> list[str]:
    """Parameter names in ``jax.flatten_util.ravel_pytree`` order: dict keys
    sorted, lists (``layers.3.qkv_w``, ``convs.0.w``) in index order with
    each element's keys sorted."""
    return sorted(names, key=_tree_key)


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Names, shapes and offsets of the parameters in the flat vector."""

    names: tuple
    shapes: tuple
    offsets: tuple
    size: int

    @classmethod
    def of(cls, params: dict) -> "FlatLayout":
        names = tuple(flat_names(params))
        shapes = tuple(tuple(params[n].shape) for n in names)
        offsets, off = [], 0
        for shp in shapes:
            offsets.append(off)
            off += math.prod(shp)
        return cls(names, shapes, tuple(offsets), off)

    def flatten(self, params: dict) -> torch.Tensor:
        return torch.cat([params[n].reshape(-1).to(torch.float32)
                          for n in self.names])

    def unflatten(self, flat: torch.Tensor) -> dict:
        """Views of ``flat`` under the parameter names (autograd flows from
        each view back to ``flat``). One split of ``flat``, not a slice a
        leaf: the backward gathers the leaves' gradients into the [P]
        gradient with one ``cat``, where a slice a leaf would fill a [P]
        buffer with zeros for each leaf and autograd would add them up."""
        pieces = flat.split([math.prod(s) for s in self.shapes])
        return {n: t.view(s)
                for n, s, t in zip(self.names, self.shapes, pieces)}

    def segment_ids(self, device=None) -> torch.Tensor:
        sizes = [math.prod(s) for s in self.shapes]
        return torch.repeat_interleave(
            torch.arange(len(sizes), device=device),
            torch.tensor(sizes, device=device))

    def mask(self, pred) -> torch.Tensor:
        """[P] bool: ``pred(name)`` of the leaf each entry belongs to."""
        keep = torch.tensor([bool(pred(n)) for n in self.names])
        return keep[self.segment_ids()]


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def inv_sqrt_schedule(base_lr: float, warmup_step: int, lr_min: float):
    """Linear warmup then sqrt decay with an lr_min floor; with warmup the
    multiplier at step 0 is 0."""

    def sched(step: int) -> float:
        step = float(step)
        if warmup_step == 0:
            return 1.0 if step == 0 else max(0.0, lr_min / base_lr)
        if step > warmup_step:
            return max(warmup_step ** 0.5 / math.sqrt(max(step, 1.0)),
                       lr_min / base_lr)
        return step / warmup_step

    return sched


def cosine_schedule(base_lr: float, max_step: int, lr_min: float,
                    warmup_step: int):
    """CosineAnnealingLR(T_max=max_step, eta_min=lr_min) on the steps after
    warmup, with a linear warmup below warmup_step."""

    def sched(step: int) -> float:
        step = float(step)
        if warmup_step > 0 and step < warmup_step:
            return step / warmup_step
        eff = max(step - warmup_step, 0.0)
        return (lr_min + (base_lr - lr_min)
                * 0.5 * (1 + math.cos(math.pi * eff / max_step))) / base_lr

    return sched


def constant_schedule(warmup_step: int):
    def sched(step: int) -> float:
        if warmup_step > 0 and step < warmup_step:
            return float(step) / warmup_step
        return 1.0

    return sched


def make_schedule(name: str, base_lr: float, max_step: int, lr_min: float,
                  warmup_step: int):
    """dev_perf's factor comes from :class:`PlateauTracker` on the host; its
    in-step schedule is the warmup/constant part."""
    if name == "cosine":
        return cosine_schedule(base_lr, max_step, lr_min, warmup_step)
    if name == "inv_sqrt":
        return inv_sqrt_schedule(base_lr, warmup_step, lr_min)
    if name in ("constant", "dev_perf"):
        return constant_schedule(warmup_step)
    raise NotImplementedError(name)


class PlateauTracker:
    """Multiply the LR by ``factor`` after ``patience`` non-improving evals,
    floored at lr_min."""

    def __init__(self, factor: float, patience: int, lr_min: float,
                 base_lr: float):
        self.factor = factor
        self.patience = patience
        self.lr_min = lr_min
        self.base_lr = base_lr
        self.best = float("inf")
        self.num_bad = 0
        self.multiplier = 1.0

    def step(self, metric: float) -> float:
        if metric < self.best:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.multiplier = max(self.multiplier * self.factor,
                                      self.lr_min / self.base_lr)
                self.num_bad = 0
        return self.multiplier


# ---------------------------------------------------------------------------
# Fused flat optimizer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FusedOptState:
    """count: updates applied so far; mu, nu: [P] fp32 moments; lr_scale:
    the mutable LR multiplier (dev_perf)."""

    count: int
    mu: torch.Tensor
    nu: torch.Tensor
    lr_scale: float = 1.0


class FusedOptimizer:
    """clip -> adam / adamw / lamb -> schedule * base_lr -> lr_scale -> -1,
    over the flat fp32 parameter vector, updated in place.

    ``decay_mask`` ([P] bool): adamw decays only these entries (all when
    None). ``trainable`` ([P] bool): the other entries are frozen exactly;
    their gradient is zeroed before the clip (it adds nothing to the norm,
    and their Adam moments, zero from the start, stay zero) and their
    update after the chain."""

    def __init__(self, optim_name: str, base_lr: float, schedule,
                 clip: float, weight_decay: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, trust_clip: float = 10.0,
                 layout: FlatLayout | None = None, eps: float | None = None,
                 decay_mask: torch.Tensor | None = None,
                 trainable: torch.Tensor | None = None):
        name = optim_name.lower()
        if name not in ("adam", "adamw", "lamb", "jitlamb"):
            raise NotImplementedError(optim_name)
        self.name = name
        self.lamb = name in ("lamb", "jitlamb")
        if self.lamb and layout is None:
            raise ValueError("lamb needs the parameter layout for its "
                             "per-leaf trust ratios")
        if (decay_mask is not None or trainable is not None) and \
                name != "adamw":
            raise ValueError("decay and trainable masks are adamw's")
        self.eps = eps if eps is not None else (1e-6 if self.lamb else 1e-8)
        self.base_lr, self.schedule, self.clip = base_lr, schedule, clip
        self.weight_decay, self.b1, self.b2 = weight_decay, b1, b2
        self.trust_clip = trust_clip
        self.layout = layout
        self.decay_mask, self.trainable = decay_mask, trainable
        self._ids = None

    def init(self, flat: torch.Tensor) -> FusedOptState:
        return FusedOptState(count=0, mu=torch.zeros_like(flat),
                             nu=torch.zeros_like(flat))

    @torch.no_grad()
    def update(self, flat: torch.Tensor, grad: torch.Tensor,
               state: FusedOptState) -> FusedOptState:
        """Apply one update to ``flat`` in place; returns the new state."""
        b1, b2, wd, eps = self.b1, self.b2, self.weight_decay, self.eps
        if self.trainable is not None:
            self.trainable = self.trainable.to(flat.device)
            grad = torch.where(self.trainable, grad, 0.0)
        gnorm = grad.square().sum().sqrt()
        g = grad * torch.where(gnorm < self.clip, 1.0, self.clip / gnorm)
        if self.name == "adam" and wd:
            g = g + wd * flat  # decayed weights added BEFORE adam
        count = state.count + 1
        mu = b1 * state.mu + (1.0 - b1) * g
        nu = b2 * state.nu + (1.0 - b2) * g * g
        if self.lamb:
            # no bias correction, weight decay folded in, per-leaf trust
            # ratio clamp(||w||, 0, trust_clip) / (||step|| + eps)
            step = mu / (nu.sqrt() + eps)
            if wd:
                step = step + wd * flat
            if self._ids is None or self._ids.device != flat.device:
                self._ids = self.layout.segment_ids(flat.device)
            n_seg = len(self.layout.names)
            w_norm = torch.zeros(n_seg, dtype=flat.dtype, device=flat.device
                                 ).index_add_(0, self._ids, flat * flat)
            a_norm = torch.zeros_like(w_norm).index_add_(0, self._ids,
                                                         step * step)
            w_norm = w_norm.sqrt().clamp(0.0, self.trust_clip)
            a_norm = a_norm.sqrt()
            trust = torch.where((w_norm == 0.0) | (a_norm == 0.0), 1.0,
                                w_norm / (a_norm + eps))
            direction = step * trust[self._ids]
        else:
            c = torch.tensor(float(count), dtype=torch.float32)
            mu_hat = mu / (1.0 - torch.tensor(b1, dtype=torch.float32) ** c
                           ).item()
            nu_hat = nu / (1.0 - torch.tensor(b2, dtype=torch.float32) ** c
                           ).item()
            direction = mu_hat / (nu_hat.sqrt() + eps)
            if self.name == "adamw" and wd:
                decay = wd * flat
                if self.decay_mask is not None:
                    self.decay_mask = self.decay_mask.to(flat.device)
                    decay = torch.where(self.decay_mask, decay, 0.0)
                direction = direction + decay
            if self.trainable is not None:
                direction = torch.where(self.trainable, direction, 0.0)
        mult = self.schedule(state.count) * self.base_lr * state.lr_scale
        flat.add_(direction * (-mult))
        return FusedOptState(count=count, mu=mu, nu=nu,
                             lr_scale=state.lr_scale)


def set_lr_multiplier(state: FusedOptState, multiplier: float
                      ) -> FusedOptState:
    return dataclasses.replace(state, lr_scale=float(multiplier))


def global_grad_norm(grads) -> torch.Tensor:
    """fp32 global norm of a flat gradient or a dict of gradients."""
    if isinstance(grads, torch.Tensor):
        return grads.float().square().sum().sqrt()
    return torch.sqrt(sum(g.float().square().sum() for g in grads.values()))


def _no_schedule(step: int) -> float:
    return 1.0


def gan_decay_mask(name: str) -> bool:
    """The BERT critic's weight-decay mask: no decay on leaves named ``*_b``
    or containing ``ln`` or ``bias`` (the MLM trainer's differs:
    ``bert.mlm.mlm_decay_mask``)."""
    leaf = name.rsplit(".", 1)[-1]
    return not (leaf.endswith("_b") or "ln" in leaf or "bias" in leaf)


def make_gan_optimizers(cfg, gen_layout: FlatLayout, dis_layout: FlatLayout,
                        n_devices: int = 1,
                        trainable: torch.Tensor | None = None):
    """The generator's and the discriminator's GAN-phase optimizers with
    their schedules: (gen_opt, gen_sched, dis_opt, dis_sched). Each is clip
    by TRAIN.clip, Adam (eps 1e-8), the base lr (DISCRIMINATOR.gen_lr over
    the device count; DISCRIMINATOR.CNN.learning_rate), then the mutable
    multiplier, which the host sets to ``sched(train_step)`` before each
    phase (the reference steps these schedulers every training step). The
    BERT critic's: clip, Adam (eps BERT.adam_epsilon), masked weight decay
    (BERT.weight_decay, :func:`gan_decay_mask`), BERT.learning_rate, the
    multiplier, frozen where ``trainable`` is False."""
    d = cfg.DISCRIMINATOR
    gen_sched = make_schedule(d.gen_scheduler, d.gen_lr, cfg.TRAIN.max_step,
                              d.gen_lr_min, d.gen_warmup_step)
    dis_sched = make_schedule(d.dis_scheduler, d.dis_lr, cfg.TRAIN.max_step,
                              d.dis_lr_min, d.dis_warmup_step)
    gen_opt = FusedOptimizer("adam", d.gen_lr / max(1, int(n_devices)),
                             _no_schedule, cfg.TRAIN.clip, layout=gen_layout)
    if d.type == "bert":
        dis_opt = FusedOptimizer(
            "adamw", d.BERT.learning_rate, _no_schedule, cfg.TRAIN.clip,
            d.BERT.weight_decay, layout=dis_layout, eps=d.BERT.adam_epsilon,
            decay_mask=dis_layout.mask(gan_decay_mask), trainable=trainable)
    else:
        dis_opt = FusedOptimizer("adam", d.CNN.learning_rate, _no_schedule,
                                 cfg.TRAIN.clip, layout=dis_layout)
    return gen_opt, gen_sched, dis_opt, dis_sched


def make_disD_optimizer(cfg, layout: FlatLayout) -> FusedOptimizer:
    """PPO's classifier ``dis_D``: clip by TRAIN.clip, Adam (eps 1e-8),
    PPO.dis_D_lr, no schedule. Unlike the BERT critic's, no leaf of it is
    frozen: the JAX package's chain has no trainable mask."""
    return FusedOptimizer("adam", float(cfg.PPO.dis_D_lr), _no_schedule,
                          cfg.TRAIN.clip, layout=layout)
