"""GAN training phases for the RelGAN CNN discriminator and the BERT
critic, PPO included.

Counterpart of ``transformer_gan_tpu/train/gan_loop.py`` (``GanPhases``)
for ``DISCRIMINATOR.type: cnn`` and ``bert``: the discriminator phase
(``dis_steps`` updates over fresh real batches, gradients summed over the
``batch_chunk`` micro-batches), the generator phase (one update of the
trainer's own generator parameters; under PPO first one update of the
auxiliary classifier ``dis_D``), the logged losses and the checkpoint
payload. Each phase's optimizer is clip, Adam, the base lr and
a multiplier set from the phase's schedule at the training step
(``train/optim.make_gan_optimizers``).

The BERT critic is sized by ``DISCRIMINATOR.BERT`` or, when
``BERT.model_path`` is an MLM checkpoint directory, by its metadata, and
takes that checkpoint's trunk (:func:`_bert_dis_cfg`,
``GanPhases._init_bert``). Its embeddings (unless ``random_weights``) and
the layers named in ``BERT.freeze_layers`` are frozen exactly
(:func:`_bert_frozen`): the dis phase takes no gradient of them and its
optimizer zeroes their updates.

Under PPO (``loss_type`` ppo / ppo-gp), ``dis_D`` is a second BERT of
the critic's size (seed 23; the trunk of the same MLM checkpoint, grafted
as the critic's is) or, with ``PPO.dis_D_type: cnn``, a RelGAN CNN; all
its leaves train (``optim.make_disD_optimizer``). P0 ([batch_size /
batch_chunk] odds) is re-snapshotted in the gen phase every
``PPO.dis_D_update_D0_freq`` steps and on the first gen phase after a
start or a restart (it is not checkpointed, as in the JAX package).

The random numbers of a micro-batch come from :meth:`GanPhases._draws`, a
``models/gan.Draws`` over the phases' own generator on the device.

Data parallel (``parallel/mesh``, JAX ``gan_loop.py`` on a mesh): the
discriminator, dis_D and the three optimizer states stay replicated; each
rank scores its rows of every GAN micro-batch (its own dis stream; P0 holds
its rows) with its own random numbers (the phases' generator is seeded by
``parallel/mesh.rank_seed``; rank 0 draws what one process draws); each
phase's flat gradient, a mean over the rank's rows, is averaged over the
ranks, which is the gradient over all rows; the logged losses too.
"""
from __future__ import annotations

import logging
import os
import time

import torch

from ..config import is_null
from ..models import bert as bert_mod
from ..models import discriminator as disc_mod
from ..models import gan as gan_mod
from ..parallel import mesh as pmesh
from ..parallel import sharding as psh
from ..utils import spans
from . import checkpoint as ckpt
from . import optim as topt
from . import step as tstep


def _bert_dis_cfg(cfg, vocab_len: int) -> bert_mod.BertConfig:
    """The critic's ``BertConfig``: the DISCRIMINATOR.BERT sizes, overridden
    by the checkpoint's recorded config when ``model_path`` is a checkpoint
    directory (the reference sizes its BERT from the checkpoint); computes
    in TPU.compute_dtype like the generator."""
    b = cfg.DISCRIMINATOR.BERT
    kw = dict(vocab_size=vocab_len + 1, hidden_size=int(b.hidden_size),
              num_hidden_layers=int(b.num_hidden_layers),
              num_attention_heads=int(b.num_attention_heads),
              intermediate_size=int(b.intermediate_size),
              compute_dtype=cfg.TPU.compute_dtype)
    if (not b.random_weights and not is_null(b.model_path)
            and os.path.isdir(b.model_path)):
        kw.update(ckpt.bert_sizes(b.model_path))
    if kw["vocab_size"] < vocab_len + 1:
        raise ValueError(
            f"BERT checkpoint vocab {kw['vocab_size']} cannot embed the "
            f"{vocab_len}-token music vocab (+1 for [MASK])")
    return bert_mod.BertConfig(**kw)


def _bert_frozen(names, freeze_layers, random_weights: bool) -> list[str]:
    """The critic's frozen leaves: the embeddings and their LayerNorm unless
    the critic starts from random weights, and every leaf of the layers
    whose index is in ``freeze_layers`` (reference calculate_unfreeze_idx)."""
    frozen_layers = {int(i) for i in freeze_layers}

    def frozen(name: str) -> bool:
        if name.startswith("layers."):
            return int(name.split(".")[1]) in frozen_layers
        if "embedding" in name or name.startswith("emb_ln"):
            return not random_weights
        return False

    return [n for n in names if frozen(n)]


class GanPhases:
    """Owns the discriminator (RelGAN CNN or BERT critic), the gen / dis
    optimizer states and the phase steps; wired into ``train/loop.Trainer``.
    The trainer provides ``xcfg``, ``vocab``, ``state`` (its flat generator
    parameters), ``n_devices``, ``device`` and ``dis_iter``; the ranks are
    the process's mesh (``parallel/mesh.current``)."""

    def __init__(self, trainer, cfg):
        self.cfg = cfg
        self.trainer = trainer
        self.xcfg = trainer.xcfg
        self.device = trainer.device
        self.mesh = pmesh.current()
        self.temperature = 1.0
        d = cfg.DISCRIMINATOR
        self.gcfg = gan_mod.GanConfig.from_cfg(cfg, len(trainer.vocab))
        rows = cfg.TRAIN.batch_size // self.mesh.world
        if (cfg.TRAIN.batch_size % self.mesh.world
                or rows % self.gcfg.batch_chunk):
            raise ValueError(
                f"GAN micro-batch rows (batch_size {cfg.TRAIN.batch_size} / "
                f"DISCRIMINATOR.batch_chunk {self.gcfg.batch_chunk}) must "
                f"divide the {self.mesh.world}-rank mesh")
        self.rows = rows
        if d.type == "bert":
            self.dis_cfg = _bert_dis_cfg(cfg, len(trainer.vocab))
            params = self._init_bert(self.dis_cfg, d.BERT.model_path,
                                     d.BERT.random_weights, seed=17)
        else:
            self.dis_cfg = disc_mod.RelganConfig(
                embed_dim=d.CNN.embed_dim, num_rep=d.CNN.num_rep,
                vocab_size=len(trainer.vocab), init=d.CNN.init,
                compute_dtype=cfg.TPU.compute_dtype)
            params = disc_mod.init_relgan_params(self.dis_cfg, seed=17)
        self.dis_layout = topt.FlatLayout.of(params)
        self.dis_flat = self.dis_layout.flatten(params).to(self.device)
        self.dis_frozen = (_bert_frozen(self.dis_layout.names,
                                        d.BERT.freeze_layers,
                                        d.BERT.random_weights)
                           if d.type == "bert" else [])
        frozen = set(self.dis_frozen)
        trainable = (self.dis_layout.mask(lambda n: n not in frozen)
                     if frozen else None)
        (self.gen_opt, self.gen_sched, self.dis_opt,
         self.dis_sched) = topt.make_gan_optimizers(
             cfg, trainer.state.layout, self.dis_layout, trainer.n_devices,
             trainable=trainable)
        self.dis_opt_state = (None if d.freeze_discriminator
                              else self.dis_opt.init(self.dis_flat))
        self.gen_opt_state = self.gen_opt.init(trainer.state.flat.detach())
        self._init_disD(cfg, len(trainer.vocab))
        self.generator = torch.Generator(device=self.device).manual_seed(
            pmesh.rank_seed(int(cfg.TRAIN.seed) + 777))
        self._dis_stream = trainer.dis_iter()
        self.log_gen_loss = self.log_dis_loss = 0.0
        self.log_gen_num = self.log_dis_num = 0
        # (phase, step, span) of the phases whose device time is not logged
        self._unread: list = []
        self.broadcast()

    # ------------------------------------------------------------------
    @staticmethod
    def _init_bert(dis_cfg, model_path, random_weights: bool, seed: int
                   ) -> dict:
        """Fresh critic parameters, with the trunk of the MLM checkpoint
        directory ``model_path`` when there is one (the reference's
        "bert_lm" path); without one, random weights and a warning."""
        params = bert_mod.init_bert_params(dis_cfg, seed=seed)
        if (not random_weights and not is_null(model_path)
                and os.path.isdir(model_path)):
            logging.info("Loading BERT discriminator weights from %s",
                         model_path)
            return ckpt.graft_bert_trunk(model_path, params,
                                         bert_mod.trunk_names(params))
        if not random_weights:
            logging.warning("BERT discriminator checkpoint %s not found; "
                            "starting from random weights", model_path)
        else:
            logging.info("Starting BERT discriminator from random weights")
        return params

    def _init_disD(self, cfg, vocab_len: int) -> None:
        """PPO's classifier dis_D, its optimizer and P0 (none without PPO).
        The BERT dis_D takes only the trunk of the MLM checkpoint, like the
        critic: the JAX package restores every leaf whose path and shape
        match, the checkpoint's untrained pooler and classifier included,
        where the reference grafts the trunk into a fresh classifier."""
        self.disD_cfg = self.disD_layout = self.disD_flat = None
        self.disD_opt = self.disD_opt_state = None
        self.P0 = torch.zeros(self.rows // self.gcfg.batch_chunk,
                              device=self.device)
        self.P0_initialized = False
        if not self.gcfg.ppo:
            return
        d = cfg.DISCRIMINATOR
        if self.gcfg.ppo_dis_type == "bert":
            self.disD_cfg = _bert_dis_cfg(cfg, vocab_len)
            params = self._init_bert(self.disD_cfg, d.BERT.model_path,
                                     d.BERT.random_weights, seed=23)
        else:
            self.disD_cfg = disc_mod.RelganConfig(
                embed_dim=d.CNN.embed_dim, num_rep=cfg.PPO.dis_D_num_rep,
                vocab_size=vocab_len, init=d.CNN.init,
                compute_dtype=cfg.TPU.compute_dtype)
            params = disc_mod.init_relgan_params(self.disD_cfg, seed=23)
        self.disD_layout = topt.FlatLayout.of(params)
        self.disD_flat = self.disD_layout.flatten(params).to(self.device)
        self.disD_opt = topt.make_disD_optimizer(cfg, self.disD_layout)
        self.disD_opt_state = self.disD_opt.init(self.disD_flat)

    def dis_params(self) -> dict:
        return self.dis_layout.unflatten(self.dis_flat)

    def disD_params(self) -> dict:
        return self.disD_layout.unflatten(self.disD_flat)

    def _draws(self) -> gan_mod.Draws:
        """The random numbers of the next micro-batch, at the rank's
        shape."""
        return gan_mod.Draws(self.generator, self.device)

    def broadcast(self) -> None:
        """Rank 0's discriminator, dis_D and optimizer states on every
        rank."""
        psh.broadcast_state(self.dis_flat, self.dis_opt_state,
                            self.gen_opt_state, self.disD_flat,
                            self.disD_opt_state)

    def _next_dis_batch(self) -> torch.Tensor:
        """[batch_chunk, tgt_len, bsz / batch_chunk] real ids."""
        data, _ = next(self._dis_stream)
        chunked = tstep.chunk_batch(data, self.gcfg.batch_chunk)
        return torch.from_numpy(chunked.copy()).to(self.device)

    def _scale(self) -> float:
        return 1.0 / (self.gcfg.batch_chunk * self.gcfg.sample_chunks_mem)

    def dis_phase(self, train_step_num: int = 0) -> torch.Tensor | None:
        """``dis_steps`` discriminator updates over fresh real batches (none
        when the discriminator is frozen). Returns the last update's flat
        gradient (before clipping)."""
        if self.dis_opt_state is None:
            return None
        t0 = time.perf_counter()
        with spans.span("gan.dis", device=self.device.type == "cuda") as sp:
            grad = self._dis_updates(train_step_num)
        _log_phase("dis_phase", train_step_num, time.perf_counter() - t0, sp,
                   self._unread)
        return grad

    def _dis_updates(self, train_step_num: int) -> torch.Tensor:
        gcfg = self.gcfg
        self.dis_opt_state = topt.set_lr_multiplier(
            self.dis_opt_state, float(self.dis_sched(train_step_num)))
        gen_params = {k: v.detach()
                      for k, v in self.trainer.state.params().items()}
        for _ in range(self.cfg.DISCRIMINATOR.dis_steps):
            data_c = self._next_dis_batch()
            flat = self.dis_flat.detach().requires_grad_(True)
            params = self.dis_layout.unflatten(flat)
            for name in self.dis_frozen:      # no gradient to compute
                params[name] = params[name].detach()
            grad = torch.zeros_like(self.dis_flat)
            dsum = torch.zeros((), device=self.device)
            for c in range(gcfg.batch_chunk):
                losses = gan_mod.gan_losses_for_batch(
                    gen_params, params, self.dis_cfg, self.xcfg, gcfg,
                    data_c[c], self.temperature, self._draws(), train_dis=True)
                total = ((losses["dis_loss"] + losses["gp_loss"])
                         * gcfg.dis_loss_factor * self._scale())
                grad += torch.autograd.grad(total, flat)[0]
                dsum = dsum + losses["dis_loss"].detach()
            pmesh.all_reduce_mean_(grad)
            self.dis_opt_state = self.dis_opt.update(self.dis_flat, grad,
                                                     self.dis_opt_state)
            # kept on the device until the log line
            self.log_dis_loss = (self.log_dis_loss + dsum * gcfg.dis_loss_factor
                                 / gcfg.sample_chunks_mem)
            self.log_dis_num += gcfg.batch_chunk
        return grad

    @spans.spanned("gan.classifier")
    def classifier_phase(self, data_c: torch.Tensor) -> torch.Tensor:
        """PPO: one update of dis_D over the micro-batches of ``data_c``
        (BCE, real -> 1, fake -> 0, on fakes of the detached generator).
        Returns its flat gradient (before clipping)."""
        gcfg = self.gcfg
        gen_params = {k: v.detach()
                      for k, v in self.trainer.state.params().items()}
        flat = self.disD_flat.detach().requires_grad_(True)
        params = self.disD_layout.unflatten(flat)
        grad = torch.zeros_like(self.disD_flat)
        for c in range(gcfg.batch_chunk):
            loss = gan_mod.classifier_loss_for_batch(
                gen_params, params, self.disD_cfg, self.xcfg, gcfg, data_c[c],
                self.temperature, self._draws())
            grad += torch.autograd.grad(loss, flat)[0]
        pmesh.all_reduce_mean_(grad)
        self.disD_opt_state = self.disD_opt.update(self.disD_flat, grad,
                                                   self.disD_opt_state)
        return grad

    def gen_phase(self, train_step_num: int) -> torch.Tensor:
        """One adversarial update of the trainer's generator parameters,
        under PPO after one update of dis_D on the same real batch
        (:meth:`classifier_phase`) and with P0 re-snapshotted when
        ``update_D0``. Returns the generator's flat gradient (before
        clipping)."""
        t0 = time.perf_counter()
        with spans.span("gan.gen", device=self.device.type == "cuda") as sp:
            grad = self._gen_update(train_step_num)
        _log_phase("gen_phase", train_step_num, time.perf_counter() - t0, sp,
                   self._unread)
        return grad

    def _gen_update(self, train_step_num: int) -> torch.Tensor:
        gcfg = self.gcfg
        state = self.trainer.state
        self.gen_opt_state = topt.set_lr_multiplier(
            self.gen_opt_state, float(self.gen_sched(train_step_num)))
        data_c = self._next_dis_batch()
        update_D0 = (train_step_num % self.cfg.PPO.dis_D_update_D0_freq == 0
                     or not self.P0_initialized)
        disD_params = None
        if gcfg.ppo:
            self.classifier_phase(data_c)
            disD_params = {k: v.detach() for k, v in self.disD_params().items()}
        dis_params = {k: v.detach() for k, v in self.dis_params().items()}
        grad = torch.zeros_like(state.flat, requires_grad=False)
        gsum = torch.zeros((), device=self.device)
        P0 = self.P0
        for c in range(gcfg.batch_chunk):
            losses = gan_mod.gan_losses_for_batch(
                state.params(), dis_params, self.dis_cfg, self.xcfg, gcfg,
                data_c[c], self.temperature, self._draws(), train_dis=False,
                disD_params=disD_params, disD_cfg=self.disD_cfg, P0=P0,
                update_P0=gcfg.ppo and update_D0)
            P0 = losses["P0"]
            total = losses["gen_loss"] * gcfg.gen_loss_factor * self._scale()
            grad += torch.autograd.grad(total, state.flat)[0]
            gsum = gsum + losses["gen_loss"].detach()
        self.P0, self.P0_initialized = P0, True
        pmesh.all_reduce_mean_(grad)
        self.gen_opt_state = self.gen_opt.update(state.flat, grad,
                                                 self.gen_opt_state)
        self.log_gen_loss = (self.log_gen_loss + gsum * gcfg.gen_loss_factor
                             / gcfg.sample_chunks_mem)
        self.log_gen_num += gcfg.batch_chunk
        return grad

    # ------------------------------------------------------------------
    def pop_log_stats(self) -> tuple[float, float]:
        """The mean logged gen and dis losses since the last call, over the
        ranks."""
        g = (float(self.log_gen_loss) / self.log_gen_num
             if self.log_gen_num else 0.0)
        d = (float(self.log_dis_loss) / self.log_dis_num
             if self.log_dis_num else 0.0)
        if self.mesh.distributed:
            g, d = (float(x) / self.mesh.world
                    for x in pmesh.host_allreduce_sum([g, d]))
        self.log_gen_loss = self.log_dis_loss = 0.0
        self.log_gen_num = self.log_dis_num = 0
        return g, d

    def ckpt_payload(self) -> dict:
        """Discriminator parameters and both optimizer states (CPU); under
        PPO also dis_D's parameters and optimizer state (not P0)."""
        payload = {"dis_params": {k: v.detach().cpu()
                                  for k, v in self.dis_params().items()},
                   "gen_opt_state": self.gen_opt_state}
        if self.dis_opt_state is not None:
            payload["dis_opt_state"] = self.dis_opt_state
        if self.disD_flat is not None:
            payload["disD_params"] = {k: v.detach().cpu()
                                      for k, v in self.disD_params().items()}
            payload["disD_opt_state"] = self.disD_opt_state
        return payload

    def restore(self, payload: dict) -> None:
        with torch.no_grad():
            if "dis_params" in payload:
                self.dis_flat.copy_(self.dis_layout.flatten(
                    payload["dis_params"]).to(self.device))
            if "disD_params" in payload and self.disD_flat is not None:
                self.disD_flat.copy_(self.disD_layout.flatten(
                    payload["disD_params"]).to(self.device))
                self.disD_opt_state = _to(payload["disD_opt_state"],
                                          self.device)
        if "gen_opt_state" in payload:
            self.gen_opt_state = _to(payload["gen_opt_state"], self.device)
        if "dis_opt_state" in payload:
            self.dis_opt_state = _to(payload["dis_opt_state"], self.device)


def _log_phase(phase: str, step: int, dispatched: float, sp,
               unread: list) -> None:
    """The phase's line: the host's seconds to enqueue it. While spans record
    on the card the phase's span joins ``unread``, and each span there whose
    end event the device has passed gets a line of its device seconds; none
    is waited for."""
    logging.info("%s step %d: dispatched in %.2fs", phase, step, dispatched)
    if sp is not None and sp.events is not None:
        unread.append((phase, step, sp))
    while unread and unread[0][2].events[1].query():
        name, n, done = unread.pop(0)
        logging.info("%s step %d: device %.2fs", name, n,
                     spans.device_seconds([done]))


def _to(state: topt.FusedOptState, device) -> topt.FusedOptState:
    return topt.FusedOptState(count=state.count, mu=state.mu.to(device),
                              nu=state.nu.to(device), lr_scale=state.lr_scale)
