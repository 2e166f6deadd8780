"""MLE training loop on one device (counterpart of
``transformer_gan_tpu/train/loop.py`` without the GAN phases and the
generation metrics).

Owns the run directory, seeding, the iterators, the step functions,
logging (the JAX package's ``Train Step ...`` and ``Eval step ...`` lines),
evaluation with a compensated NLL sum, last / best / step checkpoints,
``--restart`` and the final best-checkpoint test evaluation. The device is
CUDA when present, else the CPU (the plain path).
"""
from __future__ import annotations

import logging
import math
import os
import time

import numpy as np
import torch

from ..config import is_null
from ..data.dataset import MusicDataset
from ..models import xl
from ..utils.logging import logging_config
from . import checkpoint as ckpt
from . import optim as topt
from . import step as tstep


def _refuse_unported(cfg) -> None:
    if not is_null(cfg.DISCRIMINATOR.type):
        raise NotImplementedError(
            "GAN training (DISCRIMINATOR.type) is not ported yet")
    if (cfg.METRICS.use_bleu or cfg.METRICS.use_self_bleu
            or cfg.METRICS.CLASSIFIER.use_classifier):
        raise NotImplementedError(
            "generation metrics (METRICS.use_*) are not ported yet")
    if cfg.TPU.remat:
        raise NotImplementedError("TPU.remat is not ported yet")
    if cfg.TPU.profile_dir:
        raise NotImplementedError("TPU.profile_dir is not ported yet")
    if str(cfg.TPU.param_dtype) != "float32":
        raise NotImplementedError("only float32 master parameters")


class Trainer:
    def __init__(self, cfg, data_dir: str, work_dir: str,
                 restart: bool = False, debug: bool = False,
                 save_all: bool = False, device=None):
        _refuse_unported(cfg)
        self.cfg = cfg
        self.debug = debug
        self.save_all = save_all
        self.device = torch.device(device or ("cuda" if torch.cuda.is_available()
                                              else "cpu"))

        if not restart:
            stamp = time.strftime("%Y%m%d-%H%M%S", time.localtime())
            work_dir = os.path.join(work_dir, stamp)
        os.makedirs(work_dir, exist_ok=True)
        self.work_dir = work_dir
        if not restart:
            # the generation CLI reads the run's config.yml
            with open(os.path.join(work_dir, "config.yml"), "w") as f:
                f.write(cfg.dump())
        logging_config(work_dir, "train_rank0")

        seed = cfg.TRAIN.seed
        np.random.seed(seed)
        torch.manual_seed(seed)
        self.dataset = MusicDataset(data_dir, cfg)
        self.vocab = self.dataset.vocab
        self.batch_size = cfg.TRAIN.batch_size
        if self.batch_size % cfg.TRAIN.batch_chunk:
            raise ValueError("TRAIN.batch_size must divide into "
                             "TRAIN.batch_chunk micro-chunks")
        self.bsz_chunk = self.batch_size // cfg.TRAIN.batch_chunk
        self.train_iter = self.dataset.get_iterator(
            self.batch_size, cfg.TRAIN.tgt_length, split="train",
            do_shuffle=True, seed=seed)
        self.val_iter = self.dataset.eval_iterator(
            cfg.EVALUATE.batch_size, cfg.EVALUATE.tgt_length, split="valid",
            local_rank=0, world_size=1)
        self.test_iter = self.dataset.eval_iterator(
            cfg.EVALUATE.batch_size, cfg.EVALUATE.tgt_length, split="test",
            local_rank=0, world_size=1)
        if cfg.DISCRIMINATOR.start_iter < cfg.TRAIN.max_step:
            raise ValueError("DISCRIMINATOR.start_iter < max_step but no "
                             "discriminator configured")

        self.xcfg = xl.XLConfig.from_cfg(cfg, len(self.vocab))
        params = xl.init_xl_params(
            self.xcfg, seed=seed, base_init=tuple(cfg.INITIALIZER.base_init),
            embed_init=tuple(cfg.INITIALIZER.embed_init))
        if not is_null(cfg.TRAIN.load_from_previous) and not restart:
            logging.info("Warm starting generator from %s",
                         cfg.TRAIN.load_from_previous)
            params = ckpt.load_generator_params(cfg.TRAIN.load_from_previous,
                                                params)

        # the reference's per-rank lr = global lr / number of devices
        self.n_devices = 1
        self.local_lr = cfg.TRAIN.lr / self.n_devices
        self.schedule = topt.make_schedule(
            cfg.TRAIN.scheduler, cfg.TRAIN.lr, cfg.TRAIN.max_step,
            cfg.TRAIN.lr_min, cfg.TRAIN.warmup_step)
        self.optimizer = topt.FusedOptimizer(
            cfg.TRAIN.optim, self.local_lr, self.schedule, cfg.TRAIN.clip,
            cfg.TRAIN.weight_decay, layout=topt.FlatLayout.of(params))
        self.plateau = (topt.PlateauTracker(
            cfg.TRAIN.decay_rate, cfg.TRAIN.patience, cfg.TRAIN.lr_min,
            cfg.TRAIN.lr) if cfg.TRAIN.scheduler == "dev_perf" else None)
        self.state = tstep.init_train_state(
            params, self.optimizer, self.xcfg, cfg.TRAIN.batch_chunk,
            cfg.TRAIN.mem_length, self.bsz_chunk, seed, self.device)
        self.train_step_fn = tstep.make_mle_train_step(
            self.xcfg, self.optimizer, cfg.TRAIN.batch_chunk,
            self.vocab.pad_id, use_mle=cfg.TRAIN.use_mle,
            same_length=cfg.MODEL.same_length)
        self.eval_step_fn = tstep.make_eval_step(self.xcfg, self.vocab.pad_id)

        self.train_step_num = 0
        self.best_val_nll = math.inf
        if restart:
            self._restore_last()

        logging.info("=" * 100)
        logging.info("#total generator params = %d", self.state.layout.size)
        logging.info("work_dir = %s, device = %s", self.work_dir,
                     self.device)

    # ------------------------------------------------------------------
    def _save(self, name: str, val_nll: float) -> None:
        meta = {"train_step": int(self.train_step_num),
                "best_val_loss": float(val_nll),
                "vocab": self.vocab.all_tokens}
        path = ckpt.save_checkpoint(self.work_dir, name, self.state.params(),
                                    self.state.opt_state, meta)
        logging.info("Saved checkpoint to %s", path)

    def _restore_last(self) -> None:
        logging.info("Restarting from %s",
                     os.path.join(self.work_dir, "checkpoint_last"))
        params, opt_state, meta = ckpt.load_checkpoint(
            self.work_dir, "checkpoint_last", self.device)
        with torch.no_grad():
            self.state.flat.copy_(self.state.layout.flatten(params))
        self.state.opt_state = opt_state
        self.train_step_num = int(meta.get("train_step", 0))
        self.best_val_nll = float(meta.get("best_val_loss", math.inf))
        self.state.step = self.train_step_num

    # ------------------------------------------------------------------
    def evaluate(self, eval_iter) -> tuple[int, float]:
        """Masked-NLL evaluation; the NLL total is a compensated (Kahan)
        fp32 sum on the device, fetched once at the end."""
        cfg = self.cfg
        dev = self.device
        total_tokens = torch.zeros((), dtype=torch.int64, device=dev)
        total_nll = torch.zeros((), dtype=torch.float32, device=dev)
        comp = torch.zeros((), dtype=torch.float32, device=dev)
        mems = xl.init_mems(self.xcfg, cfg.EVALUATE.mem_length,
                            cfg.EVALUATE.batch_size, device=dev)
        params = {k: v.detach() for k, v in self.state.params().items()}
        for data, target, reset_all, _, _ in eval_iter():
            if reset_all:
                mems = tstep.reset_eval_mems(mems)
            nll_sum, cnt, mems = self.eval_step_fn(
                params, torch.from_numpy(data).to(dev),
                torch.from_numpy(target).to(dev), mems)
            y = nll_sum - comp
            t = total_nll + y
            comp = (t - total_nll) - y
            total_nll = t
            total_tokens = total_tokens + cnt
        return int(total_tokens), float(total_nll)

    # ------------------------------------------------------------------
    def train(self) -> None:
        cfg = self.cfg
        log_interval = cfg.TRAIN.log_interval
        eval_interval = cfg.TRAIN.eval_interval
        bc = cfg.TRAIN.batch_chunk
        dev = self.device
        log_acc = None
        log_start = time.time()
        logging.info("Start training")
        for data, target, reset_mems, _, _ in self.train_iter():
            batch = (torch.from_numpy(tstep.chunk_batch(data, bc)).to(dev),
                     torch.from_numpy(tstep.chunk_batch(target, bc)).to(dev),
                     torch.from_numpy(tstep.chunk_rows(reset_mems, bc)).to(dev))
            self.state, metrics = self.train_step_fn(self.state, *batch)
            self.train_step_num += 1
            log_acc = (metrics if log_acc is None
                       else {k: log_acc[k] + metrics[k] for k in log_acc})

            if self.train_step_num % log_interval == 0:
                loss_w = float(log_acc["loss_weighted"])  # waits for the device
                tokens = int(log_acc["tokens"])
                gnorm = float(log_acc["grad_norm"])
                log_acc = None
                nll = loss_w / max(tokens, 1)
                elapsed = time.time() - log_start
                logging.info(
                    "Train Step %d/%d, lr=%f, tokens/s=%.1f, nll=%.4f,"
                    " ppl=%.2f, grad norm=%.4f, gen_loss=%5.4f,"
                    " dis_loss=%5.4f",
                    self.train_step_num, cfg.TRAIN.max_step,
                    self.local_lr * self.schedule(self.train_step_num),
                    tokens / elapsed, nll, math.exp(min(nll, 50.0)),
                    gnorm / (log_interval * self.n_devices), 0.0, 0.0)
                log_start = time.time()

            if self.train_step_num % eval_interval == 0:
                self._eval_and_checkpoint()

            if self.train_step_num >= cfg.TRAIN.max_step:
                logging.info("-" * 100)
                logging.info("End of training")
                break

    # ------------------------------------------------------------------
    def final_best_eval(self) -> float:
        """Reload checkpoint_best and evaluate it on the test split (the
        end-of-training line); the current weights when there is none."""
        if ckpt.checkpoint_exists(self.work_dir, "checkpoint_best"):
            params, _, _ = ckpt.load_checkpoint(self.work_dir,
                                                "checkpoint_best", self.device)
            with torch.no_grad():
                self.state.flat.copy_(self.state.layout.flatten(params))
        else:
            logging.warning(
                "checkpoint_best not found under %s; final test eval uses "
                "the current (last-step) weights", self.work_dir)
        tok, nll = self.evaluate(self.test_iter)
        test_nll = nll / max(tok, 1)
        logging.info("=" * 100)
        logging.info("| End of training | test nll %5.2f | test ppl %9.3f",
                     test_nll, math.exp(min(test_nll, 50.0)))
        logging.info("=" * 100)
        return test_nll

    # ------------------------------------------------------------------
    def _eval_and_checkpoint(self) -> None:
        eval_start = time.time()
        tok, nll = self.evaluate(self.val_iter)
        val_nll = nll / max(tok, 1)
        logging.info(
            "Eval step %d, time=%.1fs, val nll=%.5f, val ppl=%.3f,"
            " #evaluated tokens=%d, bleu=%s, self_bleu=%s, class_acc=%s",
            self.train_step_num, time.time() - eval_start, val_nll,
            math.exp(min(val_nll, 50.0)), tok, None, None, None)
        if not self.debug:
            self._save(f"checkpoint_{self.train_step_num}" if self.save_all
                       else "checkpoint_last", val_nll)
        if val_nll < self.best_val_nll:
            self.best_val_nll = val_nll
            if not self.debug:
                self._save("checkpoint_best", self.best_val_nll)
            test_start = time.time()
            ttok, tnll = self.evaluate(self.test_iter)
            test_nll = tnll / max(ttok, 1)
            logging.info(
                "Test step %d, time=%.1fs, test nll=%.5f, test ppl=%.3f,"
                " #evaluated tokens=%d, test_bleu=%s", self.train_step_num,
                time.time() - test_start, test_nll,
                math.exp(min(test_nll, 50.0)), ttok, None)
        if self.plateau is not None:
            self.state.opt_state = topt.set_lr_multiplier(
                self.state.opt_state, self.plateau.step(val_nll))
