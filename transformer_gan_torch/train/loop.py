"""Training loop (counterpart of ``transformer_gan_tpu/train/loop.py``).

Owns the run directory, seeding, the iterators, the step functions,
logging (the JAX package's ``Train Step ...`` and ``Eval step ...`` lines),
evaluation with a compensated NLL sum, last / best / step checkpoints,
``--restart`` and the final best-checkpoint test evaluation. With a
discriminator configured (``DISCRIMINATOR.type: cnn`` or ``bert``) the GAN
phases run after the MLE step from ``start_iter`` on
(``train/gan_loop.GanPhases``), with the temperature annealed per step,
their losses on the log line and their state in the checkpoints.

The quality metrics (``METRICS.use_bleu``, ``use_self_bleu``,
``CLASSIFIER.use_classifier``) sample ``gen_seq_len``-token pieces from the
generator with gumbel-argmax on K3 (``infer/sample.generate_tokens_gumbel``)
in waves of :data:`WAVE_WIDTHS`, each call from its own random stream, and
score them: BLEU against the eval split, self-BLEU against a second set,
the BERT classifier's held-out accuracy against the validation pieces.

The device is the card: ``device=None`` means CUDA and raises without one;
the CPU (the plain path) only when the caller passes ``"cpu"``.

The model's switches follow the config: ``TPU.cache_kv`` off runs the
raw-hidden memory (plain attention, as in the JAX package),
``TRAIN.append_note_status`` feeds the iterators' held-note vectors into the
embedding, ``TPU.remat`` recomputes each decoder layer in the backward, and
``TPU.profile_dir`` records a ``torch.profiler`` trace (CPU and CUDA
activities) of steps 10 to 15 into ``trace_rank{r}.json`` there.

Data parallel under torchrun (``parallel/mesh``): each rank reads its own
train and dis streams (``batch_size / world`` rows, seed ``seed + 1000
rank``) and its share of the eval pieces; the generator's weights and every
optimizer state stay replicated (broadcast from rank 0 after init and
after a restore); the MLE step all-reduces its token counts and gradient;
the MLE lr and the gen GAN lr are divided by the world size, as the JAX
package divides them by its device count. The log's sums and the eval's
NLL and token totals are host all-reduced; rank 0 writes the console line,
``config.yml`` and the checkpoints (between barriers), every rank its own
``train_rank{r}.log``. Every rank generates the metrics' pieces from the
same stream, so every rank scores the same pieces (as every JAX process
does).
"""
from __future__ import annotations

import json
import logging
import math
import os
import time

import numpy as np
import torch

from .. import _native
from ..config import check_gan_config, is_null
from ..data.dataset import MusicDataset
from ..infer.sample import generate_tokens_gumbel, gumbel_draws
from ..models import xl
from ..parallel import mesh as pmesh
from ..parallel import sharding as psh
from ..utils import spans
from ..utils.logging import logging_config
from . import checkpoint as ckpt
from . import optim as topt
from . import step as tstep
from .losses import get_fixed_temperature


# Steps whose work TPU.profile_dir traces: from the end of step 10 to the
# end of step 15, as in the JAX package.
PROFILE_START, PROFILE_STOP = 10, 15

# The metrics' wave widths, fastest first: K3's generated tokens/s rises
# with the lanes up to its 32 (chip_smoke numbers.metrics, PERF.md). A wave
# takes the first width that divides the sample count and is at most
# METRICS.gen_batch_size.
WAVE_WIDTHS = (32, 16, 8, 4, 2, 1)


def wave_width(num_samples: int, batch_size: int) -> int:
    return next(w for w in WAVE_WIDTHS
                if w <= batch_size and num_samples % w == 0)


def _refuse_unported(cfg) -> None:
    check_gan_config(cfg)
    if str(cfg.TPU.param_dtype) != "float32":
        # as the JAX package: the flat optimizer state assumes fp32 masters
        raise NotImplementedError("only float32 master parameters")


class Trainer:
    def __init__(self, cfg, data_dir: str, work_dir: str,
                 restart: bool = False, debug: bool = False,
                 save_all: bool = False, device=None):
        _refuse_unported(cfg)
        self.cfg = cfg
        self.debug = debug
        self.save_all = save_all
        pmesh.initialize_distributed(device)
        self.mesh = pmesh.make_mesh_from_cfg(cfg)
        self.device = self.mesh.device
        self.rank, self.world = self.mesh.rank, self.mesh.world

        if not restart:
            # one stamp for every rank: rank 0's
            stamp = pmesh.broadcast_object(
                time.strftime("%Y%m%d-%H%M%S", time.localtime()))
            work_dir = os.path.join(work_dir, stamp)
        os.makedirs(work_dir, exist_ok=True)
        self.work_dir = work_dir
        if not restart and self.rank == 0:
            # the generation CLI reads the run's config.yml
            with open(os.path.join(work_dir, "config.yml"), "w") as f:
                f.write(cfg.dump())
        logging_config(work_dir, f"train_rank{self.rank}",
                       console=self.rank == 0)

        seed = cfg.TRAIN.seed
        np.random.seed(seed)
        torch.manual_seed(seed)
        self.dataset = MusicDataset(data_dir, cfg)
        self.vocab = self.dataset.vocab
        local_seed = seed + self.rank * 1000
        if cfg.TRAIN.batch_size % (self.world * cfg.TRAIN.batch_chunk):
            raise ValueError(
                f"TRAIN.batch_size {cfg.TRAIN.batch_size} must divide into "
                f"TRAIN.batch_chunk {cfg.TRAIN.batch_chunk} micro-chunks of "
                f"equal rows on each of the {self.world} rank(s)")
        self.batch_size = cfg.TRAIN.batch_size // self.world
        self.bsz_chunk = self.batch_size // cfg.TRAIN.batch_chunk
        self.train_iter = self.dataset.get_iterator(
            self.batch_size, cfg.TRAIN.tgt_length, split="train",
            do_shuffle=True, seed=local_seed)
        self.val_iter = self.dataset.eval_iterator(
            cfg.EVALUATE.batch_size, cfg.EVALUATE.tgt_length, split="valid",
            local_rank=self.rank, world_size=self.world)
        self.test_iter = self.dataset.eval_iterator(
            cfg.EVALUATE.batch_size, cfg.EVALUATE.tgt_length, split="test",
            local_rank=self.rank, world_size=self.world)
        self.has_gan = not is_null(cfg.DISCRIMINATOR.type)
        if self.has_gan:
            self.dis_iter = self.dataset.get_dis_iterator(
                self.batch_size, cfg.DISCRIMINATOR.tgt_len, split="train",
                do_shuffle=True, seed=local_seed)
        elif cfg.DISCRIMINATOR.start_iter < cfg.TRAIN.max_step:
            raise ValueError("DISCRIMINATOR.start_iter < max_step but no "
                             "discriminator configured")

        self.xcfg = xl.XLConfig.from_cfg(cfg, len(self.vocab),
                                         self.vocab.vec_len)
        params = xl.init_xl_params(
            self.xcfg, seed=seed, base_init=tuple(cfg.INITIALIZER.base_init),
            embed_init=tuple(cfg.INITIALIZER.embed_init))
        if not is_null(cfg.TRAIN.load_from_previous) and not restart:
            logging.info("Warm starting generator from %s",
                         cfg.TRAIN.load_from_previous)
            params = ckpt.load_generator_params(cfg.TRAIN.load_from_previous,
                                                params)

        # the reference's per-rank lr = global lr / number of devices
        self.n_devices = self.world
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
        psh.broadcast_state(self.state.flat, self.state.opt_state)
        self.train_step_fn = tstep.make_mle_train_step(
            self.xcfg, self.optimizer, cfg.TRAIN.batch_chunk,
            self.vocab.pad_id, use_mle=cfg.TRAIN.use_mle,
            same_length=cfg.MODEL.same_length, remat=bool(cfg.TPU.remat))
        self.eval_step_fn = tstep.make_eval_step(self.xcfg, self.vocab.pad_id)

        from ..metrics.bleu import BLEU
        from ..metrics.classifier import Classifier
        m = cfg.METRICS
        self.bleu = BLEU("BLEU", gram=[2, 3, 4, 5], if_use=m.use_bleu)
        self.self_bleu = BLEU("Self-BLEU", gram=[2, 3, 4],
                              if_use=m.use_self_bleu)
        self.classifier = Classifier(
            "Classifier", if_use=m.CLASSIFIER.use_classifier,
            seq_len=m.CLASSIFIER.block_size,
            batch_size=m.CLASSIFIER.bert_batch_size,
            model_name_or_path=m.CLASSIFIER.model_path, device=self.device)
        # calls of _generate_tokens so far: each draws its own stream
        self._gen_wave = 0
        self.metrics_timing = {}
        self.gan = None
        if self.has_gan:
            from .gan_loop import GanPhases
            self.gan = GanPhases(self, cfg)

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
        """Rank 0 writes the checkpoint; every rank waits for it."""
        meta = {"train_step": int(self.train_step_num),
                "best_val_loss": float(val_nll),
                "vocab": self.vocab.all_tokens}
        pmesh.sync_global_devices("before_save")
        if self.rank == 0:
            path = ckpt.save_checkpoint(
                self.work_dir, name, self.state.params(),
                self.state.opt_state, meta,
                gan=self.gan.ckpt_payload() if self.gan is not None else None)
            logging.info("Saved checkpoint to %s", path)
        pmesh.sync_global_devices("after_save")

    def _restore_last(self) -> None:
        logging.info("Restarting from %s",
                     os.path.join(self.work_dir, "checkpoint_last"))
        params, opt_state, meta = ckpt.load_checkpoint(
            self.work_dir, "checkpoint_last", self.device)
        with torch.no_grad():
            self.state.flat.copy_(self.state.layout.flatten(params))
        self.state.opt_state = opt_state
        if self.gan is not None:
            payload = ckpt.load_gan_payload(self.work_dir, "checkpoint_last",
                                            self.device)
            if payload is not None:
                self.gan.restore(payload)
        self.train_step_num = int(meta.get("train_step", 0))
        self.best_val_nll = float(meta.get("best_val_loss", math.inf))
        self.state.step = self.train_step_num
        psh.broadcast_state(self.state.flat, self.state.opt_state)
        if self.gan is not None:
            self.gan.broadcast()

    # ------------------------------------------------------------------
    def evaluate(self, eval_iter, mode: str = "eval"
                 ) -> tuple[int, float, list]:
        """Masked-NLL evaluation; the NLL total is a compensated (Kahan)
        fp32 sum on the device, fetched once at the end. Then the quality
        metrics (:meth:`_generation_metrics`)."""
        cfg = self.cfg
        dev = self.device
        total_tokens = torch.zeros((), dtype=torch.int64, device=dev)
        total_nll = torch.zeros((), dtype=torch.float32, device=dev)
        comp = torch.zeros((), dtype=torch.float32, device=dev)
        mems = xl.init_mems(self.xcfg, cfg.EVALUATE.mem_length,
                            cfg.EVALUATE.batch_size, device=dev)
        params = {k: v.detach() for k, v in self.state.params().items()}
        for data, target, reset_all, _, status_vec in eval_iter():
            if reset_all:
                mems = tstep.reset_eval_mems(mems)
            nll_sum, cnt, mems = self.eval_step_fn(
                params, torch.from_numpy(data).to(dev),
                torch.from_numpy(target).to(dev), mems,
                None if status_vec is None
                else torch.from_numpy(status_vec).to(dev))
            y = nll_sum - comp
            t = total_nll + y
            comp = (t - total_nll) - y
            total_nll = t
            total_tokens = total_tokens + cnt
        # the ranks' sums (reference train.py all_reduce of the eval scalars)
        tok, nll = pmesh.host_allreduce_sum([float(total_tokens),
                                             float(total_nll)])
        return int(tok), float(nll), self._generation_metrics(mode)

    @torch.no_grad()
    @spans.spanned("gen.call")
    def _generate_tokens(self, num_samples: int, batch_size: int,
                         seq_len: int) -> np.ndarray:
        """[num_samples, seq_len] gumbel-argmax pieces from <S> (token 0) on
        a fresh ``seq_len``-slot memory, in waves of :func:`wave_width`
        lanes. Each call draws from its own stream, seeded by the training
        step and the call's index, so two sets of one eval differ (else
        self-BLEU is 1.0). The waves' tokens stay on the device and are
        fetched once."""
        dev = self.device
        wave = wave_width(num_samples, batch_size)
        seed = np.random.SeedSequence(
            (1234 + self.train_step_num, self._gen_wave)).generate_state(1)[0]
        self._gen_wave += 1
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        params = {k: v.detach() for k, v in self.state.params().items()}
        out = []
        for _ in range(num_samples // wave):
            with spans.span("gen.setup", device=dev.type == "cuda"):
                mems = xl.init_mems(self.xcfg, seq_len, wave, device=dev)
                first = torch.zeros((wave,), dtype=torch.int64, device=dev)
                g = gumbel_draws(seq_len - 1, wave, self.xcfg.n_token, gen,
                                 dev)
            out.append(generate_tokens_gumbel(params, self.xcfg, seq_len,
                                              first, mems, g).T)
        with spans.span("gen.readback"):
            tokens = torch.cat(out).cpu()
        return tokens.numpy()

    def _generation_metrics(self, mode: str) -> list:
        """BLEU (mode "eval": against the validation pieces, else the test
        pieces), self-BLEU and the classifier's accuracy (mode "eval"
        only) on generated pieces: a first set of ``bleu_num_samples``
        serves as BLEU's hypotheses and self-BLEU's references, a second
        of ``self_bleu_num_samples`` as self-BLEU's hypotheses, a third of
        ``CLASSIFIER.gen_num_samples`` as the classifier's generated side.
        ``metrics_timing[mode]`` keeps the seconds of each part."""
        m = self.cfg.METRICS
        timing, pc = {}, time.perf_counter
        gen_tokens = None
        if m.use_bleu or (m.use_self_bleu and mode == "eval"):
            t0 = pc()
            gen_tokens = self._generate_tokens(
                m.bleu_num_samples, m.gen_batch_size, m.gen_seq_len).tolist()
            timing["generate_bleu_s"] = pc() - t0
        if m.use_bleu:
            corpus = (self.dataset.valid_data if mode == "eval"
                      else self.dataset.test_data)
            self.bleu.reset(test_text=gen_tokens,
                            real_text=[x.tolist() for x in corpus])
        if m.use_self_bleu and mode == "eval":
            t0 = pc()
            gen_tokens_s = self._generate_tokens(
                m.self_bleu_num_samples, m.gen_batch_size,
                m.gen_seq_len).tolist()
            timing["generate_self_bleu_s"] = pc() - t0
            self.self_bleu.reset(test_text=gen_tokens_s, real_text=gen_tokens)
        if m.CLASSIFIER.use_classifier and mode == "eval":
            c = m.CLASSIFIER
            t0 = pc()
            gen = self._generate_tokens(c.gen_num_samples, c.gen_batch_size,
                                        c.gen_seq_len)
            timing["generate_classifier_s"] = pc() - t0
            self.classifier.reset(test_text=list(gen),
                                  real_text=self.dataset.valid_data)
        t0 = pc()
        scores = [self.bleu.get_score()]
        timing["bleu_s"] = pc() - t0
        if mode == "eval":
            t0 = pc()
            scores.append(self.self_bleu.get_score())
            timing["self_bleu_s"] = pc() - t0
            scores.append(self.classifier.get_score())
            timing["classifier"] = dict(getattr(self.classifier,
                                                "last_timing", {}))
        self.metrics_timing[mode] = timing
        return scores

    # ------------------------------------------------------------------
    def train(self) -> None:
        cfg = self.cfg
        log_interval = cfg.TRAIN.log_interval
        eval_interval = cfg.TRAIN.eval_interval
        bc = cfg.TRAIN.batch_chunk
        dev = self.device
        log_acc = None
        log_start = time.time()
        profiler = None
        logging.info("Start training")
        batches = self.train_iter()
        while True:
            with spans.span("train.data"):
                item = next(batches, None)
            if item is None:
                break
            data, target, reset_mems, _, status_vec = item
            if self.gan is not None:
                # temperature annealing: the generator's is 1 / beta
                self.gan.temperature = 1.0 / get_fixed_temperature(
                    cfg.DISCRIMINATOR.beta_max, self.train_step_num,
                    cfg.TRAIN.max_step, cfg.DISCRIMINATOR.adapt)
            with spans.span("train.h2d"):
                batch = (
                    torch.from_numpy(tstep.chunk_batch(data, bc)).to(dev),
                    torch.from_numpy(tstep.chunk_batch(target, bc)).to(dev),
                    torch.from_numpy(tstep.chunk_rows(reset_mems, bc)).to(dev))
                if status_vec is not None:
                    batch += (torch.from_numpy(
                        tstep.chunk_status(status_vec, bc)).to(dev),)
            with spans.span("train.step"):
                self.state, metrics = self.train_step_fn(self.state, *batch)
            d = cfg.DISCRIMINATOR
            if self.gan is not None and self.train_step_num > d.start_iter:
                with spans.span("train.gan"):
                    if self.train_step_num % d.dis_loss_freq == 0:
                        self.gan.dis_phase(self.train_step_num)
                    if self.train_step_num % d.gen_loss_freq == 0:
                        self.gan.gen_phase(self.train_step_num)
            self.train_step_num += 1
            if cfg.TPU.profile_dir and self.train_step_num == PROFILE_START:
                profiler = self._start_profile()
            if profiler is not None and self.train_step_num == PROFILE_STOP:
                profiler = self._stop_profile(profiler)
            log_acc = (metrics if log_acc is None
                       else {k: log_acc[k] + metrics[k] for k in log_acc})

            if self.train_step_num % log_interval == 0:
                # waits for the device; sums over the ranks
                with spans.span("train.log"):
                    loss_w, tokens, gnorm = pmesh.host_allreduce_sum(
                        [float(log_acc["loss_weighted"]),
                         float(log_acc["tokens"]),
                         float(log_acc["grad_norm"])])
                log_acc = None
                nll = loss_w / max(tokens, 1.0)
                gan_stats = (self.gan.pop_log_stats() if self.gan is not None
                             else (0.0, 0.0))
                elapsed = time.time() - log_start
                logging.info(
                    "Train Step %d/%d, lr=%f, tokens/s=%.1f, nll=%.4f,"
                    " ppl=%.2f, grad norm=%.4f, gen_loss=%5.4f,"
                    " dis_loss=%5.4f",
                    self.train_step_num, cfg.TRAIN.max_step,
                    self.local_lr * self.schedule(self.train_step_num),
                    tokens / elapsed, nll, math.exp(min(nll, 50.0)),
                    gnorm / (log_interval * self.n_devices), gan_stats[0],
                    gan_stats[1])
                log_start = time.time()

            if self.train_step_num % eval_interval == 0:
                with spans.span("train.eval"):
                    self._eval_and_checkpoint()

            if self.train_step_num >= cfg.TRAIN.max_step:
                logging.info("-" * 100)
                logging.info("End of training")
                break
        if profiler is not None:
            self._stop_profile(profiler)
        # which kernels this process went through (_native.LAUNCHES)
        logging.info("Kernel launches: %s", json.dumps(
            {k: v for k, v in _native.LAUNCHES.items() if v}))

    def _start_profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
        profiler.start()
        logging.info("profiler trace started -> %s", self.cfg.TPU.profile_dir)
        return profiler

    def _stop_profile(self, profiler) -> None:
        """Stop the trace and write it (the device's work waited for)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        os.makedirs(self.cfg.TPU.profile_dir, exist_ok=True)
        path = os.path.join(self.cfg.TPU.profile_dir,
                            f"trace_rank{self.rank}.json")
        profiler.export_chrome_trace(path)
        logging.info("profiler trace saved -> %s", path)

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
        tok, nll, _ = self.evaluate(self.test_iter, mode="test")
        test_nll = nll / max(tok, 1)
        logging.info("=" * 100)
        logging.info("| End of training | test nll %5.2f | test ppl %9.3f",
                     test_nll, math.exp(min(test_nll, 50.0)))
        logging.info("=" * 100)
        return test_nll

    # ------------------------------------------------------------------
    def _eval_and_checkpoint(self) -> None:
        eval_start = time.time()
        tok, nll, val_metrics = self.evaluate(self.val_iter, mode="eval")
        val_nll = nll / max(tok, 1)
        logging.info(
            "Eval step %d, time=%.1fs, val nll=%.5f, val ppl=%.3f,"
            " #evaluated tokens=%d, bleu=%s, self_bleu=%s, class_acc=%s",
            self.train_step_num, time.time() - eval_start, val_nll,
            math.exp(min(val_nll, 50.0)), tok, *val_metrics)
        if not self.debug:
            self._save(f"checkpoint_{self.train_step_num}" if self.save_all
                       else "checkpoint_last", val_nll)
        if val_nll < self.best_val_nll:
            self.best_val_nll = val_nll
            if not self.debug:
                self._save("checkpoint_best", self.best_val_nll)
            test_start = time.time()
            ttok, tnll, test_metrics = self.evaluate(self.test_iter,
                                                     mode="test")
            test_nll = tnll / max(ttok, 1)
            logging.info(
                "Test step %d, time=%.1fs, test nll=%.5f, test ppl=%.3f,"
                " #evaluated tokens=%d, test_bleu=%s", self.train_step_num,
                time.time() - test_start, test_nll,
                math.exp(min(test_nll, 50.0)), ttok, test_metrics[0])
        if self.plateau is not None:
            self.state.opt_state = topt.set_lr_multiplier(
                self.state.opt_state, self.plateau.step(val_nll))
