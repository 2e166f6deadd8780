"""BERT masked-language-model pretraining over token shards.

Counterpart of ``transformer_gan_tpu/bert/mlm.py`` (reference BERT/main.py):
the npy token corpus blocked into fixed windows, 80/10/10 masking at 15%,
clip + Adam + weight decay with no decay on bias / LayerNorm + a cosine
warmup schedule, periodic eval perplexity and rotated ``checkpoint-{step}``
saves. Its checkpoints are what the GAN loads as its BERT critic
(``train/checkpoint.graft_bert_trunk``).

Data parallel under torchrun (JAX ``mlm.py`` on a mesh): ``batch_size`` is
the global batch; every rank walks the same block order and takes its rows
of each batch; it draws a step's masks and dropout from its own stream
(``parallel/mesh.rank_seed``), while the evaluation's masks are drawn at the
global shape, each rank taking its rows (``parallel/sharding.MlmRowDraws``),
so that the score does not depend on the world size; the loss divides the rank's masked NLL sum by the masked count of the
whole batch (all-reduced before the backward) and the flat gradient is
all-reduced; rank 0 writes the checkpoints.

Random numbers are inputs: an :class:`MlmDraws` hands out the masking draws
and the dropout draws of each step from an explicit ``torch.Generator``;
tests hand in other numbers (the JAX package's).
"""
from __future__ import annotations

import glob
import logging
import math
import os
import re
import shutil
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..models import bert as bert_mod
from ..parallel import mesh as pmesh
from ..parallel import sharding as psh
from ..train import checkpoint as ckpt
from ..train import optim as topt
from .tokenizer import MIDITokenizer


def load_block_dataset(data_dir: str, tokenizer: MIDITokenizer,
                       block_size: int = 512) -> np.ndarray:
    """All npy shards -> [N, block_size] int32 blocks; the tail shorter than
    a block is padded with [PAD] (reference TextDataset)."""
    files = sorted(glob.glob(os.path.join(data_dir, "*.npy")))
    examples = []
    for path in files:
        toks = np.load(path)
        for i in range(0, len(toks), block_size):
            sample = toks[i:i + block_size]
            if len(sample) == block_size:
                examples.append(sample)
            else:
                pad = np.full((block_size,), tokenizer.pad_token_id,
                              toks.dtype)
                pad[:len(sample)] = sample
                examples.append(pad)
    if not examples:
        raise ValueError(f"no npy shards under {data_dir}")
    return np.stack(examples).astype(np.int32)


class MlmDraws:
    """The random numbers of MLM steps, drawn in order from ``generator``
    (on ``device``)."""

    def __init__(self, generator: torch.Generator, device=None):
        self.generator = generator
        self.device = device

    def _uniform(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator,
                          dtype=torch.float32, device=self.device)

    def mask(self, shape, vocab_size: int):
        """(u_mask, u_replace, u_random, random_words) of one batch: three
        uniform draws and ids in [0, vocab_size)."""
        us = tuple(self._uniform(shape) for _ in range(3))
        words = torch.randint(0, vocab_size, shape, generator=self.generator,
                              device=self.device)
        return us + (words,)

    def dropout_u(self, shape) -> torch.Tensor:
        """Uniform draws of one dropout site (``models/bert`` order)."""
        return self._uniform(shape)


def mask_tokens(inputs: torch.Tensor, mask_token_id: int, vocab_size: int,
                pad_token_id: int, mlm_probability: float, draws):
    """80/10/10 masking (reference mask_tokens): a non-pad token is masked
    with probability ``mlm_probability``; a masked token becomes [MASK] with
    probability 0.8, else a random id with probability 0.5, from the draws
    of ``draws.mask`` (an :class:`MlmDraws`). Returns (masked inputs,
    labels) with labels -100 off the mask."""
    u_mask, u_replace, u_random, words = (
        d.to(inputs.device) for d in draws.mask(tuple(inputs.shape),
                                                vocab_size))
    prob = torch.where(inputs == pad_token_id, 0.0, mlm_probability)
    masked = u_mask < prob.to(torch.float32)
    labels = torch.where(masked, inputs, -100)
    replaced = (u_replace < 0.8) & masked
    random_sel = (u_random < 0.5) & masked & ~replaced
    out = torch.where(replaced, mask_token_id, inputs)
    out = torch.where(random_sel, words.to(inputs.dtype), out)
    return out, labels


def mlm_loss(params, cfg: bert_mod.BertConfig, batch, labels, *,
             train: bool = False, dropout_u=None,
             count: torch.Tensor | None = None) -> torch.Tensor:
    """Mean NLL over the masked positions (fp32): their NLL sum over
    ``count`` (default: their number in ``labels``; data parallel, the
    number over all ranks' rows)."""
    hidden = bert_mod.bert_encode(params, cfg, input_ids=batch, train=train,
                                  dropout_u=dropout_u)
    logp = F.log_softmax(bert_mod.bert_mlm_logits(params, cfg, hidden).float(),
                         dim=-1)
    nll = -logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    mask = labels >= 0
    cnt = (mask.sum() if count is None else count).clamp(min=1)
    return torch.where(mask, nll, 0.0).sum() / cnt


def mlm_decay_mask(name: str) -> bool:
    """The MLM trainer's weight-decay mask: no decay on leaves whose name
    contains ``_b``, ``ln`` or ``bias``."""
    leaf = name.rsplit(".", 1)[-1]
    return not ("_b" in leaf or "ln" in leaf or "bias" in leaf)


def cosine_warmup_schedule(warmup_steps: int, max_steps: int):
    """get_cosine_schedule_with_warmup's multiplier at update ``step``."""

    def sched(step: int) -> float:
        if step < warmup_steps:
            return step / max(warmup_steps, 1)
        progress = (step - warmup_steps) / max(max_steps - warmup_steps, 1)
        return max(0.5 * (1.0 + math.cos(math.pi * progress)), 0.0)

    return sched


class MlmTrainer:
    """The JAX package's ``MlmTrainer`` (the card unless ``device`` is
    given; every rank of a torchrun world): parameters as one flat fp32
    vector under ``train.optim.FlatLayout``, the optimizer chain clip,
    Adam, masked weight decay, the cosine warmup, lr as a
    ``FusedOptimizer``."""

    def __init__(self, data_dir: str, output_dir: str, vocab_file: str,
                 num_hidden_layers: int = 5, hidden_size: int = 768,
                 block_size: int = 512, batch_size: int = 16,
                 learning_rate: float = 5e-5, weight_decay: float = 0.0,
                 adam_epsilon: float = 1e-8, warmup_steps: int = 0,
                 max_steps: int = 10000, max_grad_norm: float = 1.0,
                 mlm_probability: float = 0.15, seed: int = 42,
                 logging_steps: int = 100, save_steps: int = 1000,
                 save_total_limit: int = 2, eval_steps: int = 1000,
                 compute_dtype: str = "float32", device=None):
        self.mesh = pmesh.initialize_distributed(device)
        self.device = self.mesh.device
        if batch_size % self.mesh.world:
            raise ValueError(f"batch_size {batch_size} must divide the "
                             f"{self.mesh.world}-rank mesh")
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.tokenizer = MIDITokenizer(vocab_file)
        self.cfg = bert_mod.BertConfig(
            vocab_size=len(self.tokenizer),
            num_hidden_layers=num_hidden_layers, hidden_size=hidden_size,
            max_position_embeddings=max(block_size, 512),
            compute_dtype=compute_dtype)
        self.block_size = block_size
        self.batch_size = batch_size
        self.max_steps = max_steps
        self.logging_steps = logging_steps
        self.save_steps = save_steps
        self.save_total_limit = save_total_limit
        self.eval_steps = eval_steps
        self.mlm_probability = mlm_probability

        self.train_blocks = load_block_dataset(
            os.path.join(data_dir, "train"), self.tokenizer, block_size)
        valid_dir = os.path.join(data_dir, "valid")
        self.valid_blocks = (load_block_dataset(valid_dir, self.tokenizer,
                                                block_size)
                             if os.path.isdir(valid_dir) else None)
        logging.info("MLM corpus: %d train blocks, %s valid blocks",
                     len(self.train_blocks),
                     len(self.valid_blocks)
                     if self.valid_blocks is not None else 0)

        params = bert_mod.init_bert_params(self.cfg, seed=seed)
        self.layout = topt.FlatLayout.of(params)
        self.flat = self.layout.flatten(params).to(self.device)
        self.optimizer = topt.FusedOptimizer(
            "adamw", learning_rate,
            cosine_warmup_schedule(warmup_steps, max_steps), max_grad_norm,
            weight_decay, layout=self.layout, eps=adam_epsilon,
            decay_mask=self.layout.mask(mlm_decay_mask))
        self.opt_state = self.optimizer.init(self.flat)
        psh.broadcast_state(self.flat, self.opt_state)
        self.draws = MlmDraws(torch.Generator(device=self.device).manual_seed(
            pmesh.rank_seed(seed)), self.device)
        self.step = 0
        self.history: list[dict] = []

    def params(self) -> dict:
        return self.layout.unflatten(self.flat)

    def _local(self, blocks: np.ndarray) -> torch.Tensor:
        """The rank's rows of a global batch of blocks, on the device."""
        return torch.from_numpy(psh.local_rows(blocks)).to(self.device)

    def _mask(self, batch, draws):
        tok = self.tokenizer
        return mask_tokens(batch, tok.mask_token_id, len(tok),
                           tok.pad_token_id, self.mlm_probability, draws)

    def train_step(self, batch: torch.Tensor, draws=None) -> torch.Tensor:
        """One update on a [rows, block] id batch (the rank's rows): mask,
        loss, gradient, optimizer. ``draws``: an :class:`MlmDraws` of those
        rows (the trainer's own by default). Returns the rank's share of the
        loss (on the device; the ranks' shares sum to the batch's loss)."""
        draws = draws or self.draws
        masked, labels = self._mask(batch, draws)
        count = pmesh.all_reduce_sum_((labels >= 0).sum())
        flat = self.flat.detach().requires_grad_(True)
        loss = mlm_loss(self.layout.unflatten(flat), self.cfg, masked, labels,
                        train=True, dropout_u=draws.dropout_u, count=count)
        grad = pmesh.all_reduce_sum_(torch.autograd.grad(loss, flat)[0])
        self.opt_state = self.optimizer.update(self.flat, grad, self.opt_state)
        return loss.detach()

    # ------------------------------------------------------------------
    def _rotate_checkpoints(self) -> None:
        """save_total_limit rotation (reference BERT/main.py)."""
        pat = re.compile(r"checkpoint-(\d+)$")
        dirs = []
        for d in glob.glob(os.path.join(self.output_dir, "checkpoint-*")):
            m = pat.search(d)
            if m:
                dirs.append((int(m.group(1)), d))
        dirs.sort()
        while len(dirs) > self.save_total_limit:
            _, victim = dirs.pop(0)
            logging.info("Deleting older checkpoint %s", victim)
            shutil.rmtree(victim, ignore_errors=True)

    def save(self) -> str:
        """Rank 0 writes ``checkpoint-{step}`` and rotates; every rank waits
        for it. Returns its path."""
        name = f"checkpoint-{self.step}"
        pmesh.sync_global_devices("before_save")
        if self.mesh.rank == 0:
            ckpt.save_bert_checkpoint(
                self.output_dir, name, self.params(),
                {"step": self.step,
                 "config": {"vocab_size": self.cfg.vocab_size,
                            "num_hidden_layers": self.cfg.num_hidden_layers,
                            "hidden_size": self.cfg.hidden_size}})
            self._rotate_checkpoints()
        pmesh.sync_global_devices("after_save")
        return os.path.join(os.path.abspath(self.output_dir), name)

    @torch.no_grad()
    def evaluate(self) -> float:
        """Mean over the valid batches of their masked NLL (no dropout;
        masks from a generator seeded 0, drawn at the global shape, each
        rank scoring its rows)."""
        if self.valid_blocks is None:
            return float("nan")
        draws = MlmDraws(torch.Generator(device=self.device).manual_seed(0),
                         self.device)
        if self.mesh.world > 1:
            draws = psh.MlmRowDraws(draws)
        params = self.params()
        parts = []
        for i in range(0, len(self.valid_blocks) - self.batch_size + 1,
                       self.batch_size):
            batch = self._local(self.valid_blocks[i:i + self.batch_size])
            masked, labels = self._mask(batch, draws)
            count = pmesh.all_reduce_sum_((labels >= 0).sum())
            parts.append(mlm_loss(params, self.cfg, masked, labels,
                                  count=count))
        if not parts:
            return float("nan")
        losses = pmesh.host_allreduce_sum(torch.stack(parts).cpu().numpy())
        return float(np.mean(losses))

    def train(self) -> None:
        n = len(self.train_blocks)
        order = np.random.RandomState(0).permutation(n)
        pos = 0
        t0 = time.time()
        while self.step < self.max_steps:
            if pos + self.batch_size > n:
                order = np.random.RandomState(self.step).permutation(n)
                pos = 0
            batch = self._local(self.train_blocks[
                order[pos:pos + self.batch_size]])
            pos += self.batch_size
            loss = self.train_step(batch)
            self.step += 1
            if self.step % self.logging_steps == 0:
                loss_v = float(pmesh.host_allreduce_sum([float(loss)])[0])
                rate = self.logging_steps * self.batch_size / (time.time() - t0)
                logging.info(
                    "MLM step %d/%d loss=%.4f ppl=%.2f (%.1f blk/s)",
                    self.step, self.max_steps, loss_v,
                    float(np.exp(min(loss_v, 30))), rate)
                self.history.append({"step": self.step, "loss": loss_v,
                                     "blocks_per_s": rate})
                t0 = time.time()
            if self.step % self.eval_steps == 0:
                eval_loss = self.evaluate()
                logging.info("MLM eval step %d loss=%.4f ppl=%.2f",
                             self.step, eval_loss,
                             float(np.exp(min(eval_loss, 30)))
                             if eval_loss == eval_loss else float("nan"))
                self.history.append({"step": self.step,
                                     "eval_loss": eval_loss})
            if self.step % self.save_steps == 0:
                self.save()
        self.save()
