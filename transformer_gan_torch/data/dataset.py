"""Maestro token-shard dataset and batch iterators (numpy, on the host).

A copy of ``transformer_gan_tpu/data/dataset.py`` (the port imports no
module of the JAX package) with the same emission contracts:

* train iterator -> (data, target, reset_mem, batch_token_num, status_vec)
  over per-lane piece streams with pad fill and mem-reset flags at piece
  boundaries; ``TRAIN.random_crop`` (and its one-window mode at
  ``mem_length`` 0) and ``DATASET.continuous_refill`` as there;
* eval iterator -> deterministic bptt windows over batches of pieces,
  rank-sharded by slicing the piece list;
* discriminator iterator -> (data, batch_token_num): each lane settles on a
  piece long enough for a ``bptt`` crop and emits a fresh random crop of it
  every batch.

With ``TRAIN.append_note_status`` the train and eval iterators also emit
``status_vec`` [bptt, bsz, vec_len] bool, the held notes after each token
(cleared on a reset row, or at an eval group's first window); else None.
"""

from __future__ import annotations

import glob
import logging
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .vocab import BaseVocab

# rolling-window size (batches) for train-lane utilization reporting
_UTIL_WINDOW = 512


class _EpochQueue:
    """A single pass over a permutation of piece ids, consumed lazily by
    the batch lanes (replaces the reference's shared ``next_idx`` counter)."""

    def __init__(self, order, refill=None):
        self._order = order
        self._head = 0
        self._refill = refill

    def take(self):
        if self._head >= len(self._order):
            if self._refill is None:
                return None
            # continuous mode (DATASET.continuous_refill): draw the next
            # epoch's shuffled order immediately so no lane ever idles.
            # Each piece still appears exactly once per refill cycle
            # (tests/test_dataset.py conservation check).
            self._order = self._refill()
            self._head = 0
        piece_id = self._order[self._head]
        self._head += 1
        return piece_id


class _TrainLane:
    """One batch column of the train iterator.

    Walks whole pieces pulled from the shared epoch queue, emitting up to
    ``bptt`` (data, target) tokens per batch. ``reset`` is raised on the
    first window emitted after the lane switched pieces — the trainer uses
    it to invalidate that row's XL memory. In one-window mode (mem_length
    0 + random_crop) every emitted window is an independent crop and every
    batch raises ``reset`` (reference data_utils.py:277-284).
    """

    def __init__(self, queue, pieces, lengths, bptt, rng, *,
                 crop=False, one_window=False):
        self._queue = queue
        self._pieces = pieces
        self._lengths = lengths
        self._bptt = bptt
        self._rng = rng
        self._crop = crop
        self._one_window = one_window
        self._piece_id = None
        self._cursor = 0
        self._reset = False

    def _start_next_piece(self):
        """Pull pieces until one has at least 1 emittable token."""
        while True:
            pid = self._queue.take()
            if pid is None:
                self._piece_id = None
                return False
            if self._lengths[pid] <= 1:
                # nothing but the start token: counts as a finished piece
                self._reset = True
                continue
            self._piece_id = pid
            self._cursor = 0
            if self._crop:
                margin = self._bptt if self._one_window else 0
                hi = self._lengths[pid] - 1 - margin
                self._cursor = self._rng.randint(0, hi) if hi >= 1 else 0
            return True

    def emit(self, data_col, target_col):
        """Fill one column; return (n_tokens, reset_flag)."""
        if self._piece_id is not None:
            remaining = self._lengths[self._piece_id] - 1 - self._cursor
            if remaining <= 0:
                self._reset = True
                self._piece_id = None
        if self._piece_id is None:
            if not self._start_next_piece():
                reset, self._reset = self._reset, False
                return 0, reset

        seq = self._pieces[self._piece_id]
        lo = self._cursor
        n = min(self._lengths[self._piece_id] - 1 - lo, self._bptt)
        data_col[:n] = seq[lo:lo + n]
        target_col[:n] = seq[lo + 1:lo + 1 + n]
        self._cursor = lo + n

        reset, self._reset = self._reset, False
        if self._one_window:
            # every crop is its own context; drop the piece immediately
            self._piece_id = None
            reset = True
        return n, reset


class _DisLane:
    """One batch column of the discriminator iterator: settles on the
    first queue piece long enough to hold a full ``bptt`` crop, then emits
    an independent random crop of it every batch."""

    def __init__(self, queue, pieces, lengths, bptt, rng):
        self._queue = queue
        self._pieces = pieces
        self._lengths = lengths
        self._bptt = bptt
        self._rng = rng
        self._piece_id = None
        self._dry = False

    def emit(self, data_col):
        if self._dry:
            return 0
        while self._piece_id is None:
            pid = self._queue.take()
            if pid is None:
                self._dry = True
                return 0
            if self._lengths[pid] >= self._bptt:
                self._piece_id = pid
        n = self._lengths[self._piece_id]
        lo = self._rng.randint(0, n - self._bptt + 1)
        data_col[:] = self._pieces[self._piece_id][lo:lo + self._bptt]
        return self._bptt


class MusicDataset:
    def __init__(self, data_dir, cfg):
        self._vocab_path = os.path.join(data_dir, "vocab.txt")
        self._train_folder = os.path.join(data_dir, "train")
        self._valid_folder = os.path.join(data_dir, "valid")
        self._test_folder = os.path.join(data_dir, "test")
        self._vocab = BaseVocab.from_file(self._vocab_path)
        self.cfg = cfg

        self._train_data = self.load_cache_data(self._train_folder)
        self._valid_data = self.load_cache_data(self._valid_folder)
        self._test_data = self.load_cache_data(self._test_folder)

        # Prepend start tokens (reference model/data_utils.py:123-140).
        if self.cfg.TRAIN.replace_start_with_pad:
            print("USING PAD TOKEN AS START!")
            insert_token = self._vocab.pad_id
        else:
            insert_token = self._vocab.bos_id
        self._train_data = [
            np.insert(arr, 0, insert_token) for arr in self._train_data]
        self._valid_data = [
            np.insert(arr, 0, insert_token) for arr in self._valid_data]
        self._test_data = [
            np.insert(arr, 0, insert_token) for arr in self._test_data]

        self._train_seq_length = np.array(
            [ele.shape[0] for ele in self._train_data], dtype=np.int32)
        self._valid_seq_length = np.array(
            [ele.shape[0] for ele in self._valid_data], dtype=np.int32)
        self._test_seq_length = np.array(
            [ele.shape[0] for ele in self._test_data], dtype=np.int32)
        print("Loaded Data, #Samples Train/Val/Test:{}/{}/{}".format(
            len(self._train_data), len(self._valid_data),
            len(self._test_data)))
        if len(self._valid_data):
            print("             #Total Number of Valid/Test Tokens: {}/{}"
                  .format((self._valid_seq_length - 1).sum(),
                          (self._test_seq_length - 1).sum()))
        if cfg.TRAIN.append_note_status:
            self._vocab.notes_mapping()

    @staticmethod
    def load_cache_data(dir_name):
        all_fnames = sorted(glob.glob(os.path.join(dir_name, "*.npy")))
        print("Loading #{} files from {}".format(len(all_fnames), dir_name))
        if len(all_fnames) > 32:
            # threads, not forked processes: the trainer may already hold
            # a CUDA context, and file reads release the GIL
            with ThreadPoolExecutor(8) as pool:
                return list(pool.map(np.load, all_fnames))
        return [np.load(f) for f in all_fnames]

    @property
    def vocab(self):
        return self._vocab

    @property
    def train_data(self):
        return self._train_data

    @property
    def valid_data(self):
        return self._valid_data

    @property
    def test_data(self):
        return self._test_data

    @property
    def train_seq_length(self):
        return self._train_seq_length

    @property
    def valid_seq_length(self):
        return self._valid_seq_length

    @property
    def test_seq_length(self):
        return self._test_seq_length

    def _split(self, split):
        if split == "train":
            return self.train_data, self.train_seq_length
        elif split == "valid":
            return self.valid_data, self.valid_seq_length
        elif split == "test":
            return self.test_data, self.test_seq_length
        raise NotImplementedError(split)

    def _status_buffer(self, bptt, batch_size):
        if not self.cfg.TRAIN.append_note_status:
            return None
        return np.zeros((bptt, batch_size, self._vocab.vec_len), dtype=bool)

    # ------------------------------------------------------------------ train
    def get_iterator(self, batch_size, bptt, device=None, split="train",
                     do_shuffle=True, seed=None):
        pieces, lengths = self._split(split)
        assert batch_size < len(pieces)
        crop = bool(self.cfg.TRAIN.random_crop)
        one_window = crop and self.cfg.TRAIN.mem_length == 0

        # continuous refill needs a shuffled stream (a one-pass
        # do_shuffle=False loader must still terminate)
        continuous = bool(getattr(self.cfg.DATASET, "continuous_refill",
                                  False)) and do_shuffle

        # An all-degenerate corpus (every piece only a start token) has
        # nothing to emit: the drain path would rebuild epochs forever and
        # the continuous path would spin inside one take() call pulling
        # and discarding pieces — fail loud instead (ADVICE r4).
        if not (np.asarray(lengths) > 1).any():
            raise ValueError(
                f"{split} corpus has no emittable tokens (every piece is "
                "<= 1 token after the start-token prepend)")

        def iterator():
            rng = np.random.RandomState(seed)

            def shuffled_order():
                order = np.arange(len(pieces))
                rng.shuffle(order)
                return order

            def fresh_epoch():
                order = np.arange(len(pieces))
                if do_shuffle:
                    rng.shuffle(order)
                queue = _EpochQueue(
                    order, refill=shuffled_order if continuous else None)
                return [_TrainLane(queue, pieces, lengths, bptt, rng,
                                   crop=crop, one_window=one_window)
                        for _ in range(batch_size)]

            def report_utilization(tokens, batches):
                """Measured slot utilization: under the reference's drain
                semantics lanes idle while the epoch tail empties — the
                round-4 soak fed 128 lanes from a 200-piece corpus at
                62.5%, a silent 1.6x tokens/s loss. Warn so small corpora
                point at the opt-in fix."""
                if not batches:
                    return
                util = tokens / (batches * bptt * batch_size)
                logger = logging.getLogger(__name__)
                logger.info("train iterator slot utilization: %.1f%% over "
                            "%d batches", 100.0 * util, batches)
                if util < 0.8:
                    logger.warning(
                        "train lanes ran at %.1f%% slot utilization — "
                        "tokens/s scales with it; for small corpora set "
                        "DATASET.continuous_refill: true to keep lanes "
                        "fed across epoch boundaries", 100.0 * util)

            lanes = fresh_epoch()
            data = np.empty((bptt, batch_size), dtype=np.int64)
            target = np.empty((bptt, batch_size), dtype=np.int64)
            reset_mem = np.empty((batch_size,), dtype=bool)
            status_vec = self._status_buffer(bptt, batch_size)
            win_tokens = 0
            win_batches = 0

            while True:
                data[:] = self.vocab.pad_id
                target[:] = self.vocab.pad_id
                batch_token_num = 0
                for j, lane in enumerate(lanes):
                    n, reset_mem[j] = lane.emit(data[:, j], target[:, j])
                    batch_token_num += n
                if batch_token_num == 0:
                    if not do_shuffle:
                        report_utilization(win_tokens, win_batches)
                        return  # one-pass loader
                    report_utilization(win_tokens, win_batches)
                    win_tokens = win_batches = 0
                    lanes = fresh_epoch()
                    continue
                win_tokens += batch_token_num
                win_batches += 1
                if win_batches >= _UTIL_WINDOW:
                    # continuous mode never drains an epoch; report on a
                    # rolling window so utilization is still observable
                    report_utilization(win_tokens, win_batches)
                    win_tokens = win_batches = 0

                if status_vec is not None:
                    status_vec[:, reset_mem, :] = False
                    self._vocab.update_status_vec(data, status_vec)

                yield (data.copy(), target.copy(), reset_mem.copy(),
                       batch_token_num,
                       status_vec.copy() if status_vec is not None else None)

        return iterator

    # ------------------------------------------------------------------ eval
    def get_dis_iterator(self, batch_size, bptt, device=None, split="train",
                         do_shuffle=True, seed=None):
        """Real batches for the GAN phases -> (data [bptt, bsz], tokens)."""
        pieces, lengths = self._split(split)
        if batch_size >= len(pieces):
            raise ValueError(f"batch_size {batch_size} must be below the "
                             f"{len(pieces)} pieces of split {split!r}")

        def iterator():
            rng = np.random.RandomState(seed)

            def fresh_epoch():
                order = np.arange(len(pieces))
                if do_shuffle:
                    rng.shuffle(order)
                queue = _EpochQueue(order)
                return [_DisLane(queue, pieces, lengths, bptt, rng)
                        for _ in range(batch_size)]

            lanes = fresh_epoch()
            data = np.empty((bptt, batch_size), dtype=np.int64)
            while True:
                data[:] = self.vocab.pad_id
                batch_token_num = 0
                for j, lane in enumerate(lanes):
                    batch_token_num += lane.emit(data[:, j])
                if batch_token_num == 0:
                    if not do_shuffle:
                        return
                    lanes = fresh_epoch()
                    continue
                yield data.copy(), batch_token_num

        return iterator

    def eval_iterator(self, batch_size, bptt, device=None, split="valid",
                      local_rank=0, world_size=0):
        pieces, lengths = self._split(split)
        if world_size > 0:
            # Rank sharding by contiguous piece slices (pure index
            # arithmetic — the reference's multi-rank eval contract,
            # data_utils.py:382-391). Last rank absorbs the remainder.
            per_rank = len(pieces) // world_size
            lo = per_rank * local_rank
            hi = (len(pieces) if local_rank == world_size - 1
                  else per_rank * (local_rank + 1))
            pieces = pieces[lo:hi]
            lengths = lengths[lo:hi]

        def iterator():
            data = np.empty((bptt, batch_size), dtype=np.int64)
            target = np.empty((bptt, batch_size), dtype=np.int64)
            status_vec = self._status_buffer(bptt, batch_size)
            for group_lo in range(0, len(pieces), batch_size):
                group = range(group_lo, min(group_lo + batch_size,
                                            len(pieces)))
                longest = max(lengths[i] for i in group)
                first_window = True
                for win_lo in range(0, longest - 1, bptt):
                    data[:] = self.vocab.pad_id
                    target[:] = self.vocab.pad_id
                    batch_token_num = 0
                    for j, i in enumerate(group):
                        n = min(win_lo + bptt, lengths[i] - 1) - win_lo
                        if n <= 0:
                            continue
                        data[:n, j] = pieces[i][win_lo:win_lo + n]
                        target[:n, j] = pieces[i][win_lo + 1:win_lo + 1 + n]
                        batch_token_num += n

                    if status_vec is not None:
                        if first_window:
                            status_vec[:] = False
                        self._vocab.update_status_vec(data, status_vec)

                    yield (data.copy(), target.copy(), first_window,
                           batch_token_num,
                           status_vec.copy() if status_vec is not None
                           else None)
                    first_window = False

        return iterator
