"""A seeded token corpus in the layout the program's ``MusicDataset`` reads
(the layout of ``chip_smoke.write_random_corpus``): ``vocab.txt`` and
``train/``, ``valid/``, ``test/`` folders of int32 ``.npy`` pieces, ids drawn
uniformly from every id but <S> (0) and <PAD> (1).

Train piece lengths lie on a fixed grid of quantiles of a log-normal with
the stated mean and sigma, the same for every seed: the program's train
iterator starts each lane at a piece's start and resets its memory at the
piece's end, and lengths that changed with the seed would change those
resets, and the tokens a window counts, from seed to seed. Eval pieces all
have the stated eval length."""
from __future__ import annotations

import os
from statistics import NormalDist

import numpy as np


def train_lengths(n: int, mean: float, sigma: float) -> np.ndarray:
    """Lengths at the quantiles (k + 1/2) / n of a log-normal of ``mean``
    and ``sigma``, at least 2 tokens."""
    z = np.array([NormalDist().inv_cdf((k + 0.5) / n) for k in range(n)])
    median = mean / np.exp(sigma ** 2 / 2)
    return np.maximum(median * np.exp(sigma * z), 2).astype(np.int64)


def write_corpus(data_dir: str, vocab_lines: list, seed: int, spec: dict
                 ) -> None:
    """``spec``: ``train_pieces``, ``train_mean``, ``train_sigma``,
    ``eval_pieces``, ``eval_length``."""
    rng = np.random.default_rng(int(seed))
    os.makedirs(data_dir, exist_ok=True)
    with open(os.path.join(data_dir, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab_lines) + "\n")
    V = len(vocab_lines)
    n_eval = int(spec["eval_pieces"])
    sizes = {"train": train_lengths(int(spec["train_pieces"]),
                                    float(spec["train_mean"]),
                                    float(spec["train_sigma"])),
             "valid": np.full(n_eval, int(spec["eval_length"])),
             "test": np.full(n_eval, int(spec["eval_length"]))}
    for split, lengths in sizes.items():
        folder = os.path.join(data_dir, split)
        os.makedirs(folder, exist_ok=True)
        ids = rng.integers(2, V, int(lengths.sum()), dtype=np.int32)
        for k, piece in enumerate(np.split(ids, np.cumsum(lengths)[:-1])):
            np.save(os.path.join(folder, f"{k:05d}.npy"), piece)
