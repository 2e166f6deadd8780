"""The port's data layer and config (transformer_gan_torch.data, .config)
against the JAX package: the train iterator (with and without random_crop,
its one-window mode, continuous refill) and the eval iterator (rank slices)
yield identical arrays on a small npy corpus, and every training key the
port reads defaults to the JAX package's value."""

import itertools
import os

import numpy as np
import pytest

from chip_smoke import write_random_corpus
from transformer_gan_torch.config import (PACKAGED_VOCAB, TRAINING_DEFAULTS,
                                          training_config)
from transformer_gan_torch.data.dataset import MusicDataset
from transformer_gan_torch.data.vocab import BaseVocab
from transformer_gan_tpu.config import get_default_cfg_training
from transformer_gan_tpu.data.dataset import MusicDataset as JaxDataset


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    write_random_corpus(str(d), PACKAGED_VOCAB, n_train=9, train_len=30,
                        n_eval=5, eval_len=20, seed=3)
    # a degenerate piece (start token only after the prepend) and a short one
    np.save(d / "train" / "90000.npy", np.zeros((0,), np.int32))
    np.save(d / "train" / "90001.npy", np.array([5, 6], np.int32))
    return str(d)


def _cfgs(**train):
    jcfg = get_default_cfg_training()
    jcfg.defrost()
    tcfg = training_config()
    for k, v in train.items():
        group, key = k.split(".")
        setattr(getattr(jcfg, group), key, v)
        setattr(getattr(tcfg, group), key, v)
    jcfg.freeze()
    return jcfg, tcfg


def _same(a_iter, b_iter, n):
    for a, b in itertools.islice(zip(a_iter, b_iter), n):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y


@pytest.mark.parametrize("train", [
    {"TRAIN.random_crop": False, "TRAIN.mem_length": 8},
    {"TRAIN.random_crop": True, "TRAIN.mem_length": 8},
    {"TRAIN.random_crop": True, "TRAIN.mem_length": 0},
    {"DATASET.continuous_refill": True, "TRAIN.mem_length": 8},
    {"TRAIN.replace_start_with_pad": True, "TRAIN.mem_length": 8},
])
def test_train_iterator_matches_jax(corpus, train):
    """40 batches (several epochs) of (data, target, reset, tokens, None)."""
    jcfg, tcfg = _cfgs(**train)
    j = JaxDataset(corpus, jcfg).get_iterator(4, 7, seed=11)
    t = MusicDataset(corpus, tcfg).get_iterator(4, 7, seed=11)
    _same(j(), t(), 40)


def test_eval_iterator_matches_jax_with_rank_slices(corpus):
    jcfg, tcfg = _cfgs()
    jd, td = JaxDataset(corpus, jcfg), MusicDataset(corpus, tcfg)
    for split in ("valid", "test"):
        for rank, world in ((0, 1), (0, 2), (1, 2)):
            j = jd.eval_iterator(2, 6, split=split, local_rank=rank,
                                 world_size=world)
            t = td.eval_iterator(2, 6, split=split, local_rank=rank,
                                 world_size=world)
            _same(j(), t(), 1000)
            assert len(list(t())) == len(list(j()))


def test_vocab_and_unported_inputs(corpus):
    v = BaseVocab.from_file(PACKAGED_VOCAB)
    assert len(v) == 310 and (v.bos_id, v.pad_id) == (0, 1)
    assert v.idx_to_token(v.token_to_idx("TIME_SHIFT_100")) == "TIME_SHIFT_100"
    with pytest.raises(ValueError):
        BaseVocab(["<PAD>", "<S>"])
    _, tcfg = _cfgs(**{"TRAIN.append_note_status": True})
    with pytest.raises(NotImplementedError):
        MusicDataset(corpus, tcfg)


def test_training_defaults_match_jax():
    """Every key of the port's training defaults has the JAX package's
    default value (the JAX schema is a superset)."""
    jcfg = get_default_cfg_training()

    def walk(tree, node, trail):
        for k, v in tree.items():
            ref = node[k]
            if isinstance(v, dict):
                walk(v, ref, trail + [k])
            else:
                assert v == ref, ".".join(trail + [k])

    walk(TRAINING_DEFAULTS, jcfg, [])
    cfg = training_config(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "training_config", "experiment_baseline.yml"))
    assert cfg.TRAIN.batch_size == 512 and cfg.TRAIN.mem_length == 1024
    assert cfg.TRAIN.clip == 1.0 and cfg.TRAIN.scheduler == "inv_sqrt"
