"""The frozen work counts against hand counts at one shape each, and against
the program's own copies at the cells' shapes."""
from __future__ import annotations

import pytest

from portbench import work


def test_open_scores_by_hand():
    # q 4 over 2 valid slots of a 2-slot ring: rows see 3, 4, 5, 6 keys
    assert work.open_scores(4, 2, 2) == 18
    # a reset row sees the causal band only: 1 + 2 + 3 + 4
    assert work.open_scores(4, 2, 2, reset=True) == 10
    # an empty ring of 8 slots
    assert work.open_scores(4, 8, 0) == 10


def test_attention_work_by_hand():
    # q 4, B 1, M 2, count 2, H 1, dh 2, bf16: 18 open scores
    nbytes, flops = work.attention_work(4, 1, 2, 2, H=1, dh=2)
    assert flops == 2 * 2 * 3 * 18
    assert nbytes == 2 * (4 * 4 * 2 + 2 * 2 * 2 + (2 + 8) * 2) + 4 * (8 + 8)
    nbytes, flops = work.attention_work(4, 1, 2, 2, backward=True, H=1, dh=2)
    assert flops == 2 * 2 * (6 * 18 + 2 * 10)


def test_sampler_work_by_hand():
    # one token, one lane, one layer, M 1 empty: HD 2, DI 3, V 5, bf16
    nbytes, flops = work.sampler_work(1, 1, 1, 0, L=1, HD=2, DI=3, V=5)
    assert flops == 2 * (4 * 4 + 2 * 2 * 3) + 6 * 2 * 1 + 2 * 2 * 5
    weights = 2 * (4 * 4 + 2 * 2 * 3 + 3 + 2 + 2 * 5 * 2 + 5 + 2 * 2) \
        + 4 * 4 * 2
    assert nbytes == 2 * (0 + 2 * 2) + weights + 4 * 5 + 8 + 4 * 5 + 2 * 2 * 2


def test_bound_ms_takes_the_larger():
    assert work.bound_ms(3.35e12, 1.0) == pytest.approx(1e3)
    assert work.bound_ms(1.0, 989e12) == pytest.approx(1e3)


def test_generate_chunks_cover_the_piece():
    chunks = work.generate_chunks(2047, 2048)
    assert sum(n for n, _ in chunks) == 2047 and len(chunks) == 64
    assert chunks[0] == (32, 0) and chunks[1] == (32, 32)
    assert chunks[-1] == (31, 2016)


def test_wave_flops_match_the_chunks():
    length, M, B = 2047, 2048, 32
    by_chunk = sum(work.sampler_work(n, B, M, c)[1]
                   for n, c in work.generate_chunks(length, M))
    assert work.gen_wave_flops(B, length, M) == by_chunk


def test_mle_step_flops_by_hand():
    # one row, q 2, M 2 full, one layer, d 2, H 1, dh 2, di 3, V 5
    f = work.mle_step_flops([False], 2, 2, 2, L=1, d=2, H=1, dh=2, di=3, V=5)
    dense = 2 * (2 * (3 * 4 + 4 + 2 * 6) + 2 * 2 * 5)
    rproj = 2 * 4 * 2 * 2
    attn = (3 + 4) * 3 * 2 * 2
    assert f == 3 * (dense + rproj + attn)
    g = work.mle_step_flops([True], 2, 2, 2, L=1, d=2, H=1, dh=2, di=3, V=5)
    assert f - g == 3 * (4 * 3 * 2 * 2)


@pytest.mark.parametrize("backward", [False, True])
def test_attention_work_is_the_programs(backward):
    kc = pytest.importorskip("transformer_gan_torch.kernel_check")
    for q, B, M, count in ((128, 128, 1024, 1024), (128, 32, 1024, 512)):
        assert work.attention_work(q, B, M, count, backward) == \
            kc.attention_work("v2", q, B, M, count, False, backward)


def test_sampler_work_is_the_programs():
    kc = pytest.importorskip("transformer_gan_torch.kernel_check")
    for n, B, M, count in ((32, 32, 2048, 0), (31, 32, 2048, 2016),
                           (32, 8, 4146, 4146)):
        assert work.sampler_work(n, B, M, count) == \
            kc.sampler_work(n, B, M, count)


def test_mle_followed_steps_reach_the_windows_state(tmp_path):
    """The mle cell's followed steps, on its corpus's lengths and the
    program's train iterator, run at least three steps with every memory
    slot valid, and one of those resets a row (the stream's first reset of a
    full memory)."""
    import numpy as np

    from portbench import corpus, run
    from transformer_gan_torch.config import training_config
    from transformer_gan_torch.data.dataset import MusicDataset

    cell = run.load_cell("xl_baseline.mle_b128")
    conf = cell["config_data"]
    spec = conf["assumed"]["corpus"]
    cfg = training_config().merge(conf["program_config"])
    for split, n in (("train", spec["train_pieces"]), ("valid", 2),
                     ("test", 2)):
        (tmp_path / split).mkdir()
        lengths = (corpus.train_lengths(n, spec["train_mean"],
                                        spec["train_sigma"])
                   if split == "train" else [16] * n)
        for k, size in enumerate(lengths):
            np.save(tmp_path / split / f"{k:05d}.npy",
                    np.full(int(size), 2, np.int8))
    with open(run.os.path.join(run.HERE, "configs",
                               "xl_baseline.vocab.txt")) as f:
        (tmp_path / "vocab.txt").write_text(f.read())
    rows = int(conf["deployment"]["rows_per_card"])
    q, M = cfg.TRAIN.tgt_length, cfg.TRAIN.mem_length
    it = MusicDataset(str(tmp_path), cfg).get_iterator(
        rows, q, split="train", do_shuffle=True, seed=cfg.TRAIN.seed)()
    n = int(cell["traffic_data"]["followed_steps"])
    resets = [next(it)[2] for _ in range(n)]
    full = [k for k in range(n) if k * q >= M]
    assert len(full) >= 3
    assert any(resets[k].any() for k in full)
