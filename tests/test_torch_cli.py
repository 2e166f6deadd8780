"""The port's generation CLI (transformer_gan_torch.cli.generate) end to end
on the CPU with a tiny model directory: unconditional waves, conditional
priming with the debug incremental == batch memory check and prime NLL,
and the duration-based stop."""

import os

import numpy as np
import pytest
import torch

from transformer_gan_torch import convert
from transformer_gan_torch.cli import generate as cli
from transformer_gan_torch.config import (PACKAGED_VOCAB, inference_config,
                                          training_config)
from transformer_gan_torch.models import xl as txl

torch.set_num_threads(1)


def _model_dir(tmp_path, compute_dtype="float32"):
    """config.yml (written by the JAX package's config tree, as a training
    run leaves it) + the port's parameter file of a seeded tiny model."""
    from transformer_gan_tpu.config import get_default_cfg_training
    cfg = get_default_cfg_training()
    cfg.defrost()
    cfg.MODEL.num_layers = 2
    cfg.MODEL.num_heads = 2
    cfg.MODEL.units = 16
    cfg.MODEL.inner_size = 32
    cfg.TPU.compute_dtype = compute_dtype
    cfg.freeze()
    work = tmp_path / "work"
    work.mkdir()
    (work / "config.yml").write_text(cfg.dump())
    xcfg = txl.XLConfig.from_cfg(training_config(str(work / "config.yml")),
                                 310)
    convert.save_params(str(work / "checkpoint_last.pt"),
                        txl.init_xl_params(xcfg, seed=3,
                                           base_init=("normal", 0.05)))
    return work


def _inference_cfg(work, out_dir, **over):
    icfg = inference_config()
    icfg.MODEL.model_directory = str(work)
    icfg.MODEL.checkpoint_name = "checkpoint_last"
    icfg.MODEL.memory_length = 48
    icfg.MODEL.debug = False
    icfg.SAMPLING.technique = "topk"
    icfg.SAMPLING.threshold = 8.0
    icfg.SAMPLING.temperature = 0.95
    icfg.INPUT.num_midi_files = 1
    icfg.OUTPUT.output_txt_directory = str(out_dir)
    icfg.GENERATION.generation_length = 12
    icfg.GENERATION.duration_based = False
    for dotted, v in over.items():
        group, key = dotted.split(".")
        setattr(getattr(icfg, group), key, v)
    return icfg


def _read_tokens(fp):
    with open(fp) as f:
        return [line.strip() for line in f if line.strip()]


def test_load_vocab_fallback_and_missing_custom_path(tmp_path):
    """The default vocab path is the packaged file (absolute, so it does not
    depend on the working directory); a missing performance_vocab.txt falls
    back to it, while a file of that name that exists is read as given."""
    assert os.path.isabs(PACKAGED_VOCAB) and os.path.exists(PACKAGED_VOCAB)
    assert inference_config().EVENT.vocab_file_path == PACKAGED_VOCAB
    tokens, tok2idx = cli.load_vocab(
        str(tmp_path / "missing" / "performance_vocab.txt"))
    assert len(tokens) == 310 and tokens[0] == "<S>"
    assert tok2idx[tokens[-1]] == 309
    assert cli.load_vocab() == (tokens, tok2idx)
    own = tmp_path / "performance_vocab.txt"
    own.write_text("<S>\n<PAD>\nNOTE_ON_60\n")
    assert cli.load_vocab(str(own))[0] == ["<S>", "<PAD>", "NOTE_ON_60"]
    with pytest.raises(FileNotFoundError):
        cli.load_vocab(str(tmp_path / "my_custom_vocab.txt"))


def test_cli_unconditional_waves(tmp_path):
    """10 files run as waves of 8 and 2 lanes; each file carries
    generation_length vocab tokens (40: a chunk of 32 and a remainder), and
    a generator with the same seed reproduces them."""
    work = _model_dir(tmp_path)
    icfg = _inference_cfg(work, tmp_path / "out",
                          **{"INPUT.num_midi_files": 10,
                             "GENERATION.generation_length": 40})
    summary = cli.main(icfg, "cpu", torch.Generator().manual_seed(0))
    assert len(summary["files"]) == 10 and summary["tokens"] == 400
    vocab, _ = cli.load_vocab()
    first = []
    for i in range(10):
        toks = _read_tokens(tmp_path / "out" / f"{i}.txt")
        assert len(toks) == 40
        assert all(t in vocab for t in toks) and "<S>" not in toks
        first.append(toks)
    icfg2 = _inference_cfg(work, tmp_path / "out2",
                           **{"INPUT.num_midi_files": 10,
                              "GENERATION.generation_length": 40})
    cli.main(icfg2, "cpu", torch.Generator().manual_seed(0))
    assert [_read_tokens(tmp_path / "out2" / f"{i}.txt")
            for i in range(10)] == first


def test_cli_conditional_debug(tmp_path, capsys):
    """Conditional priming + debug: the CLI asserts incremental == batch
    memories (ring full by the end) and reports the prime NLL; the output
    starts with the conditional prefix."""
    work = _model_dir(tmp_path)
    prefix = np.array([5, 105, 106, 280, 7, 9, 110, 111, 3, 4], np.int32)
    np.save(tmp_path / "prefix.npy", prefix)
    icfg = _inference_cfg(
        work, tmp_path / "out",
        **{"INPUT.time_extension": True,
           "INPUT.conditional_input_melody": str(tmp_path / "prefix.npy"),
           "INPUT.num_conditional_tokens": 6,
           "MODEL.debug": True,
           "GENERATION.generation_length": 50})
    cli.main(icfg, "cpu", torch.Generator().manual_seed(1))
    _, tok2idx = cli.load_vocab()
    toks = _read_tokens(tmp_path / "out" / "0.txt")
    assert [tok2idx[t] for t in toks[:6]] == prefix[:6].tolist()
    assert len(toks) == 6 + 50
    printed = capsys.readouterr().out
    assert "Mem same" in printed and "Prime NLL" in printed
    assert (tmp_path / "out" / "inference.yml").exists()
    assert _read_tokens(tmp_path / "out" / "prefix.txt") == toks[:6]


def test_cli_duration_based_stop(tmp_path):
    work = _model_dir(tmp_path)
    icfg = _inference_cfg(
        work, tmp_path / "out",
        **{"GENERATION.duration_based": True,
           "GENERATION.generation_duration": 0.3,
           "GENERATION.max_generation_length": 64})
    cli.main(icfg, "cpu", torch.Generator().manual_seed(2))
    toks = _read_tokens(tmp_path / "out" / "0.txt")
    assert 1 <= len(toks) <= 64
    dur = sum(int(t.split("_")[-1]) * 0.01 for t in toks
              if t.startswith("TIME_SHIFT"))
    assert dur >= 0.3 or len(toks) == 64
