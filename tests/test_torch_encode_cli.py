"""The port's MIDI-to-MIDI pipeline against the JAX package's, on the CPU:
``python -m transformer_gan_torch.cli.encode`` in every mode writes the
files ``cli/encode.py`` writes, byte for byte; the port's
``tools.make_synth_corpus`` renders the JAX tool's pieces and writes its npy
shards; ``cli.batch_generate`` (``--device cpu``) writes the JAX CLI's
directory tree and MIDI files that the JAX codec's ``from_text`` also
writes; and the whole slice runs: synthetic MIDI -> the port's encode (npy
equal to JAX's encode) -> 2 training steps -> batch generation -> MIDI,
each re-encoded to a decode -> encode fixed point within 5 passes."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from chip_smoke import fixed_point_passes
from transformer_gan_torch import convert
from transformer_gan_torch.cli import batch_generate as bcli
from transformer_gan_torch.cli import train as tcli
from transformer_gan_torch.config import PACKAGED_VOCAB, training_config
from transformer_gan_torch.data import midi as tmidi
from transformer_gan_torch.data.codec import PerformanceEventRepo
from transformer_gan_torch.models import xl as txl
from transformer_gan_tpu.data import codec as jcodec
from transformer_gan_tpu.data import midi as jmidi

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def _run(*cmd):
    out = subprocess.run([sys.executable, *cmd], cwd=ROOT, env=ENV,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _port_encode(*args):
    return _run("-m", "transformer_gan_torch.cli.encode", *args)


def _jax_encode(*args):
    return _run("cli/encode.py", *args)


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _load_jax_script(name, path):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Synthetic pieces as MIDI with a MAESTRO CSV (3 / 2 / 2, seed 7), and
    folders of token .txt and .npy files (the train pieces' encodings and a
    random token sequence) for the decoding modes."""
    root = tmp_path_factory.mktemp("inputs")
    midi = root / "maestro"
    _run("-m", "transformer_gan_torch.tools.make_synth_corpus", "--out_dir",
         str(midi), "--n_train", "3", "--n_valid", "2", "--n_test", "2",
         "--seed", "7", "--write_midi")
    repo = jcodec.PerformanceEventRepo()
    txt, npy = root / "txt", root / "npy"
    txt.mkdir()
    npy.mkdir()
    rng = np.random.RandomState(3)
    pieces = {f"p{i}": repo.encode(str(midi / "train" / f"p{i:04d}.mid"))
              for i in range(3)}
    pieces["soup"] = rng.randint(2, 310, size=300).tolist()
    for name, ids in pieces.items():
        np.save(npy / f"{name}.npy", np.asarray(ids, np.int32))
        (txt / f"{name}.txt").write_text(
            "\n".join(repo.ids_to_events[i] for i in ids))
    return {"maestro": midi, "flat": midi / "train", "txt": txt, "npy": npy}


def test_synth_midi_pieces_are_the_jax_tools(inputs):
    """--write_midi keeps the JAX tool's pieces (same seed, same draws)
    as MIDI, listed in the CSV by split."""
    tool = _load_jax_script("jax_make_synth_corpus",
                            "tools/make_synth_corpus.py")
    rng = np.random.RandomState(7)
    from transformer_gan_torch.cli.encode import get_midi_paths
    paths = get_midi_paths(str(inputs["maestro"]))
    assert [len(p) for p in paths] == [3, 2, 2]
    for split_paths in paths:
        for path in split_paths:
            with open(path, "rb") as f:
                assert f.read() == jmidi.note_sequence_to_midi_bytes(
                    tool.make_piece(rng))


def test_synth_npy_corpus_matches_jax_tool(tmp_path):
    args = ["--n_train", "3", "--n_valid", "2", "--n_test", "2", "--seed",
            "11"]
    _run("tools/make_synth_corpus.py", "--out_dir", str(tmp_path / "j"),
         *args)
    printed = _run("-m", "transformer_gan_torch.tools.make_synth_corpus",
                   "--out_dir", str(tmp_path / "t"), *args)
    got, want = _tree(tmp_path / "t"), _tree(tmp_path / "j")
    assert len(got) == 1 + 7 and got == want
    assert "total tokens:" in printed


# (input, mode, extra flags)
CASES = {
    "to_txt": ("flat", "to_txt", []),
    "to_txt_maestro": ("maestro", "to_txt", ["--encode_official_maestro"]),
    "midi_to_npy": ("flat", "midi_to_npy", []),
    "midi_to_npy_maestro": ("maestro", "midi_to_npy",
                            ["--encode_official_maestro"]),
    "midi_to_npy_maestro_grid": ("maestro", "midi_to_npy",
                                 ["--encode_official_maestro",
                                  "--stretch_factors", "0.9,1.1",
                                  "--pitch_transpose_lower", "-5",
                                  "--pitch_transpose_upper", "2"]),
    "to_midi": ("txt", "to_midi", []),
    "npy_to_midi": ("npy", "npy_to_midi", []),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_encode_cli_writes_jax_files(inputs, tmp_path, case):
    source, mode, extra = CASES[case]
    args = ["--input_folder", str(inputs[source]), "--mode", mode, *extra]
    printed = _port_encode(*args, "--output_folder", str(tmp_path / "t"))
    _jax_encode(*args, "--output_folder", str(tmp_path / "j"))
    got, want = _tree(tmp_path / "t"), _tree(tmp_path / "j")
    assert got and got == want
    if mode in ("to_txt", "midi_to_npy"):
        assert "encoder: native (" in printed
    if case == "midi_to_npy_maestro":
        assert len([p for p in got if p.startswith("train")]) == 3 * 35
        assert "vocab.txt" in got


def _jax_model_dir(root):
    """config.yml + an orbax checkpoint of a seeded tiny JAX model."""
    import jax
    from transformer_gan_tpu.config import get_default_cfg_training
    from transformer_gan_tpu.models import xl
    from transformer_gan_tpu.train import checkpoint as ckpt

    cfg = get_default_cfg_training()
    cfg.defrost()
    cfg.MODEL.num_layers = 2
    cfg.MODEL.num_heads = 2
    cfg.MODEL.units = 16
    cfg.MODEL.inner_size = 32
    cfg.freeze()
    root.mkdir()
    (root / "config.yml").write_text(cfg.dump())
    params = xl.init_xl_params(xl.XLConfig.from_cfg(cfg, 310, 88), seed=3)
    ckpt.save_checkpoint(str(root), "checkpoint_last",
                         {"params": jax.tree.map(lambda x: x, params)})
    return root


def _port_model_dir(root):
    """The same tiny shape as the port's model directory."""
    from transformer_gan_tpu.config import get_default_cfg_training
    cfg = get_default_cfg_training()
    cfg.defrost()
    cfg.MODEL.num_layers = 2
    cfg.MODEL.num_heads = 2
    cfg.MODEL.units = 16
    cfg.MODEL.inner_size = 32
    cfg.TPU.compute_dtype = "float32"
    cfg.freeze()
    root.mkdir()
    (root / "config.yml").write_text(cfg.dump())
    xcfg = txl.XLConfig.from_cfg(training_config(str(root / "config.yml")),
                                 310)
    convert.save_params(str(root / "checkpoint_last.pt"),
                        txl.init_xl_params(xcfg, seed=3,
                                           base_init=("normal", 0.05)))
    return root


def test_batch_generate_matches_jax_tree_and_midi(inputs, tmp_path,
                                                  monkeypatch):
    """One prefix and the unconditional run under topk and random: the
    port writes the JAX CLI's tree of files (the tokens differ: the two
    draw other noise), and every MIDI file it writes is the one the JAX
    codec's from_text writes from the same .txt."""
    prefix = str(tmp_path / "prime.npy")
    np.save(prefix, np.load(inputs["npy"] / "p0.npy")[:40])
    kw = dict(memory_length=48, generation_length=24, num_midi_files=2,
              num_conditional_tokens=10)
    configs = [{"technique": "topk", "temperature": 0.95, "threshold": 8.0},
               {"technique": "random", "temperature": 0.9}]

    monkeypatch.setattr(sys, "path", list(sys.path))
    jb = _load_jax_script("jax_batch_generate", "cli/batch_generate.py")
    jax_dir = _jax_model_dir(tmp_path / "jax_model")
    for prefixes in ([prefix], []):
        jb.generate_files(str(jax_dir), "checkpoint_last",
                          os.path.join(ROOT, "transformer_gan_tpu", "data",
                                       "performance_vocab.txt"),
                          str(tmp_path / "j"), prefixes, configs, **kw)
    port_dir = _port_model_dir(tmp_path / "port_model")
    runs = []
    for prefixes in ([prefix], []):
        runs += bcli.generate_files(str(port_dir), "checkpoint_last",
                                    PACKAGED_VOCAB, str(tmp_path / "t"),
                                    prefixes, configs, device="cpu", **kw)

    got, want = _tree(tmp_path / "t"), _tree(tmp_path / "j")
    assert sorted(got) == sorted(want)
    assert "prime_topk_0.95/midi/1.mid" in got
    assert "uncond_random_0.9/0.txt" in got
    assert [r["tag"] for r in runs] == [
        "prime_topk_0.95", "prime_random_0.9", "uncond_topk_0.95",
        "uncond_random_0.9"]
    assert sum(len(r["midi"]) for r in runs) == 8
    jrepo = jcodec.PerformanceEventRepo()
    for rel in sorted(got):
        if rel.endswith(".mid"):
            run, _, name = rel.split(os.sep)
            jrepo.from_text(str(tmp_path / "t" / run / name.replace(
                ".mid", ".txt")), str(tmp_path / "ref.mid"))
            assert got[rel] == (tmp_path / "ref.mid").read_bytes(), rel


def test_whole_slice_midi_to_midi(inputs, tmp_path):
    """Synthetic MIDI -> the port's encode (the train split's 35-way grid
    and the canonical valid / test npy equal the JAX encode's) -> 2
    training steps at 2 layers on the CPU -> batch generation from a
    valid piece and unconditionally -> MIDI, each re-encoded to a fixed
    point of decode -> encode within 5 passes."""
    maestro = tmp_path / "maestro"
    _run("-m", "transformer_gan_torch.tools.make_synth_corpus", "--out_dir",
         str(maestro), "--n_train", "2", "--n_valid", "3", "--n_test", "3",
         "--seed", "5", "--write_midi")
    args = ["--input_folder", str(maestro), "--mode", "midi_to_npy",
            "--encode_official_maestro"]
    _port_encode(*args, "--output_folder", str(tmp_path / "data"))
    _jax_encode(*args, "--output_folder", str(tmp_path / "jax_data"))
    data = _tree(tmp_path / "data")
    assert data == _tree(tmp_path / "jax_data")
    assert len(data) == 2 * 35 + 3 + 3 + 1

    with open(os.path.join(ROOT, "training_config",
                           "experiment_baseline.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["MODEL"].update(num_layers=2, num_heads=2, units=16, inner_size=32)
    cfg["TRAIN"].update(batch_size=4, max_step=2, log_interval=1,
                        eval_interval=2, mem_length=12, tgt_length=8,
                        warmup_step=1)
    cfg["EVALUATE"].update(batch_size=2, mem_length=16, tgt_length=8)
    cfg["TPU"]["compute_dtype"] = "float32"
    (tmp_path / "cfg.yml").write_text(yaml.safe_dump(cfg))
    trainer = tcli.main(["--data_dir", str(tmp_path / "data"), "--cfg",
                         str(tmp_path / "cfg.yml"), "--work_dir",
                         str(tmp_path / "work"), "--device", "cpu"])
    assert trainer.train_step_num == 2

    runs = bcli.main(["--model_directory", trainer.work_dir,
                      "--checkpoint_name", "checkpoint_last",
                      "--output_base", str(tmp_path / "gen"),
                      "--prefix", str(tmp_path / "data" / "valid" /
                                      "p0000.npy"),
                      "--techniques", "topk,random",
                      "--memory_length", "64", "--generation_length", "48",
                      "--num_conditional_tokens", "20", "--device", "cpu"])
    midi = [m for r in runs for m in r["midi"]]
    assert len(midi) == 2
    runs += bcli.main(["--model_directory", trainer.work_dir,
                       "--checkpoint_name", "checkpoint_last",
                       "--output_base", str(tmp_path / "gen"),
                       "--memory_length", "64", "--generation_length", "48",
                       "--device", "cpu"])
    midi = [m for r in runs for m in r["midi"]]
    assert len(midi) == 3
    repo = PerformanceEventRepo()
    for m in midi:
        with open(m, "rb") as f:
            tmidi.midi_bytes_to_note_sequence(f.read())
        passes = fixed_point_passes(repo, m, str(tmp_path))
        assert passes is not None and passes <= 5, m
