"""The port's trainer end to end on the CPU (transformer_gan_torch.cli.train
on a tiny random corpus): the run directory's checkpoints round-trip,
``--restart`` resumes the step and the schedule, the run directory feeds
``transformer_gan_torch.cli.generate.main`` unchanged, a warm start loads
matching parameters, the unported features refuse, and a JAX training
checkpoint (orbax, through its numpy archive) converts into the port's and
back. Every run asks for the CPU (``--device cpu``)."""

import glob
import os

import numpy as np
import pytest
import torch
import yaml

from chip_smoke import write_random_corpus
from transformer_gan_torch import convert
from transformer_gan_torch.cli import generate as gcli
from transformer_gan_torch.cli import train as tcli
from transformer_gan_torch.config import PACKAGED_VOCAB, inference_config
from transformer_gan_torch.train import checkpoint as ckpt
from transformer_gan_torch.train import optim as topt

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ("--device", "cpu")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    write_random_corpus(str(d), PACKAGED_VOCAB, n_train=12, train_len=60,
                        n_eval=3, eval_len=40, seed=0)
    return str(d)


def _cfg_file(tmp_path, **train):
    """experiment_baseline.yml cut to a tiny model and run."""
    with open(os.path.join(ROOT, "training_config",
                           "experiment_baseline.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["MODEL"].update(num_layers=2, num_heads=2, units=16, inner_size=32)
    cfg["TRAIN"].update(batch_size=4, batch_chunk=2, max_step=6,
                        log_interval=2, eval_interval=3, mem_length=12,
                        tgt_length=8, warmup_step=2)
    cfg["TRAIN"].update(train)
    cfg["EVALUATE"].update(batch_size=2, mem_length=16, tgt_length=8)
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_cli_trains_restarts_and_feeds_generation(tmp_path, corpus):
    cfg = _cfg_file(tmp_path)
    trainer = tcli.main(["--data_dir", corpus, "--cfg", cfg,
                         "--work_dir", str(tmp_path / "work"), *CPU])
    run = trainer.work_dir
    assert trainer.train_step_num == 6
    for name in ("checkpoint_last", "checkpoint_best"):
        assert ckpt.checkpoint_exists(run, name)
    assert os.path.exists(os.path.join(run, "config.yml"))
    with open(os.path.join(run, "train_rank0.log")) as f:
        log = f.read()
    assert "Train Step 6/6" in log and "Eval step 6" in log
    assert "| End of training | test nll" in log

    # final_best_eval left checkpoint_best's weights live
    best, _, _ = ckpt.load_checkpoint(run, "checkpoint_best")
    live = trainer.state.params()
    assert all(torch.equal(best[k], live[k].detach()) for k in live)
    params, opt, meta = ckpt.load_checkpoint(run, "checkpoint_last")
    assert opt.count == 6 and meta["train_step"] == 6
    assert torch.equal(opt.mu, trainer.state.opt_state.mu)
    assert meta["vocab"][:2] == ["<S>", "<PAD>"]

    # the run directory feeds the generation CLI unchanged
    icfg = inference_config()
    icfg.MODEL.model_directory = run
    icfg.MODEL.checkpoint_name = "checkpoint_last"
    icfg.MODEL.memory_length = 16
    icfg.OUTPUT.output_txt_directory = str(tmp_path / "gen")
    icfg.GENERATION.generation_length = 10
    icfg.INPUT.num_midi_files = 2
    summary = gcli.main(icfg, "cpu", torch.Generator().manual_seed(0))
    assert len(summary["files"]) == 2 and summary["tokens"] == 20

    # --restart resumes the step count, the optimizer and the schedule
    cfg2 = _cfg_file(tmp_path, max_step=8)
    resumed = tcli.main(["--data_dir", corpus, "--cfg", cfg2,
                         "--work_dir", run, "--restart", *CPU])
    assert resumed.train_step_num == 8
    assert resumed.state.opt_state.count == 8
    _, opt2, meta2 = ckpt.load_checkpoint(run, "checkpoint_last")
    assert meta2["train_step"] == 6 and opt2.count == 6  # eval at 3, 6 only
    sched = resumed.schedule
    assert sched(8) == topt.make_schedule("inv_sqrt", 0.004, 8, 0.0001, 2)(8)


def test_checkpoint_round_trip(tmp_path, corpus):
    """A checkpoint saved at the last step reads back as the live
    parameters and optimizer state, through the flat layout."""
    cfg = _cfg_file(tmp_path, max_step=3, eval_interval=3)
    first = tcli.main(["--data_dir", corpus, "--cfg", cfg,
                       "--work_dir", str(tmp_path / "a"), *CPU])
    state = first.state
    params, opt, _ = ckpt.load_checkpoint(first.work_dir, "checkpoint_last")
    assert torch.equal(state.layout.flatten(params), state.flat.detach())
    assert opt.count == state.opt_state.count == 3
    assert torch.equal(opt.mu, state.opt_state.mu)
    assert torch.equal(opt.nu, state.opt_state.nu)
    assert opt.lr_scale == state.opt_state.lr_scale


def test_warm_start_and_unported_features(tmp_path, corpus):
    cfg = _cfg_file(tmp_path, max_step=3, eval_interval=3)
    first = tcli.main(["--data_dir", corpus, "--cfg", cfg,
                       "--work_dir", str(tmp_path / "a"), *CPU])
    warm = _cfg_file(tmp_path, max_step=1, eval_interval=100,
                     load_from_previous=os.path.join(first.work_dir,
                                                     "checkpoint_last"))
    from transformer_gan_torch.config import training_config
    from transformer_gan_torch.train.loop import Trainer
    tr = Trainer(training_config(warm), corpus, str(tmp_path / "b"),
                 device="cpu")
    loaded = convert.load_params(os.path.join(first.work_dir,
                                              "checkpoint_last.pt"))
    live = tr.state.params()
    assert all(torch.equal(live[k].detach(), loaded[k]) for k in loaded)
    # PPO, the quality metrics and remat are ported; bf16 master parameters
    # are refused, as in the JAX package
    for over in ({"DISCRIMINATOR": {"type": "bert", "start_iter": 0,
                                    "BERT": {"loss_type": "ppo",
                                             "random_weights": True,
                                             "hidden_size": 24,
                                             "num_hidden_layers": 1,
                                             "num_attention_heads": 2,
                                             "intermediate_size": 48}}},
                 {"METRICS": {"use_bleu": True, "use_self_bleu": True,
                              "CLASSIFIER": {"use_classifier": True}}}):
        c = training_config(warm).merge(over)
        Trainer(c, corpus, str(tmp_path / "c"), device="cpu")
    c = training_config(warm).merge({"TPU": {"remat": True}})
    remat = Trainer(c, corpus, str(tmp_path / "c"), device="cpu")
    remat.train()
    assert remat.train_step_num == 1
    c = training_config(warm).merge({"TPU": {"param_dtype": "bfloat16"}})
    with pytest.raises(NotImplementedError):
        Trainer(c, corpus, str(tmp_path / "c"), device="cpu")


def test_jax_training_checkpoint_converts(tmp_path):
    """A JAX training checkpoint (orbax: params, FusedOptState, metadata)
    becomes the port's checkpoint files through its numpy archive; its
    optimizer state converts back to the JAX FusedOptState unchanged."""
    import jax
    import jax.numpy as jnp
    from transformer_gan_tpu.models import xl as jxl
    from transformer_gan_tpu.train import checkpoint as jck
    from transformer_gan_tpu.train import optim as jopt
    jcfg = jxl.XLConfig(n_layer=1, n_head=2, d_model=8, d_inner=16)
    jp = jxl.init_xl_params(jcfg, seed=1)
    jo = jopt.make_optimizer("adam", 1e-3, jopt.constant_schedule(0), 1.0)
    js = jo.init(jp)
    js = js._replace(count=jnp.asarray(7, jnp.int32),
                     mu=js.mu + 0.5, nu=js.nu + 0.25)
    meta = {"train_step": 7, "best_val_loss": 3.5, "vocab": ["<S>", "<PAD>"]}
    jck.save_checkpoint(str(tmp_path / "jax"), "checkpoint_last",
                        {"params": jp, "opt_state": js}, meta)
    from test_torch_params import write_archive
    out = convert.import_archive(
        write_archive(str(tmp_path / "jax" / "checkpoint_last")),
        str(tmp_path / "port"))
    assert out.endswith("checkpoint_last.pt")
    params, opt, meta2 = ckpt.load_checkpoint(str(tmp_path / "port"),
                                              "checkpoint_last")
    ref = convert.params_from_jax(jp)
    assert all(torch.equal(params[k], ref[k]) for k in ref)
    assert opt.count == 7 and meta2 == meta
    np.testing.assert_array_equal(opt.mu.numpy(), np.asarray(js.mu))
    d = convert.opt_state_to_jax(opt)
    back = jopt.FusedOptState(
        count=jnp.asarray(d["count"]), mu=jnp.asarray(d["mu"]),
        nu=jnp.asarray(d["nu"]),
        lr=jopt.ScaleByLrState(lr_scale=jnp.asarray(d["lr"]["lr_scale"])))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(back.count) == 7 and float(back.lr.lr_scale) == 1.0
