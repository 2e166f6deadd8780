"""GAN training trajectories of the port against the JAX package, fp32 on
the CPU, through ``transformer_gan_torch/tools/gan_parity.py`` and the JAX
package's ``tools/gan_parity.py`` at its operating point (2 layers, 2 heads,
d_model 32, cnn / rsgan, dis tgt 16, mem 16, context 3, batch_chunk 2,
sample_chunks_mem 2, B 4, clip 0.25, every dropout 0): 6 dis + gen phase
pairs from the JAX trainer's initial weights on the same recorded real
batches.

* The rolling sampler (raw-hidden memory), truncate_backprop off and on:
  the JAX side is the tool's own ``make_data`` / ``run_ours`` with the
  recorded per-phase uniforms injected, the port's phases take the same
  uniforms through ``models/gan.RecordedDraws``.
* The K/V-cache layout (the chunked sampler and the batched recompute):
  JAX cannot inject noise there, so the test drives the JAX ``GanPhases``
  with its own keys and hands the port the draws of those keys
  (``test_torch_gan.JaxDraws``), micro-batch by micro-batch.

The tool's lrs (1e-3) leave the losses at log 4 and 4 log 2 to the fourth
decimal, where a port that barely trains would pass. Both lrs here are
5e-3, so the dis loss leaves log 4 by more than 20 times the tolerance and
the gen loss by more. Higher lrs do not tighten the check: at 1e-2 the port
against itself, with only its CPU thread count changed, drifts by 1.8e-4 in
the gen loss over 6 phases, as far as it drifts from JAX. Adam's update
normalises each gradient entry, so an entry that vanishes within fp32
rounding moves its weight by a coin toss of up to lr; under rsgan the
critic's last two biases have an exact gradient of 0 and do so every step.
The losses are piecewise constant in the generator (the samples are hard
one-hots), and a weight so moved shows only where it flips a near-tied
sample.

Every logged loss within 5e-5 of JAX's. The weights after the run, by the
same rule: Adam moves a weight by at most about lr an update (|m^| / sqrt
(v^) is at most 1.02 over 6 updates at b1 0.9, b2 0.999), so every weight of
each network within 2 n lr of JAX's after its n updates, and at most 5% of
them beyond 0.1 lr (the coin tosses; at 5e-3 the critic reads 2.9%, the
generator 0.6%).

The control plants a defect that the first phase cannot show: the port's
critic at half JAX's lr. Its first dis loss, which comes before any update,
agrees within the tolerance, and the run must break it."""

import contextlib
import dataclasses
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import gan_parity as jtool  # noqa: E402  (the JAX package's tool)
from test_torch_gan import JaxDraws  # noqa: E402
from transformer_gan_torch.tools import gan_parity as ttool  # noqa: E402

torch.set_num_threads(1)

N_PHASES, TOL, LR = 6, 5e-5, 5e-3
CASES = {"rolling": (False, False), "rolling_truncate": (True, False),
         "cached": (False, True)}


@contextlib.contextmanager
def jax_lrs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtool, "GEN_LR", LR)
        mp.setattr(jtool, "DIS_LR", LR)
        yield


def jax_cfg(truncate: bool, cache_kv: bool):
    with jax_lrs():
        cfg = jtool.make_cfg(truncate)
    if cache_kv:
        cfg.defrost()
        cfg.TPU.cache_kv = True
        cfg.freeze()
    return cfg


def run_jax_cached(cfg, data_dir, recorded):
    """``run_ours`` on the K/V-cache layout, where JAX draws from its keys:
    the same phases without noise, and the port's draws of each
    micro-batch recomputed from the key the phase is about to split
    (``GanPhases._split_rng``, then one key a micro-batch)."""
    from transformer_gan_tpu.parallel import mesh as pmesh
    from transformer_gan_tpu.train.loop import Trainer
    mesh = pmesh.make_mesh(1, devices=jax.devices("cpu")[:1])
    bc, chunks = cfg.DISCRIMINATOR.batch_chunk, cfg.DISCRIMINATOR.sample_chunks_mem
    draws, losses = [], {"log_dis_loss": [], "log_gen_loss": []}
    with tempfile.TemporaryDirectory() as wd:
        trainer = Trainer(cfg, data_dir=data_dir, work_dir=wd, debug=True,
                          mesh=mesh)
        gan = trainer.gan
        gan.dis_cfg = dataclasses.replace(gan.dis_cfg, dropout=0.0)
        gan._build_steps()
        gan._dis_stream = iter([(b, None) for b in recorded])
        gen_init = jax.tree.map(np.asarray, trainer.state.params)
        dis_init = jax.tree.map(np.asarray, gan.dis_params)
        for k in range(len(recorded) // 2):
            for run, log in ((gan.dis_phase, "log_dis_loss"),
                             (gan.gen_phase, "log_gen_loss")):
                _, r = jax.random.split(gan.rng)
                draws += [JaxDraws(key, chunks)
                          for key in jax.random.split(r, bc)]
                before = getattr(gan, log)
                run(k + 1)
                losses[log].append(float(getattr(gan, log) - before))
        gen_final = jax.tree.map(np.asarray, trainer.state.params)
        dis_final = jax.tree.map(np.asarray, gan.dis_params)
    return (losses["log_dis_loss"], losses["log_gen_loss"], gen_init,
            dis_init, gen_final, dis_final, lambda: list(draws))


@pytest.fixture(scope="module")
def data():
    d, recorded, noises = jtool.make_data(N_PHASES)
    return d, recorded, noises


@pytest.fixture(scope="module")
def jax_runs(data):
    """The JAX side of each case, run once for the module, with a function
    that makes the port's draws of it."""
    d, recorded, noises = data
    cache = {}

    def get(case):
        if case not in cache:
            truncate, cache_kv = CASES[case]
            cfg = jax_cfg(truncate, cache_kv)
            if cache_kv:
                cache[case] = run_jax_cached(cfg, d, recorded)
            else:
                cache[case] = (*jtool.run_ours(cfg, d, recorded, noises),
                               lambda: ttool.recorded_draws(noises))
        return cache[case]

    return get


def port_run(case, data, jax_res, **cfg_over):
    d, recorded, _ = data
    truncate, cache_kv = CASES[case]
    _, _, gen_init, dis_init, _, _, draws = jax_res
    cfg = ttool.make_cfg(truncate, cache_kv, gen_lr=LR,
                         dis_lr=cfg_over.get("dis_lr", LR))
    return ttool.run_port(cfg, d, recorded, draws(), gen_init, dis_init,
                          device="cpu")


def drift_ok(port, jax_final, lr: float, n: int) -> tuple[bool, dict]:
    drift = ttool._max_drift(port, jax_final)
    share = ttool.drift_share(port, jax_final, 0.1 * lr)
    return drift <= 2 * n * lr and share <= 0.05, {"max": drift,
                                                    "share": share}


def test_make_data_matches_jax_tool(data, tmp_path):
    _, jrec, jnoises = data
    trec, tnoises = ttool.make_data(N_PHASES, str(tmp_path))
    assert len(trec) == len(jrec) == 2 * N_PHASES
    for a, b in zip(trec, jrec):
        np.testing.assert_array_equal(a, b)
    for (td, tg), (jd, jg) in zip(tnoises, jnoises):
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tg, jg)
    assert ttool.n_gen_steps() == jtool.N_GEN_STEPS


@pytest.mark.parametrize("case", list(CASES))
def test_trajectory_matches_jax(data, jax_runs, case):
    """6 phase pairs: every logged dis and gen loss, and the drift rule."""
    jres = jax_runs(case)
    jdis, jgen, gen_init, dis_init, jgen_final, jdis_final, _ = jres
    tdis, tgen, tgen_final, tdis_final = port_run(case, data, jres)
    assert len(tdis) == len(jdis) == len(tgen) == len(jgen) == N_PHASES
    assert np.isfinite(tdis).all() and np.isfinite(tgen).all()
    # the losses move: the dis loss off log 4, the gen loss off its start
    assert np.abs(np.asarray(jdis) - np.log(4)).max() >= 20 * TOL
    assert np.abs(np.asarray(jgen) - jgen[0]).max() >= 20 * TOL
    np.testing.assert_allclose(tdis, jdis, rtol=0, atol=TOL)
    np.testing.assert_allclose(tgen, jgen, rtol=0, atol=TOL)
    for name, got, ref, init in (("gen", tgen_final, jgen_final, gen_init),
                                 ("dis", tdis_final, jdis_final, dis_init)):
        ok, stats = drift_ok(got, ref, LR, N_PHASES)
        assert ok, (name, stats)
        assert ttool._max_drift(got, init) > 0.5 * LR     # it trained


def test_init_weights_are_the_jax_trainers(jax_runs):
    """``init_weights`` (what the card's runs start from) is what the JAX
    trainer draws for the same config, bit for bit."""
    _, _, gen_init, dis_init, _, _, _ = jax_runs("rolling")
    gen, dis = ttool.init_weights(ttool.make_cfg(False, False))
    for got, ref in ((gen, gen_init), (dis, dis_init)):
        ref = ttool.flat_tree(ref)
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_planted_control_breaks_tolerance(data, jax_runs):
    """The port's critic at half JAX's lr: the first dis loss agrees (it
    comes before the first update), the run does not."""
    jres = jax_runs("rolling")
    jdis, jgen = jres[0], jres[1]
    tdis, tgen, tgen_final, _ = port_run("rolling", data, jres,
                                         dis_lr=LR / 2)
    assert abs(tdis[0] - jdis[0]) <= TOL
    gap = max(np.abs(np.asarray(tdis) - jdis).max(),
              np.abs(np.asarray(tgen) - jgen).max())
    assert gap > TOL, gap


def test_entry_point_refuses_no_card_and_writes_losses(tmp_path):
    out = str(tmp_path / "res.json")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttool.main(["--phases", "1", "--out", out])
    res = ttool.main(["--device", "cpu", "--phases", "1", "--route", "plain",
                      "--out", out])
    assert len(res["dis_loss"]) == len(res["gen_loss"]) == 1
    assert res["route"] == "plain" and os.path.exists(out)


def main():
    """Print the CPU table of the trajectories (PERF.md): per case and
    phase pair JAX's and the port's dis and gen losses and their gaps.

        python tests/test_torch_gan_parity.py"""
    jax.config.update("jax_platforms", "cpu")
    d, recorded, noises = jtool.make_data(N_PHASES)
    data = (d, recorded, noises)
    print("| case | phase | JAX dis | port dis | gap | JAX gen | port gen | "
          "gap |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- |")
    for case, (truncate, cache_kv) in CASES.items():
        cfg = jax_cfg(truncate, cache_kv)
        jres = (run_jax_cached(cfg, d, recorded) if cache_kv else
                (*jtool.run_ours(cfg, d, recorded, noises),
                 lambda: ttool.recorded_draws(noises)))
        tdis, tgen, _, _ = port_run(case, data, jres)
        for k in range(N_PHASES):
            jd, jg = jres[0][k], jres[1][k]
            print(f"| {case} | {k + 1} | {jd:.7f} | {tdis[k]:.7f} | "
                  f"{abs(tdis[k] - jd):.1e} | {jg:.7f} | {tgen[k]:.7f} | "
                  f"{abs(tgen[k] - jg):.1e} |")


if __name__ == "__main__":
    main()
