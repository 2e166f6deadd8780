"""MLE training trajectories of the port against the JAX package, fp32 on
the CPU, through ``transformer_gan_torch/tools/convergence_parity.py`` and
the JAX package's ``tools/convergence_parity.py`` at its operating point
(2 layers, 4 heads, d_model 64, tgt 32, mem 32, B 8 in 2 micro-chunks,
lr 1e-3, inv_sqrt with a 10-step warmup, clip 0.25, dropout 0).

Both sides train from the JAX tool's initial weights on one recorded
stream (the JAX tool's ``record_batches``) for 60 steps and evaluate every
20: the JAX side is the tool's own ``run_ours`` (raw-hidden memory), and
for the K/V-cache layout the same function with ``TPU.cache_kv`` on and
``use_pallas_attention`` off; the port side is ``run_port`` on the CPU.
Every train NLL and every val NLL within 1e-4 of JAX's (the JAX tool holds
its trajectory to the torch reference within 1.7e-5 over 200 steps), and
the val NLL falls by more than 0.2, so the runs train. LAMB takes lr 2e-2
on both sides (at the tool's 1e-3 its trust ratios move each leaf by about
lr times its norm a step, and the val NLL falls by 0.01 in 60 steps; at
2e-2 by 0.5). The port's corpus and stream equal the JAX tool's."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import convergence_parity as jtool  # noqa: E402  (the JAX package's tool)
from transformer_gan_torch.tools import convergence_parity as ttool  # noqa: E402

torch.set_num_threads(1)

STEPS, EVAL_EVERY, TOL = 60, 20, 1e-4
LAMB_LR = 2e-2


@pytest.fixture(scope="module")
def stream():
    train_pieces, val_pieces = jtool.make_corpus(0)
    return jtool.record_batches(train_pieces, val_pieces, STEPS)


def test_corpus_and_stream_match_jax_tool(stream):
    jtrain, jval = jtool.make_corpus(0)
    ttrain, tval = ttool.make_corpus(0)
    assert len(ttrain) == len(jtrain) == 30 and len(tval) == len(jval) == 8
    for a, b in zip(ttrain + tval, jtrain + jval):
        np.testing.assert_array_equal(a, b)
    tb, tv, tpad = ttool.record_batches(ttrain, tval, STEPS)
    jb, jv, jpad = stream
    assert tpad == jpad and len(tb) == len(jb) == STEPS
    for t, j in zip(tb, jb):
        for x, y in zip(t, j):
            np.testing.assert_array_equal(x, y)
    assert len(tv) == len(jv) > 0
    for t, j in zip(tv, jv):
        np.testing.assert_array_equal(t[0], j[0])
        np.testing.assert_array_equal(t[1], j[1])
        assert t[2] == j[2] and t[3] == j[3]


def trajectories(stream, optim: str, cache_kv: bool) -> tuple:
    """(JAX train NLL, JAX val NLL, port train NLL, port val NLL) of one
    case from the JAX tool's initial weights."""
    raw_cfg = jtool.make_cfg

    def cached_cfg():
        cfg = raw_cfg()
        cfg.defrost()
        cfg.TPU.cache_kv = True
        cfg.TPU.use_pallas_attention = False
        cfg.freeze()
        return cfg

    lr = LAMB_LR if optim == "lamb" else ttool.LR
    train_b, val_b, pad_id = stream
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtool, "LR", lr)
        if cache_kv:
            mp.setattr(jtool, "make_cfg", cached_cfg)
        jtrain, jval, init = jtool.run_ours(train_b, val_b, pad_id,
                                           EVAL_EVERY, optim)
    ttrain, tval = ttool.run_port(train_b, val_b, pad_id, EVAL_EVERY, init,
                                  optim, device="cpu", cache_kv=cache_kv,
                                  lr=lr)
    return jtrain, jval, ttrain, tval


@pytest.mark.parametrize("optim,cache_kv", [("adam", False), ("lamb", False),
                                            ("adam", True)])
def test_trajectory_matches_jax(stream, optim, cache_kv):
    """60 steps and 3 evals of the port's MLE step against the JAX step."""
    jtrain, jval, ttrain, tval = trajectories(stream, optim, cache_kv)
    assert len(ttrain) == len(jtrain) == STEPS
    assert len(tval) == len(jval) == STEPS // EVAL_EVERY
    assert np.isfinite(ttrain).all() and np.isfinite(tval).all()
    np.testing.assert_allclose(ttrain, jtrain, rtol=0, atol=TOL)
    np.testing.assert_allclose(tval, jval, rtol=0, atol=TOL)
    assert tval[-1] < tval[0] - 0.2
    assert ttool.max_gap(ttrain, jtrain) <= TOL


def test_init_params_are_the_jax_tools():
    """The port's initial weights for the card (``init_params``) are the
    JAX tool's ``init_xl_params(seed=7)`` at its defaults, bit for bit."""
    from transformer_gan_torch import convert
    from transformer_gan_tpu.models import xl as jxl
    jp = jxl.init_xl_params(jxl.XLConfig.from_cfg(jtool.make_cfg(), 310),
                            seed=7)
    ref = convert.params_from_jax(jp)
    got = convert.params_from_jax(ttool.init_params())
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy())


def test_entry_point_refuses_no_card_and_writes_trajectories(tmp_path):
    out = str(tmp_path / "res.json")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttool.main(["--steps", "2", "--eval_every", "1", "--out", out])
    res = ttool.main(["--device", "cpu", "--steps", "4", "--eval_every", "2",
                      "--route", "plain", "--out", out])
    assert len(res["train_nll"]) == 4 and len(res["val_nll"]) == 2
    assert res["route"] == "plain" and os.path.exists(out)


def test_tools_import_nothing_of_jax():
    """The two trajectory tools, imported in a fresh interpreter, leave
    neither jax nor the JAX package in sys.modules."""
    import subprocess
    code = ("import sys\n"
            "import transformer_gan_torch.tools.convergence_parity\n"
            "import transformer_gan_torch.tools.gan_parity\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'transformer_gan_tpu')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def main():
    """Print the CPU table of the trajectories (PERF.md): per eval the
    step, JAX's and the port's val NLL and their gap, and each case's
    largest train and val NLL gap.

        python tests/test_torch_convergence_parity.py"""
    import jax
    jax.config.update("jax_platforms", "cpu")
    train_pieces, val_pieces = jtool.make_corpus(0)
    stream = jtool.record_batches(train_pieces, val_pieces, STEPS)
    print("| case | step | JAX val NLL | port val NLL | gap | max train gap |")
    print("| --- | --- | --- | --- | --- | --- |")
    for optim, cache_kv in (("adam", False), ("lamb", False), ("adam", True)):
        jtrain, jval, ttrain, tval = trajectories(stream, optim, cache_kv)
        case = f"{optim}, {'cached' if cache_kv else 'raw'}"
        tgap = ttool.max_gap(ttrain, jtrain)
        for k, (j, t) in enumerate(zip(jval, tval)):
            print(f"| {case} | {(k + 1) * EVAL_EVERY} | {j:.6f} | {t:.6f} | "
                  f"{abs(t - j):.2e} | {tgap:.2e} |")


if __name__ == "__main__":
    main()
