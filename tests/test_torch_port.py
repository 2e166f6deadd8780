"""Properties of the port as a whole: it imports nothing of JAX or of the
JAX package and reads its own vocab file; its entry points run on the card
unless the caller asks for the CPU; and the ``same_length`` window without
memory, where every key of a row is masked, averages the values uniformly
in the attention kernels' plain versions as in the JAX kernels (interpret
mode, fp32, atol 2e-5 as the other attention backward checks)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_gan_torch.ops import attention as tops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


def test_port_imports_nothing_of_jax():
    """Every module of transformer_gan_torch, and chip_smoke.py, imported in
    a fresh interpreter leaves neither jax nor transformer_gan_tpu in
    sys.modules."""
    code = """
import importlib, pkgutil, sys
import transformer_gan_torch
names = [m.name for m in pkgutil.walk_packages(transformer_gan_torch.__path__,
                                                "transformer_gan_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(k for k in sys.modules if k == "jax" or k.startswith("jax.")
             or k.startswith("jaxlib") or k.startswith("transformer_gan_tpu"))
assert not bad, bad
assert len(names) > 20, names
assert {"transformer_gan_torch.bert.mlm", "transformer_gan_torch.bert.tokenizer",
        "transformer_gan_torch.models.bert",
        "transformer_gan_torch.cli.bert_pretrain",
        "transformer_gan_torch.metrics.bleu",
        "transformer_gan_torch.metrics.classifier",
        "transformer_gan_torch.metrics.bert_score",
        "transformer_gan_torch.data.codec", "transformer_gan_torch.data.native",
        "transformer_gan_torch.data.midi", "transformer_gan_torch.data.sequences",
        "transformer_gan_torch.data.performance",
        "transformer_gan_torch.cli.encode",
        "transformer_gan_torch.cli.batch_generate",
        "transformer_gan_torch.tools.make_synth_corpus",
        "transformer_gan_torch.tools.gen_npy_samples",
        "transformer_gan_torch.parallel.mesh",
        "transformer_gan_torch.parallel.sharding",
        "transformer_gan_torch.dryrun"} <= set(names), names
assert "sklearn" not in sys.modules
print(len(names))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


def _port_imports(packages) -> tuple[list, list]:
    """(files, imports naming one of ``packages``) over the port's sources
    and chip_smoke.py, imports inside functions included."""
    import ast
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "transformer_gan_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    found = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            found += [(os.path.relpath(path, ROOT), node.lineno, m)
                      for m in mods if m.split(".")[0] in packages]
    return files, found


def test_port_source_has_no_jax_import():
    """No import statement anywhere in the port's sources or chip_smoke.py,
    inside a function included, names jax or the JAX package."""
    files, found = _port_imports(("jax", "jaxlib", "transformer_gan_tpu"))
    assert len(files) > 20, files
    assert not found, found


def test_port_source_has_no_sklearn_import():
    """The card's machine has no scikit-learn: the classifier metric fits
    its SVM itself (metrics/classifier.py)."""
    files, found = _port_imports(("sklearn", "scikit_learn"))
    assert any(f.endswith(os.path.join("metrics", "classifier.py"))
               for f in files)
    assert not found, found


def test_port_vocab_is_its_own_copy():
    from transformer_gan_torch.config import PACKAGED_VOCAB, inference_config
    port_dir = os.path.join(ROOT, "transformer_gan_torch")
    assert os.path.commonpath([PACKAGED_VOCAB, port_dir]) == port_dir
    assert inference_config().EVENT.vocab_file_path == PACKAGED_VOCAB
    with open(PACKAGED_VOCAB, "rb") as a, open(os.path.join(
            ROOT, "transformer_gan_tpu", "data", "performance_vocab.txt"),
            "rb") as b:
        assert a.read() == b.read()


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Without a card, Trainer, cli.train, cli.generate,
    cli.batch_generate, MlmTrainer, cli.bert_pretrain and the dry run raise
    unless the caller passes the CPU."""
    from transformer_gan_torch import _native
    from transformer_gan_torch.bert.mlm import MlmTrainer
    from transformer_gan_torch.cli import batch_generate as bcli
    from transformer_gan_torch.cli import bert_pretrain
    from transformer_gan_torch.cli import generate as gcli
    from transformer_gan_torch.cli import train as tcli
    from transformer_gan_torch.config import inference_config, training_config
    from transformer_gan_torch.train.loop import Trainer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _native.resolve_device(None)
    assert _native.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(training_config(), str(tmp_path / "data"), str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--data_dir", str(tmp_path / "data"), "--work_dir",
                   str(tmp_path), "--cfg", os.path.join(
                       ROOT, "training_config", "experiment_baseline.yml")])
    icfg = inference_config()
    icfg.OUTPUT.output_txt_directory = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gcli.main(icfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bcli.main(["--model_directory", str(tmp_path / "model"),
                   "--output_base", str(tmp_path / "gen")])
    from transformer_gan_torch.config import PACKAGED_VOCAB
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MlmTrainer(str(tmp_path / "data"), str(tmp_path / "bert"),
                   PACKAGED_VOCAB)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bert_pretrain.main(["--train_data_file", str(tmp_path / "data"),
                            "--output_dir", str(tmp_path / "bert"),
                            "--vocab_file", PACKAGED_VOCAB])
    from transformer_gan_torch import dryrun
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["2"])


# ---------------------------------------------------------------------------
# same_length without memory: every key masked, a uniform average
# ---------------------------------------------------------------------------

H, DH = 2, 8


@pytest.fixture
def interpret(monkeypatch):
    from transformer_gan_tpu.ops import pallas_attention as pa
    from transformer_gan_tpu.ops import pallas_attention_v2 as pa2
    monkeypatch.setattr(pa, "INTERPRET", True)
    monkeypatch.setattr(pa2, "INTERPRET", True)
    monkeypatch.setattr(pa2, "_FAST_BF16_SHIFT", [False])
    return pa, pa2


def _a(rng, *shape, s=0.5):
    return (rng.randn(*shape) * s).astype(np.float32)


def _close(got, ref, atol=2e-5):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   atol=atol, rtol=0)


@pytest.mark.parametrize("q", [8, 16])
def test_same_length_no_memory_v2_matches_pallas(interpret, q):
    """K1f (o, l) and all five K1b outputs at M 0, same_length. The JAX
    package runs this window on its BD-input kernel (K2f / K2b: its K1
    needs memory), so that kernel, fed BD[i, j] = qrr_i . rk[q-1-i+j], is
    the reference; dqrr and drk are its dBD through the same window."""
    pa, _ = interpret
    B, M = 2, 0
    rng = np.random.RandomState(q)
    ops = [_a(rng, H, B, q, DH), _a(rng, H, B, q, DH), _a(rng, H, B, M, DH),
           _a(rng, H, B, M, DH), _a(rng, H, B, q, DH), _a(rng, H, B, q, DH),
           _a(rng, H, M + 2 * q, DH)]
    ops[6][:, M + q:] = 0.0
    qrw, qrr, _, _, k, v, rk = ops
    do = _a(rng, H, B, q, DH, s=1.0)
    c = (q - 1 - np.arange(q))[:, None] + np.arange(q)[None, :]   # [i, j]
    w = np.einsum("hbid,hcd->hbic", qrr, rk)
    bd = np.take_along_axis(w, np.broadcast_to(c, (H, B, q, q)), axis=3)
    flat = [x.reshape(H * B, q, -1) for x in (qrw, k, v, bd)]
    jargs = [jnp.asarray(x) for x in flat]
    jc, jr, js = (jnp.asarray([0], jnp.int32), jnp.zeros((H * B,), jnp.int32),
                  jnp.zeros((1,), jnp.int32))
    jo, jm, jl = pa._fused_fwd_raw(*jargs, jc, jr, js, 1.0, True, 0.0)
    jdq, jdk, jdv, jdbd = pa._fused_bwd_raw(
        *jargs, jm, jl, jc, jr, js, jnp.asarray(do.reshape(H * B, q, DH)), 1.0,
        True, 0.0)
    dbd = np.asarray(jdbd).reshape(H, B, q, q)
    dw = np.zeros((H, B, q, 2 * q), np.float32)
    np.put_along_axis(dw, np.broadcast_to(c, (H, B, q, q)), dbd, axis=3)
    ref = [np.asarray(x).reshape(H, B, q, DH) for x in (jdq, jdk, jdv)]
    ref = [ref[0], np.einsum("hbic,hcd->hbid", dw, rk), ref[1], ref[2],
           np.einsum("hbic,hbid->hcd", dw, qrr)]
    t = [torch.from_numpy(x) for x in ops]
    o, m, l = tops.xl_attn_fwd_v2(*t, 0, None, True)
    _close((o.reshape(H * B, q, DH), l.reshape(H * B, 1, q)), (jo, jl))
    # every row averages all q values uniformly
    np.testing.assert_allclose(
        o.numpy(), np.broadcast_to(v.mean(2, keepdims=True), o.shape),
        atol=1e-6)
    got = tops.xl_attn_bwd_v2(*t, m, l, o, torch.from_numpy(do), 0, None, True)
    _close(got, ref)


@pytest.mark.parametrize("q", [8, 16])
def test_same_length_no_memory_v1_matches_pallas(interpret, q):
    """K2f (o, l) and K2b (dq, dk, dv, dbd) at M 0, same_length."""
    pa, _ = interpret
    BH, scale = 4, 1.0 / DH ** 0.5
    rng = np.random.RandomState(10 + q)
    ops = [_a(rng, BH, q, DH), _a(rng, BH, q, DH), _a(rng, BH, q, DH),
           _a(rng, BH, q, q)]
    do = _a(rng, BH, q, DH, s=1.0)
    jargs = [jnp.asarray(x) for x in ops]
    jc, jr, js = (jnp.asarray([0], jnp.int32), jnp.zeros((BH,), jnp.int32),
                  jnp.zeros((1,), jnp.int32))
    jo, jm, jl = pa._fused_fwd_raw(*jargs, jc, jr, js, scale, True, 0.0)
    ref = pa._fused_bwd_raw(*jargs, jm, jl, jc, jr, js, jnp.asarray(do), scale,
                            True, 0.0)
    t = [torch.from_numpy(x) for x in ops]
    o, m, l = tops.xl_attn_fwd_v1(*t, 0, None, scale, True)
    _close((o, l), (jo, jl))
    got = tops.xl_attn_bwd_v1(*t, m, l, o, torch.from_numpy(do), 0, None,
                              scale, True)
    _close(got, ref)
