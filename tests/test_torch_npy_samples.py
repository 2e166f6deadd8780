"""``transformer_gan_torch.tools.gen_npy_samples`` (checkpoint -> directory
of ``.npy`` pieces for ``metrics.bert_score``) on the CPU: the output
contract of the JAX tool's tests (tests/test_tools.py: file names, count,
shape, dtype, <S> first, vocab range, distinct lanes, seed determinism),
the files id for id against the JAX tool on the same checkpoint and the
same uniforms (JAX's key stream, handed to the port's sampler as its
noise), and the raw-hidden memory's rolling sampler. Ids exactly."""

import os

import numpy as np
import torch

from transformer_gan_torch import convert
from transformer_gan_torch.config import training_config
from transformer_gan_torch.models import xl as txl
from transformer_gan_torch.tools import gen_npy_samples as tool

torch.set_num_threads(1)


def _port_work_dir(tmp_path, cache_kv=True):
    cfg = training_config()
    cfg.MODEL.update(num_layers=2, num_heads=2, units=32, inner_size=64)
    cfg.TPU.cache_kv = cache_kv
    work = tmp_path / f"work{int(cache_kv)}"
    work.mkdir()
    (work / "config.yml").write_text(cfg.dump())
    xcfg = txl.XLConfig.from_cfg(cfg, 310)
    convert.save_params(str(work / "checkpoint_best.pt"),
                        txl.init_xl_params(xcfg, seed=3))
    return work


def _load(out):
    files = sorted(os.listdir(out))
    return files, [np.load(out / f) for f in files]


def test_output_contract(tmp_path):
    work = _port_work_dir(tmp_path)
    out = tmp_path / "npy_out"
    k = tool.main(["--model_dir", str(work), "--out", str(out), "--num", "4",
                   "--wave", "2", "--seq_len", "16", "--device", "cpu"])
    files, arrs = _load(out)
    assert k == 4 and files == [f"sample_{i:04d}.npy" for i in range(4)]
    for a in arrs:
        assert a.shape == (16,) and a.dtype == np.int32
        assert a[0] == 0
        assert (a >= 0).all() and (a < 310).all()
    assert any(not np.array_equal(arrs[0], a) for a in arrs[1:])


def test_seed_determinism(tmp_path):
    work = _port_work_dir(tmp_path)
    common = ["--model_dir", str(work), "--num", "2", "--wave", "2",
              "--seq_len", "12", "--device", "cpu"]
    outs = [tmp_path / d for d in ("o1", "o2", "o3")]
    for out, seed in zip(outs, ("7", "7", "8")):
        tool.main(common + ["--out", str(out), "--seed", seed])
    a1, a2, a3 = (_load(o)[1] for o in outs)
    assert all(np.array_equal(x, y) for x, y in zip(a1, a2))
    assert any(not np.array_equal(x, y) for x, y in zip(a1, a3))


def test_files_match_the_jax_tool(tmp_path, monkeypatch):
    """The JAX tool on its checkpoint and the port's tool on the same
    parameters (converted, beside the JAX run's config.yml, fp32), 6 pieces
    of 40
    tokens in waves of 3: each wave's noise is the JAX tool's (its key
    split per wave, the per-step [1, wave, V] uniforms turned into gumbel
    noise, drawn one step at a time as the JAX sampler's scan draws it:
    the config's "rbg" keys give other bits under vmap)."""
    import jax
    import jax.numpy as jnp

    from test_tools import _make_work_dir, _run_tool
    from transformer_gan_tpu.train import checkpoint as jck
    from transformer_gan_tpu.config import get_default_cfg_training
    from transformer_gan_tpu.models import xl as jxl
    # the JAX tests' run directory in fp32, with weights large enough that
    # the logits move the argmax away from the noise's
    work = _make_work_dir(tmp_path)
    jcfg = get_default_cfg_training()
    jcfg.defrost()
    jcfg.merge_from_file(str(work / "config.yml"))
    jcfg.TPU.compute_dtype = "float32"
    jp = jxl.init_xl_params(jxl.XLConfig.from_cfg(jcfg, 310, 0), seed=3,
                            base_init=("normal", 0.3))
    work = tmp_path / "work_large"
    jck.save_checkpoint(str(work), "checkpoint_best", {"params": jp})
    (work / "config.yml").write_text(jcfg.dump())
    convert.save_params(str(work / "checkpoint_best.pt"),
                        convert.params_from_jax(jp))
    impl = jcfg.TPU.rng_impl
    seed, num, wave, seq_len = 5, 6, 3, 40

    @jax.jit
    def step_noise(r):
        u = jax.random.uniform(r, (1, wave, 310), dtype=jnp.float32)[0]
        return -jnp.log(-jnp.log(u + 1e-20) + 1e-20)

    rng = jax.random.key(seed, impl=impl)
    noise = []
    for _ in range(num // wave):
        rng, r = jax.random.split(rng)
        noise.append(torch.from_numpy(np.stack([
            np.asarray(step_noise(k))
            for k in jax.random.split(r, seq_len - 1)])))
    waves = iter(noise)

    def jax_draws(length, bsz, V, generator, device=None):
        g = next(waves)
        assert g.shape == (length, bsz, V)
        return g

    monkeypatch.setattr(tool, "gumbel_draws", jax_draws)
    args = ["--model_dir", str(work), "--num", str(num), "--wave", str(wave),
            "--seq_len", str(seq_len), "--seed", str(seed)]
    _run_tool(args + ["--out", str(tmp_path / "jax")])
    tool.main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    jf, ja = _load(tmp_path / "jax")
    pf, pa = _load(tmp_path / "port")
    assert jf == pf and len(pf) == num
    for j, p in zip(ja, pa):
        assert p.dtype == j.dtype == np.int32
        np.testing.assert_array_equal(p, j)
    noise_argmax = torch.cat(noise, dim=1).argmax(-1).T.numpy()
    assert (np.stack(pa)[:, 1:] != noise_argmax).mean() > 0.2


def test_raw_memory_checkpoint(tmp_path):
    """A raw-hidden-memory model samples on the rolling loop; the ids equal
    the same weights' samples on the cached layout (same noise)."""
    outs = []
    for cache_kv in (False, True):
        work = _port_work_dir(tmp_path, cache_kv)
        out = tmp_path / f"out{int(cache_kv)}"
        tool.main(["--model_dir", str(work), "--out", str(out), "--num", "2",
                   "--wave", "2", "--seq_len", "20", "--device", "cpu"])
        outs.append(_load(out)[1])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
