"""Port parameters (transformer_gan_torch) against the JAX package:
seeded init bit for bit, pytree conversion both ways, orbax checkpoints and
the port's own parameter files."""

import jax
import numpy as np
import pytest
import torch

from transformer_gan_torch import convert
from transformer_gan_torch.models import xl as txl
from transformer_gan_tpu.models import xl as jxl

torch.set_num_threads(1)

SMALL = dict(n_layer=2, n_head=2, d_model=16, d_inner=32, n_token=310)


def _flat_jax(tree):
    out = {}
    for k, v in tree.items():
        if k == "layers":
            for i, layer in enumerate(v):
                for name, arr in layer.items():
                    out[f"layers.{i}.{name}"] = np.asarray(arr)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.mark.parametrize("tie,base_init", [
    (True, ("normal", 0.01)),
    (False, ("normal", 0.02)),
    (True, ("uniform", 0.1)),
])
def test_init_xl_params_bit_exact(tie, base_init):
    jp = jxl.init_xl_params(jxl.XLConfig(tie_embedding=tie, **SMALL), seed=5,
                            base_init=base_init)
    tp = txl.init_xl_params(txl.XLConfig(tie_embedding=tie, **SMALL), seed=5,
                            base_init=base_init)
    ref = _flat_jax(jp)
    assert set(tp) == set(ref)
    for k, v in ref.items():
        assert tp[k].dtype == torch.float32
        np.testing.assert_array_equal(tp[k].numpy(), v, err_msg=k)


def test_init_rejects_unknown_initializer():
    with pytest.raises(ValueError):
        txl.init_xl_params(txl.XLConfig(**SMALL), base_init=("xavier", 1.0))


def test_pytree_conversion_round_trip():
    jp = jxl.init_xl_params(jxl.XLConfig(tie_embedding=False, **SMALL), seed=1)
    flat = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    back = convert.params_to_jax(flat)
    assert len(back["layers"]) == SMALL["n_layer"]
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(jp)[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), b)


def archive_name(path) -> str:
    """A pytree path as the archive names it (README, "Converting a JAX
    checkpoint"): dict keys, list indices and field names joined by '/'."""
    return "/".join(str(getattr(k, "key", getattr(k, "idx", getattr(
        k, "name", k)))) for k in path)


def write_archive(ckpt_dir: str) -> str:
    """The README recipe: an orbax checkpoint's leaves into ``<dir>.npz``."""
    from transformer_gan_tpu.train.checkpoint import load_checkpoint
    leaves = jax.tree_util.tree_flatten_with_path(load_checkpoint(ckpt_dir))[0]
    np.savez(ckpt_dir + ".npz",
             **{archive_name(p): np.asarray(v) for p, v in leaves})
    return ckpt_dir + ".npz"


def test_orbax_checkpoint_round_trip(tmp_path):
    """A JAX checkpoint written by the training code imports into the port
    bit for bit, through its numpy archive."""
    from transformer_gan_tpu.train import checkpoint as ckpt
    jp = jxl.init_xl_params(jxl.XLConfig(**SMALL), seed=3)
    ckpt.save_checkpoint(str(tmp_path), "checkpoint_last", {"params": jp})
    got = convert.tensors_from_archive(convert.read_archive(
        write_archive(str(tmp_path / "checkpoint_last"))))
    ref = _flat_jax(jp)
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    # and back: the port's params as a JAX pytree restore the same tree
    tree = convert.params_to_jax(got)
    ckpt.save_checkpoint(str(tmp_path), "from_port", {"params": tree})
    again = ckpt.load_checkpoint(str(tmp_path / "from_port"))["params"]
    for k, v in _flat_jax(again).items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)


def test_port_param_file_round_trip(tmp_path):
    params = txl.init_xl_params(txl.XLConfig(**SMALL), seed=2)
    path = str(tmp_path / "checkpoint_last.pt")
    convert.save_params(path, params)
    got = convert.load_params(path)
    assert set(got) == set(params)
    for k in params:
        assert torch.equal(got[k], params[k])
    torch.save({"not": "params"}, str(tmp_path / "other.pt"))
    with pytest.raises(ValueError):
        convert.load_params(str(tmp_path / "other.pt"))
