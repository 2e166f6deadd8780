"""Parameter conversion between the JAX package and the port.

The JAX package keeps parameters as a pytree ``{"word_emb": ..., "layers":
[{"qkv_w": ...}, ...]}`` in orbax checkpoints; the port keeps a flat
``dict[str, Tensor]`` with the same names (``layers.3.qkv_w``) and saves it
with ``torch.save``. Orbax is not needed where the port runs: convert a
checkpoint once where JAX is installed::

    python -m transformer_gan_torch.convert --checkpoint WORK/checkpoint_last \\
        --out WORK/checkpoint_last.pt

The port's generation CLI then reads ``<model_directory>/<checkpoint_name>.pt``
beside the training ``config.yml``. A whole JAX training checkpoint
(parameters, fused optimizer state, metadata) converts into the port's
checkpoint files, so a JAX run can be restarted in the port::

    python -m transformer_gan_torch.convert --checkpoint RUN/checkpoint_last \
        --train-state RUN_PORT

The optimizer's flat ``[P]`` moments are in the JAX tree's ``ravel_pytree``
order in both packages (``train.optim.flat_names``), so they copy as they
are.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

PARAMS_SUFFIX = ".pt"
FORMAT = "transformer_gan_torch.params/1"


def params_from_jax(np_tree: dict) -> dict[str, torch.Tensor]:
    """JAX parameter pytree (numpy or jax arrays) -> flat fp32 CPU tensors."""
    out: dict[str, torch.Tensor] = {}
    for key, value in np_tree.items():
        if key == "layers":
            for i, layer in enumerate(value):
                for name, arr in layer.items():
                    out[f"layers.{i}.{name}"] = _tensor(arr)
        else:
            out[key] = _tensor(value)
    return out


def _tensor(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))


def params_to_jax(params: dict[str, torch.Tensor]) -> dict:
    """Flat port parameters -> the JAX package's pytree of numpy arrays."""
    tree: dict = {}
    layers: dict[int, dict] = {}
    for key, t in params.items():
        arr = t.detach().to("cpu", torch.float32).numpy().copy()
        if key.startswith("layers."):
            _, idx, name = key.split(".", 2)
            layers.setdefault(int(idx), {})[name] = arr
        else:
            tree[key] = arr
    if layers:
        tree["layers"] = [layers[i] for i in range(len(layers))]
    return tree


def import_jax_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """Read an orbax checkpoint written by the JAX package (needs JAX and
    orbax; run it where they are installed)."""
    from transformer_gan_tpu.train.checkpoint import load_checkpoint
    payload = load_checkpoint(path)
    tree = payload["params"] if "params" in payload else payload
    return params_from_jax(tree)


def opt_state_from_jax(state):
    """JAX ``FusedOptState`` (or orbax's dict of it: count, mu, nu,
    lr.lr_scale) -> the port's ``train.optim.FusedOptState`` on the CPU."""
    from .train.optim import FusedOptState
    if isinstance(state, dict):
        count, mu, nu = state["count"], state["mu"], state["nu"]
        lr = state["lr"]
        lr_scale = lr["lr_scale"] if isinstance(lr, dict) else lr.lr_scale
    else:
        count, mu, nu, lr_scale = (state.count, state.mu, state.nu,
                                   state.lr.lr_scale)
    return FusedOptState(count=int(np.asarray(count)), mu=_tensor(mu),
                         nu=_tensor(nu), lr_scale=float(np.asarray(lr_scale)))


def opt_state_to_jax(state) -> dict:
    """The port's ``FusedOptState`` -> the JAX package's ``FusedOptState``
    as orbax stores it: ``{"count": int32, "mu": [P], "nu": [P], "lr":
    {"lr_scale": float32}}`` of numpy arrays (the JAX side builds its
    NamedTuple from them; :func:`opt_state_from_jax` reads them back)."""
    return {"count": np.asarray(state.count, np.int32),
            "mu": state.mu.detach().to("cpu", torch.float32).numpy().copy(),
            "nu": state.nu.detach().to("cpu", torch.float32).numpy().copy(),
            "lr": {"lr_scale": np.asarray(state.lr_scale, np.float32)}}


def import_jax_train_checkpoint(path: str, work_dir: str) -> str:
    """Read a whole JAX training checkpoint (orbax directory ``path`` with
    params, the fused optimizer state and metadata.json; needs JAX and
    orbax) and write it as the port's checkpoint of the same name into
    ``work_dir``, where ``--restart`` picks it up. Returns the parameter
    file's path."""
    import os
    from transformer_gan_tpu.train.checkpoint import (load_checkpoint,
                                                      load_metadata)
    from .train import checkpoint as ckpt
    payload = load_checkpoint(path)
    os.makedirs(work_dir, exist_ok=True)
    return ckpt.save_checkpoint(
        work_dir, os.path.basename(os.path.normpath(path)),
        params_from_jax(payload["params"]),
        opt_state_from_jax(payload["opt_state"]), load_metadata(path))


def save_params(path: str, params: dict[str, torch.Tensor]) -> None:
    torch.save({"format": FORMAT,
                "params": {k: v.detach().cpu().contiguous()
                           for k, v in params.items()}}, path)


def load_params(path: str, device=None) -> dict[str, torch.Tensor]:
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        raise ValueError(f"{path} is not a {FORMAT} parameter file")
    return {k: v.to(device) for k, v in payload["params"].items()}


def main() -> None:
    ap = argparse.ArgumentParser(
        description="Convert a JAX (orbax) checkpoint to the port's format")
    ap.add_argument("--checkpoint", required=True, help="orbax checkpoint dir")
    out = ap.add_mutually_exclusive_group(required=True)
    out.add_argument("--out", help="output .pt parameter file")
    out.add_argument("--train-state", help="run directory to write the whole "
                     "training checkpoint into (params, optimizer, metadata)")
    args = ap.parse_args()
    if args.out:
        save_params(args.out, import_jax_checkpoint(args.checkpoint))
        print(f"wrote {args.out}")
    else:
        print("wrote", import_jax_train_checkpoint(args.checkpoint,
                                                   args.train_state))


if __name__ == "__main__":
    main()
