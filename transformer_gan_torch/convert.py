"""Parameter conversion between the JAX package and the port.

The JAX package keeps parameters as a pytree ``{"word_emb": ..., "layers":
[{"qkv_w": ...}, ...]}`` in orbax checkpoints; the port keeps a flat
``dict[str, Tensor]`` with the same names (``layers.3.qkv_w``) and saves it
with ``torch.save``. Orbax is not needed where the port runs: convert a
checkpoint once where JAX is installed::

    python -m transformer_gan_torch.convert --checkpoint WORK/checkpoint_last \\
        --out WORK/checkpoint_last.pt

The port's generation CLI then reads ``<model_directory>/<checkpoint_name>.pt``
beside the training ``config.yml``.
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
    ap.add_argument("--out", required=True, help="output .pt file")
    args = ap.parse_args()
    save_params(args.out, import_jax_checkpoint(args.checkpoint))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
