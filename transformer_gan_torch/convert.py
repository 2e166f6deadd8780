"""Parameter and training-state conversion between the JAX package and the
port.

The JAX package keeps its state as pytrees (``{"word_emb": ..., "layers":
[{"qkv_w": ...}, ...]}``) in orbax checkpoints; the port keeps a flat
``dict[str, Tensor]`` with the same names (``layers.3.qkv_w``) and saves it
with ``torch.save``. The port reads no orbax and imports nothing of the JAX
package: a checkpoint crosses over as a plain numpy archive, one ``.npz`` of
the checkpoint's leaves under their tree paths joined by ``/``
(``params/layers/3/qkv_w``, ``opt_state/mu``, ``dis_params/convs/0/w``,
``gen_opt_state/1/mu/word_emb``, ...), plus the checkpoint's
``metadata.json``. Where the JAX package is installed, a user writes the
archive with a few lines (README, "Converting a JAX checkpoint")::

    leaves = jax.tree_util.tree_flatten_with_path(load_checkpoint(CKPT))[0]
    np.savez(CKPT + ".npz", **{name(path): np.asarray(v) for path, v in leaves})

and the port turns it into its own checkpoint files::

    python -m transformer_gan_torch.convert --archive RUN/checkpoint_last.npz \\
        --train-state RUN_PORT        # params, optimizer, metadata, GAN state
    python -m transformer_gan_torch.convert --archive RUN/checkpoint_last.npz \\
        --out MODEL_DIR/checkpoint_last.pt    # parameters only

The optimizers' flat ``[P]`` moments are in the JAX tree's ``ravel_pytree``
order in both packages (``train.optim.flat_names``); the GAN phases' optax
chains (clip, Adam, scale, mutable lr, scale) keep Adam's state at index 1
and the multiplier at index 3, the BERT critic's (the same chain inside the
freeze's (zero, chain, zero)) at 1/1/0 and 1/3, PPO's ``dis_D`` (clip,
Adam, scale, scale: no multiplier) its Adam state at 1 and no multiplier.
:func:`archive_from_checkpoint` writes the port's checkpoint back under the
same names. Every leaf crosses under its tree path, so a note-status
model's ``status_emb`` and the GRU discriminator's ``layers/i/w_ih`` ...
(``layers.i.w_ih`` in the port) need nothing of their own. A BERT (MLM)
checkpoint is its
``params`` tree and ``metadata.json`` (:func:`import_bert_archive`,
:func:`archive_from_bert_checkpoint`); the JAX ``layers`` list becomes
``layers.i.name``.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

PARAMS_SUFFIX = ".pt"
FORMAT = "transformer_gan_torch.params/1"
ADAM, LR = "1", "3"   # the GAN optax chains' Adam and multiplier states
MASKED_ADAM, MASKED_LR = "1/1/0", "1/3"   # the BERT critic's, frozen leaves


def read_archive(path: str) -> dict[str, np.ndarray]:
    """The arrays of a numpy archive under their names."""
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def subtree(arrays: dict, prefix: str) -> dict[str, np.ndarray]:
    """The entries under ``prefix/``, renamed to the port's dotted names."""
    head = prefix + "/"
    return {k[len(head):].replace("/", "."): v for k, v in arrays.items()
            if k.startswith(head)}


def _tensor(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))


def tensors_from_archive(arrays: dict, prefix: str = "params"
                         ) -> dict[str, torch.Tensor]:
    """A parameter tree of the archive as flat fp32 CPU tensors."""
    return {k: _tensor(v) for k, v in subtree(arrays, prefix).items()}


def opt_state_from_archive(arrays: dict, prefix: str = "opt_state"):
    """The MLE fused optimizer state (count, mu, nu, lr/lr_scale) as the
    port's ``train.optim.FusedOptState``."""
    from .train.optim import FusedOptState
    return FusedOptState(count=int(arrays[f"{prefix}/count"]),
                         mu=_tensor(arrays[f"{prefix}/mu"]),
                         nu=_tensor(arrays[f"{prefix}/nu"]),
                         lr_scale=float(arrays[f"{prefix}/lr/lr_scale"]))


def adam_chain_state_from_archive(arrays: dict, prefix: str, layout):
    """A GAN phase's optax chain state as a ``FusedOptState`` over the flat
    vector of ``layout`` (its Adam moments are trees of the parameters; a
    chain without a multiplier, dis_D's, gets 1)."""
    from .train.optim import FusedOptState
    a, lr = ((MASKED_ADAM, MASKED_LR) if f"{prefix}/{MASKED_ADAM}/count" in arrays
             else (ADAM, LR))
    adam = f"{prefix}/{a}"
    lr_key = f"{prefix}/{lr}/lr_scale"
    return FusedOptState(
        count=int(arrays[f"{adam}/count"]),
        mu=layout.flatten(tensors_from_archive(arrays, f"{adam}/mu")),
        nu=layout.flatten(tensors_from_archive(arrays, f"{adam}/nu")),
        lr_scale=float(arrays[lr_key]) if lr_key in arrays else 1.0)


def params_from_jax(np_tree: dict) -> dict[str, torch.Tensor]:
    """A JAX-style parameter pytree (dicts and lists of numpy arrays) ->
    flat fp32 CPU tensors."""
    out: dict[str, torch.Tensor] = {}
    for key, value in np_tree.items():
        if key == "layers":
            for i, layer in enumerate(value):
                for name, arr in layer.items():
                    out[f"layers.{i}.{name}"] = _tensor(arr)
        else:
            out[key] = _tensor(value)
    return out


def params_to_jax(params: dict[str, torch.Tensor]) -> dict:
    """Flat port parameters -> the JAX package's pytree of numpy arrays."""
    tree: dict = {}
    layers: dict[int, dict] = {}
    for key, t in params.items():
        arr = _numpy(t)
        if key.startswith("layers."):
            _, idx, name = key.split(".", 2)
            layers.setdefault(int(idx), {})[name] = arr
        else:
            tree[key] = arr
    if layers:
        tree["layers"] = [layers[i] for i in range(len(layers))]
    return tree


def opt_state_from_jax(state):
    """JAX ``FusedOptState`` (or a dict of it: count, mu, nu, lr.lr_scale)
    of numpy arrays -> the port's ``train.optim.FusedOptState`` on the CPU."""
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
    """The port's ``FusedOptState`` -> ``{"count": int32, "mu": [P], "nu":
    [P], "lr": {"lr_scale": float32}}`` of numpy arrays, the JAX
    ``FusedOptState``'s fields."""
    return {"count": np.asarray(state.count, np.int32),
            "mu": _numpy(state.mu), "nu": _numpy(state.nu),
            "lr": {"lr_scale": np.asarray(state.lr_scale, np.float32)}}


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def _tree_names(prefix: str, params: dict) -> dict[str, np.ndarray]:
    return {f"{prefix}/" + k.replace(".", "/"): _numpy(v)
            for k, v in params.items()}


def archive_from_checkpoint(work_dir: str, name: str) -> dict[str, np.ndarray]:
    """The port's checkpoint ``name`` as archive entries under the JAX
    package's tree paths (the inverse of :func:`import_archive`)."""
    from .train import checkpoint as ckpt
    from .train.optim import FlatLayout
    params, opt, _ = ckpt.load_checkpoint(work_dir, name)
    out = _tree_names("params", params)
    out.update({"opt_state/count": np.asarray(opt.count, np.int32),
                "opt_state/mu": _numpy(opt.mu), "opt_state/nu": _numpy(opt.nu),
                "opt_state/lr/lr_scale": np.asarray(opt.lr_scale, np.float32)})
    gan = ckpt.load_gan_payload(work_dir, name)
    if gan is None:
        return out
    for key in ("dis_params", "disD_params"):
        if key in gan:
            out.update(_tree_names(key, gan[key]))
    for key, tree in (("gen_opt_state", params),
                      ("dis_opt_state", gan["dis_params"]),
                      ("disD_opt_state", gan.get("disD_params"))):
        if key not in gan:
            continue
        st, layout = gan[key], FlatLayout.of(tree)
        a, lr = ((MASKED_ADAM, MASKED_LR) if key == "dis_opt_state"
                 and "word_embeddings" in tree else (ADAM, LR))
        adam = f"{key}/{a}"
        out[f"{adam}/count"] = np.asarray(st.count, np.int32)
        for moment in ("mu", "nu"):
            out.update(_tree_names(f"{adam}/{moment}", layout.unflatten(
                getattr(st, moment))))
        if key != "disD_opt_state":          # dis_D's chain has no multiplier
            out[f"{key}/{lr}/lr_scale"] = np.asarray(st.lr_scale, np.float32)
    return out


def import_archive(path: str, work_dir: str, name: str | None = None,
                   metadata: str | None = None) -> str:
    """Write the whole training checkpoint in archive ``path`` (params, the
    fused optimizer state, the GAN state when present) as the port's
    checkpoint ``name`` (default: the archive's stem) into ``work_dir``,
    where ``--restart`` picks it up. ``metadata``: the checkpoint's
    metadata.json, by default ``<archive without .npz>/metadata.json``.
    Returns the parameter file's path."""
    from .train import checkpoint as ckpt
    from .train.optim import FlatLayout
    stem = path[:-4] if path.endswith(".npz") else path
    name = name or os.path.basename(stem)
    meta = _metadata(stem, metadata)
    arrays = read_archive(path)
    params = tensors_from_archive(arrays, "params")
    gan = None
    if any(k.startswith("dis_params/") for k in arrays):
        dis = tensors_from_archive(arrays, "dis_params")
        gan = {"dis_params": dis, "gen_opt_state": adam_chain_state_from_archive(
            arrays, "gen_opt_state", FlatLayout.of(params))}
        if any(k.startswith("dis_opt_state/") for k in arrays):
            gan["dis_opt_state"] = adam_chain_state_from_archive(
                arrays, "dis_opt_state", FlatLayout.of(dis))
        if any(k.startswith("disD_params/") for k in arrays):
            disD = tensors_from_archive(arrays, "disD_params")
            gan["disD_params"] = disD
            gan["disD_opt_state"] = adam_chain_state_from_archive(
                arrays, "disD_opt_state", FlatLayout.of(disD))
    os.makedirs(work_dir, exist_ok=True)
    return ckpt.save_checkpoint(work_dir, name, params,
                                opt_state_from_archive(arrays), meta, gan=gan)


def _metadata(stem: str, metadata: str | None) -> dict:
    metadata = metadata or os.path.join(stem, "metadata.json")
    if os.path.exists(metadata):
        with open(metadata) as f:
            return json.load(f)
    return {}


def import_bert_archive(path: str, out_dir: str,
                        metadata: str | None = None) -> str:
    """Write the BERT checkpoint in archive ``path`` (a JAX MLM
    ``checkpoint-N``: its ``params`` tree, and its metadata.json, by default
    ``<archive without .npz>/metadata.json``) as the port's BERT checkpoint
    directory ``out_dir``. Returns the directory."""
    from .train import checkpoint as ckpt
    stem = path[:-4] if path.endswith(".npz") else path
    out_dir = os.path.abspath(out_dir)
    return ckpt.save_bert_checkpoint(
        os.path.dirname(out_dir), os.path.basename(out_dir),
        tensors_from_archive(read_archive(path), "params"),
        _metadata(stem, metadata))


def archive_from_bert_checkpoint(path: str) -> dict[str, np.ndarray]:
    """The port's BERT checkpoint directory as archive entries under the
    JAX package's tree paths (the inverse of :func:`import_bert_archive`)."""
    from .train import checkpoint as ckpt
    return _tree_names("params", ckpt.load_bert_params(path))


def save_params(path: str, params: dict[str, torch.Tensor]) -> None:
    torch.save({"format": FORMAT,
                "params": {k: v.detach().cpu().contiguous()
                           for k, v in params.items()}}, path)


def load_params(path: str, device=None) -> dict[str, torch.Tensor]:
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        raise ValueError(f"{path} is not a {FORMAT} parameter file")
    return {k: v.to(device) for k, v in payload["params"].items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Convert a JAX checkpoint's numpy archive to the port's "
                    "format")
    ap.add_argument("--archive", required=True,
                    help=".npz of the checkpoint's leaves by tree path")
    ap.add_argument("--metadata", default=None,
                    help="the checkpoint's metadata.json (default: beside "
                         "the archive, in the directory of its name)")
    out = ap.add_mutually_exclusive_group(required=True)
    out.add_argument("--out", help="output .pt parameter file")
    out.add_argument("--train-state", help="run directory to write the whole "
                     "training checkpoint into (params, optimizer, metadata, "
                     "GAN state)")
    out.add_argument("--bert-dir", help="BERT checkpoint directory to write "
                     "an MLM checkpoint into (params.pt, metadata.json)")
    args = ap.parse_args(argv)
    if args.out:
        save_params(args.out, tensors_from_archive(read_archive(args.archive)))
        print(f"wrote {args.out}")
    elif args.bert_dir:
        print("wrote", import_bert_archive(args.archive, args.bert_dir,
                                           metadata=args.metadata))
    else:
        print("wrote", import_archive(args.archive, args.train_state,
                                      metadata=args.metadata))


if __name__ == "__main__":
    main()
