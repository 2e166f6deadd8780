"""Checkpoints with the reference's contract, written with ``torch.save``.

Counterpart of ``transformer_gan_tpu/train/checkpoint.py``:

* names: ``checkpoint_last`` every eval, ``checkpoint_best`` on val-NLL
  improvement, ``checkpoint_{step}`` with save-all;
* payload: model params, the optimizer state, and metadata
  (``train_step``, ``best_val_loss``, ``vocab``);
* warm start (``TRAIN.load_from_previous``): generator params only,
  non-strict (missing or mismatched names keep the fresh init).

A checkpoint ``NAME`` in the run directory is three files: ``NAME.pt``, the
parameters in ``convert.FORMAT`` (what ``cli.generate`` reads as
``MODEL.checkpoint_name: NAME``), ``NAME.opt.pt`` (the fused optimizer
state) and ``NAME.json`` (metadata). Each is written to a temporary file
and renamed into place.
"""
from __future__ import annotations

import json
import os

import torch

from .. import convert
from .optim import FusedOptState

OPT_FORMAT = "transformer_gan_torch.opt_state/1"


def _paths(work_dir: str, name: str) -> tuple[str, str, str]:
    base = os.path.join(os.path.abspath(work_dir), name)
    return base + convert.PARAMS_SUFFIX, base + ".opt.pt", base + ".json"


def _atomic(path: str, write) -> None:
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def save_checkpoint(work_dir: str, name: str, params: dict,
                    opt_state: FusedOptState, metadata: dict) -> str:
    """Write checkpoint ``name``; returns the parameter file's path."""
    p_path, o_path, m_path = _paths(work_dir, name)
    _atomic(p_path, lambda t: convert.save_params(t, params))
    _atomic(o_path, lambda t: torch.save(
        {"format": OPT_FORMAT, "count": int(opt_state.count),
         "mu": opt_state.mu.detach().cpu(), "nu": opt_state.nu.detach().cpu(),
         "lr_scale": float(opt_state.lr_scale)}, t))

    def write_meta(t):
        with open(t, "w") as f:
            json.dump(metadata, f)
    _atomic(m_path, write_meta)
    return p_path


def checkpoint_exists(work_dir: str, name: str) -> bool:
    return all(os.path.exists(p) for p in _paths(work_dir, name))


def load_opt_state(path: str, device=None) -> FusedOptState:
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or payload.get("format") != OPT_FORMAT:
        raise ValueError(f"{path} is not a {OPT_FORMAT} file")
    return FusedOptState(count=int(payload["count"]),
                         mu=payload["mu"].to(device),
                         nu=payload["nu"].to(device),
                         lr_scale=float(payload["lr_scale"]))


def load_metadata(work_dir: str, name: str) -> dict:
    m_path = _paths(work_dir, name)[2]
    if os.path.exists(m_path):
        with open(m_path) as f:
            return json.load(f)
    return {}


def load_checkpoint(work_dir: str, name: str, device=None):
    """(params, opt_state, metadata) of checkpoint ``name``."""
    p_path, o_path, _ = _paths(work_dir, name)
    return (convert.load_params(p_path, device),
            load_opt_state(o_path, device), load_metadata(work_dir, name))


def load_generator_params(path: str, template: dict) -> dict:
    """Warm start: the parameters of ``path`` (a parameter file, with or
    without its ``.pt`` suffix) whose names and shapes match ``template``;
    every other entry keeps the template's value."""
    if not path.endswith(convert.PARAMS_SUFFIX):
        path += convert.PARAMS_SUFFIX
    loaded = convert.load_params(path)
    out = {}
    for name, fresh in template.items():
        old = loaded.get(name)
        out[name] = (old.to(fresh.device, fresh.dtype)
                     if old is not None and old.shape == fresh.shape
                     else fresh)
    return out
