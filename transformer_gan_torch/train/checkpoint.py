"""Checkpoints with the reference's contract, written with ``torch.save``.

Counterpart of ``transformer_gan_tpu/train/checkpoint.py``:

* names: ``checkpoint_last`` every eval, ``checkpoint_best`` on val-NLL
  improvement, ``checkpoint_{step}`` with save-all;
* payload: model params, the optimizer state, and metadata
  (``train_step``, ``best_val_loss``, ``vocab``);
* warm start (``TRAIN.load_from_previous``): generator params only,
  non-strict (missing or mismatched names keep the fresh init);
* the GAN payload: discriminator parameters and the gen / dis optimizer
  states, under PPO also dis_D's parameters and optimizer state (P0 is
  not saved: the first gen phase after a restart re-snapshots it);
* BERT checkpoints (the MLM pretrainer's ``checkpoint-{step}``): a
  directory holding ``params.pt`` (``convert.FORMAT``) and
  ``metadata.json`` (``{"step", "config": {vocab_size, num_hidden_layers,
  hidden_size}}``), the layout of the JAX package's orbax directory; the
  critic takes its trunk from one (:func:`graft_bert_trunk`).

A checkpoint ``NAME`` in the run directory is three files: ``NAME.pt``, the
parameters in ``convert.FORMAT`` (what ``cli.generate`` reads as
``MODEL.checkpoint_name: NAME``), ``NAME.opt.pt`` (the fused optimizer
state) and ``NAME.json`` (metadata), plus ``NAME.gan.pt`` for a GAN run.
Each is written to a temporary file and renamed into place. Data parallel,
rank 0 alone writes, between two barriers (``train/loop.Trainer._save``),
and every rank restores from the same files.
"""
from __future__ import annotations

import json
import os

import torch

from .. import convert
from .optim import FusedOptState

OPT_FORMAT = "transformer_gan_torch.opt_state/1"
GAN_FORMAT = "transformer_gan_torch.gan_state/1"


def _paths(work_dir: str, name: str) -> tuple[str, str, str]:
    base = os.path.join(os.path.abspath(work_dir), name)
    return base + convert.PARAMS_SUFFIX, base + ".opt.pt", base + ".json"


def _atomic(path: str, write) -> None:
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def _opt_dict(state: FusedOptState) -> dict:
    return {"format": OPT_FORMAT, "count": int(state.count),
            "mu": state.mu.detach().cpu(), "nu": state.nu.detach().cpu(),
            "lr_scale": float(state.lr_scale)}


def _opt_from_dict(payload, device=None) -> FusedOptState:
    if not isinstance(payload, dict) or payload.get("format") != OPT_FORMAT:
        raise ValueError(f"not a {OPT_FORMAT} payload")
    return FusedOptState(count=int(payload["count"]),
                         mu=payload["mu"].to(device),
                         nu=payload["nu"].to(device),
                         lr_scale=float(payload["lr_scale"]))


def save_checkpoint(work_dir: str, name: str, params: dict,
                    opt_state: FusedOptState, metadata: dict,
                    gan: dict | None = None) -> str:
    """Write checkpoint ``name`` (and its GAN payload ``gan``: dis_params,
    gen_opt_state, optional dis_opt_state, disD_params and
    disD_opt_state); returns the parameter file's path."""
    p_path, o_path, m_path = _paths(work_dir, name)
    _atomic(p_path, lambda t: convert.save_params(t, params))
    _atomic(o_path, lambda t: torch.save(_opt_dict(opt_state), t))
    if gan is not None:
        _atomic(_gan_path(work_dir, name), lambda t: torch.save({
            "format": GAN_FORMAT,
            **{k: {n: v.detach().cpu().contiguous()
                   for n, v in gan[k].items()}
               for k in _GAN_PARAMS if k in gan},
            **{k: _opt_dict(gan[k]) for k in _GAN_OPT_STATES if k in gan}},
            t))

    def write_meta(t):
        with open(t, "w") as f:
            json.dump(metadata, f)
    _atomic(m_path, write_meta)
    return p_path


def checkpoint_exists(work_dir: str, name: str) -> bool:
    return all(os.path.exists(p) for p in _paths(work_dir, name))


_GAN_PARAMS = ("dis_params", "disD_params")
_GAN_OPT_STATES = ("gen_opt_state", "dis_opt_state", "disD_opt_state")


def _gan_path(work_dir: str, name: str) -> str:
    return os.path.join(os.path.abspath(work_dir), name) + ".gan.pt"


def load_opt_state(path: str, device=None) -> FusedOptState:
    payload = torch.load(path, map_location="cpu", weights_only=True)
    try:
        return _opt_from_dict(payload, device)
    except ValueError:
        raise ValueError(f"{path} is not a {OPT_FORMAT} file") from None


def load_gan_payload(work_dir: str, name: str, device=None) -> dict | None:
    """The GAN payload of checkpoint ``name`` (None for an MLE checkpoint):
    dis_params (and disD_params) and the optimizer states as
    ``FusedOptState``."""
    path = _gan_path(work_dir, name)
    if not os.path.exists(path):
        return None
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or payload.get("format") != GAN_FORMAT:
        raise ValueError(f"{path} is not a {GAN_FORMAT} file")
    out = {k: {n: v.to(device) for n, v in payload[k].items()}
           for k in _GAN_PARAMS if k in payload}
    for k in _GAN_OPT_STATES:
        if k in payload:
            out[k] = _opt_from_dict(payload[k], device)
    return out


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


BERT_PARAMS = "params.pt"


def save_bert_checkpoint(output_dir: str, name: str, params: dict,
                         metadata: dict) -> str:
    """Write BERT checkpoint directory ``output_dir/name``; returns it."""
    path = os.path.join(os.path.abspath(output_dir), name)
    os.makedirs(path, exist_ok=True)
    _atomic(os.path.join(path, BERT_PARAMS),
            lambda t: convert.save_params(t, params))

    def write_meta(t):
        with open(t, "w") as f:
            json.dump(metadata, f)
    _atomic(os.path.join(path, "metadata.json"), write_meta)
    return path


def load_bert_metadata(path: str) -> dict:
    """``metadata.json`` of a BERT checkpoint directory ({} without one)."""
    meta = os.path.join(os.path.abspath(path), "metadata.json")
    if os.path.exists(meta):
        with open(meta) as f:
            return json.load(f)
    return {}


def load_bert_params(path: str, device=None) -> dict:
    return convert.load_params(os.path.join(path, BERT_PARAMS), device)


BERT_SIZE_KEYS = ("vocab_size", "hidden_size", "num_hidden_layers",
                  "num_attention_heads", "intermediate_size")


def bert_sizes(path: str) -> dict:
    """The ``BertConfig`` sizes a BERT checkpoint's metadata records."""
    meta = load_bert_metadata(path).get("config", {})
    return {k: int(meta[k]) for k in BERT_SIZE_KEYS if k in meta}


def load_bert_model(path: str, device=None):
    """(``BertConfig``, parameters on ``device``) of the BERT checkpoint
    directory ``path``: sized by its metadata (the defaults without one),
    every leaf whose name and shape match from the checkpoint, the rest
    freshly initialized (seed 0). Raises OSError when there is no
    checkpoint to read."""
    from ..models import bert as bert_mod
    cfg = bert_mod.BertConfig(**bert_sizes(path))
    params = bert_mod.init_bert_params(cfg, seed=0)
    params = graft_bert_trunk(path, params, list(params))
    return cfg, {k: v.to(device) for k, v in params.items()}


def graft_bert_trunk(path: str, template: dict, trunk: list[str]) -> dict:
    """The critic's warm start from the MLM checkpoint directory ``path``
    (the reference loads BertForMaskedLM and grafts its ``.bert`` trunk into
    a fresh classification model): the ``trunk`` leaves whose names and
    shapes match come from the checkpoint; the pooler, the classifier and
    the critic's unused MLM head keep ``template``'s fresh values."""
    loaded = load_bert_params(path)
    out = dict(template)
    for name in trunk:
        old = loaded.get(name)
        if old is not None and old.shape == template[name].shape:
            out[name] = old.to(template[name].device, template[name].dtype)
    return out
