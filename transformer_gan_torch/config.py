"""Configuration trees of the port, read from the same YAML files as the
JAX package.

``transformer_gan_tpu/config.py`` holds the full training and inference
schemas. The port's defaults cover the keys it reads (the model's shape,
the MLE trainer's TRAIN / EVALUATE / INITIALIZER / DATASET keys, the keys
that must stay off because their features are not ported, and the
precision keys under ``TPU``), each with the JAX package's default; a file
may set any other key, which is kept as it is. Values keep attribute access
(``cfg.MODEL.num_layers``).

The vocab defaults to the file the JAX package ships, found from this
module's location, so no default path depends on the working directory.
"""
from __future__ import annotations

import copy
import os

import yaml

PACKAGED_VOCAB = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "transformer_gan_tpu", "data", "performance_vocab.txt")

TRAINING_DEFAULTS = {
    "MODEL": {"num_layers": 6, "num_heads": 10, "units": 500,
              "inner_size": 1000, "dropout": 0.1, "attention_dropout": 0.1,
              "pre_lnorm": False, "clamp_len": -1, "tie_embedding": True,
              "same_length": False},
    "TRAIN": {"load_from_previous": "Null", "batch_size": 200,
              "batch_chunk": 1, "tgt_length": 500, "mem_length": 50,
              "seed": 1111, "optim": "adam", "lr": 0.00025 / 4.0,
              "lr_min": 0.0, "scheduler": "cosine", "warmup_step": 0,
              "decay_rate": 0.5, "patience": 10, "clip": 0.25,
              "max_step": 200000, "log_interval": 200,
              "eval_interval": 4000, "pad_type": "model", "use_mle": True,
              "random_crop": False, "replace_start_with_pad": False,
              "weight_decay": 0.0, "append_note_status": False},
    "EVALUATE": {"batch_size": 10, "tgt_length": 128, "mem_length": 128},
    "INITIALIZER": {"base_init": ["normal", 0.01],
                    "embed_init": ["normal", 0.01]},
    "DATASET": {"continuous_refill": False},
    "DISCRIMINATOR": {"type": "Null", "start_iter": 100},
    "METRICS": {"use_bleu": False, "use_self_bleu": False,
                "CLASSIFIER": {"use_classifier": False}},
    "TPU": {"compute_dtype": "bfloat16", "param_dtype": "float32",
            "softmax_dtype": "float32", "cache_kv": True, "remat": False,
            "profile_dir": ""},
}

INFERENCE_DEFAULTS = {
    "EVENT": {"event_representation": "magenta",
              "vocab_file_path": PACKAGED_VOCAB},
    "MODEL": {"model_directory": "", "memory_length": 100,
              "src_mem_len": 100, "checkpoint_name": "checkpoint.pt",
              "device": "tpu", "debug": False},
    "SAMPLING": {"technique": "topk", "threshold": 32.0, "temperature": 0.95},
    "GENERATION": {"generation_length": 100, "duration_based": False,
                   "generation_duration": 30, "max_generation_length": 10000},
    "INPUT": {"time_extension": True, "conditional_input_melody": "",
              "num_conditional_tokens": 100, "conditional_duration": 10,
              "harmonization": "", "exclude_bos_token": True,
              "num_midi_files": 5, "num_empty_tokens_to_ignore": 0},
    "OUTPUT": {"output_txt_directory": ""},
}


def is_null(value) -> bool:
    """The configs use "Null" (or "") for None."""
    return value is None or value == "Null" or value == ""


class Config(dict):
    """A dict of dicts with attribute access."""

    def __init__(self, init: dict | None = None):
        super().__init__()
        for k, v in (init or {}).items():
            self[k] = Config(v) if isinstance(v, dict) else copy.deepcopy(v)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def merge(self, other: dict) -> "Config":
        """Recursive update."""
        for k, v in other.items():
            if isinstance(v, dict):
                if not isinstance(self.get(k), Config):
                    self[k] = Config()
                self[k].merge(v)
            else:
                self[k] = v
        return self

    def merge_from_file(self, path: str) -> "Config":
        with open(path, "r") as f:
            return self.merge(yaml.safe_load(f) or {})

    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, Config) else v
                for k, v in self.items()}

    def dump(self) -> str:
        return yaml.safe_dump(self.to_dict(), default_flow_style=None,
                              sort_keys=True)

    def __str__(self) -> str:
        return self.dump()


def training_config(path: str | None = None) -> Config:
    cfg = Config(TRAINING_DEFAULTS)
    return cfg.merge_from_file(path) if path else cfg


def inference_config(path: str | None = None) -> Config:
    cfg = Config(INFERENCE_DEFAULTS)
    return cfg.merge_from_file(path) if path else cfg
