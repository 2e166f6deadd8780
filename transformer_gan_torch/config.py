"""Configuration trees of the port, read from the same YAML files as the
JAX package.

``transformer_gan_tpu/config.py`` holds the full training and inference
schemas. The port's defaults cover the keys it reads (the model's shape,
the MLE trainer's TRAIN / EVALUATE / INITIALIZER / DATASET keys, the GAN
phases' DISCRIMINATOR / PPO keys and ``TPU.gan_*`` switches, the quality
metrics' METRICS keys, and the memory layout, remat, profiling and precision
keys under ``TPU``), each with the JAX package's default; a file may set
any other key, which is kept as it is. Values keep attribute access
(``cfg.MODEL.num_layers``).

The vocab defaults to the port's own copy of the performance vocab
(``data/performance_vocab.txt``, byte for byte the JAX package's), found
from this module's location, so no default path depends on the working
directory.
"""
from __future__ import annotations

import copy
import os

import yaml

PACKAGED_VOCAB = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "data", "performance_vocab.txt")

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
    "DISCRIMINATOR": {
        "type": "Null", "start_iter": 100, "dis_loss_freq": 50,
        "gen_loss_freq": 10, "eval_loss_freq": 10,
        "freeze_discriminator": True, "truncate_backprop": False,
        "sample_chunks_mem": 1, "beta_max": 100.0, "adapt": "no",
        "dis_steps": 1, "tgt_len": 64, "mem_len": 64,
        "gen_loss_factor": 30, "dis_loss_factor": 1, "batch_chunk": 1,
        "context_len": 5, "backprop_outside": True, "src_mem_len": 200,
        "gen_scheduler": "constant", "gen_lr_min": 0.0,
        "gen_warmup_step": 0, "gen_decay_rate": 0.5, "gen_patience": 10,
        "gen_lr": 0.00025 / 4.0,
        "dis_scheduler": "constant", "dis_lr_min": 0.0,
        "dis_warmup_step": 0, "dis_decay_rate": 0.5, "dis_patience": 10,
        "dis_lr": 0.00025 / 4.0,
        "BERT": {"learning_rate": 1e-5, "weight_decay": 0.0,
                 "adam_epsilon": 1e-8, "max_grad_norm": 1.0,
                 "model_type": "bert_lm", "loss_type": "rsgan",
                 "model_path": "../BERT/checkpoint-1969000",
                 "freeze_layers": [], "random_weights": False,
                 "hidden_size": 768, "num_hidden_layers": 5,
                 "num_attention_heads": 12, "intermediate_size": 3072},
        "CNN": {"learning_rate": 1e-4, "embed_dim": 64, "hidden_dim": 64,
                "num_rep": 64, "init": "uniform", "loss_type": "rsgan"}},
    "PPO": {"dis_D_lr": 0.00025 / 4.0, "dis_D_update_D0_freq": 20,
            "dis_D_type": "bert", "clip_param": 0.4, "dis_D_num_rep": 1},
    "METRICS": {"use_bleu": False, "use_self_bleu": False,
                "gen_seq_len": 2048, "gen_batch_size": 128,
                "bleu_num_samples": 640, "self_bleu_num_samples": 2560,
                "CLASSIFIER": {"use_classifier": False, "gen_batch_size": 128,
                               "gen_seq_len": 2048, "gen_num_samples": 256,
                               "block_size": 128, "bert_batch_size": 20,
                               "model_path": "../BERT/checkpoint-1969000"}},
    "TPU": {"compute_dtype": "bfloat16", "param_dtype": "float32",
            "softmax_dtype": "float32", "cache_kv": True, "remat": False,
            "profile_dir": "", "gan_parallel_chunks": False,
            "gan_decode_cache": "auto", "gan_fused_decode": "auto",
            "gan_chain_bwd": "auto", "mesh_shape": [-1],
            "mesh_axes": ["data"]},
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


def check_gan_config(cfg) -> None:
    """Raise ``NotImplementedError`` for a discriminator the GAN routes do
    not run (cnn and bert; the JAX package's routes take no other)."""
    d = cfg.DISCRIMINATOR
    if not is_null(d.type) and d.type not in ("cnn", "bert"):
        raise NotImplementedError(
            f"DISCRIMINATOR.type {d.type!r} is not ported (cnn and bert are)")


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
