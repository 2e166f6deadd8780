"""Tiny sizes of the cells for the CPU tests and a run of a cell at them."""
from __future__ import annotations

import copy
import time

from portbench import run

TINY = {"MODEL": {"num_layers": 2, "units": 32, "num_heads": 2,
                  "inner_size": 64},
        "TRAIN": {"batch_size": 4, "mem_length": 16, "tgt_length": 8},
        "corpus": {"train_pieces": 12, "train_mean": 200,
                   "train_sigma": 0.2,
                   "eval_pieces": 2, "eval_length": 40}}
TINY_MLE = {"followed_steps": 6, "check_block_rows": 2}
TINY_GEN = {"num_samples": 4, "batch_size": 4, "seq_len": 24,
            "warmup_samples": 4, "check_block_lanes": 2}
SEED = 2 ** 31 + 12345
# the configuration's own widths, as a MODEL override of TINY
FULL_WIDTHS = {"num_layers": 6, "units": 500, "num_heads": 10,
                   "inner_size": 1000}


def tiny_run(cell: str, *, dtype: str = "bfloat16", calibrate=False,
             seed: int = SEED, **extra):
    ov = copy.deepcopy(TINY)
    ov["TPU"] = {"compute_dtype": dtype}
    ov["traffic"] = dict(TINY_GEN if "evalgen" in cell else TINY_MLE)
    for k, v in extra.items():
        ov.setdefault(k, {}).update(v)
    return run.run_cell(cell, seed, 0.2, False, device="cpu", overrides=ov,
                        calibrate=calibrate, t_start=time.time())
