"""Experiment logging (copy of ``transformer_gan_tpu/utils/logging.py``):
a log file in the work dir plus, optionally, the console. Data parallel,
each rank writes its own file (``train_rank{r}.log``) and only rank 0 the
console."""

from __future__ import annotations

import logging
import os


def logging_config(folder: str, name: str, console: bool = True,
                   level=logging.INFO) -> None:
    os.makedirs(folder, exist_ok=True)
    logpath = os.path.join(folder, name + ".log")

    root = logging.getLogger()
    root.setLevel(level)
    for h in list(root.handlers):
        root.removeHandler(h)

    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    fh = logging.FileHandler(logpath, mode="a")
    fh.setFormatter(fmt)
    root.addHandler(fh)
    if console:
        ch = logging.StreamHandler()
        ch.setFormatter(fmt)
        root.addHandler(ch)
