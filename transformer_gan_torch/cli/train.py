"""Training CLI of the port (counterpart of ``cli/train.py``, same flags):

    python -m transformer_gan_torch.cli.train --data_dir D \\
        --cfg training_config/experiment_baseline.yml --work_dir W

``D`` holds ``vocab.txt`` and ``train/``, ``valid/``, ``test/`` folders of
token ``.npy`` pieces. Each run writes ``W/<timestamp>/``: ``config.yml``,
the log, and ``checkpoint_last`` / ``checkpoint_best`` (``.pt`` parameters
that ``transformer_gan_torch.cli.generate`` reads with
``MODEL.model_directory: W/<timestamp>``, ``MODEL.checkpoint_name:
checkpoint_last``, beside ``.opt.pt`` optimizer state and ``.json``
metadata). ``--restart --work_dir W/<timestamp>`` resumes from
``checkpoint_last``. Trains on CUDA when present, else on the CPU.
"""
from __future__ import annotations

import argparse

from ..config import training_config
from ..train.loop import Trainer


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Transformer-GAN Language Model (PyTorch port)")
    parser.add_argument("--data_dir", type=str, required=True,
                        help="location of the data corpus")
    parser.add_argument("--work_dir", type=str, required=True,
                        help="Base directory to save the trained model.")
    parser.add_argument("--cfg", type=str, default="transformer_xl.yml",
                        help="path to the cfg file")
    parser.add_argument("--restart", action="store_true",
                        help="Whether to restart from the existing checkpoint")
    parser.add_argument("--debug", action="store_true",
                        help="Debug the program (no checkpoints).")
    parser.add_argument("--save-all", action="store_true",
                        help="Save all checkpoints")
    return parser.parse_args(argv)


def main(argv=None) -> Trainer:
    args = parse_args(argv)
    cfg = training_config(args.cfg)
    trainer = Trainer(cfg, data_dir=args.data_dir, work_dir=args.work_dir,
                      restart=args.restart, debug=args.debug,
                      save_all=args.save_all)
    trainer.train()
    # reload checkpoint_best, test-evaluate, log "| End of training | ..."
    trainer.final_best_eval()
    return trainer


if __name__ == "__main__":
    main()
