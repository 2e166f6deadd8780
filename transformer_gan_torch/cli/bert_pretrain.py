"""BERT MLM pretraining CLI of the port (counterpart of
``cli/bert_pretrain.py``, the same flags plus ``--device``):

    python -m transformer_gan_torch.cli.bert_pretrain \\
        --train_data_file D --output_dir OUT --vocab_file VOCAB

``D`` holds ``train/`` (and optionally ``valid/``) folders of token ``.npy``
shards. Checkpoints land in ``OUT/checkpoint-{step}/`` (``params.pt`` and
``metadata.json``), the newest ``--save_total_limit`` kept; a GAN config's
``DISCRIMINATOR.BERT.model_path`` names one. Trains on the card;
``--device cpu`` trains on the CPU. ``torchrun --nproc_per_node N -m
transformer_gan_torch.cli.bert_pretrain ...`` trains on N ranks, one card
each, with the reference's DDP batch: ``--per_gpu_train_batch_size`` rows a
rank, that times N a step; rank 0 logs and writes the checkpoints.
"""
from __future__ import annotations

import argparse
import logging

from ..bert.mlm import MlmTrainer
from ..parallel import mesh as pmesh


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="BERT MLM pretraining (PyTorch port)")
    parser.add_argument("--train_data_file", type=str, required=True,
                        help="Directory with train/ and valid/ npy shards")
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--vocab_file", type=str, required=True)
    parser.add_argument("--num_hidden_layers", default=5, type=int)
    parser.add_argument("--hidden_size", default=768, type=int)
    parser.add_argument("--block_size", default=512, type=int)
    parser.add_argument("--per_gpu_train_batch_size", default=16, type=int)
    parser.add_argument("--learning_rate", default=5e-5, type=float)
    parser.add_argument("--weight_decay", default=0.0, type=float)
    parser.add_argument("--adam_epsilon", default=1e-8, type=float)
    parser.add_argument("--warmup_steps", default=0, type=int)
    parser.add_argument("--max_steps", default=10000, type=int)
    parser.add_argument("--max_grad_norm", default=1.0, type=float)
    parser.add_argument("--mlm_probability", default=0.15, type=float)
    parser.add_argument("--seed", default=42, type=int)
    parser.add_argument("--logging_steps", default=100, type=int)
    parser.add_argument("--save_steps", default=1000, type=int)
    parser.add_argument("--save_total_limit", default=2, type=int)
    parser.add_argument("--eval_steps", default=1000, type=int)
    parser.add_argument("--compute_dtype", default="float32", type=str,
                        help="matmul / activation dtype (bfloat16 on the "
                        "card; the reference's apex-fp16 counterpart)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card; 'cpu' "
                        "runs on the CPU)")
    return parser.parse_args(argv)


def main(argv=None) -> MlmTrainer:
    args = parse_args(argv)
    mesh = pmesh.initialize_distributed(args.device)
    logging.basicConfig(level=logging.INFO if mesh.rank == 0
                        else logging.WARNING,
                        format="%(asctime)s %(levelname)s %(message)s")
    trainer = MlmTrainer(
        data_dir=args.train_data_file, output_dir=args.output_dir,
        vocab_file=args.vocab_file, num_hidden_layers=args.num_hidden_layers,
        hidden_size=args.hidden_size, block_size=args.block_size,
        batch_size=args.per_gpu_train_batch_size * mesh.world,
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        adam_epsilon=args.adam_epsilon, warmup_steps=args.warmup_steps,
        max_steps=args.max_steps, max_grad_norm=args.max_grad_norm,
        mlm_probability=args.mlm_probability, seed=args.seed,
        logging_steps=args.logging_steps, save_steps=args.save_steps,
        save_total_limit=args.save_total_limit, eval_steps=args.eval_steps,
        compute_dtype=args.compute_dtype, device=args.device)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
