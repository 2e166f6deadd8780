"""Batch inference of the port (counterpart of ``cli/batch_generate.py``,
the reference model/batch_generate.py): generation over prefix files x
sampling configurations through the port's ``cli.generate.main``, then each
generated token text file converted to MIDI in-process.

Each run writes ``OUTPUT_BASE/<prefix or uncond>_<technique>_<temperature>/``
with the generated ``<n>.txt`` (and ``prefix.txt`` / ``full.txt`` when
primed) and their MIDI files under ``midi/``. It runs on the CUDA card
unless ``--device`` names another::

    python -m transformer_gan_torch.cli.batch_generate \\
        --model_directory RUN --checkpoint_name checkpoint_last \\
        --output_base OUT --prefix piece.npy --techniques topk,random
"""
from __future__ import annotations

import argparse
import os

from ..config import PACKAGED_VOCAB, inference_config
from ..data.codec import PerformanceEventRepo
from . import generate as generate_cli


def generate_files(model_directory, checkpoint_name, vocab_file,
                   output_base, prefixes, sampling_configs,
                   memory_length=4146, generation_length=4096,
                   num_midi_files=1, num_conditional_tokens=50,
                   device=None) -> list[dict]:
    """Generate for every (prefix, sampling config); ``prefixes`` empty
    runs unconditionally. Returns one dict a run: its ``tag``,
    ``out_dir``, the MIDI files written (``midi``) and the generation
    summary of ``cli.generate.main`` (``summary``)."""
    repo = PerformanceEventRepo()
    runs = []
    for prefix in (prefixes or [None]):
        for scfg in sampling_configs:
            tag = "{}_{}_{}".format(
                os.path.splitext(os.path.basename(prefix))[0]
                if prefix else "uncond",
                scfg["technique"], scfg["temperature"])
            out_dir = os.path.join(output_base, tag)

            icfg = inference_config()
            icfg.EVENT.vocab_file_path = vocab_file
            icfg.MODEL.model_directory = model_directory
            icfg.MODEL.checkpoint_name = checkpoint_name
            icfg.MODEL.memory_length = memory_length
            icfg.SAMPLING.technique = scfg["technique"]
            icfg.SAMPLING.threshold = float(scfg.get("threshold", 32.0))
            icfg.SAMPLING.temperature = float(scfg["temperature"])
            icfg.GENERATION.generation_length = generation_length
            icfg.INPUT.time_extension = prefix is not None
            icfg.INPUT.conditional_input_melody = prefix or "Null"
            icfg.INPUT.num_conditional_tokens = num_conditional_tokens
            icfg.INPUT.num_midi_files = num_midi_files
            icfg.OUTPUT.output_txt_directory = out_dir

            print(f"=== generating {tag} ===")
            summary = generate_cli.main(icfg, device)

            midi_dir = os.path.join(out_dir, "midi")
            os.makedirs(midi_dir, exist_ok=True)
            midi = []
            for fname in sorted(os.listdir(out_dir)):
                if fname.endswith(".txt") and fname[0].isdigit():
                    midi.append(repo.from_text(
                        os.path.join(out_dir, fname),
                        os.path.join(midi_dir,
                                     fname.replace(".txt", ".mid"))))
            runs.append({"tag": tag, "out_dir": out_dir, "midi": midi,
                         "summary": summary})
    return runs


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Batch generation to MIDI "
                                                 "(PyTorch port)")
    parser.add_argument("--model_directory", type=str, required=True)
    parser.add_argument("--checkpoint_name", type=str,
                        default="checkpoint_best")
    parser.add_argument("--vocab_file", type=str, default=PACKAGED_VOCAB)
    parser.add_argument("--output_base", type=str, required=True)
    parser.add_argument("--prefix", type=str, action="append", default=[],
                        help="conditional prefix npy (repeatable)")
    parser.add_argument("--temperatures", type=str, default="0.95")
    parser.add_argument("--techniques", type=str, default="topk")
    parser.add_argument("--threshold", type=float, default=32.0)
    parser.add_argument("--memory_length", type=int, default=4146)
    parser.add_argument("--generation_length", type=int, default=4096)
    parser.add_argument("--num_midi_files", type=int, default=1)
    parser.add_argument("--num_conditional_tokens", type=int, default=50)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card; 'cpu' "
                        "runs on the CPU)")
    return parser.parse_args(argv)


def main(argv=None) -> list[dict]:
    args = parse_args(argv)
    sampling_configs = [
        {"technique": tech, "temperature": float(temp),
         "threshold": args.threshold}
        for tech in args.techniques.split(",")
        for temp in args.temperatures.split(",")]
    return generate_files(args.model_directory, args.checkpoint_name,
                          args.vocab_file, args.output_base,
                          args.prefix, sampling_configs,
                          memory_length=args.memory_length,
                          generation_length=args.generation_length,
                          num_midi_files=args.num_midi_files,
                          num_conditional_tokens=args.num_conditional_tokens,
                          device=args.device)


if __name__ == "__main__":
    main()
