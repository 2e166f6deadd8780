"""Preprocessing CLI of the port (counterpart of ``cli/encode.py``, the
reference data/music_encoder.py).

The same flags and modes (``--mode {to_txt, to_midi, midi_to_npy,
npy_to_midi}``, ``--stretch_factors``, ``--pitch_transpose_lower/upper``,
``--encode_official_maestro``) over the port's codec, and the same files.
With ``--encode_official_maestro`` the train split gets the stretch x
transpose grid (35 encodings a piece by default) and valid / test the
canonical encoding. ``--input_folder`` has no default: the reference's
``data/maestro-v1.0.0`` is a path of its own repo layout.

Encoding runs on the native encoder, built once before the worker pool
forks; the CLI prints which encoder ran::

    python -m transformer_gan_torch.cli.encode --input_folder MAESTRO \\
        --output_folder DATA --mode midi_to_npy --encode_official_maestro
"""
from __future__ import annotations

import argparse
import csv
import functools
import multiprocessing as mpl
import os
import time

from ..data import native
from ..data.codec import PerformanceEventRepo


def find_files_by_extensions(root, exts):
    for dirpath, _, files in os.walk(root):
        for fname in files:
            if os.path.splitext(fname)[1].lower() in exts:
                yield os.path.join(dirpath, fname)


def read_maestro_meta_info(data_dir):
    """Maestro v1/v2 CSV split parsing (reference music_encoder.py:27-56),
    without pandas: returns {split: [midi_filename, ...]}."""
    for version in ("maestro-v1.0.0.csv", "maestro-v2.0.0.csv"):
        csv_path = os.path.join(data_dir, version)
        if os.path.exists(csv_path):
            break
    else:
        raise ValueError("Cannot find valid csv files!")
    splits = {"train": [], "validation": [], "test": []}
    with open(csv_path, newline="", encoding="utf-8") as f:
        for row in csv.DictReader(f):
            splits[row["split"]].append(row["midi_filename"])
    return splits


def get_midi_paths(maestro_dir):
    if not os.path.exists(maestro_dir):
        raise ValueError(f"Cannot find {maestro_dir}; download and extract "
                         "the data.")
    splits = read_maestro_meta_info(maestro_dir)
    return tuple(
        [os.path.join(maestro_dir, p) for p in splits[k]]
        for k in ("train", "validation", "test"))


# The workers are module-level functions reading the encoder from a global
# set before the pool forks, so they pickle by name and every worker
# inherits the encoder and its loaded native library (the reference relies
# on the same fork-inherits-globals property, music_encoder.py:108-135).
ENCODER = None


def _out_path(path, out_dir, ext):
    filename, _ = os.path.splitext(os.path.basename(path))
    return os.path.join(out_dir, filename + ext)


def run_to_text(path, out_dir):
    ENCODER.to_text(path, _out_path(path, out_dir, ".txt"))


def run_to_text_trans(path, out_dir):
    ENCODER.to_text_transposition(path, _out_path(path, out_dir, ".txt"))


def run_to_npy(path, out_dir):
    ENCODER.to_npy(path, _out_path(path, out_dir, ".npy"))


def run_to_npy_trans(path, out_dir):
    ENCODER.to_npy_transposition(path, _out_path(path, out_dir, ".npy"))


def run_from_text(path, out_dir):
    ENCODER.from_text(path, _out_path(path, out_dir, ".mid"))


def run_npy_to_midi(path, out_dir):
    ENCODER.npy_to_midi(path, _out_path(path, out_dir, ".mid"))


def _convert(convert_f, paths, out_dir):
    """Run ``convert_f`` over ``paths`` in a forked pool of at most one
    worker a core (one core left free) and one a file."""
    workers = max(1, min(mpl.cpu_count() - 1, len(paths)))
    with mpl.get_context("fork").Pool(workers) as pool:
        pool.map(functools.partial(convert_f, out_dir=out_dir), paths)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="MIDI <-> token encoder "
                                                 "(PyTorch port)")
    parser.add_argument("--input_folder", type=str, required=True,
                        help="Directory with the MIDI files (with "
                        "--encode_official_maestro: the MAESTRO dataset "
                        "with its CSV), or the .txt / .npy files to decode")
    parser.add_argument("--output_folder", type=str, required=True,
                        help="Directory to encode the event signals")
    parser.add_argument("--encode_official_maestro", action="store_true",
                        help="Whether to encode the official Maestro dataset.")
    parser.add_argument("--mode", type=str, default="to_txt",
                        choices=["to_txt", "to_midi", "midi_to_npy",
                                 "npy_to_midi"],
                        help="Convert to/from MIDIs to TXT/Numpy")
    parser.add_argument("--stretch_factors", type=str,
                        default="0.95,0.975,1.0,1.025,1.05")
    parser.add_argument("--pitch_transpose_lower", type=int, default=-3)
    parser.add_argument("--pitch_transpose_upper", type=int, default=3)
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    global ENCODER
    stretch_factors = [float(x) for x in args.stretch_factors.split(",")]
    ENCODER = PerformanceEventRepo(
        steps_per_second=100, num_velocity_bins=32,
        stretch_factors=stretch_factors,
        pitch_transpose_lower=args.pitch_transpose_lower,
        pitch_transpose_upper=args.pitch_transpose_upper)
    os.makedirs(args.output_folder, exist_ok=True)

    if args.mode in ("to_txt", "midi_to_npy"):
        # build (or find) the native library before the pool forks
        native.load()
        print(f"encoder: native ({native.library_path()})", flush=True)
        if args.mode == "to_txt":
            convert_transposition_f, convert_f = run_to_text_trans, run_to_text
        else:
            convert_transposition_f, convert_f = run_to_npy_trans, run_to_npy

        if args.encode_official_maestro:
            train_paths, valid_paths, test_paths = get_midi_paths(
                args.input_folder)
            print("Load MAESTRO from {}. Train/Val/Test={}/{}/{}".format(
                args.input_folder, len(train_paths), len(valid_paths),
                len(test_paths)))
            for split_name, midi_paths in [("train", train_paths),
                                           ("valid", valid_paths),
                                           ("test", test_paths)]:
                convert_function = (convert_transposition_f
                                    if split_name == "train" else convert_f)
                out_split_dir = os.path.join(args.output_folder, split_name)
                os.makedirs(out_split_dir, exist_ok=True)
                start = time.time()
                _convert(convert_function, midi_paths, out_split_dir)
                print("Split {} converted! Spent {:.1f}s to convert {}"
                      " samples.".format(split_name, time.time() - start,
                                         len(midi_paths)))
            ENCODER.create_vocab_txt(args.output_folder)
        else:
            midi_paths = list(find_files_by_extensions(
                args.input_folder, {".mid", ".midi"}))
            start = time.time()
            _convert(convert_f, midi_paths, args.output_folder)
            print("Converted {} midi files in {:.1f}s.".format(
                len(midi_paths), time.time() - start))
    else:
        convert_f = (run_from_text if args.mode == "to_midi"
                     else run_npy_to_midi)
        ext = {".npy"} if args.mode == "npy_to_midi" else {".txt"}
        input_paths = list(find_files_by_extensions(args.input_folder, ext))
        start = time.time()
        _convert(convert_f, input_paths, args.output_folder)
        print("Converted! Spent {:.1f}s to convert {} samples.".format(
            time.time() - start, len(input_paths)))


if __name__ == "__main__":
    main()
