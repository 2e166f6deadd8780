"""A music-like synthetic corpus through the port's codec (counterpart of
``tools/make_synth_corpus.py``).

Each piece picks a key and scale, a tempo and a chord progression, then
renders phrases of scale-walk melody over block chords with sustain pedal,
velocity arcs and a closing ritardando: structure (key consistency,
repeated motifs, chord / melody alignment) that MLE training can learn.
The same seed gives the same pieces as the JAX package's tool.

By default every piece goes NoteSequence -> SMF -> ``PerformanceEventRepo``
encode, and the tool writes a data directory (``vocab.txt``, ``train/``,
``valid/``, ``test/`` of int32 ``.npy`` pieces). With ``--write_midi`` it
keeps the pieces as MIDI files instead, beside a MAESTRO-style
``maestro-v2.0.0.csv`` of the splits, for ``cli.encode
--encode_official_maestro``::

    python -m transformer_gan_torch.tools.make_synth_corpus --out_dir D \\
        [--n_train 200] [--write_midi]
"""
from __future__ import annotations

import argparse
import csv
import os

import numpy as np

from ..data import midi as midi_io
from ..data.codec import PerformanceEventRepo, build_performance_vocab
from ..data.midi import ControlChange, Note, NoteSequence

MAJOR = [0, 2, 4, 5, 7, 9, 11]
MINOR = [0, 2, 3, 5, 7, 8, 10]
# I-IV-V-vi style progressions as scale-degree roots
PROGRESSIONS = [[0, 3, 4, 0], [0, 5, 3, 4], [0, 4, 5, 3], [0, 3, 0, 4]]
# the split names of the MAESTRO CSV, whose split and midi_filename columns
# cli.encode reads
MAESTRO_SPLITS = {"train": "train", "valid": "validation", "test": "test"}


def _scale_pitch(tonic, scale, degree):
    octave, step = divmod(degree, 7)
    return tonic + 12 * octave + scale[step]


def make_piece(rng: np.random.RandomState) -> NoteSequence:
    ns = NoteSequence()
    tonic = int(rng.randint(48, 60))
    scale = MAJOR if rng.rand() < 0.6 else MINOR
    beat = float(rng.uniform(0.28, 0.55))          # seconds per beat
    progression = PROGRESSIONS[rng.randint(len(PROGRESSIONS))]
    n_bars = int(rng.randint(24, 64))
    base_vel = int(rng.randint(48, 80))

    # a reusable 1-bar melodic motif (8 eighth notes of scale steps)
    motif = rng.randint(-2, 3, size=8)

    t = 0.0
    degree = 7                                      # melody an octave up
    for bar in range(n_bars):
        chord_root = progression[bar % len(progression)]
        rit = 1.0 + 0.6 * max(0, bar - (n_bars - 4)) / 4.0  # final rit.
        bar_beat = beat * rit
        vel_arc = int(18 * np.sin(np.pi * (bar % 8) / 8.0))

        # block chord (root-third-fifth) held for the bar
        for off in (0, 2, 4):
            p = _scale_pitch(tonic - 12, scale, chord_root + off)
            ns.notes.append(Note(
                pitch=int(np.clip(p, 21, 108)),
                velocity=int(np.clip(base_vel - 12 + rng.randint(-4, 5),
                                     1, 127)),
                start_time=t, end_time=t + 4 * bar_beat * 0.95))

        # melody: the motif, sometimes varied, over the chord
        steps = motif if rng.rand() < 0.7 else rng.randint(-2, 3, size=8)
        mt = t
        for s in steps:
            degree = int(np.clip(degree + s, 4, 17))
            dur = bar_beat * 0.5 * float(rng.choice([0.9, 1.0, 1.0, 1.9]))
            p = _scale_pitch(tonic, scale, chord_root % 7 + degree)
            ns.notes.append(Note(
                pitch=int(np.clip(p, 21, 108)),
                velocity=int(np.clip(base_vel + vel_arc + rng.randint(-6, 7),
                                     1, 127)),
                start_time=mt, end_time=mt + dur))
            mt += bar_beat * 0.5
        # sustain pedal down at bar start, up just before the next
        ns.control_changes.append(ControlChange(
            time=t, control_number=64, control_value=127))
        ns.control_changes.append(ControlChange(
            time=t + 4 * bar_beat * 0.97, control_number=64,
            control_value=0))
        t += 4 * bar_beat
    ns.total_time = max(n.end_time for n in ns.notes)
    return ns


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Synthetic corpus (PyTorch "
                                             "port)")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--n_train", type=int, default=200)
    ap.add_argument("--n_valid", type=int, default=24)
    ap.add_argument("--n_test", type=int, default=24)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--write_midi", action="store_true",
                    help="keep the pieces as MIDI files with a "
                    "maestro-v2.0.0.csv of the splits; encode nothing")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    rng = np.random.RandomState(args.seed)
    repo = None if args.write_midi else PerformanceEventRepo()
    os.makedirs(args.out_dir, exist_ok=True)
    if repo is not None:
        with open(os.path.join(args.out_dir, "vocab.txt"), "w") as f:
            f.write("\n".join(build_performance_vocab()))

    total = 0
    rows = []
    for split, n in (("train", args.n_train), ("valid", args.n_valid),
                     ("test", args.n_test)):
        d = os.path.join(args.out_dir, split)
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            ns = make_piece(rng)
            mid = os.path.join(d, f"p{i:04d}.mid")
            midi_io.note_sequence_to_midi_file(ns, mid)
            if repo is None:
                rows.append({"split": MAESTRO_SPLITS[split],
                             "midi_filename": f"{split}/p{i:04d}.mid"})
                continue
            npy = os.path.join(d, f"p{i:04d}.npy")
            repo.to_npy(mid, npy)
            os.remove(mid)
            total += len(np.load(npy))
        print(f"{split}: {n} pieces")
    if repo is None:
        with open(os.path.join(args.out_dir, "maestro-v2.0.0.csv"), "w",
                  newline="", encoding="utf-8") as f:
            writer = csv.DictWriter(f, fieldnames=["split", "midi_filename"])
            writer.writeheader()
            writer.writerows(rows)
    else:
        print(f"total tokens: {total}")


if __name__ == "__main__":
    main()
