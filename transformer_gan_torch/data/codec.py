"""MIDI <-> performance-token codec with the reference's public API.

The port's counterpart of ``transformer_gan_tpu/data/codec.py`` (the
reference ``PerformanceEventRepo``): the same constructor, the same methods
(``encode``, ``encode_transposition``, ``decode``, ``to_text`` /
``from_text``, ``to_npy`` / ``to_npy_transposition``, ``npy_to_midi``,
``create_vocab_txt``, ``filter_pitches``, ``midi_quantizer``) and the same
token ids over the 310-token vocab, read from the port's packaged
``performance_vocab.txt``.

Encoding runs on the native C++ encoder (``data/native.py``) unless the
caller asks for the pure-Python one (``encoder="python"``), the bit-exact
oracle; nothing switches between them silently. Decoding is Python.
"""

from __future__ import annotations

import functools
import itertools
import os

import numpy as np

from ..config import PACKAGED_VOCAB
from . import midi as midi_io
from . import native
from . import performance as perf
from . import sequences as seq_lib
from .midi import NoteSequence

MIN_PITCH, MAX_PITCH = 21, 108
ENCODERS = ("native", "python")


def build_performance_vocab(max_shift_steps: int = 100,
                            min_pitch: int = MIN_PITCH,
                            max_pitch: int = MAX_PITCH,
                            num_velocity_bins: int = 32) -> list[str]:
    """The fixed 310-token vocab layout (reference
    data/performance_vocab.txt): id 0 <S>, id 1 <PAD>, TIME_SHIFT_1..100,
    interleaved NOTE_ON_p/NOTE_OFF_p for p in [21,108], VELOCITY_1..32."""
    tokens = ["<S>", "<PAD>"]
    tokens += [f"TIME_SHIFT_{i}" for i in range(1, max_shift_steps + 1)]
    for p in range(min_pitch, max_pitch + 1):
        tokens.append(f"NOTE_ON_{p}")
        tokens.append(f"NOTE_OFF_{p}")
    tokens += [f"VELOCITY_{i}" for i in range(1, num_velocity_bins + 1)]
    return tokens


def augment_note_sequence(ns: NoteSequence, stretch_factor: float,
                          transpose_amount: int, min_pitch: int,
                          max_pitch: int) -> NoteSequence:
    """Time-stretch + pitch-transpose augmentation
    (reference data/performance_event_repo.py:51-66)."""
    augmented = seq_lib.stretch_note_sequence(ns, stretch_factor,
                                              in_place=False)
    _, num_deleted = seq_lib.transpose_note_sequence(
        augmented, transpose_amount,
        min_allowed_pitch=min_pitch, max_allowed_pitch=max_pitch,
        in_place=True)
    if num_deleted:
        print("Transposition caused out-of-range pitch(es).")
    return augmented


class PerformanceEventRepo:
    """Encode/decode MIDI <-> Magenta performance-event token ids.

    ``encoder``: ``"native"`` (the C++ encoder, built at first use; it
    covers the reference's codec parameters, 100 steps a second, 32
    velocity bins and pitches 21-108) or ``"python"``."""

    def __init__(self, steps_per_second=100, num_velocity_bins=32,
                 min_pitch=MIN_PITCH, max_pitch=MAX_PITCH,
                 stretch_factors=(1.0,), pitch_transpose_lower=0,
                 pitch_transpose_upper=0, encoder="native"):
        if encoder not in ENCODERS:
            raise ValueError(f"encoder must be one of {ENCODERS}, got "
                             f"{encoder!r}")
        if encoder == "native" and (steps_per_second, num_velocity_bins,
                                    min_pitch, max_pitch) != (
                                        100, 32, MIN_PITCH, MAX_PITCH):
            raise ValueError(
                "the native encoder covers 100 steps a second, 32 velocity "
                f"bins and pitches {MIN_PITCH}-{MAX_PITCH}; pass "
                "encoder='python' for other codec parameters")
        self.encoder = encoder
        self._steps_per_second = steps_per_second
        self._num_velocity_bins = num_velocity_bins

        with open(PACKAGED_VOCAB, "r") as f:
            self.contents = f.readlines()
        self.ids_to_events = {
            key: value.strip() for key, value in enumerate(self.contents)}
        self.events_to_ids = {
            value.strip(): key for key, value in enumerate(self.contents)}

        self.stretch_factors = list(stretch_factors)
        self.transpose_amounts = list(range(pitch_transpose_lower,
                                            pitch_transpose_upper + 1))
        self.augment_fns = [
            functools.partial(augment_note_sequence, stretch_factor=s,
                              transpose_amount=t, min_pitch=min_pitch,
                              max_pitch=max_pitch)
            for s, t in itertools.product(self.stretch_factors,
                                          self.transpose_amounts)
        ]
        self.min_pitch, self.max_pitch = min_pitch, max_pitch

    # -- note sequence helpers ------------------------------------------------
    def filter_pitches(self, ns: NoteSequence) -> None:
        """In-place keep notes within [min_pitch, max_pitch]
        (reference data/performance_event_repo.py:104-124)."""
        new_note_list = []
        deleted_note_count = 0
        end_time = 0.0
        for note in ns.notes:
            if self.min_pitch <= note.pitch <= self.max_pitch:
                end_time = max(end_time, note.end_time)
                new_note_list.append(note)
            else:
                deleted_note_count += 1
        if deleted_note_count > 0:
            ns.notes = new_note_list
        ns.total_time = end_time

    def _load_midi(self, input_midi: str | None) -> NoteSequence:
        if input_midi:
            ns = midi_io.midi_file_to_note_sequence(input_midi)
            ns = seq_lib.apply_sustain_control_changes(ns)
            ns.control_changes = []
        else:
            ns = NoteSequence()
        return ns

    # -- event <-> id ---------------------------------------------------------
    def encode_event(self, event: perf.PerformanceEvent) -> int:
        if event.event_type == perf.PerformanceEvent.NOTE_ON:
            event_name = f"NOTE_ON_{event.event_value}"
        elif event.event_type == perf.PerformanceEvent.NOTE_OFF:
            event_name = f"NOTE_OFF_{event.event_value}"
        elif event.event_type == perf.PerformanceEvent.TIME_SHIFT:
            event_name = f"TIME_SHIFT_{event.event_value}"
        elif event.event_type == perf.PerformanceEvent.VELOCITY:
            event_name = f"VELOCITY_{event.event_value}"
        else:
            raise ValueError(f"Unknown event type: {event.event_type}")
        return self.events_to_ids[event_name]

    def decode_event(self, index: int) -> perf.PerformanceEvent:
        type_map = {
            "NOTE_ON": perf.PerformanceEvent.NOTE_ON,
            "NOTE_OFF": perf.PerformanceEvent.NOTE_OFF,
            "TIME_SHIFT": perf.PerformanceEvent.TIME_SHIFT,
            "VELOCITY": perf.PerformanceEvent.VELOCITY,
        }
        try:
            event_name = self.ids_to_events[int(index)]
            event_splits = event_name.split("_")
            return perf.PerformanceEvent(
                event_type=type_map["_".join(event_splits[:-1])],
                event_value=int(event_splits[-1]))
        except (KeyError, ValueError) as e:
            raise ValueError(f"Unknown event index: {index}") from e

    # -- encode ---------------------------------------------------------------
    def encode_note_sequence(self, ns: NoteSequence) -> list[int]:
        quantized = seq_lib.quantize_note_sequence_absolute(
            ns, self._steps_per_second)
        events = perf.performance_events_from_quantized_sequence(
            quantized, num_velocity_bins=self._num_velocity_bins)
        return [self.encode_event(e) for e in events]

    def encode(self, input_midi: str | None) -> list[int]:
        """MIDI path -> token ids (reference :205-221); no path encodes
        the empty piece."""
        if input_midi and self.encoder == "native":
            with open(input_midi, "rb") as f:
                return native.encode_midi(f.read(), pitch_filter=True).tolist()
        ns = self._load_midi(input_midi)
        self.filter_pitches(ns)
        return self.encode_note_sequence(ns)

    def encode_transposition(self, input_midi: str | None):
        """Yield one encoding per (stretch, transpose) pair (reference
        :180-203). The reference does NOT pitch-filter here; range
        enforcement comes from the transpose bounds. The native encoder
        parses the MIDI once for the whole grid."""
        if input_midi and self.encoder == "native":
            with open(input_midi, "rb") as f:
                data = f.read()
            lo = self.transpose_amounts[0] if self.transpose_amounts else 0
            for ids in native.encode_midi_grid(
                    data, self.stretch_factors, lo,
                    lo + len(self.transpose_amounts) - 1):
                yield ids.tolist()
            return
        ns = self._load_midi(input_midi)
        for augment_fn in self.augment_fns:
            yield self.encode_note_sequence(augment_fn(ns))

    # -- decode ---------------------------------------------------------------
    def decode(self, event_ids, save_path=None):
        """Token ids -> MIDI file, collapsing TIME_SHIFT_100 runs with the
        reference's exact (quirky) condition (reference :223-250)."""
        tokens = []
        events = []
        for event_id in event_ids:
            event_id = int(event_id)
            if (len(tokens) >= 2
                    and self.ids_to_events[tokens[-1]] == "TIME_SHIFT_100"
                    and self.ids_to_events[event_id] == "TIME_SHIFT_100"):
                continue
            tokens.append(event_id)
            if event_id > 1:
                events.append(self.decode_event(event_id))

        ns = perf.performance_events_to_sequence(
            events, steps_per_second=self._steps_per_second,
            num_velocity_bins=self._num_velocity_bins, max_note_duration=3)
        midi_io.note_sequence_to_midi_file(ns, save_path)
        return save_path

    def create_vocab_txt(self, input_dir: str) -> None:
        event2word = [value.rstrip("\n") for value in self.contents]
        with open(os.path.join(input_dir, "vocab.txt"), "w") as f:
            f.write("\n".join(event2word))

    def midi_quantizer(self, input_midi, output_midi):
        ns = self._load_midi(input_midi)
        midi_io.note_sequence_to_midi_file(ns, output_midi)
        return output_midi

    # -- text / npy round trips ----------------------------------------------
    def to_text(self, input_midi, output_txt):
        ids = self.encode(input_midi)
        event_text = [self.ids_to_events[idx] for idx in ids]
        with open(output_txt, "w") as f:
            f.write("\n".join(event_text))

    def to_text_transposition(self, input_midi, output_txt):
        for i, ids in enumerate(self.encode_transposition(input_midi)):
            event_text = [self.ids_to_events[idx] for idx in ids]
            filename, _ = os.path.splitext(output_txt)
            with open(filename + "_arg" + str(i) + ".txt", "w") as f:
                f.write("\n".join(event_text))

    def from_text(self, input_txt, output_midi):
        with open(input_txt, "r", encoding="utf-8") as f:
            events = f.read().strip().splitlines()
        ids = [self.events_to_ids[event] for event in events]
        return self.decode(ids, save_path=output_midi)

    def to_npy_transposition(self, input_midi, out_npy_file):
        for i, event_ids in enumerate(self.encode_transposition(input_midi)):
            filename, _ = os.path.splitext(out_npy_file)
            event_ids_np = np.array(event_ids, dtype=np.int32)
            np.save(filename + "_arg" + str(i) + ".npy", event_ids_np)

    def to_npy(self, input_midi, out_npy_file):
        event_ids = self.encode(input_midi)
        np.save(out_npy_file, np.array(event_ids, dtype=np.int32))

    def npy_to_midi(self, in_npy_file, out_midi_file):
        event_ids = np.load(in_npy_file)
        return self.decode(event_ids, save_path=out_midi_file)
