"""NoteSequence transforms: sustain pedal, stretch, transpose, quantize.

The port's copy of ``transformer_gan_tpu/data/sequences.py``: the
note_seq.sequences_lib algorithms the reference codec depends on
(``apply_sustain_control_changes``, ``stretch_note_sequence``,
``transpose_note_sequence`` and ``quantize_note_sequence_absolute``) with
note_seq's event ordering, rounding cutoffs and zero-duration handling, so
the token ids are bit-exact with the reference pipeline.
"""

from __future__ import annotations

import copy
from collections import defaultdict

from .midi import NoteSequence

MIN_MIDI_PITCH = 0
MAX_MIDI_PITCH = 127
MIN_MIDI_VELOCITY = 1
MAX_MIDI_VELOCITY = 127

_SUSTAIN_ON = 0
_SUSTAIN_OFF = 1
_NOTE_ON = 2
_NOTE_OFF = 3


class NegativeTimeError(Exception):
    pass


def apply_sustain_control_changes(ns: NoteSequence,
                                  sustain_control_number: int = 64
                                  ) -> NoteSequence:
    """Extend note durations while the sustain pedal (CC64 >= 64) is down.

    Mirrors note_seq.sequences_lib.apply_sustain_control_changes, including
    the stable time-ordering of (sustain-on, sustain-off, note-on, note-off)
    at equal times and the deletion of notes driven to zero duration by a
    re-onset of the same pitch under pedal.
    """
    seq = copy.deepcopy(ns)
    events = []
    events.extend((cc.time, _SUSTAIN_ON, cc) for cc in seq.control_changes
                  if cc.control_number == sustain_control_number
                  and cc.control_value >= 64)
    events.extend((cc.time, _SUSTAIN_OFF, cc) for cc in seq.control_changes
                  if cc.control_number == sustain_control_number
                  and cc.control_value < 64)
    events.extend((n.start_time, _NOTE_ON, n) for n in seq.notes)
    events.extend((n.end_time, _NOTE_OFF, n) for n in seq.notes)
    events.sort(key=lambda e: (e[0], e[1]))

    active_notes = defaultdict(list)   # keyed by (instrument, program)
    sus_active = defaultdict(bool)
    deleted = set()

    time = 0.0
    for time, kind, event in events:
        key = (event.instrument, event.program)
        if kind == _SUSTAIN_ON:
            sus_active[key] = True
        elif kind == _SUSTAIN_OFF:
            sus_active[key] = False
            still = []
            for note in active_notes[key]:
                if note.end_time < time:
                    note.end_time = time
                    if time > seq.total_time:
                        seq.total_time = time
                else:
                    still.append(note)
            active_notes[key] = still
        elif kind == _NOTE_ON:
            if sus_active[key]:
                still = []
                for note in active_notes[key]:
                    if note.pitch == event.pitch:
                        note.end_time = time
                        if note.start_time == note.end_time:
                            # Zero-duration from same-pitch re-onset under
                            # pedal: note_seq deletes this note.
                            deleted.add(id(note))
                    else:
                        still.append(note)
                active_notes[key] = still
            active_notes[key].append(event)
        else:  # _NOTE_OFF
            if sus_active[key]:
                pass  # extended until pedal release
            else:
                lst = active_notes[key]
                for i, note in enumerate(lst):
                    if note is event:
                        del lst[i]
                        break

    # Notes still being extended at the end of the event stream end at the
    # final event time.
    for notes in active_notes.values():
        for note in notes:
            note.end_time = time
            seq.total_time = time

    if deleted:
        seq.notes = [n for n in seq.notes if id(n) not in deleted]
    return seq


def stretch_note_sequence(ns: NoteSequence, stretch_factor: float,
                          in_place: bool = False) -> NoteSequence:
    """Time-stretch all event times (note_seq.sequences_lib semantics)."""
    seq = ns if in_place else copy.deepcopy(ns)
    if stretch_factor == 1.0:
        return seq
    for note in seq.notes:
        note.start_time *= stretch_factor
        note.end_time *= stretch_factor
    seq.total_time *= stretch_factor
    for cc in seq.control_changes:
        cc.time *= stretch_factor
    for tempo in seq.tempos:
        tempo.time *= stretch_factor
        tempo.qpm /= stretch_factor
    return seq


def transpose_note_sequence(ns: NoteSequence, amount: int,
                            min_allowed_pitch: int = MIN_MIDI_PITCH,
                            max_allowed_pitch: int = MAX_MIDI_PITCH,
                            in_place: bool = False):
    """Pitch-shift notes; delete notes leaving [min, max]. Returns
    (sequence, num_deleted) like note_seq.sequences_lib.transpose_note_sequence.
    """
    seq = ns if in_place else copy.deepcopy(ns)
    kept = []
    deleted = 0
    end_time = 0.0
    for note in seq.notes:
        if not note.is_drum:
            new_pitch = note.pitch + amount
            if min_allowed_pitch <= new_pitch <= max_allowed_pitch:
                note.pitch = new_pitch
                kept.append(note)
                end_time = max(end_time, note.end_time)
            else:
                deleted += 1
        else:
            kept.append(note)
            end_time = max(end_time, note.end_time)
    if deleted:
        seq.notes = kept
        seq.total_time = end_time
    return seq, deleted


QUANTIZE_CUTOFF = 0.5


def quantize_to_step(unquantized_seconds: float, steps_per_second: float,
                     quantize_cutoff: float = QUANTIZE_CUTOFF) -> int:
    """note_seq.sequences_lib.quantize_to_step: round-half-up."""
    unquantized_steps = unquantized_seconds * steps_per_second
    return int(unquantized_steps + (1 - quantize_cutoff))


def quantize_note_sequence_absolute(ns: NoteSequence,
                                    steps_per_second: float) -> NoteSequence:
    """Absolute-time quantization (note_seq semantics).

    Annotates each note with ``quantized_start_step``/``quantized_end_step``
    (end bumped to start+1 when equal) and each control change with
    ``quantized_step``.
    """
    qns = copy.deepcopy(ns)
    qns.steps_per_second = steps_per_second
    qns.total_quantized_steps = quantize_to_step(qns.total_time,
                                                 steps_per_second)
    for note in qns.notes:
        note.quantized_start_step = quantize_to_step(note.start_time,
                                                     steps_per_second)
        note.quantized_end_step = quantize_to_step(note.end_time,
                                                   steps_per_second)
        if note.quantized_end_step == note.quantized_start_step:
            note.quantized_end_step += 1
        if note.quantized_start_step < 0 or note.quantized_end_step < 0:
            raise NegativeTimeError(
                "Got negative note time: start_step = %s, end_step = %s"
                % (note.quantized_start_step, note.quantized_end_step))
        if note.quantized_end_step > qns.total_quantized_steps:
            qns.total_quantized_steps = note.quantized_end_step
    for cc in qns.control_changes:
        cc.quantized_step = quantize_to_step(cc.time, steps_per_second)
        if cc.quantized_step < 0:
            raise NegativeTimeError(
                "Got negative control change time: step = %s"
                % cc.quantized_step)
    return qns
