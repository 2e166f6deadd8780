"""Magenta performance-event state machine (encode + decode).

The port's copy of ``transformer_gan_tpu/data/performance.py``:
note_seq.performance_lib.Performance for the absolute-time, velocity-binned
configuration the reference uses (steps_per_second=100,
num_velocity_bins=32). Token ids produced from a quantized NoteSequence are
bit-exact with the reference pipeline.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .midi import Note, NoteSequence
from .sequences import MAX_MIDI_VELOCITY, MIN_MIDI_VELOCITY

DEFAULT_MAX_SHIFT_STEPS = 100
STANDARD_PPQ = 220


@dataclass(frozen=True)
class PerformanceEvent:
    NOTE_ON = 1
    NOTE_OFF = 2
    TIME_SHIFT = 3
    VELOCITY = 4

    event_type: int
    event_value: int


def velocity_bin_size(num_velocity_bins: int) -> int:
    return int(math.ceil(
        (MAX_MIDI_VELOCITY - MIN_MIDI_VELOCITY + 1) / num_velocity_bins))


def velocity_to_bin(velocity: int, num_velocity_bins: int) -> int:
    return ((velocity - MIN_MIDI_VELOCITY)
            // velocity_bin_size(num_velocity_bins) + 1)


def velocity_bin_to_velocity(velocity_bin: int, num_velocity_bins: int) -> int:
    return (MIN_MIDI_VELOCITY
            + (velocity_bin - 1) * velocity_bin_size(num_velocity_bins))


def performance_events_from_quantized_sequence(
        quantized_sequence: NoteSequence,
        start_step: int = 0,
        num_velocity_bins: int = 0,
        max_shift_steps: int = DEFAULT_MAX_SHIFT_STEPS,
        instrument: int | None = None) -> list[PerformanceEvent]:
    """BasePerformance._from_quantized_sequence, faithfully.

    Notes sorted by (start_time, pitch); onset/offset stream sorted by
    (step, idx, is_offset); time shifts chunked at ``max_shift_steps``;
    velocity events emitted on bin change at onsets only.
    """
    notes = [note for note in quantized_sequence.notes
             if not note.is_drum
             and note.quantized_start_step >= start_step
             and (instrument is None or note.instrument == instrument)]
    sorted_notes = sorted(notes, key=lambda note: (note.start_time, note.pitch))

    onsets = [(note.quantized_start_step, idx, False)
              for idx, note in enumerate(sorted_notes)]
    offsets = [(note.quantized_end_step, idx, True)
               for idx, note in enumerate(sorted_notes)]
    note_events = sorted(onsets + offsets)

    current_step = start_step
    current_velocity_bin = 0
    performance_events: list[PerformanceEvent] = []

    for step, idx, is_offset in note_events:
        if step > current_step:
            while step > current_step + max_shift_steps:
                performance_events.append(PerformanceEvent(
                    PerformanceEvent.TIME_SHIFT, max_shift_steps))
                current_step += max_shift_steps
            performance_events.append(PerformanceEvent(
                PerformanceEvent.TIME_SHIFT, step - current_step))
            current_step = step

        if num_velocity_bins:
            velocity_bin = velocity_to_bin(
                sorted_notes[idx].velocity, num_velocity_bins)
            if not is_offset and velocity_bin != current_velocity_bin:
                current_velocity_bin = velocity_bin
                performance_events.append(PerformanceEvent(
                    PerformanceEvent.VELOCITY, velocity_bin))

        performance_events.append(PerformanceEvent(
            PerformanceEvent.NOTE_OFF if is_offset
            else PerformanceEvent.NOTE_ON,
            sorted_notes[idx].pitch))

    return performance_events


def performance_events_to_sequence(
        events: list[PerformanceEvent],
        steps_per_second: float,
        num_velocity_bins: int = 0,
        start_step: int = 0,
        velocity: int = 100,
        instrument: int = 0,
        program: int = 0,
        max_note_duration: float | None = None) -> NoteSequence:
    """BasePerformance._to_sequence: events -> NoteSequence.

    FIFO note-off matching per pitch, zero-duration notes dropped,
    ``max_note_duration`` truncation, dangling note-ons closed at the final
    step (reference decodes with max_note_duration=3;
    data/performance_event_repo.py:247).
    """
    seconds_per_step = 1.0 / steps_per_second
    sequence_start_time = start_step * seconds_per_step
    seq = NoteSequence(ticks_per_quarter=STANDARD_PPQ)
    seq.tempos = []
    step = 0

    # pitch -> list of (start_step, velocity), FIFO
    pitch_start_steps_and_velocities: dict[int, list] = {}

    def _add_note(pitch, pitch_start_step, pitch_velocity):
        start_time = pitch_start_step * seconds_per_step + sequence_start_time
        end_time = step * seconds_per_step + sequence_start_time
        if max_note_duration and end_time - start_time > max_note_duration:
            end_time = start_time + max_note_duration
        note = Note(pitch=pitch, velocity=pitch_velocity,
                    start_time=start_time, end_time=end_time,
                    program=program, instrument=instrument)
        seq.notes.append(note)
        if note.end_time > seq.total_time:
            seq.total_time = note.end_time

    for event in events:
        if event.event_type == PerformanceEvent.NOTE_ON:
            pitch_start_steps_and_velocities.setdefault(
                event.event_value, []).append((step, velocity))
        elif event.event_type == PerformanceEvent.NOTE_OFF:
            open_list = pitch_start_steps_and_velocities.get(
                event.event_value, [])
            if not open_list:
                pass  # NOTE_OFF with no previous NOTE_ON: ignored
            else:
                pitch_start_step, pitch_velocity = open_list.pop(0)
                if step == pitch_start_step:
                    continue  # zero duration: ignored
                _add_note(event.event_value, pitch_start_step, pitch_velocity)
        elif event.event_type == PerformanceEvent.TIME_SHIFT:
            step += event.event_value
        elif event.event_type == PerformanceEvent.VELOCITY:
            assert num_velocity_bins
            velocity = velocity_bin_to_velocity(
                event.event_value, num_velocity_bins)
        else:
            raise ValueError(f"Unknown event type: {event.event_type}")

    # Close any pitches that never received a NOTE_OFF at the final step.
    for pitch, open_list in pitch_start_steps_and_velocities.items():
        for pitch_start_step, pitch_velocity in open_list:
            if step == pitch_start_step:
                continue
            _add_note(pitch, pitch_start_step, pitch_velocity)

    return seq
