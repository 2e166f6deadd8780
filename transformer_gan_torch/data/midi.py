"""Standard MIDI File (SMF) reader/writer, dependency-free.

The port's copy of ``transformer_gan_tpu/data/midi.py`` (the port imports
no module of the JAX package). The reference delegates MIDI I/O to
``note_seq``/``pretty_midi``; this module implements the subset of SMF the
Maestro pipeline needs:

* parse format 0/1 files, build the tempo map, convert ticks to wall-clock
  seconds exactly as pretty_midi does (piecewise-linear over tempo changes),
* pair note-on/note-off events into :class:`Note` records with seconds times,
* collect control changes (sustain pedal CC64 is what the codec consumes),
* write a format-1 file at 220 PPQ / 120 bpm, matching note_seq's
  ``sequence_proto_to_midi_file`` output conventions (STANDARD_PPQ = 220).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field


@dataclass
class Note:
    pitch: int
    velocity: int
    start_time: float
    end_time: float
    program: int = 0
    instrument: int = 0
    is_drum: bool = False


@dataclass
class ControlChange:
    time: float
    control_number: int
    control_value: int
    program: int = 0
    instrument: int = 0
    is_drum: bool = False


@dataclass
class Tempo:
    time: float
    qpm: float


@dataclass
class NoteSequence:
    """Minimal stand-in for note_seq's NoteSequence proto."""

    notes: list = field(default_factory=list)
    control_changes: list = field(default_factory=list)
    tempos: list = field(default_factory=list)
    total_time: float = 0.0
    ticks_per_quarter: int = 220


def _read_varlen(data: bytes, pos: int) -> tuple[int, int]:
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not (b & 0x80):
            return value, pos


def _write_varlen(value: int) -> bytes:
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(out))


class _TickToTime:
    """Tempo map: absolute tick -> seconds (pretty_midi semantics)."""

    def __init__(self, tempo_changes: list[tuple[int, int]], ppq: int):
        # tempo_changes: sorted (tick, us_per_quarter); implicit 120bpm at 0.
        self.ppq = ppq
        changes = sorted(tempo_changes)
        if not changes or changes[0][0] > 0:
            changes = [(0, 500000)] + changes
        self.ticks = []
        self.times = []
        self.us_per_tick = []
        t = 0.0
        last_tick = 0
        last_uspq = changes[0][1]
        self.ticks.append(0)
        self.times.append(0.0)
        self.us_per_tick.append(last_uspq / ppq)
        for tick, uspq in changes[1:]:
            t += (tick - last_tick) * (last_uspq / ppq) * 1e-6
            last_tick, last_uspq = tick, uspq
            self.ticks.append(tick)
            self.times.append(t)
            self.us_per_tick.append(uspq / ppq)

    def __call__(self, tick: int) -> float:
        # binary search over change points
        lo, hi = 0, len(self.ticks) - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self.ticks[mid] <= tick:
                lo = mid
            else:
                hi = mid - 1
        return self.times[lo] + (tick - self.ticks[lo]) * self.us_per_tick[lo] * 1e-6


def midi_file_to_note_sequence(path: str) -> NoteSequence:
    """Parse an SMF file into a :class:`NoteSequence` (seconds times).

    Equivalent role to note_seq.midi_file_to_sequence_proto
    (used at reference data/performance_event_repo.py:189,214).
    """
    with open(path, "rb") as f:
        data = f.read()
    return midi_bytes_to_note_sequence(data)


def midi_bytes_to_note_sequence(data: bytes) -> NoteSequence:
    if data[:4] != b"MThd":
        raise ValueError("not a standard MIDI file")
    hdr_len = struct.unpack(">I", data[4:8])[0]
    fmt, ntrks, division = struct.unpack(">HHH", data[8:14])
    if division & 0x8000:
        raise ValueError("SMPTE time division not supported")
    ppq = division
    pos = 8 + hdr_len

    # First pass: gather raw events per track with absolute ticks.
    tracks = []
    tempo_changes: list[tuple[int, int]] = []
    for _ in range(ntrks):
        if data[pos:pos + 4] != b"MTrk":
            raise ValueError("bad track chunk")
        trk_len = struct.unpack(">I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + trk_len]
        pos += 8 + trk_len
        events = []
        p = 0
        tick = 0
        running = 0
        while p < len(body):
            delta, p = _read_varlen(body, p)
            tick += delta
            status = body[p]
            if status & 0x80:
                p += 1
                if status < 0xF0:
                    running = status
            else:
                status = running
            kind = status & 0xF0
            channel = status & 0x0F
            if kind in (0x80, 0x90, 0xA0, 0xB0, 0xE0):
                d1, d2 = body[p], body[p + 1]
                p += 2
                events.append((tick, kind, channel, d1, d2))
            elif kind in (0xC0, 0xD0):
                d1 = body[p]
                p += 1
                events.append((tick, kind, channel, d1, 0))
            elif status == 0xFF:
                meta = body[p]
                p += 1
                mlen, p = _read_varlen(body, p)
                payload = body[p:p + mlen]
                p += mlen
                if meta == 0x51 and mlen == 3:
                    uspq = (payload[0] << 16) | (payload[1] << 8) | payload[2]
                    tempo_changes.append((tick, uspq))
                # end-of-track / others ignored
            elif status in (0xF0, 0xF7):  # sysex
                slen, p = _read_varlen(body, p)
                p += slen
            else:
                raise ValueError(f"unhandled status byte {status:#x}")
        tracks.append(events)

    t2t = _TickToTime(tempo_changes, ppq)
    ns = NoteSequence(ticks_per_quarter=ppq)
    for tick, uspq in sorted(tempo_changes):
        ns.tempos.append(Tempo(time=t2t(tick), qpm=6e7 / uspq))
    if not ns.tempos:
        ns.tempos.append(Tempo(time=0.0, qpm=120.0))

    total = 0.0
    for instrument, events in enumerate(tracks):
        program = {ch: 0 for ch in range(16)}
        # (channel, pitch) -> list of (start_tick, velocity)
        open_notes: dict[tuple[int, int], list[tuple[int, int]]] = {}
        for tick, kind, channel, d1, d2 in events:
            if kind == 0xC0:
                program[channel] = d1
            elif kind == 0x90 and d2 > 0:
                open_notes.setdefault((channel, d1), []).append((tick, d2))
            elif kind == 0x80 or (kind == 0x90 and d2 == 0):
                key = (channel, d1)
                if key in open_notes and open_notes[key]:
                    still_open = []
                    for start_tick, vel in open_notes[key]:
                        if start_tick == tick:
                            # zero-length so far: stays open (pretty_midi)
                            still_open.append((start_tick, vel))
                            continue
                        note = Note(
                            pitch=d1, velocity=vel,
                            start_time=t2t(start_tick), end_time=t2t(tick),
                            program=program[channel],
                            instrument=instrument,
                            is_drum=(channel == 9),
                        )
                        ns.notes.append(note)
                        total = max(total, note.end_time)
                    open_notes[key] = still_open
            elif kind == 0xB0:
                ns.control_changes.append(ControlChange(
                    time=t2t(tick), control_number=d1, control_value=d2,
                    program=program[channel], instrument=instrument,
                    is_drum=(channel == 9)))
    ns.notes.sort(key=lambda n: (n.instrument, n.start_time, n.pitch))
    ns.control_changes.sort(key=lambda c: (c.instrument, c.time))
    ns.total_time = total
    return ns


STANDARD_PPQ = 220  # note_seq constants.STANDARD_PPQ


def note_sequence_to_midi_bytes(ns: NoteSequence, qpm: float = 120.0) -> bytes:
    """Serialize to a format-1 SMF (220 PPQ, constant tempo).

    Equivalent role to note_seq.sequence_proto_to_midi_file
    (reference data/performance_event_repo.py:248).
    """
    ppq = STANDARD_PPQ
    uspq = int(round(6e7 / qpm))
    sec_to_tick = ppq * qpm / 60.0

    # Track 0: tempo
    trk0 = b"\x00" + bytes([0xFF, 0x51, 0x03]) + struct.pack(">I", uspq)[1:]
    trk0 += b"\x00\xff\x2f\x00"

    # Track 1: notes + control changes on channel 0
    events = []  # (tick, order, statusbyte, d1, d2)
    for note in ns.notes:
        on_tick = int(round(note.start_time * sec_to_tick))
        off_tick = int(round(note.end_time * sec_to_tick))
        events.append((on_tick, 1, 0x90, note.pitch, note.velocity))
        events.append((off_tick, 0, 0x80, note.pitch, 64))
    for cc in ns.control_changes:
        events.append((int(round(cc.time * sec_to_tick)), 2, 0xB0,
                       cc.control_number, cc.control_value))
    events.sort(key=lambda e: (e[0], e[1]))

    body = bytearray()
    last = 0
    for tick, _, status, d1, d2 in events:
        body += _write_varlen(tick - last)
        body += bytes([status, d1, d2])
        last = tick
    body += b"\x00\xff\x2f\x00"

    out = bytearray()
    out += b"MThd" + struct.pack(">IHHH", 6, 1, 2, ppq)
    out += b"MTrk" + struct.pack(">I", len(trk0)) + trk0
    out += b"MTrk" + struct.pack(">I", len(body)) + bytes(body)
    return bytes(out)


def note_sequence_to_midi_file(ns: NoteSequence, path: str) -> str:
    with open(path, "wb") as f:
        f.write(note_sequence_to_midi_bytes(ns))
    return path
