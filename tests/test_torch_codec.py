"""The port's codec (transformer_gan_torch/data) against the JAX package's
pure-Python codec, bit for bit: token ids of random and adversarial
sequences (sustain CC 63/64 edges, same-time event order, zero durations,
the velocity-bin sweep, stretch factors on the .5 rounding cut-off), the
35-way stretch x transpose grid, the tempo map, decoded MIDI bytes, text
round trips and the decode -> encode fixed point. The port's native
encoder is held to its own pure-Python encoder on every case, and its build
(a failed compiler raises; concurrent builds) is checked. The JAX side is
always ``encode_note_sequence`` on the file its SMF reader loads, so its
own native library is never the oracle."""

import os
import subprocess
import sys

import numpy as np
import pytest

from transformer_gan_torch.config import PACKAGED_VOCAB
from transformer_gan_torch.data import codec as tcodec
from transformer_gan_torch.data import midi as tmidi
from transformer_gan_torch.data import native
from transformer_gan_torch.data import performance as tperf
from transformer_gan_torch.data import sequences as tseq
from transformer_gan_tpu.data import codec as jcodec
from transformer_gan_tpu.data import midi as jmidi
from transformer_gan_tpu.data import performance as jperf
from transformer_gan_tpu.data import sequences as jseq

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = dict(stretch_factors=[0.95, 0.975, 1.0, 1.025, 1.05],
            pitch_transpose_lower=-3, pitch_transpose_upper=3)


# ---------------------------------------------------------------------------
# sequences, written once per package from the same plain description
# ---------------------------------------------------------------------------

def _ns(mod, notes, ccs=(), total=None):
    """A NoteSequence of ``mod`` (a package's midi module) from
    (pitch, velocity, start, end) notes and (time, value) CC64 events."""
    ns = mod.NoteSequence()
    ns.notes = [mod.Note(pitch=p, velocity=v, start_time=s, end_time=e)
                for p, v, s, e in notes]
    ns.control_changes = [mod.ControlChange(time=t, control_number=64,
                                            control_value=v)
                          for t, v in ccs]
    ns.total_time = (max(n.end_time for n in ns.notes) if total is None
                     else total)
    return ns


def _random_description(rng, n_notes=40, with_sustain=True,
                        wide_pitch=False):
    notes, t = [], 0.0
    lo, hi = (0, 127) if wide_pitch else (21, 108)
    for _ in range(n_notes):
        t += rng.uniform(0.0, 0.35)
        notes.append((int(rng.randint(lo, hi + 1)), int(rng.randint(1, 128)),
                      t, t + rng.uniform(0.02, 2.0)))
    ccs, tt = [], 0.0
    if with_sustain:
        for _ in range(6):
            tt += rng.uniform(0.2, 2.0)
            ccs.append((tt, int(rng.choice([0, 127]))))
    return notes, ccs


def _boundary_sustain_description(seed):
    rng = np.random.RandomState(100 + seed)
    notes, t = [], 0.0
    for _ in range(40):
        t += float(rng.randint(0, 40)) / 100
        notes.append((int(rng.randint(21, 109)), int(rng.randint(1, 128)), t,
                      t + float(rng.randint(1, 120)) / 100))
    ccs, tt = [], 0.0
    for _ in range(25):
        tt += float(rng.randint(0, 60)) / 100
        ccs.append((tt, int(rng.choice([0, 62, 63, 64, 65, 127, 127]))))
    return notes, ccs


def _cutoff_description():
    """Onsets that land exactly on a .5 step cut-off after one of the grid's
    stretches."""
    stretches = GRID["stretch_factors"]
    rng = np.random.RandomState(0)
    notes, t = [], 0.0
    for i in range(30):
        s = stretches[i % len(stretches)]
        t += round((1 + int(rng.randint(1, 20))) * 0.005 / s, 10)
        notes.append((int(rng.randint(21, 109)), int(rng.randint(1, 128)), t,
                      t + float(rng.randint(1, 50)) / 100))
    return notes, []


# the adversarial cases of tests/test_codec_adversarial.py and
# tests/test_codec.py: (notes, CC64 events, total_time or None)
ADVERSARIAL = {
    "cc64_engages": ([(60, 80, 0.0, 0.5)], [(0.1, 64), (2.0, 0)], 0.5),
    "cc63_does_not": ([(60, 80, 0.0, 0.5)], [(0.1, 63), (2.0, 0)], 0.5),
    "release_at_63": ([(60, 80, 0.0, 0.5)],
                      [(0.0, 127), (1.0, 63), (1.5, 127), (3.0, 0)], 0.5),
    "repeated_pedal": ([(60, 80, 0.0, 0.3)],
                       [(0.0, 100), (0.1, 127), (1.0, 10), (1.2, 0)], 0.3),
    "same_time_order": ([(60, 80, 0.0, 0.5), (64, 80, 2.0, 2.5)],
                        [(0.5, 127), (2.0, 0)], 2.5),
    "zero_duration_reonset": ([(60, 80, 1.0, 1.2), (60, 90, 1.0, 1.5)],
                              [(0.0, 127), (3.0, 0)], 1.5),
    "dangling_pedal": ([(60, 80, 0.0, 0.5), (64, 80, 0.2, 4.0)],
                       [(0.1, 127)], 4.0),
    "note_past_total_time": ([(60, 1, 0.0, 2.0)], [], 0.5),
    "same_step_same_pitch": ([(60, 10, 0.0, 0.5), (60, 10, 0.5, 1.0)], [],
                             1.0),
    "same_step_cross_pitch": ([(70, 10, 0.0, 0.5), (60, 10, 0.5, 1.0)], [],
                              1.0),
    "zero_duration_note": ([(60, 1, 1.0, 1.0005)], [], 1.0005),
    "velocity_sweep": ([(60, v, 0.1 * (v - 1), 0.1 * (v - 1) + 0.05)
                        for v in range(1, 128)], [], None),
    "same_bin_velocity": ([(60, 5, 0.0, 0.1), (62, 8, 0.2, 0.3)], [], 0.3),
    "time_shift_chunking": ([(60, 1, 3.205, 3.5)], [], 3.5),
    "stretch_cutoff_t01": ([(60, 1, 0.1, 0.5)], [], 0.5),
    "chord_and_gap": ([(60, 80, 0.0, 0.5), (64, 100, 0.25, 0.75),
                       (67, 100, 2.0, 2.5)], [], 2.5),
}


def _notes_of(ns):
    return [(n.pitch, n.velocity, n.start_time, n.end_time)
            for n in ns.notes], ns.total_time


def _write(tmp_path, name, notes, ccs=(), total=None):
    """Both packages' SMF writers give the same bytes; the file is the
    port's."""
    tb = tmidi.note_sequence_to_midi_bytes(_ns(tmidi, notes, ccs, total))
    jb = jmidi.note_sequence_to_midi_bytes(_ns(jmidi, notes, ccs, total))
    assert tb == jb
    path = str(tmp_path / f"{name}.mid")
    with open(path, "wb") as f:
        f.write(tb)
    return path


def _jax_encode(path):
    """The JAX package's pure-Python canonical encode of a file."""
    repo = jcodec.PerformanceEventRepo()
    ns = repo._load_midi(path)
    repo.filter_pitches(ns)
    return repo.encode_note_sequence(ns)


def _jax_grid(path):
    repo = jcodec.PerformanceEventRepo(**GRID)
    ns = repo._load_midi(path)
    return [repo.encode_note_sequence(fn(ns)) for fn in repo.augment_fns]


def _assert_encodes_like_jax(path):
    ref = _jax_encode(path)
    assert tcodec.PerformanceEventRepo(encoder="python").encode(path) == ref
    assert tcodec.PerformanceEventRepo().encode(path) == ref
    return ref


def _assert_grid_like_jax(path):
    ref = _jax_grid(path)
    assert len(ref) == 35
    for encoder in tcodec.ENCODERS:
        got = list(tcodec.PerformanceEventRepo(
            encoder=encoder, **GRID).encode_transposition(path))
        assert got == ref, encoder


# ---------------------------------------------------------------------------
# vocab and helpers
# ---------------------------------------------------------------------------

def test_vocab_matches_jax_and_packaged_file():
    vocab = tcodec.build_performance_vocab()
    assert vocab == jcodec.build_performance_vocab()
    with open(PACKAGED_VOCAB) as f:
        assert [line.strip() for line in f if line.strip()] == vocab
    repo = tcodec.PerformanceEventRepo(encoder="python")
    assert repo.ids_to_events == jcodec.PerformanceEventRepo().ids_to_events


def test_velocity_bins_and_quantize_steps_match_jax():
    for v in range(1, 128):
        assert tperf.velocity_to_bin(v, 32) == jperf.velocity_to_bin(v, 32)
    for b in range(1, 33):
        assert (tperf.velocity_bin_to_velocity(b, 32)
                == jperf.velocity_bin_to_velocity(b, 32))
    for t in (0.0, 0.004999, 0.005, 0.105, 1.0049999, 2.675):
        assert tseq.quantize_to_step(t, 100) == jseq.quantize_to_step(t, 100)


def test_encoder_choice_is_explicit(monkeypatch, tmp_path):
    """No silent fallback: a native repo whose library cannot be built
    raises; the Python encoder is reached only by asking for it, and the
    native encoder refuses codec parameters it does not cover."""
    with pytest.raises(ValueError, match="encoder must be"):
        tcodec.PerformanceEventRepo(encoder="fast")
    with pytest.raises(ValueError, match="encoder='python'"):
        tcodec.PerformanceEventRepo(num_velocity_bins=16)
    assert tcodec.PerformanceEventRepo(
        num_velocity_bins=16, encoder="python").encoder == "python"
    path = _write(tmp_path, "x", [(60, 80, 0.0, 0.5)])

    def broken():
        raise RuntimeError("building the native encoder failed (1)")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build", broken)
    with pytest.raises(RuntimeError, match="native encoder failed"):
        tcodec.PerformanceEventRepo().encode(path)
    with pytest.raises(RuntimeError, match="native encoder failed"):
        list(tcodec.PerformanceEventRepo(**GRID).encode_transposition(path))
    assert tcodec.PerformanceEventRepo(encoder="python").encode(path) == (
        _jax_encode(path))
    assert tcodec.PerformanceEventRepo().encode(None) == []


# ---------------------------------------------------------------------------
# sustain and the event machine, on the NoteSequence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(ADVERSARIAL))
def test_adversarial_sustain_and_ids_match_jax(case):
    notes, ccs, total = ADVERSARIAL[case]
    t = tseq.apply_sustain_control_changes(_ns(tmidi, notes, ccs, total))
    j = jseq.apply_sustain_control_changes(_ns(jmidi, notes, ccs, total))
    assert _notes_of(t) == _notes_of(j)
    trepo = tcodec.PerformanceEventRepo(encoder="python")
    jrepo = jcodec.PerformanceEventRepo()
    ids = trepo.encode_note_sequence(_ns(tmidi, notes, ccs, total))
    assert ids == jrepo.encode_note_sequence(_ns(jmidi, notes, ccs, total))
    assert ids


@pytest.mark.parametrize("case", sorted(ADVERSARIAL))
def test_adversarial_files_encode_like_jax(tmp_path, case):
    """Through the SMF file: native == pure Python == JAX, canonical and on
    the 35-way grid."""
    notes, ccs, total = ADVERSARIAL[case]
    path = _write(tmp_path, case, notes, ccs, total)
    _assert_encodes_like_jax(path)
    _assert_grid_like_jax(path)


@pytest.mark.parametrize("stretch", [0.95, 1.05])
def test_stretch_rounding_cutoff_matches_jax(stretch):
    """stretch 1.05 puts a t=0.1 onset at 10.5 steps, on the round-half-up
    cut-off: the port's stretch + quantize take the same float path."""
    notes = [(60, 1, 0.1, 0.5)]
    t = tseq.stretch_note_sequence(_ns(tmidi, notes), stretch)
    j = jseq.stretch_note_sequence(_ns(jmidi, notes), stretch)
    assert _notes_of(t) == _notes_of(j)
    qt = tseq.quantize_note_sequence_absolute(t, 100)
    qj = jseq.quantize_note_sequence_absolute(j, 100)
    assert ([(n.quantized_start_step, n.quantized_end_step) for n in qt.notes]
            == [(n.quantized_start_step, n.quantized_end_step)
                for n in qj.notes])
    assert qt.total_quantized_steps == qj.total_quantized_steps


@pytest.mark.parametrize("amount", [-30, -3, 0, 3, 30])
def test_transpose_matches_jax(amount):
    notes, _ = _random_description(np.random.RandomState(3), wide_pitch=True)
    t, td = tseq.transpose_note_sequence(_ns(tmidi, notes), amount, 21, 108)
    j, jd = jseq.transpose_note_sequence(_ns(jmidi, notes), amount, 21, 108)
    assert td == jd and _notes_of(t) == _notes_of(j)


# ---------------------------------------------------------------------------
# files: random, boundary sustain, stretch cut-offs, tempo map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(8))
def test_random_files_encode_like_jax(tmp_path, seed):
    """With and without sustain, pitches over the whole MIDI range."""
    rng = np.random.RandomState(seed)
    notes, ccs = _random_description(rng, with_sustain=seed % 2 == 0,
                                     wide_pitch=seed % 3 == 0)
    path = _write(tmp_path, f"r{seed}", notes, ccs)
    assert _assert_encodes_like_jax(path)


@pytest.mark.parametrize("seed", range(4))
def test_random_grid_like_jax(tmp_path, seed):
    notes, ccs = _random_description(np.random.RandomState(100 + seed))
    _assert_grid_like_jax(_write(tmp_path, f"g{seed}", notes, ccs))


@pytest.mark.parametrize("seed", range(4))
def test_boundary_sustain_files_like_jax(tmp_path, seed):
    """CC64 values 62-65 and repeated ons / offs."""
    notes, ccs = _boundary_sustain_description(seed)
    path = _write(tmp_path, f"b{seed}", notes, ccs)
    _assert_encodes_like_jax(path)
    _assert_grid_like_jax(path)


def test_stretch_cutoff_grid_like_jax(tmp_path):
    notes, ccs = _cutoff_description()
    _assert_grid_like_jax(_write(tmp_path, "cutoff", notes, ccs))


def _tempo_map_smf():
    """Format 1, 480 PPQ, tempo 120 -> 240 -> 80 bpm at ticks 960 / 1920,
    a running-status-free note track."""
    import struct

    def vl(x):
        out = [x & 0x7F]
        x >>= 7
        while x:
            out.append((x & 0x7F) | 0x80)
            x >>= 7
        return bytes(reversed(out))

    trk0 = b"\x00\xff\x51\x03" + (500000).to_bytes(3, "big")
    trk0 += vl(960) + b"\xff\x51\x03" + (250000).to_bytes(3, "big")
    trk0 += vl(960) + b"\xff\x51\x03" + (750000).to_bytes(3, "big")
    trk0 += b"\x00\xff\x2f\x00"
    trk1 = b"\x00\x90\x3c\x50" + vl(480) + b"\x80\x3c\x40"
    trk1 += vl(960) + b"\x90\x40\x64" + vl(1440) + b"\x80\x40\x40"
    trk1 += b"\x00\xff\x2f\x00"
    smf = b"MThd" + struct.pack(">IHHH", 6, 1, 2, 480)
    smf += b"MTrk" + struct.pack(">I", len(trk0)) + trk0
    smf += b"MTrk" + struct.pack(">I", len(trk1)) + trk1
    return smf


def test_tempo_map_matches_jax(tmp_path):
    smf = _tempo_map_smf()
    t = tmidi.midi_bytes_to_note_sequence(smf)
    j = jmidi.midi_bytes_to_note_sequence(smf)
    assert _notes_of(t) == _notes_of(j)
    assert ([(x.time, x.qpm) for x in t.tempos]
            == [(x.time, x.qpm) for x in j.tempos])
    path = str(tmp_path / "tempo.mid")
    with open(path, "wb") as f:
        f.write(smf)
    assert _assert_encodes_like_jax(path)
    _assert_grid_like_jax(path)


def test_garbage_is_rejected_by_both_encoders(tmp_path):
    with pytest.raises(ValueError, match="not a standard MIDI"):
        native.encode_midi(b"this is not a midi file")
    path = tmp_path / "bad.mid"
    path.write_bytes(b"this is not a midi file")
    for encoder in tcodec.ENCODERS:
        with pytest.raises(ValueError, match="not a standard MIDI"):
            tcodec.PerformanceEventRepo(encoder=encoder).encode(str(path))


def test_native_grows_its_buffer_for_long_silences(tmp_path):
    """Two notes 70,000 s apart: 70,000 TIME_SHIFT_100 ids from a file of
    under 100 bytes, past the first output buffer (65,536 ids an
    encoding), so the native encoder retries with a larger one."""
    notes = [(60, 80, 0.0, 0.5), (62, 80, 70000.0, 70000.5)]
    path = _write(tmp_path, "gap", notes)
    ids = _assert_encodes_like_jax(path)
    assert len(ids) > 1 << 16
    with open(path, "rb") as f:
        grid = native.encode_midi_grid(f.read(), [1.0, 1.05], 0, 0)
    jrepo = jcodec.PerformanceEventRepo(stretch_factors=[1.0, 1.05])
    ns = jrepo._load_midi(path)
    assert [g.tolist() for g in grid] == [
        jrepo.encode_note_sequence(fn(ns)) for fn in jrepo.augment_fns]


# ---------------------------------------------------------------------------
# decode: MIDI bytes, text round trips, the fixed point
# ---------------------------------------------------------------------------

def _token_soup(seed, n=150):
    rng = np.random.RandomState(1000 + seed)
    repo = jcodec.PerformanceEventRepo()
    ids = []
    for _ in range(n):
        r = rng.rand()
        if r < 0.35:
            ids.append(int(rng.randint(2, 102)))
        elif r < 0.6:
            ids.append(repo.events_to_ids[f"NOTE_ON_{rng.randint(21, 109)}"])
        elif r < 0.85:
            ids.append(repo.events_to_ids[f"NOTE_OFF_{rng.randint(21, 109)}"])
        else:
            ids.append(repo.events_to_ids[f"VELOCITY_{rng.randint(1, 33)}"])
    return ids


@pytest.mark.parametrize("seed", range(6))
def test_decode_writes_jax_bytes(tmp_path, seed):
    """Random token soup, runs of TIME_SHIFT_100 and <S> / <PAD> included."""
    ids = [0] + _token_soup(seed) + [101] * 5 + [1, 1]
    tcodec.PerformanceEventRepo().decode(ids, str(tmp_path / "t.mid"))
    jcodec.PerformanceEventRepo().decode(ids, str(tmp_path / "j.mid"))
    got = (tmp_path / "t.mid").read_bytes()
    assert got == (tmp_path / "j.mid").read_bytes()


def test_text_npy_and_quantizer_round_trips_match_jax(tmp_path):
    """to_text / from_text / to_text_transposition / to_npy /
    to_npy_transposition / npy_to_midi / midi_quantizer / create_vocab_txt
    write the JAX package's bytes."""
    notes, ccs = _random_description(np.random.RandomState(11))
    mid = _write(tmp_path, "piece", notes, ccs)
    out = {}
    for name, repo in (("t", tcodec.PerformanceEventRepo(**GRID)),
                       ("j", jcodec.PerformanceEventRepo(**GRID))):
        d = tmp_path / name
        d.mkdir()
        repo.to_text(mid, str(d / "a.txt"))
        repo.from_text(str(d / "a.txt"), str(d / "a.mid"))
        repo.to_text_transposition(mid, str(d / "g.txt"))
        repo.to_npy(mid, str(d / "a.npy"))
        repo.to_npy_transposition(mid, str(d / "g.npy"))
        repo.npy_to_midi(str(d / "a.npy"), str(d / "b.mid"))
        repo.midi_quantizer(mid, str(d / "q.mid"))
        repo.create_vocab_txt(str(d))
        out[name] = {p: (d / p).read_bytes() for p in sorted(os.listdir(d))}
    assert len(out["t"]) == 6 + 2 * 35
    assert out["t"] == out["j"]


@pytest.mark.parametrize("seed", range(8))
def test_decode_encode_fixed_point_matches_jax(tmp_path, seed):
    """decode -> encode from random token soup: the same ids as JAX's at
    every pass, reaching the same fixed point within 4 passes (decode's
    TIME_SHIFT_100 collapse can need a second pass)."""
    trajectories = {}
    for name, repo in (("t", tcodec.PerformanceEventRepo()),
                       ("j", jcodec.PerformanceEventRepo())):
        prev, traj = _token_soup(seed), []
        for it in range(5):
            mid = str(tmp_path / f"{name}{it}.mid")
            repo.decode(prev, save_path=mid)
            cur = (list(repo.encode(mid)) if name == "t"
                   else _jax_encode(mid))
            traj.append(cur)
            if cur == prev:
                break
            prev = cur
        else:
            pytest.fail(f"no fixed point within 5 passes ({name})")
        trajectories[name] = traj
    assert trajectories["t"] == trajectories["j"]
    assert len(trajectories["t"]) <= 4


# ---------------------------------------------------------------------------
# the native build
# ---------------------------------------------------------------------------

def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="native encoder failed") as e:
        native.build()
    assert "false -O3" in str(e.value)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="not found"):
        native.build()
    assert os.listdir(tmp_path) == []      # no temporary file left behind


def test_concurrent_builds_give_one_library(tmp_path):
    """Three processes build into one empty directory at once: each loads
    the library and encodes, and the directory holds one library and no
    temporary file."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from transformer_gan_torch.data import native\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "native.load()\n"
        "print(len(native.encode_midi(open(sys.argv[2], 'rb').read())))\n")
    mid = _write(tmp_path, "c", *_random_description(np.random.RandomState(5)))
    out = tmp_path / "build"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(out), mid],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    results = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], results
    want = str(len(_jax_encode(mid)))
    assert [r[0].strip() for r in results] == [want] * 3
    assert os.listdir(out) == [native.library_path().name]
