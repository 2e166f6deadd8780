"""ctypes binding for the port's native C++ encoder (``native/codec.cpp``).

The source is compiled at first use with ``g++ -O3 -fPIC -std=c++17
-shared`` (``CXX`` names another compiler, as in ``native/Makefile``) into
``build/transformer_gan_torch/`` beside the package. The library is named
by a hash of the source, the compiler and the flags, and is written under a
temporary name and renamed, so processes that build at once (test workers,
an encoding pool) never load half a file. Nothing is compiled at import.

A failed build raises with the compiler's output. Nothing falls back to the
pure-Python encoder: callers reach that only by asking for it
(``PerformanceEventRepo(encoder="python")``), and it stays the bit-exact
oracle the tests hold this encoder to.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "codec.cpp"
BUILD_DIR = _PKG.parent / "build" / "transformer_gan_torch"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]

_lock = threading.Lock()
_lib = None


def _compiler() -> str:
    return os.environ.get("CXX", "g++")


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join([_compiler(), *CXX_FLAGS]).encode())
    return BUILD_DIR / f"libtgtcodec_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/codec.cpp`` unless the library for this source
    exists; return its path. Raises ``RuntimeError`` with the compiler's
    output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=out.stem + ".",
                               suffix=".tmp")
    os.close(fd)
    cmd = [_compiler(), *CXX_FLAGS, "-o", tmp, str(SOURCE)]
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except FileNotFoundError as e:
            raise RuntimeError(f"building the native encoder: compiler "
                               f"{cmd[0]!r} not found (set CXX)") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"building the native encoder failed ({proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)    # atomic: no build sees half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load() -> ctypes.CDLL:
    """The loaded encoder library (built on the first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.tgt_encode_midi.restype = ctypes.c_int
            lib.tgt_encode_midi.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_double,
                ctypes.c_int, ctypes.c_int, i32p, ctypes.c_size_t]
            lib.tgt_encode_midi_grid.restype = ctypes.c_int
            lib.tgt_encode_midi_grid.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                ctypes.c_int, ctypes.c_int, i32p, ctypes.c_size_t, i32p]
            _lib = lib
        return _lib


def _check(n: int, what: str) -> None:
    if n == -1:
        raise ValueError("not a standard MIDI file (native parser)")
    if n < 0:
        raise ValueError(f"native MIDI {what} failed (code {n})")


def encode_midi(midi_bytes: bytes, stretch: float = 1.0, transpose: int = 0,
                pitch_filter: bool = True) -> np.ndarray:
    """MIDI bytes -> int32 token ids. ``pitch_filter``: the canonical
    ``encode`` path (drop pitches outside [21, 108]); off, the augmentation
    path (transpose, then drop what leaves the range)."""
    lib = load()
    cap = max(len(midi_bytes) * 4, 1 << 16)
    while True:
        out = np.empty((cap,), np.int32)
        n = lib.tgt_encode_midi(
            midi_bytes, len(midi_bytes), float(stretch), int(transpose),
            1 if pitch_filter else 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
        if n != -2:     # -2: the buffer was too small
            break
        cap *= 8
    _check(n, "encode")
    return out[:n].copy()


def encode_midi_grid(midi_bytes: bytes, stretches, transpose_lo: int,
                     transpose_hi: int) -> list[np.ndarray]:
    """Parse once and encode the whole augmentation grid, stretch-major
    (the order of ``itertools.product(stretches, transposes)``)."""
    lib = load()
    st = np.asarray(list(stretches), np.float64)
    n_enc = len(st) * max(0, transpose_hi - transpose_lo + 1)
    lengths = np.zeros((max(n_enc, 1),), np.int32)
    cap = max(len(midi_bytes) * 4, 1 << 16) * max(n_enc, 1)
    while True:
        out = np.empty((cap,), np.int32)
        n = lib.tgt_encode_midi_grid(
            midi_bytes, len(midi_bytes),
            st.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(st),
            int(transpose_lo), int(transpose_hi),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if n != -2:
            break
        cap *= 8
    _check(n, "grid encode")
    offsets = np.concatenate([[0], np.cumsum(lengths[:n], dtype=np.int64)])
    return [out[offsets[i]:offsets[i + 1]].copy() for i in range(n)]
