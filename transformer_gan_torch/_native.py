"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` into one shared library
with a plain C interface under ``build/transformer_gan_torch/`` (beside the
package), named by a hash of the sources so an edit triggers a rebuild.
The library is loaded with ``ctypes``; every entry point returns
``cudaGetLastError()`` and :func:`check` raises when it is not 0.

Nothing is compiled or loaded at import: the CPU tests import every module
and never reach this code. A failed build raises; no caller falls back.

Each kernel wrapper counts its launches in :data:`LAUNCHES`, adding one only
where it launches its kernel, so a run can show that the main path went
through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "transformer_gan_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo"]

# kernel name -> launches since the last reset_launches()
# (the "_tc" entries count the bf16 K1f / K1b / K2f / K2b calls that ran the
# tensor-core kernels, a subset of the calls of the plain names)
LAUNCHES: dict[str, int] = {"xl_attn_fwd_v2": 0, "xl_attn_fwd_v1": 0,
                            "xl_attn_bwd_v2": 0, "xl_attn_bwd_v1": 0,
                            "xl_attn_fwd_v2_tc": 0, "xl_attn_bwd_v2_tc": 0,
                            "xl_attn_fwd_v1_tc": 0, "xl_attn_bwd_v1_tc": 0,
                            "generate_chunk": 0, "decode_chunk": 0,
                            "decode_step": 0, "chain_bwd_res": 0,
                            "chain_bwd_recompute": 0}

_lock = threading.Lock()
_lib = None
BUILD_LOG: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def _sources() -> list[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the port's CUDA kernels")
    return found


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libtgt_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists:
    one ``nvcc -c`` per source, all started together, then one link.
    Returns its path; raises ``RuntimeError`` with nvcc's output on failure.
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills) to a
    fresh build; its output lands in ``BUILD_LOG["log"]``."""
    out = library_path()
    if out.exists():
        BUILD_LOG.update(path=str(out), seconds=0.0, cached=True, log="")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        jobs = []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = os.path.join(tmp_dir, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", str(CSRC), "-c",
                   "-o", obj, str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for cmd, _, proc in jobs:
            text, _ = proc.communicate()
            log.append(text)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{text}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = os.path.join(tmp_dir, "lib.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp,
               *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    BUILD_LOG.update(path=str(out), seconds=time.perf_counter() - t0,
                     cached=False, log="".join(log))
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            i64, u32 = ctypes.c_longlong, ctypes.c_uint
            handle.tg_xl_attn_fwd.argtypes = [
                i32, i32, vp, vp, vp, vp, i64, vp, vp, i64, vp, vp, vp,
                vp, vp, vp, i32, i32, i32, i32, i32, i32, f32, i32, u32, u32,
                f32, vp, i32, vp]
            handle.tg_xl_attn_fwd.restype = i32
            handle.tg_xl_attn_bwd.argtypes = [vp, vp]
            handle.tg_xl_attn_bwd.restype = i32
            handle.tg_sizeof_attn_bwd_args.argtypes = []
            handle.tg_sizeof_attn_bwd_args.restype = i32
            handle.tg_generate_chunk.argtypes = [vp, vp]
            handle.tg_generate_chunk.restype = i32
            handle.tg_sizeof_gen_args.argtypes = []
            handle.tg_sizeof_gen_args.restype = i32
            for name in ("tg_decode_chunk", "tg_decode_step", "tg_chain_bwd"):
                getattr(handle, name).argtypes = [vp, vp]
                getattr(handle, name).restype = i32
            handle.tg_sizeof_chain_args.argtypes = []
            handle.tg_sizeof_chain_args.restype = i32
            _lib = handle
        return _lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} (a cudaError_t code)")


def dtype_code(dtype) -> int:
    import torch
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")
    return codes[dtype]


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def resolve_device(device) -> "torch.device":
    """``device``, or the card when None: without one that raises, since a
    run on the CPU has to be asked for (``"cpu"``)."""
    import torch
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device 'cpu' (--device "
                               "cpu) to run on the CPU")
        device = "cuda"
    return torch.device(device)


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
