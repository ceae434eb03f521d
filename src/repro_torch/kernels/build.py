"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with its own ``nvcc`` process (all
started together) into ``build/kernels/<name>-<hash>.so`` at the root of
the checkout, where ``<hash>`` covers the source and the flags, so an
edited source rebuilds and an unchanged one loads at once.  The sources
have a plain C interface (no PyTorch headers), so a build takes seconds.
Flags: ``sm_90a`` (Hopper), ``-O3``, and no ``--use_fast_math`` — the
Lorenzo kernels rely on IEEE float64 division and ``rint``, the
quantizer on IEEE float32 division.

Nothing here runs at import: :func:`library` builds on its first call.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "build_all", "build_dir", "build_logs", "library"]

SOURCES = ("lorenzo3d", "hist", "huffdec", "qdq")
CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
#: C signature of every exported launcher: (library, function) → argtypes.
SIGNATURES = {
    ("lorenzo3d", "lorenzo3d_codes_batched"): (_P, _P, _L, _I, _I, _I, _D, _P),
    ("lorenzo3d", "lorenzo3d_recon_batched"):
        (_P, _P, _P, _L, _I, _I, _I, _D, _P),
    ("lorenzo3d", "lorenzo3d_codes"): (_P, _P, _I, _I, _I, _I, _I, _I, _D, _P),
    ("lorenzo3d", "lorenzo3d_recon"):
        (_P, _P, _P, _I, _I, _I, _I, _I, _I, _D, _P),
    ("hist", "hist_codes"): (_P, _L, _L, _I, _P, _I, _P),
    ("huffdec", "huffdec_payloads"):
        (_P, _P, _P, _P, _P, _I, _P, _L, _P, _P, _P, _I, _P, _P, _P),
    ("qdq", "group_quant_f32"): (_P, _P, _P, _L, _I, _P),
    ("qdq", "group_quant_bf16"): (_P, _P, _P, _L, _I, _P),
    ("qdq", "group_dequant_f32"): (_P, _P, _P, _L, _I, _I, _P),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """``build/kernels`` at the root of the checkout (git-ignored)."""
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:12]}.so"


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every missing library in parallel; returns name → path.

    :raises RuntimeError: naming each source that failed, with nvcc's
        output.
    """
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for n, so in targets.items():
        if so.exists():
            continue
        tmp = so.with_suffix(f".tmp{os.getpid()}.so")
        procs[n] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, so)
    failed = []
    for n, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        (out / f"{n}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return targets


def build_logs() -> dict[str, str]:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills)
    of each library built by this checkout."""
    return {n: (build_dir() / f"{n}.log").read_text()
            for n in SOURCES if (build_dir() / f"{n}.log").exists()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built on first use), with argtypes
    and restype set for each launcher."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all((name,))[name]))
            for (lname, fn), argtypes in SIGNATURES.items():
                if lname == name:
                    f = getattr(lib, fn)
                    f.argtypes = argtypes
                    f.restype = ctypes.c_int
            _libs[name] = lib
        return lib
