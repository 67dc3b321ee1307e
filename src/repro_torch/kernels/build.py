"""Builds the port's CUDA kernels with ``nvcc`` and loads them with ctypes.

Each source in ``csrc/`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), for
``sm_90a``, at first use, into ``build/repro_torch_kernels/`` at the root of
the checkout. A library's file name carries a hash of its source and flags:
an edited source is rebuilt and a stale library is never loaded. A missing
``nvcc`` or a failed build raises; nothing falls back to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("flash_attention", "gather_scores", "sampled_loss", "segment_scores",
           "tree_logprob")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found (on PATH or under $CUDA_HOME/bin); "
                       "the port's CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    source = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source that has no library yet, one ``nvcc``
    each, all started together. Returns the compiler's report (``ptxas``
    registers, shared memory and spills) of each source it compiled."""
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    try:
        for name in todo:
            tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
            cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        reports = {}
        for name, (tmp, proc) in procs.items():
            report, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu "
                                   f"(exit {proc.returncode}):\n{report}")
            os.replace(tmp, library_path(name))
            reports[name] = report
        return reports
    finally:
        for tmp, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if it is missing."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]


def check_launch(lib: ctypes.CDLL, prefix: str, code: int) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError()``)."""
    if code != 0:
        describe = getattr(lib, f"{prefix}_error_string")
        describe.restype = ctypes.c_char_p
        describe.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{prefix} kernel launch failed: CUDA error "
                           f"{code} ({describe(code).decode()})")
