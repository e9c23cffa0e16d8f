"""Build and load the port's CUDA kernels (plain C interface, bound with ctypes).

Every ``kernels/*/csrc/*.cu`` compiles with one ``nvcc`` process of its own,
all started together, into a shared library under ``build/repro_torch_kernels``
at the repository root (listed in ``.gitignore``). A library's file name
carries a hash of its source, the headers beside it and the flags, so an
edited source rebuilds and an unchanged one loads straight from disk. Nothing
builds at import: the first wrapper call that needs a library builds them all.

The C entry points take every pointer and the stream as ``void*`` and return
``cudaGetLastError()`` after the launch; :func:`check` raises on a non-zero
code. A failed build raises with nvcc's stderr.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "repro_torch_kernels"
# --split-compile=0: the device code's optimization in parallel over the host's
# cores (the attention source, 54 kernel instantiations, took 74 s in one thread)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "--split-compile=0"]


class KernelBuildError(RuntimeError):
    """nvcc refused a source (message carries its stderr)."""


class KernelLaunchError(RuntimeError):
    """A C entry point returned a non-zero ``cudaError_t``."""


class _Libraries:
    """Built libraries by source stem; owned by the module-level instance."""

    def __init__(self) -> None:
        self.libs: dict[str, ctypes.CDLL] = {}
        self.build_seconds: Optional[float] = None


_STATE = _Libraries()


def sources() -> dict[str, Path]:
    """Every kernel source of the package, by stem."""
    return {p.stem: p for p in sorted(_PKG.glob("*/csrc/*.cu"))}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for cand in ("/usr/local/cuda/bin/nvcc",):
        if os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found on PATH or under /usr/local/cuda")


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256()
    for p in [src, *sorted(src.parent.glob("*.cuh"))]:
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every source not yet built (one nvcc each, in parallel) and
    load all libraries. Returns the seconds spent building (0 if cached)."""
    if _STATE.build_seconds is not None and len(_STATE.libs) == len(sources()):
        return _STATE.build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    todo = {stem: src for stem, src in sources().items()
            if not _lib_path(src).exists()}
    procs = {}
    if todo:
        nvcc = _nvcc()
        for stem, src in todo.items():
            out = _lib_path(src)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(src)]
            procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True),
                           tmp, out)
    errors = []
    ptxas = []
    for stem, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"--- {stem} (exit {proc.returncode}) ---\n{stderr}{stdout}")
            continue
        ptxas.append(f"--- {stem} ---\n{stderr}")
        os.replace(tmp, out)
    if errors:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(errors))
    if ptxas:
        (BUILD_DIR / "ptxas.log").write_text("\n".join(ptxas))
    for stem, src in sources().items():
        if stem not in _STATE.libs:
            _STATE.libs[stem] = ctypes.CDLL(str(_lib_path(src)))
    _STATE.build_seconds = time.perf_counter() - t0
    return _STATE.build_seconds


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``<stem>.cu`` (building on first use)."""
    if stem not in _STATE.libs:
        build_all()
    return _STATE.libs[stem]


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise KernelLaunchError(f"{what}: CUDA error {code}")


VP = ctypes.c_void_p
I32 = ctypes.c_int
F32 = ctypes.c_float
