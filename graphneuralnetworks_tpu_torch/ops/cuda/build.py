"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each source ``csrc/<name>.cu`` has a plain C interface and compiles on its
own into ``build/<name>-<digest>.so`` at the repository root (the directory
is git-ignored). The digest covers the source text and the flags, so an
edited source builds anew and a stale library is never loaded. Nothing is
built at import: the first call that launches a kernel builds its library,
and :func:`build_all` builds every source at once, one ``nvcc`` process per
source, all started together. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCES", "NVCC_FLAGS", "build", "build_all", "build_logs",
           "load"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
SOURCES = ("spmm", "edge_softmax", "sddmm", "segment")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: dict[str, ctypes.CDLL] = {}
_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def _library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(*names: str) -> dict[str, Path]:
    """Compile each named source that has no library yet, all in parallel.

    Returns the library path of every name. Raises ``RuntimeError`` with the
    compiler's output when any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _library_path(n) for n in names}
    nvcc = None
    running = {}
    for n, path in paths.items():
        if path.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        running[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp)
    failed = []
    for n, (proc, tmp) in running.items():
        out, _ = proc.communicate()
        _logs[n] = out
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def build_all() -> dict[str, Path]:
    """Build every source of the package (see :data:`SOURCES`)."""
    return build(*SOURCES)


def build_logs() -> dict[str, str]:
    """Compiler output (``-Xptxas=-v`` register and spill report) of the
    builds this process ran."""
    return dict(_logs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)[name]))
        _libs[name] = lib
    return lib
