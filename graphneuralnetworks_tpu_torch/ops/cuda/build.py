"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each source ``csrc/<name>.cu`` has a plain C interface and compiles on its
own into ``build/<name>-<digest>.so`` at the repository root (the directory
is git-ignored). The digest covers the source text and the flags, so an
edited source builds anew and a stale library is never loaded. Nothing is
built at import: the first call that launches a kernel builds its library,
and :func:`build_all` builds every source at once, one ``nvcc`` process per
source, all started together. A failed build raises; nothing falls back.

``sweep=True`` builds a second library of a source with ``-DGNN_SWEEP``:
it holds every kernel instance that ``chip_smoke.py --sweep`` times, where
the first holds only the ones the wrappers choose.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCES", "NVCC_FLAGS", "SWEEP_FLAGS", "build", "build_all",
           "build_logs", "load"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
SOURCES = ("spmm", "edge_softmax", "sddmm", "segment")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
SWEEP_FLAGS = ("-DGNN_SWEEP",)

_libs: dict[tuple[str, bool], ctypes.CDLL] = {}
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


def _flags(sweep: bool) -> tuple[str, ...]:
    return NVCC_FLAGS + SWEEP_FLAGS if sweep else NVCC_FLAGS


def _library_path(name: str, sweep: bool) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(_flags(sweep)).encode()).hexdigest()
    return BUILD_DIR / f"{name}{'-sweep' * sweep}-{digest[:16]}.so"


def build(*names: str, sweep: bool = False) -> dict[str, Path]:
    """Compile each named source that has no library yet, all in parallel
    (with ``sweep``, the sweep build of each).

    Returns the library path of every name. Raises ``RuntimeError`` with the
    compiler's output when any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _library_path(n, sweep) for n in names}
    nvcc = None
    running = {}
    for n, path in paths.items():
        if path.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *_flags(sweep), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        running[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp)
    failed = []
    for n, (proc, tmp) in running.items():
        out, _ = proc.communicate()
        _logs[f"{n}-sweep" if sweep else n] = out
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
    builds this process ran, by source name (``<name>-sweep`` for a sweep
    build)."""
    return dict(_logs)


def load(name: str, sweep: bool = False) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (with ``sweep``, its sweep
    build), built first if needed."""
    lib = _libs.get((name, sweep))
    if lib is None:
        lib = ctypes.CDLL(str(build(name, sweep=sweep)[name]))
        _libs[name, sweep] = lib
    return lib
