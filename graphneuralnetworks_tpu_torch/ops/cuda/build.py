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

``host=True`` builds a host source, ``csrc/<name>.cc`` (the neighbor
sampler), with ``g++`` (:data:`HOST_FLAGS`) into the same directory, by the
same digest rule.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCES", "NVCC_FLAGS", "SWEEP_FLAGS", "HOST_FLAGS", "build",
           "build_all", "build_logs", "load"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
SOURCES = ("spmm", "edge_softmax", "sddmm", "segment")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
SWEEP_FLAGS = ("-DGNN_SWEEP",)
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_libs: dict[tuple[str, bool, bool], ctypes.CDLL] = {}
_logs: dict[str, str] = {}


def _compiler(host: bool) -> str:
    if host:
        found = shutil.which("g++")
        if found:
            return found
        raise RuntimeError("g++ not found: the host sources are built from "
                           "source at first use")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def _flags(sweep: bool, host: bool = False) -> tuple[str, ...]:
    if host:
        return HOST_FLAGS
    return NVCC_FLAGS + SWEEP_FLAGS if sweep else NVCC_FLAGS


def _source(name: str, host: bool) -> Path:
    return CSRC / f"{name}.{'cc' if host else 'cu'}"


def _library_path(name: str, sweep: bool, host: bool = False) -> Path:
    src = _source(name, host).read_bytes()
    digest = hashlib.sha1(src + " ".join(_flags(sweep, host)).encode()
                          ).hexdigest()
    return BUILD_DIR / f"{name}{'-sweep' * sweep}-{digest[:16]}.so"


def build(*names: str, sweep: bool = False,
          host: bool = False) -> dict[str, Path]:
    """Compile each named source that has no library yet, all in parallel
    (with ``sweep``, the sweep build of each; with ``host``, the host
    sources ``csrc/<name>.cc`` by ``g++``).

    Returns the library path of every name. Raises ``RuntimeError`` with the
    compiler's output when any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _library_path(n, sweep, host) for n in names}
    cc = None
    running = {}
    for n, path in paths.items():
        if path.exists():
            continue
        cc = cc or _compiler(host)
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        cmd = [cc, *_flags(sweep, host), "-o", str(tmp),
               str(_source(n, host))]
        running[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp)
    failed = []
    for n, (proc, tmp) in running.items():
        out, _ = proc.communicate()
        _logs[f"{n}-sweep" if sweep else n] = out
        if proc.returncode != 0:
            failed.append(f"{_source(n, host).name} (exit "
                          f"{proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError(f"{'g++' if host else 'nvcc'} failed for "
                           + "\n".join(failed))
    return paths


def build_all() -> dict[str, Path]:
    """Build every source of the package (see :data:`SOURCES`)."""
    return build(*SOURCES)


def build_logs() -> dict[str, str]:
    """Compiler output (``-Xptxas=-v`` register and spill report) of the
    builds this process ran, by source name (``<name>-sweep`` for a sweep
    build)."""
    return dict(_logs)


def load(name: str, sweep: bool = False, host: bool = False) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (with ``sweep``, its sweep
    build; with ``host``, of ``csrc/<name>.cc``), built first if needed."""
    lib = _libs.get((name, sweep, host))
    if lib is None:
        lib = ctypes.CDLL(str(build(name, sweep=sweep, host=host)[name]))
        _libs[name, sweep, host] = lib
    return lib
