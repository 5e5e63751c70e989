"""Build and load the hand-written CUDA kernels and host C code of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, loaded with ``ctypes``;
each ``csrc/<name>.c`` (host code: the ROI rasterizer, the LZF codec) by
the system C compiler (``cc``), which needs no CUDA toolchain. Libraries land
in ``build/torch_kernels/`` beside the package, named by a hash of the
source and the flags, so an edited source is rebuilt at its next use.
Nothing is built at import time: the CPU tests import every module without
a CUDA toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_kernels"
#: every kernel source of the package (``csrc/<name>.cu``)
SOURCES = ("specred", "rlsep", "envelope", "rl2d", "rlsep_cluster", "rl2d_cluster", "bandsum",
           "tilt", "polar")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: every host C source of the package (``csrc/<name>.c``)
C_SOURCES = ("roi", "lzf")
CC_FLAGS = ("-O2", "-fPIC", "-shared")

_loaded: dict[str, ctypes.CDLL] = {}
#: how many ``build`` calls are compiling right now (``building()``)
_compiling = 0
_compiling_lock = threading.Lock()


def building() -> bool:
    """True while some thread's :func:`build` runs a compiler: the shell
    shows it as the pipeline's "building" phase."""
    return _compiling > 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _cc() -> str:
    found = shutil.which("cc")
    if found is None:
        raise RuntimeError("no C compiler found (put cc on PATH)")
    return found


def _source(name: str) -> tuple[Path, tuple[str, ...]]:
    """The source of ``name`` and its compiler's flags."""
    if name in C_SOURCES:
        return CSRC / f"{name}.c", CC_FLAGS
    return CSRC / f"{name}.cu", NVCC_FLAGS


def library_path(name: str) -> Path:
    src, flags = _source(name)
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every missing library of ``names``, one compiler process per
    source, all started together. Returns ``{name: compiler log}`` for the
    sources compiled now (``-Xptxas -v`` prints registers and shared
    memory); raises with the compiler's output if any build fails."""
    missing = [name for name in names if not library_path(name).exists()]
    if not missing:
        return {}
    global _compiling
    with _compiling_lock:
        _compiling += 1
    try:
        return _compile(missing)
    finally:
        with _compiling_lock:
            _compiling -= 1


def _compile(names) -> dict[str, str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        src, flags = _source(name)
        compiler = _cc() if name in C_SOURCES else _nvcc()
        cmd = [compiler, *flags, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("the compiler failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` or ``.c``, built first if
    needed."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib

