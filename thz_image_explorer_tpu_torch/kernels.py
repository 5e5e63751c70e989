"""Build and load the hand-written CUDA kernels and host C code of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, loaded with ``ctypes``;
each ``csrc/<name>.c`` (host code: the ROI rasterizer, the LZF codec) by
the system C compiler (``cc``), which needs no CUDA toolchain. Libraries land
in ``build/torch_kernels/`` beside the package, named by a hash of the
source and the flags, so an edited source is rebuilt at its next use.
Nothing is built at import time: the CPU tests import every module without
a CUDA toolchain.

:data:`SIGNATURES` declares every entry point's C signature; :func:`load`
applies them when it first loads a library. A new kernel takes its source
in ``SOURCES`` (or ``C_SOURCES``) and its entry points in ``SIGNATURES``.
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

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_PLL, _SZ, _U64 = ctypes.POINTER(ctypes.c_longlong), ctypes.c_size_t, ctypes.c_uint64
#: library -> symbol -> (restype, argtypes): every exported function of
#: ``csrc/<library>.cu`` / ``.c``, as its source declares it (a stream is a
#: ``void*``, a plan a ``const long long*``)
SIGNATURES = {
    "specred": {
        "thz_specred": (_I, [_P] * 5 + [_I] * 4 + [_PLL, _I, _P]),
        "thz_specred_smem": (_LL, [_I] * 6),
        "thz_specred_config": (None, [_PLL]),
        "thz_specred_blocks_per_sm": (_I, [_I] * 3 + [_LL]),
    },
    "rlsep": {
        "thz_rlsep": (_I, [_P] * 7 + [_I] * 7 + [_P]),
    },
    "envelope": {
        "thz_envelope": (_I, [_P] * 3 + [_LL, _I, _I, _F, _F, _PLL, _P]),
        "thz_envelope_smem": (_LL, [_I] * 5),
        "thz_envelope_config": (None, [_PLL]),
        "thz_envelope_blocks_per_sm": (_I, [_I, _I, _LL]),
    },
    "rl2d": {
        "thz_rl2d": (_I, [_P] * 4 + [_I] * 5 + [_P]),
    },
    "rlsep_cluster": {
        "thz_rlsep_cluster": (_I, [_P] * 6 + [_I] * 9 + [_P]),
        "thz_rlsep_grouped": (_I, [_P] * 6 + [_I] * 10 + [_P]),
        "thz_rlsep_cluster_smem": (_LL, [_I] * 5),
        "thz_rlsep_grouped_smem": (_LL, [_I] * 6),
        "thz_rlsep_wide": (_I, [_P] * 8 + [_I] * 8 + [_P] * 3),
        "thz_rlsep_wide_smem": (_LL, [_I] * 5),
    },
    "rl2d_cluster": {
        "thz_rl2d_cluster": (_I, [_P] * 3 + [_I] * 6 + [_P]),
        "thz_rl2d_cluster_smem": (_LL, [_I] * 5),
        "thz_rl2d_cluster_tile": (_I, [_I]),
    },
    "bandsum": {
        "thz_bandsum": (_I, [_P] * 4 + [_LL] + [_I] * 7 + [_PLL, _P]),
        "thz_bandsum_smem": (_LL, [_I] * 2),
        "thz_bandsum_config": (None, [_PLL]),
    },
    "tilt": {
        "thz_tilt_insert": (_I, [_P] * 4 + [_LL] + [_I] * 8 + [_F] * 9 + [_LL, _P]),
    },
    "polar": {
        "thz_polar_unwrap": (_I, [_P] * 4 + [_LL, _I, _LL, _P]),
        "thz_polar_config": (None, [_PLL]),
    },
    "roi": {
        "thz_roi_polygon_mask": (_LL, [ctypes.POINTER(_U64)] * 2 + [_SZ] * 3 + [
            _U64, ctypes.POINTER(ctypes.c_uint8)]),
    },
    "lzf": {
        "thz_lzf_decompress": (_LL, [ctypes.c_char_p, _SZ, _P, _SZ]),
        "thz_lzf_compress": (_LL, [ctypes.c_char_p, _SZ, _P, _SZ]),
    },
}

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
    needed, its entry points declared."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = _loaded[name] = declare(ctypes.CDLL(str(library_path(name))), name)
    return lib


def declare(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """``lib`` with the C signature of each entry point of ``csrc/<name>``
    (:data:`SIGNATURES`) set on it: a library built from that source, with
    any flags."""
    for symbol, (restype, argtypes) in SIGNATURES[name].items():
        fn = getattr(lib, symbol)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def check_launch(err: int, what: str) -> None:
    """Raise where a kernel's launch returned a CUDA error ``err``."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
