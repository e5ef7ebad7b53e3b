"""Build the port's CUDA kernels and load them through ``ctypes``.

Each source under ``csrc/`` has a plain C interface (``extern "C"``
launchers that return a ``cudaError_t``), so it is compiled by ``nvcc``
alone into its own shared library — seconds per file, where a source that
includes PyTorch's headers takes minutes.  All missing libraries are built
at first use, one ``nvcc`` per source, all started together, into
``build/repro_torch_ext/`` at the repository root (listed in
``.gitignore``).  A library's file name carries a hash of its source and
flags, so an edited source is rebuilt and a stale one never loaded.

Nothing here runs at import time: the CPU tests import every module of the
port on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_ext"

#: library name -> source file under csrc/
SOURCES = {
    "fused_aggregate": "fused_aggregate.cu",
    "fsvrg_update": "fsvrg_update.cu",
    "fedavg_update": "fedavg_update.cu",
    "dane_update": "dane_update.cu",
    "cocoa_sdca": "cocoa_sdca.cu",
    "robust_aggregate": "robust_aggregate.cu",
    "wkv6": "wkv6.cu",
    "wkv6_bwd": "wkv6_bwd.cu",
    "segment_sum": "segment_sum.cu",
    "selective_scan": "selective_scan.cu",
}

NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_L = ctypes.c_longlong
_F = ctypes.c_float

#: C signatures of each library's main launcher (all return int =
#: cudaError_t); EXTRA_SIGNATURES lists a library's other launchers
SIGNATURES = {
    "fused_aggregate": ("fused_aggregate_launch",
                        [_P, _I, _I, _P, _P, _P, _P, _F, _P, _P, _L, _L, _L,
                         _L, _L, _P]),
    "fsvrg_update": ("fsvrg_update_launch",
                     [_P, _P, _P, _P, _P, _I, _P, _F, _P, _L, _L, _L, _L, _L,
                      _L, _P]),
    "fedavg_update": ("fedavg_update_launch",
                      [_P, _P, _I, _P, _F, _F, _P, _L, _L, _L, _P]),
    "dane_update": ("dane_update_launch",
                    [_P, _P, _P, _P, _I, _F, _F, _F, _P, _L, _L, _L, _P]),
    "cocoa_sdca": ("cocoa_sdca_launch", [_P, _P, _P, _I, _P, _L, _I, _P]),
    "robust_aggregate": ("robust_select_launch",
                         [_P, _P, _I, _P, _P, _I, _I, _L, _I, _I, _P, _P]),
    "wkv6": ("wkv6_launch", [_P, _P, _P, _P, _P, _L, _P, _I, _P, _P, _I, _I,
                             _I, _I, _I, _L, _L, _L, _P]),
    "wkv6_bwd": ("wkv6_bwd_launch", [_P, _P, _P, _P, _P, _L, _P, _P, _P, _P,
                                     _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _L, _L, _L, _I, _I, _I, _P]),
    "segment_sum": ("segment_sum_launch", [_P, _P, _U, _I, _P, _P, _P, _P,
                                           _I, _I, _I, _P, _P]),
    "selective_scan": ("selective_scan_launch",
                       [_P, _I, _L, _L, _P, _L, _L, _P, _P, _P, _P, _L, _L,
                        _P, _P, _P, _P, _I, _I, _I, _I, _P]),
}
EXTRA_SIGNATURES = {
    "fused_aggregate": {"fused_aggregate_occupancy": [_I, _I, _P],
                        "fused_epilogue_launch": [_P, _P, _P, _P, _F, _P, _L,
                                                  _P]},
    "cocoa_sdca": {"cocoa_sdca_pass_launch": [_P, _P, _P, _P, _P, _P, _P, _P,
                                              _P, _L, _I, _I, _L, _F, _F, _F,
                                              _I, _I, _P]},
    "robust_aggregate": {"robust_compact_launch": [_P, _I, _P, _P, _P],
                         "robust_select_occupancy": [_I, _I, _P, _P, _P,
                                                     _P]},
    "wkv6": {"wkv6_occupancy": [_I, _P, _P, _P]},
    "wkv6_bwd": {"wkv6_bwd_occupancy": [_I, _P, _P, _P, _P]},
    "segment_sum": {"segment_sum_occupancy": [_P, _P, _P, _P, _P]},
    "selective_scan": {"selective_scan_occupancy": [_I, _P, _P, _P, _P,
                                                    _P]},
}

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler PyTorch would use (``CUDA_HOME``), else ``nvcc`` on
    the ``PATH``."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{tag}.so"


def build_all() -> Dict[str, float]:
    """Build every library that is missing, all ``nvcc`` runs at once.

    Returns the seconds each build took (0.0 for one already built).  The
    compiler's ``-Xptxas=-v`` report (registers, spills) is kept beside each
    library as ``<library>.log``.  Raises with the compiler's output if a
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if not library_path(n).exists()]
    seconds = {n: 0.0 for n in SOURCES}
    if not todo:
        return seconds
    nvcc = nvcc_path()
    procs: List = []
    t0 = time.perf_counter()
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failures = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n"
                            f"{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """The compiler's report for ``name``'s library ('' if not built here)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text(errors="replace") if log.exists() else ""


def launcher(name: str, fn_name: Optional[str] = None):
    """The C launcher ``fn_name`` (default: the main one) of library
    ``name``, built and loaded on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(library_path(name)))
        main, argtypes = SIGNATURES[name]
        for fname, types in {main: argtypes,
                             **EXTRA_SIGNATURES.get(name, {})}.items():
            fn = getattr(lib, fname)
            fn.argtypes = types
            fn.restype = ctypes.c_int
        _LOADED[name] = lib
    return getattr(lib, fn_name or SIGNATURES[name][0])


def check(err: int, name: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")
