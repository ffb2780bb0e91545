"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``llp_tpu_torch/csrc/<name>.cu`` compiles on its own into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds).  The library lands in ``build/llp_tpu_torch/`` at the root of the
checkout, named after a hash of its source and flags, so an edited source
is rebuilt and an unchanged one is reused.  :func:`build_all` starts one
``nvcc`` per source, all at once.  A failed build raises.

Nothing here runs at import: the CPU tests import every module on hosts
that have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "llp_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I64, _INT, _F32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
# argtypes of each library's entry point: pointers and the stream as
# c_void_p (a bare Python int would be cut to 32 bits), sizes as int64,
# type codes as int, fp32 scalars as float.
SIGNATURES = {
    "segsum": ("llp_segsum",
               [_P, _P, _P, _P, _P, _P, _I64, _I64, _INT, _INT, _INT, _P, _I64, _I64, _P,
                _P]),
    "sddmm": ("llp_sddmm_mlp_f32",
              [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _INT, _P]),
    "mlp_topk": ("llp_mlp_topk",
                 [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _P, _INT, _INT, _P]),
    "spmm_tiles": ("llp_spmm_tiles", [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _INT, _P]),
    "relu_dropout": ("llp_relu_dropout",
                     [_P, _P, _P, _P, _P, _I64, _F32, _F32, _INT, _P]),
}
# argtypes of further entry points (``load_library(name, entry)``).
ENTRY_POINTS = {
    "llp_sddmm_split_w1": [_P, _P, _I64, _I64, _P],
    "llp_mlp_topk_mma": [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _P, _INT, _I64, _I64, _P],
    "llp_trace_marker": [_P, _P],
    "llp_relu_dropout_backward": [_P, _P, _P, _I64, _F32, _INT, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names=tuple(SIGNATURES)) -> dict:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` process each, all started together.  Returns ``{name:
    {"seconds", "ptxas", "cached"}}``; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        procs[name] = (tmp, out, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    report = {n: {"seconds": 0.0, "ptxas": "", "cached": True}
              for n in names if n not in procs}
    failed = []
    for name, (tmp, out, proc) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": log,
                        "cached": False}
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


@functools.cache
def load_library(name: str, entry: str = ""):
    """The entry point of ``csrc/<name>.cu`` (its ``SIGNATURES`` one, or
    ``entry`` of ``ENTRY_POINTS``), built if needed, with its ``argtypes``
    and ``restype`` (``int``, a ``cudaError_t``) declared."""
    path = library_path(name)
    if not path.exists():
        build_all((name,))
    fn_name, argtypes = (entry, ENTRY_POINTS[entry]) if entry else SIGNATURES[name]
    fn = getattr(ctypes.CDLL(str(path)), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
