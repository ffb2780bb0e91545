"""ctypes bindings of the host partitioner ``csrc/partition.cpp`` (the port's
own copy of ``llp_tpu/native/lib.py``'s ``partition_graph``,
``partition_multilevel`` and ``build_csr``).

The library is built with ``g++`` at first use into ``build/llp_tpu_torch/``
at the root of the checkout, named after a hash of its source and flags (the
scheme of :mod:`llp_tpu_torch.ops.build`), so an edited source is rebuilt.
This is host code that runs once per dataset, not a device kernel.

Without ``g++`` the JAX package's own fallback applies: ``partition_graph``
and ``build_csr`` run the same algorithm in numpy and give the same result
(slowly: a warning past 100,000 nodes), and ``partition_multilevel`` returns
None, so ``partition_assign(method="auto")`` degrades to the flat method.  A
``g++`` that is found but fails to build the source raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import warnings
from typing import Optional, Tuple

import numpy as np

from llp_tpu_torch.ops.build import BUILD_DIR, CSRC

SRC = CSRC / "partition.cpp"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path():
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"partition-{digest}.so"


def _build() -> Optional[ctypes.CDLL]:
    """The loaded library, built if needed; None when no ``g++`` is found."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = library_path()
        if not out.exists():
            gxx = shutil.which("g++")
            if gxx is None:
                return None
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".tmp{os.getpid()}.so")
            res = subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"building {SRC.name} failed:\n{res.stderr}")
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        lib = ctypes.CDLL(str(out))
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32 = ctypes.c_int32
        lib.llp_build_csr_perm.argtypes = [i32p, ctypes.c_int64, i32, i32p, i64p]
        lib.llp_partition_graph.argtypes = [i32p, i32p, i32, i32, i32, i32, i32, i32p, i32p]
        lib.llp_partition_multilevel.argtypes = [i32p, i32p, i32, i32, i32, i32,
                                                 ctypes.c_double, i32p]
        for fn in (lib.llp_build_csr_perm, lib.llp_partition_graph,
                   lib.llp_partition_multilevel):
            fn.restype = None
        _lib = lib
        return _lib


def native_available() -> bool:
    return _build() is not None


def partition_graph(row_ptr: np.ndarray, col: np.ndarray, num_parts: int, max_passes: int,
                    cap: int, cap2: int, order: np.ndarray) -> np.ndarray:
    """(N,) int32 balanced locality partition: an LDG stream over ``order``,
    then capacitated label-propagation restreams (``csrc/partition.cpp``).
    Deterministic; the numpy fallback runs the same sequential algorithm and
    gives the same assignment."""
    row_ptr = np.ascontiguousarray(row_ptr, np.int32)
    col = np.ascontiguousarray(col, np.int32)
    order = np.ascontiguousarray(order, np.int32)
    n = row_ptr.shape[0] - 1
    assign = np.empty((n,), np.int32)
    lib = _build()
    if lib is not None:
        lib.llp_partition_graph(row_ptr, col, n, num_parts, max_passes, cap, cap2, order,
                                assign)
        return assign
    if n > 100_000:
        # O(max_passes * N * P) interpreter steps: at a million nodes this
        # would look like a hang while the data are prepared.
        warnings.warn(
            f"no g++ to build {SRC.name}: partitioning {n} nodes with the numpy "
            f"fallback, O(passes*N*P) interpreter work that may take hours at this "
            f"scale; install g++ to build the native partitioner.",
            RuntimeWarning, stacklevel=2,
        )
    assign[:] = -1
    load = np.zeros(num_parts, np.int64)
    nb = np.zeros(num_parts, np.int64)
    for v in order:
        nbrs = col[row_ptr[v]:row_ptr[v + 1]]
        nb[:] = 0
        an = assign[nbrs]
        an = an[an >= 0]
        if an.size:
            np.add.at(nb, an, 1)
        score = nb * (cap - load)
        score[load >= cap] = np.iinfo(np.int64).min
        best = int(np.argmax(score))  # ties to the lowest part, as the C++ scan
        assign[v] = best
        load[best] += 1
    for _ in range(max_passes):
        moved = 0
        for v in range(n):
            cur = assign[v]
            nbrs = col[row_ptr[v]:row_ptr[v + 1]]
            nb[:] = 0
            np.add.at(nb, assign[nbrs], 1)
            score = np.where((load < cap2) | (np.arange(num_parts) == cur), nb, -1)
            best = int(np.argmax(score))
            if best != cur and score[best] > nb[cur]:
                load[cur] -= 1
                load[best] += 1
                assign[v] = best
                moved += 1
        if moved == 0:
            break
    return assign


def partition_multilevel(row_ptr: np.ndarray, col: np.ndarray, num_parts: int,
                         coarsest: int, refine_passes: int, slack: float
                         ) -> Optional[np.ndarray]:
    """(N,) int32 multilevel partition (``csrc/partition.cpp``'s V-cycle), or
    None without the native library (callers take the flat method)."""
    lib = _build()
    if lib is None:
        return None
    row_ptr = np.ascontiguousarray(row_ptr, np.int32)
    col = np.ascontiguousarray(col, np.int32)
    n = row_ptr.shape[0] - 1
    assign = np.empty((n,), np.int32)
    lib.llp_partition_multilevel(row_ptr, col, n, num_parts, coarsest, refine_passes,
                                 slack, assign)
    return assign


def build_csr(senders: np.ndarray, receivers: np.ndarray, num_nodes: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """``(row_ptr, col)`` int32 CSR sorted stably by sender."""
    senders = np.ascontiguousarray(senders, np.int32)
    receivers = np.ascontiguousarray(receivers, np.int32)
    e = senders.shape[0]
    lib = _build()
    if lib is not None:
        row_ptr = np.empty((num_nodes + 1,), np.int32)
        perm = np.empty((e,), np.int64)
        lib.llp_build_csr_perm(senders, e, num_nodes, row_ptr, perm)
        return row_ptr, receivers[perm]
    order = np.argsort(senders, kind="stable")
    counts = np.bincount(senders, minlength=num_nodes)
    row_ptr = np.zeros((num_nodes + 1,), np.int32)
    row_ptr[1:] = np.cumsum(counts).astype(np.int32)
    return row_ptr, receivers[order]
