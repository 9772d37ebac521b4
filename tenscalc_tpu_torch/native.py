"""ctypes bindings to the reverse Cuthill-McKee ordering in
``csrc/ordering.cpp`` (a copy of the JAX package's native source).

The library is compiled with g++ at first use into the port's build
directory.  There is no scipy fallback: scipy's RCM may order ties
differently, and the banded plan must equal the reference's.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from ._build import build_shared_library, find_tool

_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path = build_shared_library(
            "ordering.cpp", find_tool("g++"),
            ["-O3", "-fPIC", "-std=c++17", "-shared"],
        )
        lib = ctypes.CDLL(str(path))
        lib.tc_version.restype = ctypes.c_int64
        if lib.tc_version() != 1:
            raise RuntimeError(f"{path}: unexpected ABI version")
        I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.tc_rcm.argtypes = [ctypes.c_int64, I64P, I64P, I64P]
        lib.tc_rcm.restype = ctypes.c_int
        lib.tc_bandwidth.argtypes = [ctypes.c_int64, I64P, I64P, I64P]
        lib.tc_bandwidth.restype = ctypes.c_int64
        _lib = lib
    return _lib


def _to_csr(pattern: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Boolean adjacency (diagonal ignored) -> CSR indptr/indices."""
    adj = pattern.copy()
    np.fill_diagonal(adj, False)
    indptr = np.zeros(pattern.shape[0] + 1, dtype=np.int64)
    np.cumsum(adj.sum(axis=1), out=indptr[1:])
    indices = np.nonzero(adj)[1].astype(np.int64)
    return indptr, indices


def rcm(pattern: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee permutation of a boolean symmetric pattern."""
    lib = _load()
    n = pattern.shape[0]
    indptr, indices = _to_csr(pattern)
    perm = np.empty(n, dtype=np.int64)
    rc = lib.tc_rcm(n, indptr, indices, perm)
    if rc != 0:
        raise RuntimeError(f"tc_rcm failed with code {rc}")
    return perm


def bandwidth(pattern: np.ndarray, perm: np.ndarray) -> int:
    """Half bandwidth of ``pattern[perm][:, perm]``."""
    lib = _load()
    indptr, indices = _to_csr(pattern)
    return int(lib.tc_bandwidth(
        pattern.shape[0], indptr, indices,
        np.ascontiguousarray(perm, np.int64),
    ))
