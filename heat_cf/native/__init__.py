"""ctypes bindings for the native (C++/OpenMP) components.

The shared library is built lazily with g++ on first use and cached next to
the sources; every binding has a pure-Python fallback, so the framework
works without a toolchain (the native path is the production fast path for
large datasets).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "_heat_native.so")
_SRCS = [
    os.path.join(_DIR, "click_parser.cc"),
    os.path.join(_DIR, "metrics_kernels.cc"),
]
_LOCK = threading.Lock()
_LIB = None


def _build() -> str:
    cmd = [
        "g++",
        "-O3",
        "-march=native",
        "-fopenmp",
        "-shared",
        "-fPIC",
        "-std=c++17",
        *_SRCS,
        "-o",
        _SO,
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    return _SO


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            if not os.path.exists(_SO) or os.path.getmtime(_SO) < max(
                os.path.getmtime(s) for s in _SRCS
            ):
                _build()
            lib = ctypes.CDLL(_SO)
            lib.parse_click_file.restype = ctypes.c_void_p
            lib.parse_click_file.argtypes = [ctypes.c_char_p, ctypes.c_char]
            for fn in ("parsed_num_users", "parsed_num_items", "parsed_num_pairs"):
                getattr(lib, fn).restype = ctypes.c_int64
                getattr(lib, fn).argtypes = [ctypes.c_void_p]
            lib.parsed_fill.restype = None
            lib.parsed_fill.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.parsed_free.restype = None
            lib.parsed_free.argtypes = [ctypes.c_void_p]
            lib.hits_matrix.restype = None
            lib.hits_matrix.argtypes = [
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_double),
            ]
            _LIB = lib
    return _LIB


def hits_matrix(top: np.ndarray, true_items) -> np.ndarray:
    """(U, k) 0/1 hit matrix via the native OpenMP kernel.

    top: (U, k) ranked item ids; true_items: per-user truth lists.
    """
    lib = _lib()
    top = np.ascontiguousarray(top, np.int32)
    u, k = top.shape
    offsets = np.zeros(u + 1, np.int64)
    for i, t in enumerate(true_items):
        offsets[i + 1] = offsets[i] + len(t)
    truth = np.empty(max(int(offsets[-1]), 1), np.int32)
    for i, t in enumerate(true_items):
        if len(t):
            truth[offsets[i] : offsets[i + 1]] = np.sort(
                np.asarray(t, np.int32)
            )
    out = np.empty((u, k), np.float64)
    lib.hits_matrix(
        top.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        u,
        k,
        truth.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out


def parse_click_file(path: str, separator: str = " ") -> list[np.ndarray]:
    """Parse a click file natively; returns per-user item arrays.

    Matches heat_cf.data.datasets._parse_lines_numpy semantics (last line
    wins for duplicate users; absent user ids get empty lists).
    """
    lib = _lib()
    sep = separator.encode() if separator else b" "
    handle = lib.parse_click_file(path.encode(), sep[0:1])
    if not handle:
        raise OSError(f"native parser failed to open {path}")
    try:
        num_users = lib.parsed_num_users(handle)
        num_pairs = lib.parsed_num_pairs(handle)
        offsets = np.empty(num_users + 1, np.int64)
        items = np.empty(max(num_pairs, 1), np.int32)
        lib.parsed_fill(
            handle,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            items.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
    finally:
        lib.parsed_free(handle)
    return [
        items[offsets[u] : offsets[u + 1]] for u in range(num_users)
    ]
