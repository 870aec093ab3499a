"""ctypes bindings for the repo's native graph-IO library
(native/graphio.cpp).

Counterpart of the JAX package's `graph/_native_io.py`.  The first
parse builds the library with g++ into the port's `_build/` directory
(never into `native/`), named by the hash of the source and the flags,
and loads it; nothing is built when the module is imported.  A build
that fails raises `NativeBuildError`, and `market.read_market` then
takes its NumPy parser, as the reference does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR.parent / "native" / "graphio.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None
_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    """native/graphio.cpp could not be built or loaded."""


class _MtxResult(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64),
        ("m", ctypes.c_int64),
        ("symmetric", ctypes.c_int),
        ("has_values", ctypes.c_int),
        ("first", ctypes.POINTER(ctypes.c_int64)),
        ("second", ctypes.POINTER(ctypes.c_int64)),
        ("values", ctypes.POINTER(ctypes.c_float)),
        ("error", ctypes.c_char * 256),
    ]


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"graphio-{h.hexdigest()[:16]}.so"


def _load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            out = library_path()
            if not out.exists():
                BUILD_DIR.mkdir(exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp),
                                str(SOURCE)], check=True,
                               capture_output=True, timeout=300)
                os.replace(tmp, out)
            lib = ctypes.CDLL(str(out))
        except (OSError, subprocess.SubprocessError) as e:
            raise NativeBuildError(f"cannot build or load {SOURCE.name}: "
                                   f"{e}") from e
        lib.gr_parse_mtx.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(_MtxResult)]
        lib.gr_parse_mtx.restype = ctypes.c_int
        lib.gr_free.argtypes = [ctypes.c_void_p]
        lib.gr_free.restype = None
        _lib = lib
        return lib


def parse_mtx(path: str):
    """Returns (n, rows, cols, values|None, symmetric) with the
    reference's direction convention: a line "a b" is the edge
    b-1 -> a-1 (market.cuh:150).  A missing file raises
    FileNotFoundError, a malformed one ValueError."""
    lib = _load()
    res = _MtxResult()
    if lib.gr_parse_mtx(os.fsencode(path), ctypes.byref(res)) != 0:
        err = res.error.decode(errors="replace")
        if "cannot open" in err:
            raise FileNotFoundError(err)
        raise ValueError(f"mtx parse failed: {err}")
    m = res.m
    try:
        first = np.ctypeslib.as_array(res.first, shape=(m,)).copy()
        second = np.ctypeslib.as_array(res.second, shape=(m,)).copy()
        values = None
        if res.values and res.has_values:
            values = np.ctypeslib.as_array(res.values, shape=(m,)).copy()
    finally:
        lib.gr_free(ctypes.cast(res.first, ctypes.c_void_p))
        lib.gr_free(ctypes.cast(res.second, ctypes.c_void_p))
        if res.values:
            lib.gr_free(ctypes.cast(res.values, ctypes.c_void_p))
    # the reference's convention: column token first, row token second
    return int(res.n), second - 1, first - 1, values, bool(res.symmetric)
