"""ctypes bindings for the native data-plane kernels (batcher.cpp).

Compiled with g++ on first use into ``libbatcher-<source hash>.so`` next to
the source, so an edited ``batcher.cpp`` always gets a fresh build and an
unchanged one is never rebuilt; every entry point has a numpy fallback, so
the framework works without a toolchain too. ``available()`` reports which
path is active.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "batcher.cpp")
_lock = threading.Lock()
_lib = None
_tried = False


def lib_path(src: str = _SRC) -> str:
    """Library built from ``src``: named by a hash of the source's bytes."""
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(os.path.dirname(src), f"libbatcher-{digest}.so")


def _build(src: str, so: str):
    tmp = f"{so}.{os.getpid()}.tmp"  # each concurrent build renames its own
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, src,
           "-lpthread"]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, so)


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            so = lib_path()
            if not os.path.exists(so):
                _build(_SRC, so)
            lib = ctypes.CDLL(so)
            lib.normalize_u8_to_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
            lib.mask_from_alpha.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
            lib.gather_rows_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
            _lib = lib
        except (OSError, subprocess.CalledProcessError):
            _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def normalize_images(imgs: np.ndarray, threads: int = 4) -> np.ndarray:
    """uint8 → float32 (x/127.5 - 1), threaded native path when available."""
    imgs = np.ascontiguousarray(imgs)
    lib = _load()
    if lib is None or imgs.dtype != np.uint8:
        return (imgs.astype(np.float32) / 127.5 - 1)
    out = np.empty(imgs.shape, np.float32)
    lib.normalize_u8_to_f32(imgs.ctypes.data, out.ctypes.data,
                            imgs.size, threads)
    return out


def mask_from_alpha(alpha: np.ndarray, threads: int = 4) -> np.ndarray:
    alpha = np.ascontiguousarray(alpha)
    lib = _load()
    if lib is None or alpha.dtype != np.uint8:
        return alpha.astype(np.float32) / 255.0
    out = np.empty(alpha.shape, np.float32)
    lib.mask_from_alpha(alpha.ctypes.data, out.ctypes.data, alpha.size, threads)
    return out


def gather_rows(table: np.ndarray, idx: np.ndarray, threads: int = 4
                ) -> np.ndarray:
    """out[r] = table[idx[r]] for 2-D float32 tables."""
    table = np.ascontiguousarray(table, np.float32)
    idx = np.ascontiguousarray(idx, np.int64)
    lib = _load()
    if lib is None:
        return table[idx]
    out = np.empty((idx.shape[0], table.shape[1]), np.float32)
    lib.gather_rows_f32(table.ctypes.data, idx.ctypes.data, out.ctypes.data,
                        idx.shape[0], table.shape[1], threads)
    return out
