"""ctypes bindings for the repository's native host helpers
(`native/gaussctrl_native.cpp`): OPENCV-model undistortion, bilinear
resize, and the k-nearest-neighbour mean distance.

Counterpart of `gaussctrl_tpu/native`, with a build of its own: one `g++`
call compiles the source into the git-ignored `gaussctrl_tpu_torch/_build/`
at first use, keyed by a hash of the source and flags. Nothing is built
inside `native/`. Where no compiler is present `available()` is False, and
each call site keeps its cv2 fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "gaussctrl_native.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + f.read())
    so = os.path.join(BUILD_DIR, f"libgaussctrl_native_{digest.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            raise RuntimeError("no C++ compiler for the native helpers")
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp], check=True,
                       capture_output=True)
        os.replace(tmp, so)
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(_build())
    except (OSError, RuntimeError, subprocess.CalledProcessError):
        return None
    fp, i, d = ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_double
    lib.undistort_f32.argtypes = [fp, i, i, i, d, d, d, d,
                                  ctypes.POINTER(ctypes.c_double), fp]
    lib.resize_bilinear.argtypes = [fp, i, i, i, i, i, fp]
    lib.knn_mean_dist.argtypes = [fp, ctypes.c_int64, i, fp]
    for fn in (lib.undistort_f32, lib.resize_bilinear, lib.knn_mean_dist):
        fn.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def undistort(image: np.ndarray, fx: float, fy: float, cx: float, cy: float,
              dist6) -> np.ndarray:
    """OPENCV-model undistortion with output intrinsics = input intrinsics.
    image [H,W,C] float32; dist6 = (k1, k2, k3, k4, p1, p2)."""
    lib = _load()
    assert lib is not None
    img = np.ascontiguousarray(image, np.float32)
    h, w, c = img.shape
    out = np.empty_like(img)
    d6 = np.ascontiguousarray(dist6, np.float64)
    lib.undistort_f32(_fptr(img), h, w, c, fx, fy, cx, cy,
                      d6.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                      _fptr(out))
    return out


def resize(image: np.ndarray, oh: int, ow: int) -> np.ndarray:
    lib = _load()
    assert lib is not None
    img = np.ascontiguousarray(image, np.float32)
    h, w, c = img.shape
    out = np.empty((oh, ow, c), np.float32)
    lib.resize_bilinear(_fptr(img), h, w, c, oh, ow, _fptr(out))
    return out


def knn_mean_dist(points: np.ndarray, k: int = 3) -> np.ndarray:
    """Mean distance of each point to its k nearest neighbours."""
    lib = _load()
    assert lib is not None
    pts = np.ascontiguousarray(points, np.float32)
    out = np.empty((pts.shape[0],), np.float32)
    lib.knn_mean_dist(_fptr(pts), pts.shape[0], k, _fptr(out))
    return out
