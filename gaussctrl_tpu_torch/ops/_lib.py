"""Build and load the CUDA kernel library.

All sources under `gaussctrl_tpu_torch/csrc/` are compiled by one `nvcc` call
for `sm_90a` into one shared library with a plain C interface, which is
loaded with `ctypes`. The attention kernels fetch libcuda's tensor-map encoder
through the runtime (`cudaGetDriverEntryPointByVersion`), so no link flag
beyond nvcc's defaults is needed. `--threads 0` lets that call compile the
sources in parallel, one thread per CPU. The build runs at first use and is
keyed by a hash of the sources (`*.cu` and the headers `*.cuh`) and flags,
so a changed source rebuilds and an unchanged one is reused. The output
directory (`gaussctrl_tpu_torch/_build/`) is git-ignored. The first load
holds a lock, so that threads (the viewer renders on one per request) build
and bind the library once.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v",
              "--threads", "0"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "gc_splat_blend_fwd": [_P] * 14 + [_I] * 4 + [_P],
    "gc_splat_blend_bwd": [_P] * 11 + [_I] * 3 + [_P],
    "gc_splat_blend_fwd_attrs": [_I, _P],
    "gc_splat_blend_bwd_attrs": [_I, _P],
    "gc_flash_attention": [_P] * 4 + [_I] * 5 + [_P],
    "gc_cross_view_attention": [_P] * 4 + [_I] * 6 + [ctypes.c_float, _P],
    "gc_attention_full": [_P] * 4 + [_L, _L] + [_I] * 5 + [_P],
    "gc_attention_stream": [_P] * 4 + [_L, _L] + [_I] * 5 + [_P],
    "gc_supported_head_dim": [_I],
    "gc_flash_smem_bytes": [_I],
    "gc_cross_view_smem_bytes": [_I],
    "gc_attention_full_smem_bytes": [_I, _I],
}

_lib = None
_load_lock = threading.Lock()
build_seconds = None   # wall time of the last build in this process (None: reused)
build_log = ""         # nvcc/ptxas report of that build (registers, spills)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return path


def library_path() -> str:
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                     + glob.glob(os.path.join(CSRC, "*.cuh")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libgaussctrl_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library if this source hash has not been built yet."""
    global build_seconds, build_log
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is not None:
        return _lib
    with _load_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
