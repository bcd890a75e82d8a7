"""Build the CUDA sources under ``tdnet_tpu_torch/csrc`` at first use.

Each library is compiled by ``nvcc`` for ``sm_90a`` into a shared object with
a plain C interface and loaded with ``ctypes``. The object lands in
``build/tdnet_tpu_torch/`` at the root of the checkout, named by a hash of
its sources and flags, so a changed source builds anew and an unchanged one
is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build", "tdnet_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def load_library(name: str, sources: tuple[str, ...]) -> ctypes.CDLL:
    """Compile ``sources`` (file names under csrc/) once and load the library."""
    if name in _loaded:
        return _loaded[name]
    paths = [os.path.join(CSRC, s) for s in sources]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        with open(p, "rb") as f:
            digest.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")
    if not os.path.isfile(lib_path):
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, *paths]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, lib_path)  # atomic: a concurrent build never sees half a file
    _loaded[name] = ctypes.CDLL(lib_path)
    return _loaded[name]
