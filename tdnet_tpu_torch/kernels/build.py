"""Build the CUDA sources under ``tdnet_tpu_torch/csrc`` at first use.

Each library is compiled by ``nvcc`` for ``sm_90a`` into a shared object with
a plain C interface and loaded with ``ctypes``. The object lands in
``build/tdnet_tpu_torch/`` at the root of the checkout, named by a hash of
its sources, the local headers they include (``#include "x.cuh"``), the
flags and any ``-D`` defines, so a changed source or header builds anew and an
unchanged one is reused. ``compile_libraries`` starts one ``nvcc`` per
library, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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


def _with_headers(sources: tuple[str, ...]) -> list[str]:
    """``sources`` and, transitively, the csrc/ headers they include."""
    seen, todo = [], list(sources)
    while todo:
        name = todo.pop(0)
        if name in seen:
            continue
        seen.append(name)
        with open(os.path.join(CSRC, name)) as f:
            todo += re.findall(r'^\s*#include\s+"([^"]+)"', f.read(), re.M)
    return seen


def _lib_path(name: str, sources: tuple[str, ...], defines: tuple[str, ...] = ()) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + defines).encode())
    for s in _with_headers(sources):
        with open(os.path.join(CSRC, s), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def compile_libraries(specs: dict[str, tuple[str, ...]],
                      defines: dict[str, tuple[str, ...]] | None = None) -> None:
    """Compile every library of ``specs`` (name -> source file names under
    csrc/) that is not built yet, one nvcc process each, all concurrently;
    ``defines`` (name -> ``NAME=value`` strings) adds ``-D`` flags to a library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for name, sources in specs.items():
        defs = (defines or {}).get(name, ())
        lib_path = _lib_path(name, sources, defs)
        if os.path.isfile(lib_path):
            continue
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, *[f"-D{d}" for d in defs], "-o", tmp,
               *[os.path.join(CSRC, s) for s in sources]]
        jobs.append((cmd, tmp, lib_path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for cmd, tmp, lib_path, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
        else:
            os.replace(tmp, lib_path)  # atomic: a concurrent build never sees half a file
    if failures:
        raise RuntimeError("\n".join(failures))


def load_library(name: str, sources: tuple[str, ...],
                 defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Compile ``sources`` (file names under csrc/) once, with ``-D`` ``defines``,
    and load the library."""
    if name not in _loaded:
        compile_libraries({name: sources}, {name: defines})
        _loaded[name] = ctypes.CDLL(_lib_path(name, sources, defines))
    return _loaded[name]
