"""Builds ``csrc/ensemble_mlp.cu`` with ``nvcc`` at first use and loads it with ctypes.

The shared library goes to ``mbrl_tpu_torch/_build/`` (git-ignored), named by
a hash of the source, so an edited source is rebuilt and an unchanged one is
reused. Nothing is built when the module is imported: only
:func:`load_library` builds, and only the CUDA kernel wrappers call it.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "ensemble_mlp.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(os.path.join(os.environ[env], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda/bin)")


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libensemble_mlp_{digest[:16]}.so"


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the source if its library is not built yet; return its path."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
            )
        if verbose:
            print(proc.stdout + proc.stderr, file=sys.stderr)
        os.replace(tmp, lib)  # atomic: a reader never sees a half-written library
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels, with every signature declared."""
    lib = ctypes.CDLL(str(build()))
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    dims = ctypes.POINTER(ctypes.c_int)
    lib.mbrl_ensemble_mlp.argtypes = [p, p, p, p, dims, i, i, i, i, i, p]
    lib.mbrl_ensemble_mlp.restype = i
    lib.mbrl_ensemble_mlp_gaussian.argtypes = [
        u, u, p, p, p, p, p, p, dims, i, i, i, i, i, i, i, p
    ]
    lib.mbrl_ensemble_mlp_gaussian.restype = i
    lib.mbrl_rollout_returns.argtypes = [
        u, u, p, p, p, p, p, p, p, p, p, dims, i, i, i, i, i, i, i, i, i, i, i, p
    ]
    lib.mbrl_rollout_returns.restype = i
    return lib
