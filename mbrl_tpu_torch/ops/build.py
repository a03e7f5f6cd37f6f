"""Builds the kernels of ``csrc/`` with ``nvcc`` at first use and loads them with ctypes.

Every ``csrc/*.cu`` is compiled to an object by its own ``nvcc``, all at once,
and the objects are linked into one shared library in ``mbrl_tpu_torch/_build/``
(git-ignored), named by a hash of every source and header (``*.cu``, ``*.cuh``),
so an edited file is rebuilt and an unchanged tree is reused. Nothing is built
when the module is imported: only :func:`load_library` builds, and only the
CUDA kernel wrappers call it.
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
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
)


# Extra nvcc flags for every source, part of the library's hash; the timeline
# tool (ops/chain_timeline.py) sets ("-DTC_TIMELINE",) before the first load.
EXTRA_FLAGS: tuple = ()


def sources() -> list:
    """The kernel sources to compile, in a fixed order."""
    return sorted(CSRC.glob("*.cu"))


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + EXTRA_FLAGS).encode())
    for f in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"libensemble_mlp_{h.hexdigest()[:16]}.so"


def _run(procs) -> str:
    """Wait for every (cmd, Popen); raise on the first that failed."""
    logs = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
        logs.append(out)
    return "".join(logs)


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the sources if their library is not built yet; return its path."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    flags = [*NVCC_FLAGS, *EXTRA_FLAGS, *(["-Xptxas=-v"] if verbose else [])]
    try:
        objs, procs = [], []
        for src in sources():  # one nvcc per source, all started together
            obj = os.path.join(work, src.stem + ".o")
            cmd = [nvcc, *flags, "-c", "-o", obj, str(src)]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
            objs.append(obj)
        log = _run(procs)
        tmp = os.path.join(work, "lib.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        log += _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))])
        if verbose:
            print(log, file=sys.stderr)
        os.replace(tmp, lib)  # atomic: a reader never sees a half-written library
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib


_P, _I, _U, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong
_DIMS = ctypes.POINTER(ctypes.c_int)
# every entry of the library: its argument types (each returns a CUDA error code)
SIGNATURES = {
    "mbrl_ensemble_mlp": [_P, _P, _P, _P, _DIMS, _I, _I, _I, _I, _I, _I, _LL, _P],
    "mbrl_ensemble_mlp_gaussian": [
        _U, _U, _P, _P, _P, _P, _P, _P, _DIMS, _I, _I, _I, _I, _I, _I, _I, _LL, _P,
    ],
    "mbrl_rollout_returns": [
        _U, _U, _P, _P, _P, _P, _P, _P, _P, _P, _P, _DIMS, _I, _I, _I, _I, _I, _I, _I, _I, _I,
        _I, _I, _LL, _P,
    ],
    # the wide route (csrc/wide_chain.cu): host dims, device dims, ..., scratch
    "mbrl_ensemble_mlp_wide": [
        _P, _P, _P, _P, _DIMS, _P, _I, _I, _I, _I, _I, _I, _LL, _P, _LL, _P,
    ],
    "mbrl_ensemble_mlp_gaussian_wide": [
        _U, _U, _P, _P, _P, _P, _P, _P, _DIMS, _P, _I, _I, _I, _I, _I, _I, _I, _LL, _P, _LL, _P,
    ],
    "mbrl_rollout_returns_wide": [
        _U, _U, _P, _P, _P, _P, _P, _P, _P, _P, _P, _DIMS, _P, _I, _I, _I, _I, _I, _I, _I, _I,
        _I, _I, _I, _LL, _P, _LL, _P,
    ],
}


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels, with every signature declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
