"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/*.cu`` file compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with :mod:`ctypes`. The build runs at the
first CUDA use, all sources at once (one ``nvcc`` process per source), into
``build/dcc_tpu_torch/<hash>/`` under the repository root; the hash covers
every source and the compiler flags, so an edited source rebuilds.

Every C entry point returns ``cudaGetLastError()`` after its launches, and
:func:`check` raises if it is not 0. Kernels launch on the caller's current
stream and allocate nothing; the Python wrappers allocate with
``torch.empty``.

``LAUNCHES`` counts kernel launches per kernel name; each wrapper adds one
where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "dcc_tpu_torch")
SOURCES = ("gae", "fused_mlp", "fused_ppo")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "gae": {"dcc_gae": [_P, _P, _P, _P, _P, _P, _I, _L, _F, _F, _P]},
    "fused_mlp": {
        "dcc_trunk_fwd": [_P, _I, _L, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P],
    },
    "fused_ppo": {
        "dcc_actor_grads": [
            _P, _I, _P, _L, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P, _P, _I,
            _P, _L, _I, _P, _P,
        ],
        "dcc_critic_grads": [
            _P, _I, _P, _P, _L, _I, _I, _I, _I, _I, _I, _F, _F, _I, _I, _I,
            _P, _P, _I, _P, _L, _I, _P, _P,
        ],
        "dcc_ppo_smem_bytes": [_I, _I, _I, _I, _I],
    },
}


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> dict:
    """Compile every source whose library is missing, in parallel; returns
    {name: path of the .so} and the seconds the build took under key
    ``"_seconds"``."""
    out_dir = os.path.join(BUILD_ROOT, _source_hash())
    os.makedirs(out_dir, exist_ok=True)
    paths = {n: os.path.join(out_dir, f"libdcc_{n}.so") for n in SOURCES}
    todo = [n for n in SOURCES if not os.path.exists(paths[n])]
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = paths[n] + f".tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, cwd=CSRC, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for n, (tmp, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{n}.cu (rc {p.returncode}):\n{log}")
            continue
        if verbose and log:
            print(f"--- nvcc {n}.cu ---\n{log}")
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    paths["_seconds"] = time.perf_counter() - t0
    return paths


@functools.lru_cache(maxsize=None)
def _libraries() -> dict:
    paths = build()
    libs = {}
    for name in SOURCES:
        lib = ctypes.CDLL(paths[name])
        for fn, argtypes in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_ulonglong if fn == "dcc_ppo_smem_bytes" else ctypes.c_int
        lib.dcc_error_string.argtypes = [ctypes.c_int]
        lib.dcc_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    return _libraries()[name]


def check(name: str, code: int, kernel: str) -> None:
    if code != 0:
        msg = library(name).dcc_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: {msg} ({code})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtypes, shape=None, device=None) -> None:
    """Validate a kernel operand: CUDA, dtype, shape, contiguity, device."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
