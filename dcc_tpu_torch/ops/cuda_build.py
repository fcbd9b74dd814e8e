"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/*.cu`` file compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with :mod:`ctypes`. The build runs at the
first CUDA use, all sources at once (one ``nvcc`` process per source; or
in a background thread of the caller's, :func:`build`), into
``build/dcc_tpu_torch/<hash>/`` under the repository root; the hash covers
every source and the compiler flags, so an edited source rebuilds.

Every C entry point returns ``cudaGetLastError()`` after its launches, and
:func:`check` raises if it is not 0. Kernels launch on the caller's current
stream and allocate nothing; the Python wrappers allocate with
``torch.empty``.

``LAUNCHES`` counts kernel launches per kernel name; each wrapper adds one
where it launches its kernel and nowhere else. ``ENTRY`` records the C entry
point of each kernel's latest launch (K1's ``dcc_gae_seg``; for K2-K4,
K2b and the unfolded K3u / K4u the tensor-core ``*_mma`` entry or the FMA
one), ``TILE`` the row tile of each K2-K4, K2b, K3u / K4u latest launch.
At rows too wide for a staged tile (``ops.tiles.plan``) bf16 K3, K4, K3u
and K4u count their chunked launches under their own names, the chunked
K2 under ``fused_mlp_chunked`` and the chunked K2b under
``fused_mlp_bwd_chunked``, and the kernels that finish their layer 0
under ``actor_ppo_grads_dv0`` and ``critic_ppo_grads_dv0`` (dV0 of the
folded K3 and K4), ``dv0_unfolded`` (dW0 of K2b, K3u and K4u) and
``layer0_input_bwd`` (the feature norm's gradients and d(x) of K2b, K3u
and K4u); ``csrc/layer0_tail.cu`` holds dV0 and the layer-0 input
backward without d(x) on the warpgroup tensor cores (``dcc_dv0_wgmma``,
``dcc_layer0_input_bwd_wgmma``).

The trunk kernels read their parameter offsets from a device table
(:func:`offsets_table`, one per offsets list and device, made once and
never copied per launch), so they take a trunk of any depth. The bf16
gradient kernels' depth layout keeps each layer's saved tiles in a scratch
in device memory (:func:`deep_scratch`, one buffer per device that grows to
the largest launch); their column-blocked layout (the ``*_blocked``
libraries, hidden widths past what a staged or depth tile holds) keeps
every tile as wide as the hidden layer there too, as K2's does the later
layers' input, and their launches count under the kernel's name with
``_blocked`` appended (``fused_mlp_blocked``, ``fused_mlp_chunked_blocked``,
``critic_ppo_grads_blocked``, ...).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "dcc_tpu_torch")
SOURCES = ("gae", "fused_mlp", "fused_mlp_bwd", "fused_ppo", "fused_mlp_wide",
           "fused_mlp_bwd_wide", "fused_ppo_wide", "fused_mlp_blocked",
           "fused_mlp_bwd_blocked", "fused_ppo_blocked", "layer0_tail")
# the tensor-core kernels' hidden widths: an even width up to MMA_HMAX
# (csrc/trunk_mma.cuh) runs every layer in one pass in the base libraries;
# any other width (wider layers in column passes, odd widths element by
# element) the ``*_wide`` ones, the same sources built with DCC_WIDE; the
# column-blocked layout (``ops.tiles.plan``'s ``blocked``) the
# ``*_blocked`` ones, built with DCC_WIDE and DCC_BLOCKED
MMA_HMAX = 256
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

LAUNCHES: collections.Counter = collections.Counter()
ENTRY: dict = {}
TILE: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "gae": {"dcc_gae_seg": [_P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _F, _F, _P]},
    "fused_mlp": {
        "dcc_trunk_fwd": [_P, _I, _L, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P],
        "dcc_trunk_fwd_mma": [
            _P, _I, _L, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P,
        ],
        "dcc_trunk_fwd_mma_smem_bytes": [_I, _I, _I],
        "dcc_trunk_fwd_mma_chunked_smem_bytes": [_I, _I, _I],
        "dcc_trunk_fwd_scratch_bytes": [_I, _I],
    },
    "fused_mlp_bwd": {
        "dcc_trunk_bwd": [
            _P, _I, _P, _L, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P, _L, _I, _P, _P, _P,
        ],
        "dcc_trunk_bwd_mma": [
            _P, _I, _P, _L, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P, _I, _P, _L, _I,
            _P, _P, _P, _P, _P,
        ],
        # dcc_trunk_bwd_mma's arguments, with g0 and xstats in dx's place
        "dcc_trunk_bwd_chunked_mma": [
            _P, _I, _P, _L, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P, _I, _P, _L, _I,
            _P, _P, _P, _P, _P, _P,
        ],
        "dcc_layer0_input_bwd_mma": [
            _P, _I, _L, _I, _P, _P, _I, _P, _P, _I, _I, _P, _I, _P, _P, _P,
        ],
        "dcc_trunk_bwd_smem_bytes": [_I, _I, _I, _I],
        "dcc_trunk_bwd_mma_smem_bytes": [_I, _I, _I, _I, _I],
        "dcc_trunk_bwd_mma_chunked_smem_bytes": [_I, _I, _I, _I, _I],
        "dcc_layer0_input_bwd_smem_bytes": [_I, _I],
        "dcc_deep_scratch_bytes": [_I, _I, _I],
        "dcc_blocked_scratch_bytes": [_I, _I, _I, _I, _I],
    },
    "fused_ppo": {
        "dcc_actor_grads": [
            _P, _I, _P, _L, _I, _I, _I, _I, _I, _I, _F, _I, _P, _P, _I,
            _P, _L, _I, _P, _P,
        ],
        "dcc_actor_grads_mma": [
            _P, _I, _P, _L, _I, _I, _I, _I, _I, _I, _F, _I, _P, _P, _I, _P, _P, _I,
            _P, _L, _I, _P, _P, _P, _P,
        ],
        "dcc_critic_grads": [
            _P, _I, _P, _P, _L, _I, _I, _I, _I, _I, _F, _F, _I, _I, _I,
            _P, _P, _I, _P, _L, _I, _P, _P,
        ],
        "dcc_critic_grads_mma": [
            _P, _I, _P, _P, _L, _I, _I, _I, _I, _I, _F, _F, _I, _I, _I,
            _P, _P, _I, _P, _P, _I, _P, _L, _I, _P, _P, _P, _P,
        ],
        # dcc_critic_grads_mma's arguments, with g0 and xstats before out
        "dcc_critic_grads_chunked_mma": [
            _P, _I, _P, _P, _L, _I, _I, _I, _I, _I, _F, _F, _I, _I, _I,
            _P, _P, _I, _P, _P, _I, _P, _L, _I, _P, _P, _P, _P, _P, _P,
        ],
        # dcc_actor_grads_mma's arguments, with g0 and xstats before out
        "dcc_actor_grads_chunked_mma": [
            _P, _I, _P, _L, _I, _I, _I, _I, _I, _I, _F, _I, _P, _P, _I, _P, _P, _I,
            _P, _L, _I, _P, _P, _P, _P, _P, _P,
        ],
        "dcc_ppo_smem_bytes": [_I, _I, _I, _I, _I],
        "dcc_ppo_mma_smem_bytes": [_I, _I, _I, _I, _I, _I],
        "dcc_ppo_mma_chunked_smem_bytes": [_I, _I, _I, _I, _I, _I],
        "dcc_ppo_unfolded_smem_bytes": [_I, _I, _I, _I, _I],
        "dcc_ppo_unfolded_mma_smem_bytes": [_I, _I, _I, _I, _I, _I],
        "dcc_ppo_unfolded_mma_chunked_smem_bytes": [_I, _I, _I, _I, _I, _I],
    },
    # the layer-0 tail of the chunked kernels on warpgroup tensor cores: dV0
    # (dW0 in its affine mode) and the layer-0 input backward without dx
    "layer0_tail": {
        "dcc_dv0_wgmma": [_P, _I, _L, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P],
        "dcc_layer0_input_bwd_wgmma": [_P, _I, _L, _I, _P, _P, _I, _P, _I, _P, _P, _P],
        "dcc_dv0_wgmma_smem_bytes": [_I, _I],
        "dcc_layer0_input_bwd_wgmma_smem_bytes": [_I, _I],
    },
}


# the unfolded K3u / K4u entry points take the folded ones' arguments
_SIGNATURES["fused_ppo"].update({
    name.replace("_grads", "_grads_unfolded"): _SIGNATURES["fused_ppo"][name]
    for name in ("dcc_actor_grads", "dcc_actor_grads_mma", "dcc_critic_grads",
                 "dcc_critic_grads_mma", "dcc_critic_grads_chunked_mma",
                 "dcc_actor_grads_chunked_mma")
})
# the chunked K2 takes the staged one's arguments
_SIGNATURES["fused_mlp"]["dcc_trunk_fwd_chunked_mma"] = _SIGNATURES["fused_mlp"][
    "dcc_trunk_fwd_mma"]
# the wide and blocked libraries hold the same entry points
for _name in ("fused_mlp", "fused_mlp_bwd", "fused_ppo"):
    _SIGNATURES[f"{_name}_wide"] = _SIGNATURES[f"{_name}_blocked"] = _SIGNATURES[_name]


_TABLES: dict = {}
_SCRATCH: dict = {}
# the sources being compiled ({name: Event set when done}) and their nvcc
# processes, shared by the threads that build (:func:`build`)
_BUILD_LOCK = threading.Lock()
_BUILDING: dict = {}
_PROCS: set = set()


def offsets_table(offs, device) -> torch.Tensor:
    """The int64 device table of the element offsets ``offs`` that a
    kernel reads its parameters at, cached by (device, offsets): the copy
    to the device happens at the first launch of each trunk shape only."""
    key = (str(device), tuple(offs))
    t = _TABLES.get(key)
    if t is None:
        t = _TABLES[key] = torch.tensor(offs, dtype=torch.int64, device=device)
    return t


def deep_scratch(nbytes: int, device) -> torch.Tensor:
    """A uint8 device buffer of at least ``nbytes`` for the depth layout's
    saved tiles, one per device, kept between launches and grown to the
    largest asked for. Launches on one stream use it in turn."""
    key = str(device)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = _SCRATCH[key] = torch.empty(nbytes, dtype=torch.uint8, device=device)
    return buf


def reset_launches() -> None:
    LAUNCHES.clear()
    ENTRY.clear()
    TILE.clear()


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


def build(verbose: bool = False, names=SOURCES) -> dict:
    """Compile every source of ``names`` whose library is missing, in
    parallel; returns {name: path of the .so} of ``names``, the seconds the
    build took under key ``"_seconds"`` and, with ``verbose``, each source
    it compiled's ``-Xptxas -v`` report (registers, spills) under
    ``"_ptxas"``. Threads of one process may call it at once: a source in
    flight in another call is waited for, never compiled twice, so a
    program may build in a background thread and load the libraries it
    needs meanwhile (:func:`library` waits for its own source only)."""
    out_dir = os.path.join(BUILD_ROOT, _source_hash())
    os.makedirs(out_dir, exist_ok=True)
    paths = {n: os.path.join(out_dir, f"libdcc_{n}.so") for n in names}
    with _BUILD_LOCK:
        waits = [_BUILDING[n] for n in names if n in _BUILDING]
        todo = [n for n in names if n not in _BUILDING and not os.path.exists(paths[n])]
        for n in todo:
            _BUILDING[n] = threading.Event()
    t0 = time.perf_counter()
    failed, logs = [], {}
    try:
        procs = {}
        for n in todo:
            # each compiler's output to a file of its own: a pipe that
            # nobody reads while another compile is waited for would stall it
            tmp = paths[n] + f".tmp{os.getpid()}"
            cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
            with open(tmp + ".log", "w") as out:
                procs[n] = (tmp, subprocess.Popen(cmd, cwd=CSRC, stdout=out,
                                                  stderr=subprocess.STDOUT))
            _PROCS.add(procs[n][1])
        for n, (tmp, p) in procs.items():
            p.wait()
            _PROCS.discard(p)
            with open(tmp + ".log") as f:
                log = f.read()
            os.remove(tmp + ".log")
            if p.returncode != 0:
                failed.append(f"{n}.cu (rc {p.returncode}):\n{log}")
                continue
            logs[n] = log
            os.replace(tmp, paths[n])
    finally:
        with _BUILD_LOCK:
            for n in todo:
                _BUILDING.pop(n).set()
    for event in waits:
        event.wait()
    failed += [f"{n}.cu (built by another call)" for n in names
               if n not in todo and not os.path.exists(paths[n])]
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    paths["_seconds"] = time.perf_counter() - t0
    if verbose:
        paths["_ptxas"] = logs
    return paths


def stop_builds() -> None:
    """Kill the ``nvcc`` processes of every build in flight (a program that
    fails while a background thread builds)."""
    for p in list(_PROCS):
        p.kill()


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use, with
    every other missing source unless a build is already in flight)."""
    with _BUILD_LOCK:
        building = bool(_BUILDING)
    path = build(names=(name,) if building else SOURCES)[name]
    lib = ctypes.CDLL(path)
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_ulonglong if fn.endswith("_bytes") else ctypes.c_int
    lib.dcc_error_string.argtypes = [ctypes.c_int]
    lib.dcc_error_string.restype = ctypes.c_char_p
    return lib


def mma_library(name: str, hidden: int, blocked: bool = False) -> ctypes.CDLL:
    """The library whose tensor-core kernels take hidden width ``hidden``:
    ``name``'s for an even width up to ``MMA_HMAX``, else its ``_wide``
    twin (layers in column passes past ``MMA_HMAX`` padded to 16, odd
    widths element by element); with ``blocked``, its ``_blocked`` twin
    (the column-blocked layout, any width)."""
    if blocked:
        return library(f"{name}_blocked")
    wide = hidden % 2 or -(-hidden // 16) * 16 > MMA_HMAX
    return library(f"{name}_wide" if wide else name)


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
