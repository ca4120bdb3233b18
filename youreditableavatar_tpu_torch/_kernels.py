"""Builds and loads the hand-written Hopper kernels under `csrc/`.

Each `csrc/*.cu` file compiles with `nvcc` for sm_90a into an object (all
sources at once, one `nvcc` process each), and the objects link into one
shared library with a plain C interface, loaded with ctypes. The build runs
at the first kernel call of a process — never at import — into
`_build/`, keyed by a hash of the sources and flags, so an unchanged
checkout reuses it.

Every wrapper adds one to `LAUNCHES[name]` where it launches its kernel,
and nowhere else, so a run can show that its main path went through them.
A CUDA graph replay (`utils/cuda_graphs.py`) adds the launches the graph
holds, taken once at its capture. `GRAPHS` counts the graphed functions
`captured`, the graphed calls `replayed` and the calls that could have been
graphed and ran `eager` (on CPU tensors).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]
# Per-source flags. The expansion cull, the compositing α decisions and the
# z-buffer's inside/depth tests must repeat the plain PyTorch versions' f32
# arithmetic op for op: no FMA contraction there. ptxas reports the
# compositing kernels' registers, shared memory and spills (`BUILD_LOGS`).
SOURCE_FLAGS: Dict[str, list] = {
    "counting.cu": [],
    "expand.cu": ["--fmad=false"],
    "composite.cu": ["--fmad=false", "-Xptxas", "-v"],
    "mesh_resolve.cu": ["--fmad=false"],
    "hash_scatter.cu": [],
    # K7 multiplies with explicit `fmaf` alone; ptxas reports its
    # registers, shared memory and spills.
    "conv.cu": ["-Xptxas", "-v"],
}

KERNEL_NAMES = (
    "tile_histogram",
    "counting_layout",
    "expand_pairs",
    "composite_forward",
    "composite_backward",
    "composite_backward_pairs",
    "mesh_resolve",
    "hash_scatter",
    "conv_forward",
    "conv_input_grad",
    "conv_forward_ws",
    "conv_input_grad_ws",
    "conv_reduce",
)
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNEL_NAMES}
GRAPHS: Dict[str, int] = {"captured": 0, "replayed": 0, "eager": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "yea_tile_histogram": [_P, _P, _I, _I, _P],
    "yea_counting_layout": [_P, _P, _P, _P, _I, _I, _P],
    "yea_expand_pairs": [_P, _P, _I, _P, _P, _I, _I, _I, _I, _P],
    "yea_composite_forward": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                              _I, _I, _I, _I, _P],
    "yea_composite_forward_clusters": [_I, _I],
    "yea_composite_backward": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _P, _I, _I, _I, _I, _P],
    "yea_composite_backward_pairs": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _P, _I, _I, _I, _I, _P],
    "yea_mesh_resolve": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "yea_hash_scatter": [_P, _P, _P, _I, _L, _I, _P, _P],
    "yea_conv": [_P, _I, _I, _I, _I, _I, _I, _P],
    "yea_conv_reduce": [_P, _P, _P, _L, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
BUILD_SECONDS = None  # wall time of this process's build (None if reused)
BUILD_LOGS: Dict[str, str] = {}  # nvcc's output per source of that build


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _digest() -> str:
    h = hashlib.sha256()
    for name in sorted(SOURCE_FLAGS):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
        h.update(" ".join(SOURCE_FLAGS[name]).encode())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(ARCH + COMMON_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (in parallel) and link the shared library."""
    global BUILD_SECONDS
    out = BUILD_DIR / f"libyea_kernels_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name, flags in SOURCE_FLAGS.items():
            obj = Path(tmp) / (name + ".o")
            cmd = [nvcc, *ARCH, *COMMON_FLAGS, *flags, "-c", str(CSRC / name),
                   "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for name, _, proc in procs:
            log = proc.communicate()[0].decode(errors="replace")
            BUILD_LOGS[name] = log
            if proc.returncode != 0:
                errors.append(f"--- {name} ---\n{log}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp_lib),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout.decode())
        os.replace(tmp_lib, out)
    BUILD_SECONDS = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn, argtypes in _SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _lib = lib
    return _lib


def launch(kernel: str, fn: str, device: torch.device, *args) -> None:
    """Call C entry `fn` on `device`'s current stream; count and check the
    launch."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn} failed to launch: CUDA error {err}")
    LAUNCHES[kernel] += 1


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and rank."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have rank {ndim}, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
