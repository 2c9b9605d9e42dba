"""Hand-written Hopper kernels: build at first use, load, count launches.

Every `aocr_torch/csrc/*.cu` source compiles with `nvcc` for `sm_90a` into
one shared library with a plain C interface, loaded with `ctypes`.  The
library lands in `build/aocr_torch/` at the repo root, named by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
loads at once.  Nothing here runs at import time: the CPU tests import
every module on a machine without `nvcc`.

Each kernel module (`conv1_pool`, `lstm_fwd`, `decode_step`,
`greedy_loop`) holds a wrapper, a plain PyTorch version, and a plain
integer `launches` that the wrapper bumps at each kernel launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "aocr_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

# the kernel modules of this package, one per kernel
KERNELS = ("conv1_pool", "lstm_fwd", "decode_step", "greedy_loop")

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels of aocr_torch "
                           "build only where the CUDA toolkit is installed")
    return found


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    deps = sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + deps:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return srcs, h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a library of the same sources exists;
    returns its path.  The build writes to a temporary name and renames,
    so concurrent processes never load a half-written file."""
    srcs, digest = _sources()
    out = BUILD_DIR / f"libaocr_kernels_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
           *map(str, srcs)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        return _lib


_P = ctypes.c_void_p
_I = ctypes.c_int


def _declare(lib) -> None:
    sigs = {
        # x, w9, b, out, B, H, W, stream
        "conv1_pool": [_P, _P, _P, _P, _I, _I, _I, _P],
        # wh, xp, xp_is_f32, c0, h0, hs, cf, hf, L, B, H, reverse, stream
        "lstm_fwd": [_P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        # h, ctx, prev, wa, wc, pw, pb, htilde, tok, delta, L, B, H, Vp,
        # stream
        "decode_step": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _P],
        # ctx, c0, h0, eg, wfh0, wx, bx, wa, wc, pw, pb, labels, scores,
        # state, L, B, H, Vp, T, num_layers, input_feed, stream
        "greedy_loop": [_P] * 14 + [_I] * 7 + [_P],
    }
    for name, args in sigs.items():
        for suffix in ("f32", "bf16"):
            fn = getattr(lib, f"aocr_{name}_{suffix}")
            fn.argtypes = args
            fn.restype = ctypes.c_int


def launch(name: str, dtype: torch.dtype, device: torch.device,
           *args) -> None:
    """Call `aocr_<name>_<f32|bf16>` on `device`'s current stream; raise
    on a launch error (a refused launch never runs, and no later
    synchronize reports it)."""
    suffix = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
    fn = getattr(library(), f"aocr_{name}_{suffix}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"aocr_{name}_{suffix} launch failed: CUDA error "
                           f"{err}")


def check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    """Raise unless `t` is a contiguous tensor of this shape and dtype on
    this device (shape entries of None match any size)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch_counts() -> dict:
    import importlib

    return {k: importlib.import_module(f"{__name__}.{k}").launches
            for k in KERNELS}


def reset_launch_counts() -> None:
    import importlib

    for k in KERNELS:
        importlib.import_module(f"{__name__}.{k}").launches = 0
