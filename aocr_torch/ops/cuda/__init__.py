"""Hand-written Hopper kernels: build at first use, load, count launches.

Every `aocr_torch/csrc/*.cu` source compiles with `nvcc` for `sm_90a` into
one shared library with a plain C interface, loaded with `ctypes`.  The
library lands in `build/aocr_torch/` at the repo root, named by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
loads at once.  Nothing here runs at import time: the CPU tests import
every module on a machine without `nvcc`.

Each kernel module (`KERNELS`) holds a wrapper, a plain PyTorch version,
and a plain integer `launches` that the wrapper bumps at each kernel
launch (some keep per-mode counters `launches_*` beside it).  A kernel
that plans its launch has a `checked_plan`, which holds the wrapper's
plan against the kernel's own through `held_plan`.  The inference
kernels' wrappers (`OPS`) call a `torch.library` custom op,
`aocr_torch::<wrapper>`, whose body is the launch (or, on CPU tensors,
the plain version) and whose fake version states the outputs' shapes.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
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
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

# the kernel modules of this package, one per kernel
KERNELS = ("conv1_pool", "lstm_fwd", "decode_step", "greedy_loop",
           "conv1_pool_bwd", "lstm_bwd", "tf_fwd", "tf_bwd", "beam_step",
           "beam_loop", "conv1_pool_dx", "pool_bwd")

# the inference kernels, whose wrappers call custom ops
# (`aocr_torch::<wrapper>`, registered when their module is imported) so
# that torch.export traces them as nodes of a program (aocr_torch/export.py)
OPS = ("conv1_pool", "lstm_fwd", "decode_step", "greedy_loop", "beam_step",
       "beam_loop")

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
    returns its path.  Every source compiles in its own `nvcc` process,
    all started together, then one link.  The library is written under a
    temporary name and renamed, so concurrent processes never load a
    half-written file."""
    srcs, digest = _sources()
    out = BUILD_DIR / f"libaocr_kernels_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        nvcc = _nvcc()
        procs = []
        for src in srcs:
            obj = work / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj),
                   str(src)]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            procs.append((obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = [(p.args[-1], p.communicate()[0], p.returncode)
                for _, p in procs]
        failed = [f"{src} ({rc}):\n{log}" for src, log, rc in logs if rc]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = work / "lib.so"
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
             *(str(o) for o, _ in procs)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        if verbose:
            print("".join(log for _, log, _ in logs))
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
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
        # x, w, b, out, B, H, W, blocks, stream
        "conv1_pool": [_P] * 4 + [_I] * 4 + [_P],
        # wh, xp, xp_is_f32, c0, h0, hs, cf, hf, ifog, cs, L, B, H,
        # reverse, stream
        "lstm_fwd": [_P, _P, _I] + [_P] * 7 + [_I] * 4 + [_P],
        # h, ctx, prev, wa, wc, wq, wc (the cluster route's packed weights,
        # beam_step.packed_weights), pw, pb, valid, htilde, tok, delta,
        # scratch, L, B, H, Vp, V, nb, stream
        "decode_step": [_P] * 14 + [_I] * 6 + [_P],
        # ctx, c0, h0, eg, w0, wl, bx, wq, wc (the packed weights of
        # greedy_loop.pack_weights), pw, pb, trie, labels, scores, scratch,
        # L, B, H, Vp, V, T, num_layers, input_feed, stream
        "greedy_loop": [_P] * 15 + [_I] * 8 + [_P],
        # x, w, b, dy, part, count, dw, db, B, H, W, blocks, stream
        "conv1_pool_bwd": [_P] * 8 + [_I] * 4 + [_P],
        # wh, dhs, ifog, cs, c0, dcf, dhf, dg, dh0, dc0, scratch, L, B, H,
        # reverse, stream
        "lstm_bwd": [_P] * 11 + [_I] * 4 + [_P],
        # ctx, c0, h0, xp, w0, wl, bi, bh, wq, wc (the packed weights of
        # greedy_loop.pack_weights), htl, hs, ifog, cs, alpha, cvec,
        # scratch, L, B, H, T, num_layers, input_feed, stream
        "tf_fwd": [_P] * 17 + [_I] * 6 + [_P],
        # ctx, w0, wl, wct, wat (the packed transposed weights of
        # tf_bwd.pack_weights), dys, htl, alpha, ifog, cs, c0, dg, dht, dq,
        # dcvec, dscore, dc0, dh0, scratch, L, B, H, T, num_layers,
        # input_feed, stream
        "tf_bwd": [_P] * 19 + [_I] * 6 + [_P],
        # ctx, h, prev, scores, wa, wc, wq, wc (the cluster route's packed
        # weights, beam_step.packed_weights), pw, pb, valid, htilde, nsc,
        # par, tok, nvalid, scratch, L, B, H, Vp, V, K, nb, stream
        "beam_step": [_P] * 17 + [_I] * 7 + [_P],
        # ctx, init, tok0, sc0, node0, eg, w0, wl, bx, wq, wc (the packed
        # weights of greedy_loop.pack_weights), pw, pb, trie, tok_hist,
        # par_hist, fsc, flen, refills, minv, scratch, L, B, H, Vp, V, T,
        # num_layers, input_feed, K, count_lengths, stream
        "beam_loop": [_P] * 21 + [_I] * 10 + [_P],
        # x, w, b, dy, out, B, H, W, blocks, stream
        "conv1_pool_dx": [_P] * 5 + [_I] * 4 + [_P],
        # y, dy, dz, B, H, W, C, wh, ww, stream
        "pool_bwd": [_P] * 3 + [_I] * 6 + [_P],
    }
    for name, args in sigs.items():
        for suffix in ("f32", "bf16"):
            fn = getattr(lib, f"aocr_{name}_{suffix}")
            fn.argtypes = args
            fn.restype = ctypes.c_int
    # H, B, is_f32, xp_is_f32, out[9]
    lib.aocr_lstm_fwd_plan.argtypes = [_I] * 4 + [ctypes.POINTER(_I)]
    lib.aocr_lstm_fwd_plan.restype = ctypes.c_int
    # B, H, W, is_f32, out[5]
    lib.aocr_conv1_pool_plan.argtypes = [_I] * 4 + [ctypes.POINTER(_I)]
    lib.aocr_conv1_pool_plan.restype = ctypes.c_int
    # B, H, W, is_f32, out[4]
    for name in ("aocr_conv1_pool_bwd_plan", "aocr_conv1_pool_dx_plan"):
        getattr(lib, name).argtypes = [_I] * 4 + [ctypes.POINTER(_I)]
        getattr(lib, name).restype = ctypes.c_int
    # H, B, is_f32, out[7]
    lib.aocr_lstm_bwd_plan.argtypes = [_I] * 3 + [ctypes.POINTER(_I)]
    lib.aocr_lstm_bwd_plan.restype = ctypes.c_int
    # H, B, is_f32, L, Vp, num_layers, out[10]
    lib.aocr_greedy_loop_plan.argtypes = [_I] * 6 + [ctypes.POINTER(_I)]
    lib.aocr_greedy_loop_plan.restype = ctypes.c_int
    # H, B, is_f32, L, Vp, num_layers -> the attention's position slices
    lib.aocr_greedy_loop_split.argtypes = [_I] * 6
    lib.aocr_greedy_loop_split.restype = ctypes.c_int
    # H, B, K, is_f32, L, Vp, num_layers, out[11]
    lib.aocr_beam_loop_plan.argtypes = [_I] * 7 + [ctypes.POINTER(_I)]
    lib.aocr_beam_loop_plan.restype = ctypes.c_int
    # H, B, K, is_f32, L, Vp, out[11]
    lib.aocr_beam_step_plan.argtypes = [_I] * 6 + [ctypes.POINTER(_I)]
    lib.aocr_beam_step_plan.restype = ctypes.c_int
    # H, B, is_f32, L, Vp, out[11]
    lib.aocr_decode_step_plan.argtypes = [_I] * 5 + [ctypes.POINTER(_I)]
    lib.aocr_decode_step_plan.restype = ctypes.c_int
    # H, B, is_f32, L, num_layers, out[10]
    for name in ("aocr_tf_fwd_plan", "aocr_tf_bwd_plan"):
        getattr(lib, name).argtypes = [_I] * 5 + [ctypes.POINTER(_I)]
        getattr(lib, name).restype = ctypes.c_int


# the C entry points by (kernel, dtype)
_fns: dict = {}


def launch(name: str, dtype: torch.dtype, device: torch.device,
           *args) -> None:
    """Call `aocr_<name>_<f32|bf16>` on `device`'s current stream, made the
    current device for the call where it is not; raise on a launch error
    (a refused launch never runs, and no later synchronize reports it).
    The entry point is looked up once, and the device switched only where
    needed: both cost ~20 us of host time a call, as much as a small
    kernel takes on the card."""
    fn = _fns.get((name, dtype))
    if fn is None:
        suffix = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
        fn = _fns[(name, dtype)] = getattr(library(),
                                           f"aocr_{name}_{suffix}")
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


def ptr(t) -> int:
    """A tensor's device address, 0 (a null pointer) for None."""
    return 0 if t is None else t.data_ptr()


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


def check_aligned(**tensors) -> None:
    """Raise unless each tensor's first element lies on a 16-byte boundary,
    as the kernels' vector loads and bulk copies need (a fresh allocation
    always does; a view at an offset may not)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def held_plan(kernel: str, key, query, n_out: int, mirror, describe,
              cache: dict, rows: bool = False):
    """The launch plan of `kernel` at shape `key`, held against the
    kernel's own.  On the key's first launch, query(out) (the kernel's
    `aocr_<kernel>_plan`) fills out[0..n_out-2] with its plan and the last
    slot with the clusters (or blocks) the card runs at once, `active`;
    mirror(active), the wrapper's plan, must equal it (RuntimeError where
    not; with `rows`, an all-zero kernel plan is the rows route, None);
    the line describe(plan, active) is logged and `cache` keeps (plan,
    line).  Later launches of the key read the cache."""
    if key not in cache:
        out = (ctypes.c_int * n_out)()
        err = query(out)
        if err != 0:
            raise RuntimeError(f"aocr_{kernel}_plan failed: CUDA error {err}")
        active = out[n_out - 1]
        p = mirror(active)
        got = tuple(out[:n_out - 1])
        if (None if p is None else tuple(p)) != (
                None if rows and not any(got) else got):
            raise RuntimeError(f"{kernel} plan mismatch: kernel "
                               f"{tuple(out)}, wrapper {p}")
        line = describe(p, active)
        cache[key] = (p, line)
        logging.getLogger(f"{__name__}.{kernel}").info(line)
    return cache[key][0]


def register_ops() -> None:
    """Register the custom ops of OPS (import their modules); needs no
    nvcc: an op builds its kernel when it first launches on the card."""
    import importlib

    for k in OPS:
        importlib.import_module(f"{__name__}.{k}")


def launch_counts() -> dict:
    import importlib

    return {k: importlib.import_module(f"{__name__}.{k}").launches
            for k in KERNELS}


def reset_launch_counts() -> None:
    """Set every kernel module's counters (`launches` and the per-mode
    `launches_*`) to 0."""
    import importlib

    for k in KERNELS:
        m = importlib.import_module(f"{__name__}.{k}")
        for name in vars(m):
            if name.startswith("launches"):
                setattr(m, name, 0)
