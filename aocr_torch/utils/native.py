"""ctypes bindings for the native (C++) host kernels in native/ (the
port's own copy of aocr/utils/native.py, so both packages take the same
host path; tests/test_torch_port_trie.py holds the two equal).

Loads the repo's native/libaocr_native.so lazily, at the first call, if
present (build with `make -C native`); every entry point has a numpy
fallback so the framework works without the build step.  `available()`
reports which path is active.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOAD_LOCK = threading.Lock()


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _LOAD_LOCK:
        return _lib_locked()


def _lib_locked() -> Optional[ctypes.CDLL]:
    # under _LOAD_LOCK: decode worker threads racing the first load must
    # block rather than see _TRIED=True with _LIB still None and silently
    # take the numpy fallback for their in-flight images
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for cand in (
        os.environ.get("AOCR_NATIVE_LIB", ""),
        os.path.join(root, "native", "libaocr_native.so"),
    ):
        if cand and os.path.exists(cand):
            try:  # AttributeError: library older than this binding
                lib = ctypes.CDLL(cand)
                lib.aocr_native_abi_version.restype = ctypes.c_int
                if lib.aocr_native_abi_version() != 3:
                    continue  # stale build: rebuild with `make -C native`
                _f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
                _i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
                lib.aocr_luminance_resize.argtypes = [
                    _f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    _f32p, ctypes.c_int, ctypes.c_int,
                ]
                _u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
                lib.aocr_luminance_resize_u8.argtypes = [
                    _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    _f32p, ctypes.c_int, ctypes.c_int,
                ]
                lib.aocr_edit_distance_batch.argtypes = [
                    _i32p, _i32p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, _i32p,
                ]
                _LIB = lib
                break
            except (OSError, AttributeError):
                continue
    _TRIED = True  # set LAST: racing threads block on the lock until done
    return _LIB


def available() -> bool:
    return _lib() is not None


def luminance_resize(
    img: np.ndarray, out_h: int, out_w: int
) -> Optional[np.ndarray]:
    """(h, w[, c]) float32 -> (out_h, out_w) float32 luminance, or None if
    the native library is unavailable (caller falls back to numpy)."""
    lib = _lib()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    out = np.empty((out_h, out_w), np.float32)
    lib.aocr_luminance_resize(img, h, w, c, out, out_h, out_w)
    return out


def luminance_resize_u8(
    raw: bytes, h: int, w: int, c: int, out_h: int, out_w: int
) -> Optional[np.ndarray]:
    """Raw uint8 pixel bytes (h, w, c) -> (out_h, out_w) float32 luminance.
    The whole conversion runs in C with the GIL released."""
    lib = _lib()
    if lib is None:
        return None
    arr = np.frombuffer(raw, np.uint8)
    if arr.size != h * w * c:
        return None
    out = np.empty((out_h, out_w), np.float32)
    lib.aocr_luminance_resize_u8(arr, h, w, c, out, out_h, out_w)
    return out


def edit_distance_batch(
    pred: np.ndarray, gold: np.ndarray, eos: int
) -> Optional[np.ndarray]:
    lib = _lib()
    if lib is None:
        return None
    pred = np.ascontiguousarray(pred, np.int32)
    gold = np.ascontiguousarray(gold, np.int32)
    assert pred.shape == gold.shape
    b, t = pred.shape
    out = np.empty((b,), np.int32)
    lib.aocr_edit_distance_batch(pred, gold, b, t, eos, out)
    return out
