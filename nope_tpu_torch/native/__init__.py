"""ctypes bindings for the native data plane (``nope_tpu/native``), with
fallbacks.

The host-side preprocessing hot path (RGBA compositing, the perspective
warp and the fused batch preprocess) in C++ (``warp.cpp``), built with
g++ at first use (:mod:`nope_tpu_torch.native.build`) and loaded
lazily.  Where the library cannot be built every entry point falls back:
compositing and the batch preprocess to numpy, the warp to
:func:`nope_tpu_torch.geometry.cropping.warp_perspective_torch` on CPU
tensors.  :func:`available` says which one runs.
"""

from __future__ import annotations

import ctypes
import logging
import subprocess
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    from nope_tpu_torch.native.build import build

    try:
        so_path = build()
    except (OSError, subprocess.CalledProcessError) as e:  # no compiler, or it failed: fall back
        logging.info("native library unavailable (%s); using the fallbacks", getattr(e, "stderr", None) or e)
        return None
    lib = ctypes.CDLL(str(so_path))
    i64, f32p, f64p, u8p = (
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
    )
    lib.warp_perspective_f32.argtypes = [f32p, i64, i64, i64, f64p, f32p, i64]
    lib.warp_perspective_u8.argtypes = [u8p, i64, i64, i64, f64p, u8p, i64]
    lib.composite_rgba_black.argtypes = [u8p, i64, i64, u8p]
    lib.preprocess_batch.argtypes = [u8p, i64, i64, i64, f64p, f32p, i64, i64]
    for fn in (lib.warp_perspective_f32, lib.warp_perspective_u8, lib.composite_rgba_black,
               lib.preprocess_batch):
        fn.restype = None
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def warp_perspective(img: np.ndarray, M: np.ndarray, out_size: int) -> np.ndarray:
    """cv2.warpPerspective-semantics warp (native when available)."""
    lib = _load()
    M = np.ascontiguousarray(M, dtype=np.float64)
    if lib is None:
        import torch

        from nope_tpu_torch.geometry.cropping import warp_perspective_torch

        out = warp_perspective_torch(torch.from_numpy(np.asarray(img, np.float32)), torch.from_numpy(M),
                                     out_size).numpy()
        if img.dtype == np.uint8:
            out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
        return out
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    H, W, C = img.shape
    if img.dtype == np.uint8:
        dst = np.empty((out_size, out_size, C), np.uint8)
        lib.warp_perspective_u8(np.ascontiguousarray(img), H, W, C, M, dst, out_size)
    else:
        src = np.ascontiguousarray(img, dtype=np.float32)
        dst = np.empty((out_size, out_size, C), np.float32)
        lib.warp_perspective_f32(src, H, W, C, M, dst, out_size)
    return dst[..., 0] if squeeze else dst


def composite_rgba_black(rgba: np.ndarray) -> np.ndarray:
    """(H, W, 4) uint8 → (H, W, 3) uint8 over black."""
    lib = _load()
    rgba = np.ascontiguousarray(rgba, dtype=np.uint8)
    h, w = rgba.shape[:2]
    if lib is None:
        alpha = rgba[..., 3:4].astype(np.uint16)
        return ((rgba[..., :3].astype(np.uint16) * alpha + 127) // 255).astype(np.uint8)
    rgb = np.empty((h, w, 3), np.uint8)
    lib.composite_rgba_black(rgba, h, w, rgb)
    return rgb


def preprocess_batch(
    rgba: np.ndarray, homographies: np.ndarray, out_size: int,
    num_threads: int = 0,
) -> np.ndarray:
    """Fused composite+warp+normalize for a whole batch:
    (B, H, W, 4) u8 + (B, 3, 3) f64 → (B, S, S, 3) f32 in [-1, 1]."""
    lib = _load()
    rgba = np.ascontiguousarray(rgba, dtype=np.uint8)
    Ms = np.ascontiguousarray(homographies, dtype=np.float64)
    b, h, w = rgba.shape[:3]
    out = np.empty((b, out_size, out_size, 3), np.float32)
    if lib is None:
        for i in range(b):
            rgb = composite_rgba_black(rgba[i]).astype(np.float32)
            out[i] = warp_perspective(rgb, Ms[i], out_size) * (2.0 / 255.0) - 1.0
        return out
    lib.preprocess_batch(rgba, b, h, w, Ms, out, out_size, num_threads)
    return out
