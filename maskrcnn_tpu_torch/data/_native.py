"""ctypes bindings for the C++ host-data library (native/coco_fast.cpp).

Loads ``native/libcoco_fast.so`` if present (``make -C native``); every entry
point has a numpy fallback in ``maskrcnn_tpu_torch.data.coco``, so the native
library is a pure acceleration — same outputs, no hard dependency
(pybind11 is not in this image; ctypes is the binding layer).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None


def _find_lib():
    here = os.path.dirname(os.path.abspath(__file__))
    for cand in (
        os.path.join(here, "..", "..", "native", "libcoco_fast.so"),
        os.environ.get("COCO_FAST_LIB", ""),
    ):
        if cand and os.path.exists(cand):
            return os.path.abspath(cand)
    return None


def load():
    global _LIB
    if _LIB is not None:
        return _LIB
    path = _find_lib()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    i64 = ctypes.c_int64
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

    lib.rle_decode_counts.argtypes = [p_i64, i64, i64, i64, p_u8]
    lib.rle_string_to_counts.argtypes = [
        ctypes.c_char_p, i64, p_i64, i64]
    lib.rle_string_to_counts.restype = i64
    lib.fill_poly.argtypes = [p_f64, i64, i64, i64, p_u8]
    lib.resize_bilinear_f32.argtypes = [p_f32, i64, i64, p_f32, i64, i64]
    lib.crop_resize_mask.argtypes = [
        p_u8, i64, i64, i64, i64, i64, i64, p_f32, i64]
    _LIB = lib
    return lib


def available() -> bool:
    return load() is not None


def rle_decode(rle: dict) -> np.ndarray:
    lib = load()
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        raw = counts.encode("ascii")
        buf = np.zeros(len(raw) + 8, np.int64)
        n = lib.rle_string_to_counts(raw, len(raw), buf, len(buf))
        if n < 0:
            raise ValueError("RLE decode overflow")
        counts_arr = buf[:n]
    else:
        counts_arr = np.ascontiguousarray(counts, np.int64)
    out = np.zeros((h, w), np.uint8)
    lib.rle_decode_counts(counts_arr, len(counts_arr), h, w, out)
    return out


def polygons_to_mask(polys: list, h: int, w: int) -> np.ndarray:
    lib = load()
    out = np.zeros((h, w), np.uint8)
    for p in polys:
        pts = np.ascontiguousarray(
            np.asarray(p, np.float64).reshape(-1, 2)
        )
        if len(pts) >= 3:
            lib.fill_poly(pts, len(pts), h, w, out)
    return out


def crop_resize_mask(mask: np.ndarray, box, s: int) -> np.ndarray:
    lib = load()
    y0, x0, y1, x1 = (int(v) for v in box)
    out = np.zeros((s, s), np.float32)
    m = np.ascontiguousarray(mask, np.uint8)
    lib.crop_resize_mask(m, mask.shape[0], mask.shape[1],
                         y0, x0, y1, x1, out, s)
    return out
