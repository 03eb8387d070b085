"""Native (C++) host-pipeline components (counterpart of
``madtp_tpu/native/__init__.py``).

``jpeg_decode.cpp`` fuses JPEG decode -> crop -> Pillow-bicubic resize ->
normalize into one GIL-free call.  Its JPEG decoder is the file's own (no
libjpeg is linked): baseline and progressive Huffman streams, grayscale and
YCbCr at any integer sampling, restart intervals, with libjpeg's integer
IDCT, fancy chroma upsampling and fixed-point colour conversion, so that
the full-scale decode equals Pillow's (libjpeg-turbo's defaults) bit for bit.

The library is built with ``g++`` at first use into ``build/`` at the
repository root (beside the kernels, under a name carrying a hash of the
source and flags) and loaded with ``ctypes``; nothing is built at import.
:func:`library` raises when the build fails; :func:`available` says whether
it builds.  The transforms use it only under ``MADTP_NATIVE_JPEG=1`` (or
``2``: the M/8 reduced-scale decode, within a few uint8 steps of the full
one); the default stays the numpy and Pillow path.

API (the JAX package's):
    available() -> bool
    jpeg_dims(data) -> (w, h)
    decode_resize(data, size, crop=None, dct_scale=True) -> uint8 HWC
    decode_resize_norm(data, size, crop=None, dct_scale=True) -> fp32 CHW
    resize(arr, size, crop=None) -> uint8 HWC
    resize_norm(arr, size, crop=None) -> fp32 CHW
    UnsupportedJpeg: a stream the decoder does not read (CMYK or YCCK,
        lossless or arithmetic coding, corrupt); the caller decodes that
        image another way
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "jpeg_decode.cpp"
# -march=native: the library runs where it is built, and the loops vectorize
# (the JAX package builds its decoder so too, so the normalized floats
# round alike: both contract x * scale + bias into one FMA)
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-shared"]
_lock = threading.Lock()
_lib = None


def _stats():
    from madtp_tpu_torch.data.transforms import MEAN, STD

    return (np.ascontiguousarray(MEAN, np.float32), np.ascontiguousarray(STD, np.float32))


def compiler() -> str:
    """The C++ compiler: ``g++`` on the ``PATH``."""
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the native JPEG decode (MADTP_NATIVE_JPEG) is "
                           "built with it")
    return found


def target() -> Path:
    """Where the library of this source and these flags is built."""
    from madtp_tpu_torch.kernels.build import BUILD_DIR

    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libjpeg_decode-{h.hexdigest()[:16]}.so"


def _build_and_load() -> ctypes.CDLL:
    so = target()
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)  # atomic against a concurrent build
    lib = ctypes.CDLL(str(so))
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.madtp_jpeg_dims.restype = i32
    lib.madtp_jpeg_dims.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                    ctypes.POINTER(i32), ctypes.POINTER(i32)]
    lib.madtp_decode_resize.restype = i32
    lib.madtp_decode_resize.argtypes = [ctypes.c_char_p, ctypes.c_size_t, i32, i32, i32, i32,
                                        i32, i32, i32, i32, p, p, p, p]
    lib.madtp_resize_norm.restype = i32
    lib.madtp_resize_norm.argtypes = [p, i32, i32, i32, i32, i32, i32, i32, i32, i32,
                                      p, p, p, p]
    return lib


def library() -> ctypes.CDLL:
    """The loaded library, built at the first call; raises when it cannot
    be built or loaded."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = _build_and_load()
    return _lib


def available() -> bool:
    """Whether the library builds and loads here (built at the first call)."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


class UnsupportedJpeg(Exception):
    """A stream the decoder does not read (CMYK / YCCK, another coding, or
    corrupt): decode the image another way."""


def jpeg_dims(data: bytes) -> Tuple[int, int]:
    w, h = ctypes.c_int(), ctypes.c_int()
    if library().madtp_jpeg_dims(data, len(data), ctypes.byref(w), ctypes.byref(h)):
        raise UnsupportedJpeg("no JPEG frame header")
    return w.value, h.value


def _out(size, fuse: bool):
    out_w, out_h = (size, size) if isinstance(size, int) else size
    if fuse:
        out = np.empty((3, out_h, out_w), np.float32)
        return out, out_w, out_h, None, out.ctypes.data_as(ctypes.c_void_p)
    out = np.empty((out_h, out_w, 3), np.uint8)
    return out, out_w, out_h, out.ctypes.data_as(ctypes.c_void_p), None


def _call(data: bytes, size, crop, dct_scale: bool, fuse: bool) -> np.ndarray:
    lib = library()
    out, out_w, out_h, u8, f32 = _out(size, fuse)
    cx, cy, cw, ch = crop if crop is not None else (0, 0, -1, -1)
    mean, std = _stats()
    rc = lib.madtp_decode_resize(data, len(data), cx, cy, cw, ch, out_w, out_h,
                                 int(dct_scale), int(fuse),
                                 mean.ctypes.data_as(ctypes.c_void_p),
                                 std.ctypes.data_as(ctypes.c_void_p), u8, f32)
    if rc:
        raise UnsupportedJpeg(f"native decode rc={rc}")
    return out


def decode_resize(data: bytes, size, crop: Optional[tuple] = None,
                  dct_scale: bool = True) -> np.ndarray:
    """JPEG bytes -> uint8 HWC RGB at ``size`` (an int or ``(w, h)``);
    ``crop=(x, y, w, h)`` in full-resolution pixel coordinates."""
    return _call(data, size, crop, dct_scale, fuse=False)


def decode_resize_norm(data: bytes, size, crop: Optional[tuple] = None,
                       dct_scale: bool = True) -> np.ndarray:
    """JPEG bytes -> normalized float32 CHW (the eval transform's layout)."""
    return _call(data, size, crop, dct_scale, fuse=True)


def _resize_call(arr: np.ndarray, size, crop, fuse: bool) -> np.ndarray:
    lib = library()
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w = arr.shape[:2]
    out, out_w, out_h, u8, f32 = _out(size, fuse)
    cx, cy, cw, ch = crop if crop is not None else (0, 0, -1, -1)
    mean, std = _stats()
    rc = lib.madtp_resize_norm(arr.ctypes.data_as(ctypes.c_void_p), w, h, cx, cy, cw, ch,
                               out_w, out_h, int(fuse), mean.ctypes.data_as(ctypes.c_void_p),
                               std.ctypes.data_as(ctypes.c_void_p), u8, f32)
    if rc:
        raise UnsupportedJpeg(f"native resize rc={rc}")
    return out


def resize(arr: np.ndarray, size, crop: Optional[tuple] = None) -> np.ndarray:
    """uint8 HWC RGB -> uint8 HWC at ``size`` (Pillow-bicubic; an optional
    crop in source pixel coordinates), for images already decoded."""
    return _resize_call(arr, size, crop, fuse=False)


def resize_norm(arr: np.ndarray, size, crop: Optional[tuple] = None) -> np.ndarray:
    """uint8 HWC RGB -> normalized float32 CHW (the eval transform's layout)."""
    return _resize_call(arr, size, crop, fuse=True)
