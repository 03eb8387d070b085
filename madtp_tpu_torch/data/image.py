"""Image files as uint8 HWC RGB arrays (the counterpart of
``madtp_tpu/data/datasets.py:47-52`` ``_open_image`` followed by the
transforms' ``convert("RGB")``).

PNG is decoded here with ``zlib`` and numpy: 8-bit grey, grey with alpha,
RGB and RGBA, not interlaced, all five row filters.  Alpha is dropped and
grey is repeated into three channels, as Pillow's ``convert("RGB")`` does.
Any other file goes through Pillow, imported at the call; without Pillow it
raises an ``ImportError`` that names it.

Under ``MADTP_NATIVE_JPEG=1`` or ``2`` a JPEG file is not decoded here: it
comes back as an :class:`EncodedJpeg` (its bytes and size), which the
transforms decode, crop and resize in one call of the port's own decoder
(:mod:`madtp_tpu_torch.native`, built at the first use; a failed build
raises).  A JPEG that decoder does not read (CMYK, say) is decoded by
Pillow, that image alone (:func:`decode_pixels`)."""

from __future__ import annotations

import io
import os
import struct
import zlib
from typing import NamedTuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> samples per pixel


def _paeth_row(raw: bytes, prior: bytearray, bpp: int) -> bytearray:
    out = bytearray(raw)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out


def _average_row(raw: bytes, prior: bytearray, bpp: int) -> bytearray:
    out = bytearray(raw)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + prior[i]) >> 1)) & 0xFF
    return out


def _unfilter(data: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    rows = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        start = y * (stride + 1)
        ftype = data[start]
        raw = np.frombuffer(data, np.uint8, stride, start + 1)
        if ftype == 0:
            row = raw
        elif ftype == 1:
            row = np.cumsum(raw.reshape(-1, bpp), axis=0, dtype=np.uint8).ravel()
        elif ftype == 2:
            row = raw + prior
        elif ftype == 3:
            row = np.frombuffer(_average_row(raw.tobytes(), bytearray(prior.tobytes()), bpp),
                                np.uint8)
        elif ftype == 4:
            row = np.frombuffer(_paeth_row(raw.tobytes(), bytearray(prior.tobytes()), bpp),
                                np.uint8)
        else:
            raise ValueError(f"PNG row {y} has filter type {ftype}")
        rows[y] = row
        prior = rows[y]
    return rows


def decode_png(blob: bytes) -> np.ndarray:
    """uint8 HWC RGB pixels of a PNG file's bytes."""
    if not blob.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    pos, header, idat = len(PNG_SIGNATURE), None, []
    while pos + 8 <= len(blob):
        length, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        body = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"PNG with bit depth {depth}, colour type {ctype}, interlace "
                         f"{interlace}: only 8-bit grey, grey+alpha, RGB and RGBA, not "
                         "interlaced, are decoded")
    bpp = _CHANNELS[ctype]
    data = zlib.decompress(b"".join(idat))
    if len(data) != height * (width * bpp + 1):
        raise ValueError("PNG image data has the wrong length")
    px = _unfilter(data, height, width * bpp, bpp).reshape(height, width, bpp)
    rgb = px[..., :3] if bpp >= 3 else np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(rgb)


class EncodedJpeg(NamedTuple):
    """A JPEG file left encoded for the native decode: its bytes, width and
    height."""

    data: bytes
    width: int
    height: int


def native_mode() -> int:
    """``MADTP_NATIVE_JPEG``: 1 (the native decode, bit-equal to Pillow's), 2
    (also the M/8 reduced-scale decode) or 0 (off, the default)."""
    return {"1": 1, "2": 2}.get(os.environ.get("MADTP_NATIVE_JPEG", ""), 0)


def _pillow(blob: bytes, name: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{name} is not a PNG file; decoding it needs PIL (Pillow), "
                          "which is not installed") from e
    with Image.open(io.BytesIO(blob)) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def decode_pixels(img) -> np.ndarray:
    """uint8 HWC RGB pixels of an array (as it is) or an :class:`EncodedJpeg`
    (decoded by Pillow)."""
    if isinstance(img, EncodedJpeg):
        return _pillow(img.data, "a JPEG stream")
    return img


def open_image(path: str):
    """The file's pixels as uint8 HWC RGB: PNG by the port's decoder, any
    other format by Pillow; under ``MADTP_NATIVE_JPEG`` a JPEG file as an
    :class:`EncodedJpeg` for the transforms' native decode."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob.startswith(PNG_SIGNATURE):
        return decode_png(blob)
    if blob.startswith(b"\xff\xd8") and native_mode():
        from madtp_tpu_torch import native

        try:
            return EncodedJpeg(blob, *native.jpeg_dims(blob))
        except native.UnsupportedJpeg:
            pass
    return _pillow(blob, path)
