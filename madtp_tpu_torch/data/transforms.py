"""Image preprocessing without PIL (counterpart of
``madtp_tpu/data/transforms.py``): the same functions on uint8 HWC RGB numpy
arrays, each equal bit for bit to the JAX package's Pillow pipeline.

Eval: bicubic resize to (S, S), scale to [0, 1], normalize with CLIP's
statistics, CHW float32.  Train adds RandomResizedCrop(0.5-1.0, bicubic), a
horizontal flip and RandAugment(2, 5) over the reference's 10-op palette.

Pillow's arithmetic is reproduced here:

* :func:`resize_bicubic` is ``Image.resize(BICUBIC)``: separable convolution
  (a = -0.5, support widened when downscaling), per-output normalized
  weights in 22-bit fixed point, the horizontal pass first, each pass
  rounded and clipped to uint8;
* :func:`affine_bicubic` is ``Image.transform(AFFINE, BICUBIC)``: each output
  pixel centre mapped back, Pillow's 4x4 cubic convolution sampled in
  double precision, edges clamped, black outside the source, truncated to
  uint8;
* Brightness and Sharpness are ``Image.blend`` in float32 against a black
  image or the 3x3 SMOOTH filter (border pixels kept); AutoContrast and
  Equalize are ``ImageOps``' per-channel lookup tables.
"""

from __future__ import annotations

import contextlib
import hashlib
import math
import random
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from madtp_tpu_torch.data.image import EncodedJpeg, decode_pixels, native_mode

MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

# ---------------------------------------------------------------------------
# Per-sample deterministic augmentation RNG (``transforms.py:37-125``): a
# stream derived from (seed, epoch, sample index), so augmentation does not
# depend on which loader thread fetched the sample.
# ---------------------------------------------------------------------------

_SAMPLE_TL = threading.local()


@contextlib.contextmanager
def sample_ctx(epoch: int, index: int):
    """Declare the (epoch, sample index) of the ``dataset[i]`` fetches on this
    thread; :class:`PerSampleRng` draws inside derive from it.  Each entry
    starts a fresh stream, even for a repeated (epoch, index)."""
    prev = getattr(_SAMPLE_TL, "ctx", None)
    token = getattr(_SAMPLE_TL, "token", 0) + 1
    _SAMPLE_TL.token = token
    _SAMPLE_TL.ctx = (int(epoch), int(index), token)
    try:
        yield
    finally:
        _SAMPLE_TL.ctx = prev


def fetch_with_ctx(dataset, epoch: int, index: int):
    """``dataset[index]`` inside :func:`sample_ctx`: the one item fetch of
    every loader path."""
    with sample_ctx(epoch, index):
        return dataset[int(index)]


def _derived_rng(seed: int, epoch: int, index: int) -> random.Random:
    # blake2b, not hash(): Python's hash is salted per process
    h = hashlib.blake2b(f"{seed}/{epoch}/{index}".encode(), digest_size=8)
    return random.Random(int.from_bytes(h.digest(), "little"))


class PerSampleRng:
    """The ``random.Random`` surface the train transforms consume.  Inside a
    loader's :func:`sample_ctx` it draws from a stream derived from (seed,
    epoch, sample index), fresh at each context entry and shared by every
    draw of that fetch; outside one, from a plain seeded stream."""

    def __init__(self, seed: int = 0):
        self._seed = int(seed)
        self._fallback = random.Random(seed)

    def _rng(self) -> random.Random:
        ctx = getattr(_SAMPLE_TL, "ctx", None)
        if ctx is None:
            return self._fallback
        epoch, index, token = ctx
        # one live stream per seed within the current context entry
        derived = getattr(_SAMPLE_TL, "derived", None)
        if derived is None or derived[0] != token:
            derived = (token, {})
            _SAMPLE_TL.derived = derived
        rng = derived[1].get(self._seed)
        if rng is None:
            rng = _derived_rng(self._seed, epoch, index)
            derived[1][self._seed] = rng
        return rng

    def random(self):
        return self._rng().random()

    def uniform(self, a, b):
        return self._rng().uniform(a, b)

    def randint(self, a, b):
        return self._rng().randint(a, b)

    def choices(self, population, k=1):
        return self._rng().choices(population, k=k)

    def choice(self, seq):
        return self._rng().choice(seq)


def normalize_chw(img: np.ndarray) -> np.ndarray:
    """uint8 HWC -> (x / 255 - MEAN) / STD as float32 CHW."""
    a = np.asarray(img, np.float32) / 255.0
    a = (a - MEAN) / STD
    return a.transpose(2, 0, 1)


# ---------------------------------------------------------------------------
# Pillow's convolution resize (Resample.c), 8-bit fixed point
# ---------------------------------------------------------------------------

_PRECISION_BITS = 32 - 8 - 2


def _bicubic_weight(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    far = (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per output pixel: the source index of each tap (clamped; the extra
    taps weigh 0) and its fixed-point weight, ``[out_size, ksize]``."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    taps = np.arange(ksize)
    valid = taps[None, :] < xmax[:, None]
    w = _bicubic_weight(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5)
                        * (1.0 / filterscale))
    w = np.where(valid, w, 0.0)
    total = np.zeros(out_size)
    for x in range(ksize):  # Pillow sums the taps in order
        total = total + w[:, x]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], 0.0)
    one = float(1 << _PRECISION_BITS)
    k = np.trunc(np.where(w < 0, w * one - 0.5, w * one + 0.5)).astype(np.int64)
    idx = np.minimum(xmin[:, None] + taps[None, :], in_size - 1)
    return idx, np.where(valid, k, 0)


def _pass(a: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One separable pass along ``axis``; int32 cannot overflow: the weights
    sum to ``1 << 22``, so ``|acc| < 255 * 2^22 + 2^21``."""
    idx, k = _coeffs(a.shape[axis], out_size)
    k = k.astype(np.int32)
    shape = [1] * a.ndim
    shape[axis] = out_size
    acc = np.full((1,) * a.ndim, 1 << (_PRECISION_BITS - 1), np.int32)
    for j in range(k.shape[1]):
        acc = acc + np.take(a, idx[:, j], axis=axis).astype(np.int32) * k[:, j].reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``Image.resize((w, h), BICUBIC)`` of a uint8 HWC image."""
    w, h = size
    out = np.asarray(img, np.uint8)
    if out.shape[1] != w:
        out = _pass(out, 1, w)
    if out.shape[0] != h:
        out = _pass(out, 0, h)
    return np.ascontiguousarray(out)


# ---------------------------------------------------------------------------
# Pillow's affine transform with bicubic sampling (Geometry.c)
# ---------------------------------------------------------------------------


def _horner(p1, p2, p3, p4, d):
    return p1 + d * (p2 + d * (p3 + d * p4))


def _cubic_int(v1, v2, v3, v4, d):
    # the first pass: Pillow's p terms are integer sums of the uint8 taps
    return _horner(v2, v3 - v1, 2 * (v1 - v2) + v3 - v4, v2 - v1 - v3 + v4, d)


def _cubic(v1, v2, v3, v4, d):
    return _horner(v2, -v1 + v3, 2 * (v1 - v2) + v3 - v4, -v1 + v2 - v3 + v4, d)


def affine_bicubic(img: np.ndarray, matrix: Sequence[float]) -> np.ndarray:
    """``Image.transform(size, AFFINE, matrix, BICUBIC)`` at the image's own
    size: output pixel (x, y) samples the source at ``(a x' + b y' + c,
    d x' + e y' + f)`` for the pixel centre (x', y') = (x + 0.5, y + 0.5)."""
    img = np.asarray(img, np.uint8)
    H, W, C = img.shape
    a0, a1, a2, a3, a4, a5 = (float(m) for m in matrix[:6])
    ys = np.arange(H, dtype=np.float64)[:, None] + 0.5
    xs = np.arange(W, dtype=np.float64)[None, :] + 0.5
    xin = np.broadcast_to(a0 * xs + a1 * ys + a2, (H, W))
    yin = np.broadcast_to(a3 * xs + a4 * ys + a5, (H, W))
    inside = (xin >= 0.0) & (xin < W) & (yin >= 0.0) & (yin < H)
    xin = np.where(inside, xin, 0.5) - 0.5
    yin = np.where(inside, yin, 0.5) - 0.5
    x0, y0 = np.floor(xin), np.floor(yin)
    dx, dy = xin - x0, yin - y0
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    # taps that a zero fraction multiplies drop out exactly (p1 + 0 * finite == p1)
    tx = (-1, 0, 1, 2) if dx.any() else (0,)
    ty = (-1, 0, 1, 2) if dy.any() else (0,)
    cols = [np.clip(x0 + i, 0, W - 1) for i in tx]
    rows = [np.clip(y0 + i, 0, H - 1) * W for i in ty]
    out = np.empty(img.shape, np.uint8)
    for c in range(C):
        plane = img[..., c].astype(np.int32).ravel()
        v = []
        for r in rows:
            taps = [plane[r + col] for col in cols]
            v.append(_cubic_int(*taps, dx) if len(taps) == 4 else taps[0].astype(np.float64))
        val = np.clip(_cubic(*v, dy) if len(v) == 4 else v[0], 0.0, 255.0)
        out[..., c] = np.where(inside, val, 0.0).astype(np.uint8)  # truncated
    return out


def rotate_bicubic(img: np.ndarray, angle: float) -> np.ndarray:
    """``Image.rotate(angle, BICUBIC)`` at the angles RandAugment draws
    (-30 to 30 degrees; Pillow transposes at 90, 180 and 270 instead):
    counter-clockwise about the centre, the same size, black outside."""
    angle = angle % 360.0
    if angle == 0:
        return np.array(img, np.uint8)
    H, W = img.shape[:2]
    center = (W / 2, H / 2)
    angle = -math.radians(angle)
    m = [round(math.cos(angle), 15), round(math.sin(angle), 15), 0.0,
         round(-math.sin(angle), 15), round(math.cos(angle), 15), 0.0]
    x, y = -center[0], -center[1]
    m[2], m[5] = m[0] * x + m[1] * y + m[2], m[3] * x + m[4] * y + m[5]
    m[2] += center[0]
    m[5] += center[1]
    return affine_bicubic(img, m)


# ---------------------------------------------------------------------------
# ImageEnhance and ImageOps
# ---------------------------------------------------------------------------


def _blend(im1: np.ndarray, im2: np.ndarray, alpha: float) -> np.ndarray:
    """``Image.blend(im1, im2, alpha)``: float32 arithmetic, truncated
    (clipped first when extrapolating)."""
    alpha = np.float32(alpha)
    a = np.asarray(im1, np.int32)
    v = a.astype(np.float32) + alpha * (np.asarray(im2, np.int32) - a).astype(np.float32)
    if not 0.0 <= alpha <= 1.0:
        v = np.where(v <= 0.0, np.float32(0), np.where(v >= 255.0, np.float32(255), v))
    return np.trunc(v).astype(np.uint8)


def _smooth(img: np.ndarray) -> np.ndarray:
    """``img.filter(ImageFilter.SMOOTH)``: the 3x3 kernel (1 1 1, 1 5 1,
    1 1 1) / 13 in float32, rounded to uint8, the border pixels copied."""
    k = np.array([1, 1, 1, 1, 5, 1, 1, 1, 1], np.float32) / np.float32(13)
    f = np.asarray(img, np.float32)
    out = np.array(img, np.uint8)
    if f.shape[0] < 3 or f.shape[1] < 3:
        return out

    def row(r, kk):  # one kernel row over the interior columns
        return (r[:, :-2] * kk[0] + r[:, 1:-1] * kk[1]) + r[:, 2:] * kk[2]

    ss = np.float32(0.0) + row(f[2:], k[0:3])
    ss = ss + row(f[1:-1], k[3:6])
    ss = ss + row(f[:-2], k[6:9])
    ss = np.where(ss <= 0.0, np.float32(0),
                  np.where(ss >= 255.0, np.float32(255), ss + np.float32(0.5)))
    out[1:-1, 1:-1] = np.trunc(ss).astype(np.uint8)  # rounded, as Pillow's clip8
    return out


def _apply_lut(img: np.ndarray, luts) -> np.ndarray:
    out = np.empty_like(img)
    for c, lut in enumerate(luts):
        out[..., c] = np.clip(np.asarray(lut), 0, 255).astype(np.uint8)[img[..., c]]
    return out


def autocontrast(img: np.ndarray) -> np.ndarray:
    """``ImageOps.autocontrast(img)`` (no cutoff), per channel."""
    luts = []
    for c in range(img.shape[2]):
        h = np.bincount(img[..., c].ravel(), minlength=256)
        nz = np.nonzero(h)[0]
        lo, hi = (int(nz[0]), int(nz[-1])) if len(nz) else (255, 0)
        if hi <= lo:
            luts.append(list(range(256)))
            continue
        scale = 255.0 / (hi - lo)
        offset = -lo * scale
        luts.append([min(max(int(ix * scale + offset), 0), 255) for ix in range(256)])
    return _apply_lut(img, luts)


def equalize(img: np.ndarray) -> np.ndarray:
    """``ImageOps.equalize(img)``, per channel."""
    luts = []
    for c in range(img.shape[2]):
        h = [int(v) for v in np.bincount(img[..., c].ravel(), minlength=256)]
        histo = [v for v in h if v]
        step = (sum(histo) - histo[-1]) // 255 if len(histo) > 1 else 0
        if not step:
            luts.append(list(range(256)))
            continue
        lut, n = [], step // 2
        for i in range(256):
            lut.append(n // step)
            n = n + h[i]
        luts.append(lut)
    return _apply_lut(img, luts)


# ---------------------------------------------------------------------------
# Eval and train transforms
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# The native path (``MADTP_NATIVE_JPEG=1|2``, madtp_tpu_torch/native): a JPEG
# from ``open_image`` (an ``EncodedJpeg``) decoded, cropped and resized in one
# call, bit for bit Pillow's decode and resize at 1 (2 adds the M/8
# reduced-scale decode); a decoded array resized by the same library.  A
# JPEG its decoder refuses is decoded by Pillow and goes the array's way.
# ---------------------------------------------------------------------------


def _native(img, size: int, crop=None, norm: bool = False) -> Optional[np.ndarray]:
    """The native path's result, or None when it is off."""
    mode = native_mode()
    if not mode:
        return None
    from madtp_tpu_torch import native

    if isinstance(img, EncodedJpeg):
        try:
            fn = native.decode_resize_norm if norm else native.decode_resize
            return fn(img.data, size, crop=crop, dct_scale=mode == 2)
        except native.UnsupportedJpeg:
            img = decode_pixels(img)
    return (native.resize_norm if norm else native.resize)(img, size, crop=crop)


def _size(img) -> Tuple[int, int]:
    """``(width, height)`` of an array or an ``EncodedJpeg``."""
    if isinstance(img, EncodedJpeg):
        return img.width, img.height
    return img.shape[1], img.shape[0]


def eval_resize_uint8(img, image_size: int) -> np.ndarray:
    """Bicubic resize only, uint8 HWC (the ``--uint8_feed`` host side; the
    model normalizes on the device)."""
    out = _native(img, image_size)
    if out is not None:
        return out
    return resize_bicubic(decode_pixels(img), (image_size, image_size))


def eval_transform(img, image_size: int) -> np.ndarray:
    out = _native(img, image_size, norm=True)
    if out is not None:
        return out
    return normalize_chw(eval_resize_uint8(img, image_size))


def _random_crop_box(W: int, H: int, rng: random.Random, scale,
                     ratio=(3 / 4, 4 / 3)) -> Optional[Tuple[int, int, int, int]]:
    """RandomResizedCrop's box draw (the same rng consumption as the JAX
    package's)."""
    area = W * H
    for _ in range(10):
        target = rng.uniform(*scale) * area
        log_r = (np.log(ratio[0]), np.log(ratio[1]))
        ar = np.exp(rng.uniform(*log_r))
        w = int(round((target * ar) ** 0.5))
        h = int(round((target / ar) ** 0.5))
        if 0 < w <= W and 0 < h <= H:
            x = rng.randint(0, W - w)
            y = rng.randint(0, H - h)
            return x, y, w, h
    return None


def _crop_resize(img, box, size: int) -> np.ndarray:
    out = _native(img, size, crop=box)
    if out is not None:
        return out
    img = decode_pixels(img)
    if box is not None:
        x, y, w, h = box
        img = img[y:y + h, x:x + w]
    return resize_bicubic(img, (size, size))


def random_resized_crop(img, size: int, rng: random.Random,
                        scale=(0.5, 1.0), ratio=(3 / 4, 4 / 3)) -> np.ndarray:
    box = _random_crop_box(*_size(img), rng, scale, ratio)
    return _crop_resize(img, box, size)


def _shear_x(img, v):
    return affine_bicubic(img, (1, v, 0, 0, 1, 0))


def _shear_y(img, v):
    return affine_bicubic(img, (1, 0, 0, v, 1, 0))


def _translate_x(img, v):
    return affine_bicubic(img, (1, 0, v * img.shape[1], 0, 1, 0))


def _translate_y(img, v):
    return affine_bicubic(img, (1, 0, 0, 0, 1, v * img.shape[0]))


_OPS = {
    "Identity": (lambda img, v: img, 0.0, 0.0),
    "AutoContrast": (lambda img, v: autocontrast(img), 0.0, 0.0),
    "Equalize": (lambda img, v: equalize(img), 0.0, 0.0),
    "Brightness": (lambda img, v: _blend(np.zeros_like(img), img, 1 + v), -0.9, 0.9),
    "Sharpness": (lambda img, v: _blend(_smooth(img), img, 1 + v), -0.9, 0.9),
    "ShearX": (_shear_x, -0.3, 0.3),
    "ShearY": (_shear_y, -0.3, 0.3),
    "TranslateX": (_translate_x, -0.3, 0.3),
    "TranslateY": (_translate_y, -0.3, 0.3),
    "Rotate": (rotate_bicubic, -30, 30),
}

DEFAULT_AUGS = ["Identity", "AutoContrast", "Brightness", "Sharpness",
                "Equalize", "ShearX", "ShearY", "TranslateX", "TranslateY",
                "Rotate"]


def rand_augment(img: np.ndarray, n: int, m: int, rng: random.Random,
                 augs: Sequence[str] = tuple(DEFAULT_AUGS)) -> np.ndarray:
    """Apply ``n`` random ops at magnitude ``m`` (0-10 scale)."""
    for name in rng.choices(list(augs), k=n):
        fn, lo, hi = _OPS[name]
        v = lo + (hi - lo) * (m / 10.0) * rng.random()
        img = fn(img, v)
    return img


def _train_augmented(img, image_size: int, rng: random.Random,
                     min_scale: float) -> np.ndarray:
    """RandomResizedCrop -> flip -> RandAugment(2, 5); the crop box is drawn
    before anything else, as in the JAX package."""
    box = _random_crop_box(*_size(img), rng, (min_scale, 1.0))
    cropped = _crop_resize(img, box, image_size)
    if rng.random() < 0.5:
        cropped = np.ascontiguousarray(cropped[:, ::-1])
    return rand_augment(cropped, 2, 5, rng)


def train_transform(img: np.ndarray, image_size: int, rng: random.Random,
                    min_scale: float = 0.5) -> np.ndarray:
    return normalize_chw(_train_augmented(img, image_size, rng, min_scale))


def train_transform_uint8(img: np.ndarray, image_size: int, rng: random.Random,
                          min_scale: float = 0.5) -> np.ndarray:
    """The augmented uint8 HWC image (the same rng stream as
    :func:`train_transform`), normalized on the device (``--uint8_feed``)."""
    return np.ascontiguousarray(_train_augmented(img, image_size, rng, min_scale), np.uint8)
