"""The port's native JPEG decode (``madtp_tpu_torch/native``: a decoder in its
own C++ source, no libjpeg) against Pillow and the JAX package's native
decode (``madtp_tpu/native``, built here against libjpeg), on the cases of
``tests/test_native_jpeg.py`` and a few more.

* Mode 1 (``dct_scale=False``) is bit-equal to Pillow's decode, crop and
  ``resize(BICUBIC)`` and to the JAX package's native decode: the photo at
  two sizes and three crops, grayscale, progressive, a small source
  upscaled, 1x1 / 1x8 / 8x1, each chroma subsampling cropped (baseline and
  progressive), an edge crop, restart intervals.
* Mode 2 stays within the JAX test's bound (mean < 8) and keeps its shape.
* Garbage and CMYK raise ``UnsupportedJpeg``; a truncated stream decodes.
* The built library needs no libjpeg (its ELF ``DT_NEEDED`` entries).
* Under ``MADTP_NATIVE_JPEG=1`` the port's transforms (``open_image`` then
  eval, uint8 eval and train) equal the JAX package's under the same
  variable bit for bit, PNG input included, and through the loader; with
  the variable set and no ``g++`` the port raises."""

import io
import random
import struct

import numpy as np
import pytest
from PIL import Image

from madtp_tpu import native as jnative
from madtp_tpu.data import transforms as JT
from madtp_tpu_torch import native
from madtp_tpu_torch.data import transforms as TT
from madtp_tpu_torch.data.image import EncodedJpeg, open_image


def _photo(w=500, h=420, seed=0):
    rng = np.random.RandomState(seed)
    gx = np.linspace(0, 255, w)[None, :] * np.ones((h, 1))
    gy = np.linspace(0, 255, h)[:, None] * np.ones((1, w))
    img = np.stack([gx, gy, (gx + gy) / 2], -1).astype(np.uint8)
    return img + (rng.rand(h, w, 3) * 40).astype(np.uint8)


def _jpeg(arr, **kw):
    b = io.BytesIO()
    Image.fromarray(arr).save(b, "JPEG", **{"quality": 92, **kw})
    return b.getvalue()


def _pil(data, size, box=None):
    im = Image.open(io.BytesIO(data)).convert("RGB")
    if box is not None:
        x, y, w, h = box
        im = im.crop((x, y, x + w, y + h))
    return np.asarray(im.resize((size, size) if isinstance(size, int) else size,
                                Image.BICUBIC), np.uint8)


def _cases():
    rng = np.random.RandomState(0)
    img = _photo()
    photo = _jpeg(img)
    out = [("photo", photo, 384, None), ("photo", photo, 128, None)]
    out += [("photo crop", photo, 64, box) for box in
            [(0, 0, 100, 100), (37, 81, 301, 233), (399, 319, 101, 101)]]
    out.append(("grayscale", _jpeg(img[:, :, 0]), 64, None))
    out.append(("progressive", _jpeg(img, progressive=True), 96, None))
    out.append(("small upscaled", _jpeg(img[:40, :50]), 128, None))
    for shape in [(1, 1, 3), (1, 8, 3), (8, 1, 3)]:
        out.append((f"{shape}", _jpeg((rng.rand(*shape) * 255).astype(np.uint8)), 32, None))
    for ss in (0, 1, 2):
        pix = (rng.rand(100, 150, 3) * 255).astype(np.uint8)
        out.append((f"subsampling {ss}", _jpeg(pix, subsampling=ss), 48, (13, 7, 100, 80)))
        out.append((f"subsampling {ss} progressive",
                    _jpeg(pix, subsampling=ss, progressive=True), 48, (13, 7, 100, 80)))
    out.append(("edge crop", _jpeg((rng.rand(50, 50, 3) * 255).astype(np.uint8)), 32,
                (40, 40, 100, 100)))
    out.append(("restart intervals", _jpeg(img, restart_marker_blocks=3), 96, None))
    out.append(("restart rows, progressive",
                _jpeg(img, restart_marker_rows=1, progressive=True), 96, None))
    return out


CASES = _cases()


@pytest.mark.parametrize("i", range(len(CASES)), ids=[c[0] for c in CASES])
def test_mode1_bit_equal_to_pillow_and_jax(i):
    _, data, size, box = CASES[i]
    got = native.decode_resize(data, size, crop=box, dct_scale=False)
    W, H = Image.open(io.BytesIO(data)).size
    if box is not None:  # PIL's crop of a box past the edge, as the decoder clamps it
        x, y, w, h = box
        box = (x, y, min(w, W - x), min(h, H - y))
    assert np.array_equal(got, _pil(data, size, box))
    if jnative.available():
        assert np.array_equal(got, jnative.decode_resize(data, size, crop=box, dct_scale=False))
    f = native.decode_resize_norm(data, size, crop=box, dct_scale=False)
    want = ((got.astype(np.float32) / 255.0 - TT.MEAN) / TT.STD).transpose(2, 0, 1)
    np.testing.assert_allclose(f, want, atol=1e-6)
    assert native.jpeg_dims(data) == (W, H)


def test_mode2_within_bound():
    data = _jpeg(_photo())
    for size in (224, 100, 64):
        ref = native.decode_resize(data, size, dct_scale=False)
        got = native.decode_resize(data, size, dct_scale=True)
        assert got.shape == ref.shape
        assert np.abs(ref.astype(int) - got.astype(int)).mean() < 8.0
    # a target larger than source / 8 in one dim takes a finer scale
    assert native.decode_resize(data, (480, 64), dct_scale=True).shape == (64, 480, 3)


def test_refusals_and_soft_truncation():
    with pytest.raises(native.UnsupportedJpeg):
        native.decode_resize(b"not a jpeg" * 20, 64)
    c = io.BytesIO()
    Image.fromarray(_photo()).convert("CMYK").save(c, "JPEG", quality=92)
    with pytest.raises(native.UnsupportedJpeg):
        native.decode_resize(c.getvalue(), 64)
    full = _jpeg((np.random.RandomState(0).rand(400, 400, 3) * 255).astype(np.uint8))
    assert native.decode_resize(full[:len(full) // 2], 128).shape == (128, 128, 3)


def _needed(path):
    """The DT_NEEDED entries of a 64-bit little-endian ELF shared library."""
    b = open(path, "rb").read()
    assert b[:4] == b"\x7fELF" and b[4] == 2 and b[5] == 1
    shoff, = struct.unpack_from("<Q", b, 0x28)
    shentsize, shnum = struct.unpack_from("<HH", b, 0x3A)
    sections = [struct.unpack_from("<IIQQQQIIQQ", b, shoff + i * shentsize)
                for i in range(shnum)]
    dyn = next(s for s in sections if s[1] == 6)  # SHT_DYNAMIC
    strtab = sections[dyn[6]]  # its sh_link: the string table
    names = []
    for off in range(dyn[4], dyn[4] + dyn[5], 16):
        tag, val = struct.unpack_from("<qQ", b, off)
        if tag == 1:  # DT_NEEDED
            start = strtab[4] + val
            names.append(b[start:b.index(b"\0", start)].decode())
    return names


def test_library_needs_no_libjpeg():
    native.library()
    needed = _needed(native.target())
    assert needed and not any("jpeg" in n for n in needed), needed


def test_transforms_equal_jax_under_the_variable(tmp_path, monkeypatch):
    p = str(tmp_path / "img.jpg")
    Image.fromarray(_photo()).save(p, "JPEG", quality=92)
    png = str(tmp_path / "x.png")
    Image.fromarray(_photo(64, 64)).save(png)
    monkeypatch.setenv("MADTP_NATIVE_JPEG", "1")
    assert isinstance(open_image(p), EncodedJpeg)
    assert np.array_equal(TT.eval_transform(open_image(p), 384),
                          JT.eval_transform(Image.open(p), 384))
    assert np.array_equal(TT.eval_resize_uint8(open_image(p), 384),
                          JT.eval_resize_uint8(Image.open(p), 384))
    for seed in (7, 11):
        assert np.array_equal(TT.train_transform(open_image(p), 224, random.Random(seed)),
                              JT.train_transform(Image.open(p), 224, random.Random(seed)))
    assert np.array_equal(TT.eval_transform(open_image(png), 32),
                          JT.eval_transform(Image.open(png), 32))
    assert np.array_equal(TT.train_transform(open_image(png), 32, random.Random(3)),
                          JT.train_transform(Image.open(png), 32, random.Random(3)))
    # a JPEG the decoder refuses takes Pillow's decode, that image alone, and
    # then the native resize, as in the JAX package
    c = str(tmp_path / "c.jpg")
    Image.fromarray(_photo()).convert("CMYK").save(c, "JPEG", quality=92)
    assert np.array_equal(TT.eval_transform(open_image(c), 64),
                          JT.eval_transform(Image.open(c), 64))
    monkeypatch.setenv("MADTP_NATIVE_JPEG", "2")
    got2 = TT.eval_transform(open_image(p), 128)
    monkeypatch.delenv("MADTP_NATIVE_JPEG")
    assert np.abs(got2 - TT.eval_transform(open_image(p), 128)).mean() < 0.15


def test_loader_with_the_native_decode(tmp_path, monkeypatch):
    from madtp_tpu_torch.data.loader import batched_loader

    paths = [str(tmp_path / f"i{i}.jpg") for i in range(4)]
    for i, p in enumerate(paths):
        Image.fromarray(_photo(seed=i)).save(p, "JPEG", quality=92)

    class DS:
        def __len__(self):
            return len(paths)

        def __getitem__(self, i):
            return TT.eval_transform(open_image(paths[i]), 64), i

    monkeypatch.delenv("MADTP_NATIVE_JPEG", raising=False)
    ref = list(batched_loader(DS(), 2, num_workers=2))
    monkeypatch.setenv("MADTP_NATIVE_JPEG", "1")
    got = list(batched_loader(DS(), 2, num_workers=2))
    assert len(ref) == len(got) == 2
    for (ra, ri), (ga, gi) in zip(ref, got):  # the same pixels, normalized in C++
        np.testing.assert_allclose(ga, ra, atol=1e-6)
        np.testing.assert_array_equal(gi, ri)


def test_the_variable_without_gxx_raises(tmp_path, monkeypatch):
    from madtp_tpu_torch.kernels import build

    p = str(tmp_path / "img.jpg")
    Image.fromarray(_photo(64, 48)).save(p, "JPEG")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")  # nothing built there
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path / "no_bin"))
    monkeypatch.setenv("MADTP_NATIVE_JPEG", "1")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        TT.eval_transform(open_image(p), 32)
    assert not native.available()
