"""The port's data layer (``madtp_tpu_torch/data``) against the JAX package's
(``madtp_tpu/data``), on the CPU: text preprocessing and the result file, the
per-sample augmentation streams, Pillow's bicubic resize and the ten
RandAugment ops reproduced without PIL (bit-equal), the train and eval
transforms, the PNG decoder against Pillow on every row filter and colour
type, every dataset on ``tools/make_fixture.py``'s fixture (its JPEGs
through Pillow on both sides) and the threaded loader's batches."""

import json
import os
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

import madtp_tpu.data.datasets as jds
import madtp_tpu.data.loader as jloader
import madtp_tpu.data.text_utils as jtext
import madtp_tpu.data.transforms as jtf
import madtp_tpu_torch.data.datasets as tds
import madtp_tpu_torch.data.loader as tloader
import madtp_tpu_torch.data.text_utils as ttext
import madtp_tpu_torch.data.transforms as ttf
from madtp_tpu_torch.data.image import decode_png, open_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _images(seed):
    """Seeded noise and a smooth gradient, at two sizes."""
    rng = np.random.RandomState(seed)
    out = []
    for h, w in ((64, 64), (45, 71)):
        out.append((rng.rand(h, w, 3) * 255).astype(np.uint8))
        y, x = np.mgrid[0:h, 0:w]
        out.append(np.stack([x * 255 // (w - 1), y * 255 // (h - 1),
                             (x + 2 * y) % 256], -1).astype(np.uint8))
    return out


# ---------------------------------------------------------------------------
# text
# ---------------------------------------------------------------------------

TEXTS = ["A dog; on the (left)!", "  two   cats\n", "What*is#this: a ~test~?",
         "word " * 60, "Where's the \"red\" ball.", ""]


def test_pre_caption_and_pre_question():
    for t in TEXTS:
        for n in (3, 30, 50):
            assert ttext.pre_caption(t, n) == jtext.pre_caption(t, n)
            assert ttext.pre_question(t, n) == jtext.pre_question(t, n)


def test_save_result(tmp_path):
    result = [{"image_id": i % 3, "caption": f"c{i}"} for i in range(7)]
    for dedup in ("", "image_id"):
        want = jtext.save_result(result, str(tmp_path / "j"), "res", dedup)
        got = ttext.save_result(result, str(tmp_path / "t"), "res", dedup)
        assert os.path.basename(got) == os.path.basename(want)
        for name in ("res.json", "res_rank0.json"):
            with open(tmp_path / "j" / name) as f, open(tmp_path / "t" / name) as g:
                assert json.load(g) == json.load(f)


# ---------------------------------------------------------------------------
# augmentation streams
# ---------------------------------------------------------------------------


def _draws(rng):
    return [rng.random(), rng.uniform(0.5, 1.0), rng.randint(0, 99),
            rng.choices(list("abcdefghij"), k=2), rng.choice([3, 5, 7])]


def test_per_sample_rng_streams():
    for epoch, index in ((0, 0), (0, 5), (3, 5), (7, 123)):
        j, j2 = jtf.PerSampleRng(42), jtf.PerSampleRng(7)
        t, t2 = ttf.PerSampleRng(42), ttf.PerSampleRng(7)
        with jtf.sample_ctx(epoch, index):
            want = [_draws(j), _draws(j2), _draws(j)]  # two streams alternating
        with ttf.sample_ctx(epoch, index):
            got = [_draws(t), _draws(t2), _draws(t)]
        assert got == want
    # outside a context: the plain seeded stream
    assert _draws(ttf.PerSampleRng(3)) == _draws(jtf.PerSampleRng(3))


# ---------------------------------------------------------------------------
# Pillow's arithmetic without PIL
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,size", [((96, 96), 384), ((480, 640), 480), ((375, 500), 384)])
def test_resize_bicubic_bit_equal(shape, size):
    img = (np.random.RandomState(sum(shape)).rand(*shape, 3) * 255).astype(np.uint8)
    want = np.asarray(Image.fromarray(img).resize((size, size), Image.BICUBIC))
    np.testing.assert_array_equal(ttf.resize_bicubic(img, (size, size)), want)


@pytest.mark.parametrize("magnitude", [0, 5, 10])
@pytest.mark.parametrize("op", jtf.DEFAULT_AUGS)
def test_rand_augment_op_bit_equal(op, magnitude):
    fn, lo, hi = jtf._OPS[op]
    port_fn = ttf._OPS[op][0]
    assert ttf._OPS[op][1:] == (lo, hi)
    for i, img in enumerate(_images(len(op) + magnitude)):
        for r in (0.0, 0.31, 0.77, 1.0):
            v = lo + (hi - lo) * (magnitude / 10.0) * r
            want = np.asarray(fn(Image.fromarray(img), v))
            got = port_fn(img, v)
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, want, err_msg=f"{op} v={v} image {i}")


def _png_file(path, img):
    Image.fromarray(img).save(path)
    return path


@pytest.fixture(scope="module")
def photo(tmp_path_factory):
    """A 70 x 90 gradient-and-noise image as a PNG file."""
    rng = np.random.RandomState(11)
    y, x = np.mgrid[0:70, 0:90]
    img = np.stack([x * 2, y * 3, x + y], -1) + rng.randint(0, 40, size=(70, 90, 3))
    return _png_file(tmp_path_factory.mktemp("img") / "photo.png",
                     np.clip(img, 0, 255).astype(np.uint8))


def test_train_transforms_bit_equal(photo):
    arr = open_image(str(photo))
    pairs = [(e, i) for e in range(4) for i in (0, 1, 7, 30, 999)]
    assert len(pairs) == 20
    for name in ("train_transform", "train_transform_uint8"):
        jfn, tfn = getattr(jtf, name), getattr(ttf, name)
        jr, tr = jtf.PerSampleRng(42), ttf.PerSampleRng(42)
        for epoch, index in pairs:
            with jtf.sample_ctx(epoch, index):
                want = jfn(Image.open(photo), 48, jr)
            with ttf.sample_ctx(epoch, index):
                got = tfn(arr, 48, tr)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {epoch} {index}")


def test_eval_transforms_bit_equal(photo):
    arr = open_image(str(photo))
    for size in (32, 96, 384):
        np.testing.assert_array_equal(ttf.eval_resize_uint8(arr, size),
                                      jtf.eval_resize_uint8(Image.open(photo), size))
        want = jtf.eval_transform(Image.open(photo), size)
        got = ttf.eval_transform(arr, size)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _encode_png(px, ctype, filters):
    """An 8-bit PNG of ``px`` [H, W, C] with row ``y`` filtered by
    ``filters[y % len(filters)]``."""
    H, W, C = px.shape
    stride, raw, prior = W * C, bytearray(), [0] * (W * C)
    for y in range(H):
        row = [int(v) for v in px[y].reshape(-1)]
        f = filters[y % len(filters)]
        out = []
        for i, v in enumerate(row):
            a = row[i - C] if i >= C else 0
            b = prior[i]
            c = prior[i - C] if i >= C else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[f]
            out.append((v - pred) & 0xFF)
        raw.append(f)
        raw += bytes(out)
        prior = row

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype,channels,filters", [
    (2, 3, (0,)), (2, 3, (1,)), (2, 3, (2,)), (2, 3, (3,)), (2, 3, (4,)),
    (6, 4, (0, 1, 2, 3, 4)), (0, 1, (4, 3, 2, 1, 0)), (4, 2, (3, 4, 1))])
def test_png_decoder_against_pillow(tmp_path, ctype, channels, filters):
    rng = np.random.RandomState(ctype * 10 + filters[0])
    y, x = np.mgrid[0:19, 0:23]
    px = (np.stack([x * 9 + y * c for c in range(channels)], -1)
          + rng.randint(0, 60, size=(19, 23, channels))) % 256
    path = tmp_path / "x.png"
    path.write_bytes(_encode_png(px.astype(np.uint8), ctype, filters))
    want = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(open_image(str(path)), want)
    np.testing.assert_array_equal(decode_png(path.read_bytes()), want)


def test_pillow_written_png_and_jpeg(tmp_path):
    img = _images(3)[1]
    for ext in ("png", "jpg"):
        path = tmp_path / f"a.{ext}"
        Image.fromarray(img).save(path)
        np.testing.assert_array_equal(open_image(str(path)),
                                      np.asarray(Image.open(path).convert("RGB")))


def test_jpeg_without_pillow_names_it(tmp_path, monkeypatch):
    jpg, png = tmp_path / "a.jpg", tmp_path / "a.png"
    Image.fromarray(_images(4)[0]).save(jpg)
    Image.fromarray(_images(4)[0]).save(png)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        open_image(str(jpg))
    assert open_image(str(png)).shape == (64, 64, 3)


# ---------------------------------------------------------------------------
# datasets and loader on the fixture
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import make_fixture

    root = str(tmp_path_factory.mktemp("fixture"))
    make_fixture.make(root)
    nocaps = [{"image": f"coco_{i:04d}.jpg", "img_id": 100 + i} for i in range(3)]
    for split in ("nocaps_val.json", "nocaps_test.json"):
        with open(os.path.join(root, "annotation", split), "w") as f:
            json.dump(nocaps, f)
    return root


def _eq(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    else:
        assert a == b and type(a) is type(b)


def _pair(kind, root):
    """(JAX dataset, port dataset) of ``kind`` on the fixture."""
    img, ann = os.path.join(root, "images"), os.path.join(root, "annotation")
    jr, tr = jtf.PerSampleRng(42), ttf.PerSampleRng(42)
    jtrain = lambda im: jtf.train_transform(im, 32, jr)  # noqa: E731
    ttrain = lambda im: ttf.train_transform(im, 32, tr)  # noqa: E731
    jeval = lambda im: jtf.eval_resize_uint8(im, 32)  # noqa: E731
    teval = lambda im: ttf.eval_resize_uint8(im, 32)  # noqa: E731
    return {
        "nlvr_train": lambda m, tf: m.NLVRDataset(tf, img, ann, "train"),
        "nlvr_val": lambda m, tf: m.NLVRDataset(tf, img, ann, "val"),
        "caption_train": lambda m, tf: m.CaptionTrainDataset(tf, img, ann, prompt="a picture of "),
        "caption_eval": lambda m, tf: m.CaptionEvalDataset(tf, img, ann, "test"),
        "retrieval_eval": lambda m, tf: m.RetrievalEvalDataset(tf, img, ann, "val",
                                                               dataset="flickr"),
        "vqa_train": lambda m, tf: m.VQADataset(tf, ann, img, split="train"),
        "vqa_test": lambda m, tf: m.VQADataset(tf, ann, img, split="test"),
        "nocaps": lambda m, tf: m.NoCapsEvalDataset(tf, img, ann, "val"),
    }[kind], (jtrain, ttrain) if kind.endswith("train") else (jeval, teval)


@pytest.mark.parametrize("kind", ["nlvr_train", "nlvr_val", "caption_train", "caption_eval",
                                  "retrieval_eval", "vqa_train", "vqa_test", "nocaps"])
def test_dataset_items_match_jax(fixture_root, kind):
    make, (jtf_, ttf_) = _pair(kind, fixture_root)
    j, t = make(jds, jtf_), make(tds, ttf_)
    assert len(t) == len(j)
    for attr in ("text", "image", "txt2img", "img2txt", "img_ids", "answer_list"):
        if hasattr(j, attr):
            assert getattr(t, attr) == getattr(j, attr)
    for i in range(len(j)):
        with jtf.sample_ctx(1, i):
            want = j[i]
        with ttf.sample_ctx(1, i):
            got = t[i]
        _eq(got, want)
    if kind == "vqa_train":
        items = [(t[i], j[i]) for i in range(3)]
        _eq(tds.vqa_collate([a for a, _ in items]), jds.vqa_collate([b for _, b in items]))


@pytest.mark.parametrize("n,bs,shards,drop", [(10, 3, 1, False), (10, 3, 2, True),
                                              (7, 4, 3, False), (16, 8, 1, True)])
def test_schedule_matches_jax(n, bs, shards, drop):
    for shard in range(shards):
        for shuffle in (False, True):
            kw = dict(shuffle=shuffle, seed=42, epoch=3, num_shards=shards, shard_id=shard,
                      drop_last=drop)
            np.testing.assert_array_equal(tloader.shard_indices(n, **kw),
                                          jloader.shard_indices(n, **kw))
    assert tloader.num_batches(n, bs, num_shards=shards, drop_last=drop) == \
        jloader.num_batches(n, bs, num_shards=shards, drop_last=drop)


def test_batched_loader_matches_jax_with_any_thread_count(fixture_root):
    make, (jtf_, ttf_) = _pair("caption_train", fixture_root)
    j, t = make(jds, jtf_), make(tds, ttf_)
    kw = dict(shuffle=True, epoch=2)
    want = list(jloader.batched_loader(j, 3, num_workers=0, **kw))
    for workers in (0, 1, 3, 8):
        got = list(tloader.batched_loader(t, 3, num_workers=workers, **kw))
        _eq(got, want)
    # a slice of the schedule, without fetching the batches before it
    _eq(list(tloader.batched_loader(t, 3, num_workers=2, batch_range=(1, 2), **kw)), want[1:2])
    _eq(list(tloader.batched_loader(t, 3, num_workers=2, drop_last=True, **kw)),
        list(jloader.batched_loader(j, 3, num_workers=0, drop_last=True, **kw)))


def test_batched_loader_raises_fetch_errors():
    class Bad:
        def __len__(self):
            return 12

        def __getitem__(self, i):
            if i == 7:
                raise ValueError("corrupt image")
            return np.zeros((2, 2), np.float32), i

    for workers in (0, 2):
        with pytest.raises(ValueError, match="corrupt image"):
            list(tloader.batched_loader(Bad(), 4, num_workers=workers))


def test_abandoned_loader_unblocks_its_producer():
    import threading
    import time

    class Ds:
        def __len__(self):
            return 64

        def __getitem__(self, i):
            return np.zeros((4,), np.float32), i

    before = threading.active_count()
    for prefetch in (1, 2, 1, 2, 1):
        it = tloader.batched_loader(Ds(), 2, num_workers=2, prefetch=prefetch)
        next(it)
        it.close()
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.1)
    assert threading.active_count() <= before + 1


def test_factory_matches_jax(fixture_root):
    from madtp_tpu.data.factory import create_dataset as jcreate
    from madtp_tpu_torch.data.factory import create_dataset, create_loader

    config = {"image_size": 32, "image_root": os.path.join(fixture_root, "images"),
              "ann_root": os.path.join(fixture_root, "annotation"),
              "vqa_root": os.path.join(fixture_root, "images")}
    for name in ("nlvr", "caption_coco", "retrieval_coco", "vqa", "nocaps"):
        got, want = create_dataset(name, config), jcreate(name, config)
        assert [len(d) for d in got] == [len(d) for d in want]
        with ttf.sample_ctx(0, 0):
            item = got[-1][0]
        with jtf.sample_ctx(0, 0):
            _eq(item, want[-1][0])
    loaders = create_loader(got, batch_size=[2, 2], is_trains=[False, False], num_workers=0)
    assert len(list(loaders[1](epoch=0))) == 2
