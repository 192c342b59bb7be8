"""The port's host data path against the JAX package's: the native binding,
records and splits, the numpy augmentations, the packed cache,
`prepare_example`, the Loader, `prefetch`, the synthetic fixture and the
detector's resize (fault F1).

Every comparison is bit-for-bit: both packages run the same numpy code and
the same C++ source (`native/src/voc_native.cpp`, built by each package
into its own directory with the same flags) on the same inputs and seeds.
"""

import os
import threading
import time

import numpy as np
import pytest

from objectdetection_ssd_tpu import native as jnative
from objectdetection_ssd_tpu.config import DataConfig as JDataConfig
from objectdetection_ssd_tpu.data import augment as jaugment
from objectdetection_ssd_tpu.data import cache as jcache
from objectdetection_ssd_tpu.data import pipeline as jpipeline
from objectdetection_ssd_tpu.data import synthetic as jsynthetic
from objectdetection_ssd_tpu.data import voc as jvoc
from objectdetection_ssd_torch import native
from objectdetection_ssd_torch.config import DataConfig
from objectdetection_ssd_torch.data import augment, cache, pipeline, synthetic
from objectdetection_ssd_torch.data import voc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    jsynthetic.generate_voc(str(root), num_2007=10, num_2012=4,
                            image_size=(160, 120), max_objects=5, seed=3,
                            difficult_fraction=0.2)
    return str(root)


@pytest.fixture(scope="module")
def records(voc_root):
    return voc.load_records(voc_root, train=True)


def _assert_examples_equal(a, b):
    assert a.image.dtype == b.image.dtype
    np.testing.assert_array_equal(a.image, b.image)
    np.testing.assert_array_equal(a.boxes, b.boxes)
    np.testing.assert_array_equal(a.classes, b.classes)
    assert a.image_id == b.image_id


# ------------------------------------------------------------ native library


def test_native_library_built_in_the_ports_own_directory():
    assert native.available() and jnative.available()
    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(
        REPO, "objectdetection_ssd_torch", "_build")
    assert os.path.exists(path)
    assert os.path.realpath(path) != os.path.realpath(jnative._LIB_PATH)
    assert "-ffast-math" not in native.GXX_FLAGS


def test_native_parse_voc_xml_bit_equal_to_jax(voc_root):
    _, xmls = jvoc.voc_file_lists(voc_root)
    for x in xmls:
        for got, want in zip(native.parse_voc_xml(x),
                             jnative.parse_voc_xml(x)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("normalize", [True, False])
def test_native_resize_normalize_bit_equal_to_jax(normalize):
    rng = np.random.default_rng(4)
    for h, w in ((120, 160), (375, 500), (300, 300), (77, 311)):
        img = rng.random((h, w, 3), dtype=np.float32)
        np.testing.assert_array_equal(
            native.resize_normalize(img, 300, normalize=normalize),
            jnative.resize_normalize(img, 300, normalize=normalize))


@pytest.mark.parametrize("normalize", [True, False])
def test_native_train_augment_bit_equal_to_jax(records, normalize):
    for i, rec in enumerate(records[:6]):
        img = jpipeline.load_image(rec.image_path)
        for seed in (0, 7 * i + 1, 2**31 - 1):
            got = native.train_augment(img, rec.boxes_xyxy, rec.classes,
                                       seed, 300, normalize=normalize)
            want = jnative.train_augment(img, rec.boxes_xyxy, rec.classes,
                                         seed, 300, normalize=normalize)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


def test_fallthroughs_are_counted(monkeypatch, records):
    """Without the library, preprocess and augment take PIL / numpy, and
    every such fall-through is counted."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    monkeypatch.setattr(native, "fallbacks", 0)
    img = np.random.default_rng(0).random((50, 60, 3), dtype=np.float32)
    out = pipeline.preprocess_image(img, 32)
    np.testing.assert_array_equal(
        out, jpipeline.normalize_image(jpipeline.resize_image(img, 32)))
    assert native.fallbacks == 1
    pipeline.prepare_example(records[0], 32, True, False, seed=3)
    assert native.fallbacks == 3          # the augment and the resize
    pipeline.prepare_example(records[0], 32, True, False, seed=3,
                             use_native_augment=False)
    assert native.fallbacks == 4          # the resize only


# ------------------------------------------------------- records and splits


def test_records_match_jax(voc_root):
    got = voc.load_records(voc_root, train=True)
    want = jvoc.load_records(voc_root, train=True)
    assert len(got) == len(want) == 14
    for g, w in zip(got, want):
        assert (g.image_path, g.image_id) == (w.image_path, w.image_id)
        np.testing.assert_array_equal(g.boxes_xyxy, w.boxes_xyxy)
        np.testing.assert_array_equal(g.classes, w.classes)
        np.testing.assert_array_equal(g.difficulties, w.difficulties)
    assert voc.voc_file_lists(voc_root, train=False) == jvoc.voc_file_lists(
        voc_root, train=False)
    for g, w in zip(got, want):
        g, w = g.without_difficult(), w.without_difficult()
        np.testing.assert_array_equal(g.boxes_xyxy, w.boxes_xyxy)


@pytest.mark.parametrize("parity", [False, True])
def test_train_val_split_matches_jax(parity):
    for n, frac, seed in ((14, 0.1, 10), (100, 0.25, 3), (1000, 0.1, 10)):
        got = voc.train_val_split(n, frac, seed, parity=parity)
        want = jvoc.train_val_split(n, frac, seed, parity=parity)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_missing_year_is_a_hard_error(tmp_path):
    synthetic.generate_voc(str(tmp_path), num_2007=3, num_2012=0)
    import shutil
    shutil.rmtree(tmp_path / "VOC2012")
    with pytest.raises(FileNotFoundError, match="allow-partial-voc"):
        voc.voc_file_lists(str(tmp_path))
    images, _ = voc.voc_file_lists(str(tmp_path), allow_partial=True)
    assert len(images) == 3


# ---------------------------------------------------------------- augment


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_numpy_augmentations_match_jax(records, seed):
    rec = records[seed]
    img = jpipeline.load_image(rec.image_path)
    boxes = rec.boxes_xyxy.astype(np.float32)
    for fn in ("photometric_distort",):
        np.testing.assert_array_equal(
            getattr(augment, fn)(img, np.random.default_rng(seed)),
            getattr(jaugment, fn)(img, np.random.default_rng(seed)))
    for got, want in zip(
            augment.expand(img, boxes, np.random.default_rng(seed)),
            jaugment.expand(img, boxes, np.random.default_rng(seed))):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(
            augment.random_crop(img, boxes, rec.classes,
                                np.random.default_rng(seed)),
            jaugment.random_crop(img, boxes, rec.classes,
                                 np.random.default_rng(seed))):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(augment.hflip(img, boxes),
                         jaugment.hflip(img, boxes)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(
            augment.train_transform(img, boxes, rec.classes,
                                    np.random.default_rng(seed)),
            jaugment.train_transform(img, boxes, rec.classes,
                                     np.random.default_rng(seed))):
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ cache


def test_cache_bytes_match_jax_and_rebuild_on_new_paths(records, tmp_path):
    paths = [r.image_path for r in records]
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    cache.build(paths, ours, num_workers=2)
    jcache.build(paths, theirs)
    with open(ours + ".bin", "rb") as a, open(theirs + ".bin", "rb") as b:
        assert a.read() == b.read()
    ia, ib = np.load(ours + ".idx.npz"), np.load(theirs + ".idx.npz")
    for key in ("offsets", "heights", "widths", "paths_sha256"):
        np.testing.assert_array_equal(ia[key], ib[key])
    assert cache.num_images(ours) == len(paths)
    np.testing.assert_array_equal(cache.get_image(ours, 3),
                                  jcache.get_image(theirs, 3))
    # A changed path list (order) rebuilds; the same list does not.
    mtime = os.path.getmtime(ours + ".idx.npz")
    cache.build(paths, ours)
    assert os.path.getmtime(ours + ".idx.npz") == mtime
    cache.build(paths[::-1], ours)
    assert cache.is_current(paths[::-1], ours)
    assert not cache.is_current(paths, ours)
    np.testing.assert_array_equal(cache.get_image(ours, 0),
                                  jcache.get_image(theirs, len(paths) - 1))


def test_cache_write_from_pixels_equals_decode_build(records, tmp_path):
    """`cache.write` of pixels the caller holds lays out the same files as
    `build` decoding those pixels (here: the decoded images)."""
    paths = [r.image_path for r in records[:5]]
    built, written = str(tmp_path / "built"), str(tmp_path / "written")
    cache.build(paths, built)
    pixels = [pipeline.quantize_uint8(pipeline.load_image(p)) for p in paths]
    cache.write(paths, written, lambda: iter(pixels))
    with open(built + ".bin", "rb") as a, open(written + ".bin", "rb") as b:
        assert a.read() == b.read()
    assert cache.is_current(paths, written)


# --------------------------------------------------------- prepare_example


@pytest.mark.parametrize("use_cache", [False, True])
@pytest.mark.parametrize("transfer_dtype", ["uint8", "float32"])
@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("augment_example", [False, True])
def test_prepare_example_bit_equal_to_jax(records, tmp_path, augment_example,
                                          use_native, transfer_dtype,
                                          use_cache):
    cache_path = None
    if use_cache:
        cache_path = str(tmp_path / "c")
        cache.build([r.image_path for r in records], cache_path)
    for i, rec in enumerate(records):
        kw = dict(seed=100 + i, cache_path=cache_path, cache_index=i,
                  use_native_augment=use_native,
                  transfer_dtype=transfer_dtype)
        got = pipeline.prepare_example(rec, 96, augment_example, False, **kw)
        want = jpipeline.prepare_example(rec, 96, augment_example, False,
                                         **kw)
        _assert_examples_equal(got, want)


# ------------------------------------------------------------------ Loader


@pytest.fixture(scope="module")
def loader_pairs(records):
    """(port, JAX) Loaders per worker count, train=True; each case sets
    ``train`` and ``drop_last`` on both.  One pool per worker count."""
    pairs = {}
    for w in (0, 2):
        cfg = dict(batch_size=4, num_workers=w, max_boxes=6)
        pairs[w] = (pipeline.Loader(records, DataConfig(**cfg), 64, seed=5),
                    jpipeline.Loader(records, JDataConfig(**cfg), 64, seed=5))
    yield pairs
    for a, b in pairs.values():
        a.close()
        b.close()


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_batches_identical_to_jax(loader_pairs, num_workers, train,
                                         drop_last):
    ours, theirs = loader_pairs[num_workers]
    for ld in (ours, theirs):
        ld.train, ld.drop_last = train, drop_last
    assert len(ours) == len(theirs) == (3 if drop_last else 4)
    for epoch in (0, 1):
        got = list(ours.epoch(epoch))
        want = list(theirs.epoch(epoch))
        assert len(got) == len(want) == len(ours)
        for g, w in zip(got, want):
            assert set(g) == set(w) == {"images", "boxes", "classes", "mask",
                                        "image_ids"}
            for key in g:
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_loader_adds_worker_fallthroughs(records, monkeypatch):
    """A worker returns its fall-through count with each example
    (`_prepare_counted`), and the Loader adds them to the parent's."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    monkeypatch.setattr(native, "fallbacks", 0)
    ex, n, seconds = pipeline._prepare_counted((records[0], 32, True, False,
                                                3))
    assert n == 2 and ex.image.shape == (32, 32, 3) and seconds > 0
    assert native.fallbacks == 2

    class WorkerPool:                       # results as from processes
        def map(self, fn, args):
            return [(pipeline.prepare_example(*a), 5, 0.25) for a in args]

    loader = pipeline.Loader(records, DataConfig(batch_size=4, num_workers=0,
                                                 augment=False), 32)
    loader._pool = WorkerPool()
    monkeypatch.setattr(native, "fallbacks", 0)
    batches = list(loader.epoch(0))
    # 5 per example from the "workers", plus nothing in the parent: the
    # examples above ran in-process too, one resize fall-through each.
    assert native.fallbacks == (5 + 1) * 4 * len(batches)
    assert loader.worker_seconds == 0.25 * 4 * len(batches)


# ---------------------------------------------------------------- prefetch


def test_prefetch_preserves_order():
    items = list(range(50))
    assert list(pipeline.prefetch(iter(items), size=3)) == items


def test_prefetch_relays_loader_exceptions():
    def bad():
        yield 1
        yield 2
        raise RuntimeError("corrupt example")

    it = pipeline.prefetch(bad())
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(RuntimeError, match="corrupt example"):
        next(it)


def test_prefetch_releases_producer_on_early_exit():
    produced = []
    done = threading.Event()

    def gen():
        try:
            for i in range(1000):
                produced.append(i)
                yield i
        finally:
            done.set()

    it = pipeline.prefetch(gen(), size=2)
    assert next(it) == 0
    it.close()
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and not done.is_set():
        time.sleep(0.05)
    assert done.is_set(), "producer still running after consumer closed"
    assert len(produced) < 1000


# ------------------------------------------------------------- synthetic


def test_generate_voc_equals_jax_and_renders_without_pil(tmp_path):
    kw = dict(num_2007=5, num_2012=3, image_size=(96, 80), max_objects=6,
              seed=11, class_color_coding=True)
    jsynthetic.generate_voc(str(tmp_path / "jax"), **kw)
    synthetic.generate_voc(str(tmp_path / "port"), **kw)
    pixels = {}
    synthetic.generate_voc(str(tmp_path / "mem"), **kw,
                           image_sink=pixels.__setitem__)
    n_files = 0
    for dirpath, _, files in os.walk(tmp_path / "jax"):
        rel = os.path.relpath(dirpath, tmp_path / "jax")
        for name in files:
            with open(os.path.join(dirpath, name), "rb") as f:
                want = f.read()
            with open(os.path.join(tmp_path, "port", rel, name), "rb") as f:
                assert f.read() == want, os.path.join(rel, name)
            mem = os.path.join(str(tmp_path / "mem"), rel, name)
            if name.endswith(".jpg"):
                # The sink got the pixels that the JPEG encodes.
                assert not os.path.exists(mem)
                synthetic.save_jpeg(str(tmp_path / "again.jpg"), pixels[mem])
                with open(tmp_path / "again.jpg", "rb") as f:
                    assert f.read() == want
            else:
                with open(mem, "rb") as f:
                    assert f.read() == want
            n_files += 1
    assert n_files == 2 * (5 + 3) + 3     # images, XML, three lists


def test_render_image_draws_like_jax_write_image(tmp_path, monkeypatch):
    """`render_image` draws from ``rng`` exactly as the JAX package's
    `_write_image` does."""
    from PIL import Image
    boxes = [(3, 4, 30, 40), (10, 12, 50, 33)]
    got = synthetic.render_image(64, 48, np.random.default_rng(2), boxes)
    saved = {}
    monkeypatch.setattr(Image.Image, "save",
                        lambda self, path, **kw: saved.update(
                            pixels=np.asarray(self)))
    jsynthetic._write_image(str(tmp_path / "x.jpg"), 64, 48,
                            np.random.default_rng(2), boxes)
    np.testing.assert_array_equal(got, saved["pixels"])


# ----------------------------------------------------- F1: detector resize


@pytest.mark.parametrize("hw", [(240, 320), (260, 200), (375, 500)])
def test_preprocess_image_bit_equal_to_jax(hw):
    """F1: the port resizes the float image natively, as the JAX package
    does when its library is built, not through PIL's uint8 image."""
    img = np.random.default_rng(hw[0]).random(hw + (3,), dtype=np.float32)
    got = pipeline.quantize_uint8(pipeline.preprocess_image(
        img, 300, normalize=False))
    want = jpipeline.quantize_uint8(jpipeline.preprocess_image(
        img, 300, normalize=False))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        pipeline.preprocess_image(img, 300),
        jpipeline.preprocess_image(img, 300))
    pil = pipeline.quantize_uint8(pipeline.resize_image(img, 300))
    assert (pil != got).any()             # the path F1 took differs

