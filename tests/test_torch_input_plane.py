"""The port's input plane held against the JAX package's on the CPU.

Decoded pixels (``imread_rgb``, ``load_resized_uint8``,
``load_and_transform``) bit-equal to the JAX package's; the decoded-image
cache's RAM and disk tiers, torn files and invalidation (as
``tests/test_data.py`` holds the JAX cache); the decode pool and the
cached loaders giving the in-thread batches, and the JAX loader's; the
``StreamLoader`` plan equal to the JAX one; ``train_net``'s default
batches equal to the JAX ``train_net``'s (both ``StreamLoader``), and
``data__streaming=false`` giving the ``AnchorLoader`` plan; and
``DeviceStager`` passing batches through, re-raising errors and
releasing its thread (as ``tests/test_streaming.py`` holds the JAX one,
without its timing test).  The datasets are the VOCdevkit of
``tests/test_torch_datasets.py``.
"""

import glob
import os
import subprocess
import sys
from typing import NamedTuple

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.data import image as jimage
from mx_rcnn_tpu.data.loader import AnchorLoader as JAnchorLoader
from mx_rcnn_tpu.data.loader import StreamLoader as JStreamLoader
from mx_rcnn_tpu.data.loader import TestLoader as JTestLoader
from mx_rcnn_tpu.tools import train as jtrain_tool
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core import train as ttrain
from mx_rcnn_tpu_torch.core.fit import fit
from mx_rcnn_tpu_torch.data import image as timage
from mx_rcnn_tpu_torch.data import load_gt_roidb
from mx_rcnn_tpu_torch.data.cache import DecodedImageCache, plan_scale
from mx_rcnn_tpu_torch.data.decode_pool import DecodePool
from mx_rcnn_tpu_torch.data.loader import (AnchorLoader, StreamLoader,
                                           cache_from_config,
                                           decode_pool_from_config)
from mx_rcnn_tpu_torch.data.loader import TestLoader as PortTestLoader
from mx_rcnn_tpu_torch.data.staging import DeviceStager
from mx_rcnn_tpu_torch.tools import train as train_tool
from tests.test_torch_datasets import SMALL, scenes, write_voc

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    """A VOCdevkit of 12 trainval images (3 portrait), its configs in both
    packages and the port's training roidb with flips."""
    root = str(tmp_path_factory.mktemp("voc"))
    devkit = write_voc(root, scenes()[:12], {"trainval": range(12)})
    over = dict(SMALL, dataset__root_path=root, dataset__dataset_path=devkit,
                dataset__image_set="2007_trainval",
                dataset__test_image_set="2007_trainval")
    cfg = generate_config("tiny", "PascalVOC", **over)
    imdb, roidb = load_gt_roidb(cfg, training=True)
    return dict(root=root, over=over, cfg=cfg, imdb=imdb, roidb=roidb,
                jcfg=j_generate_config("tiny", "PascalVOC", **over))


def _same_batches(got, want) -> int:
    """Equal lists of batches (namedtuples, or (Batch, indices, scales)
    tuples); returns the number of images compared."""
    assert len(got) == len(want) > 0
    n = 0
    for g, w in zip(got, want):
        if isinstance(w, tuple) and len(w) == 3 and isinstance(w[1], list):
            assert g[1] == w[1]
            np.testing.assert_array_equal(g[2], w[2])
            g, w = g[0], w[0]
        assert type(g).__name__ == type(w).__name__
        for a, b in zip(g, w):
            a = a.numpy() if isinstance(a, torch.Tensor) else a
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))
        n += len(g.images)
    return n


# ---- decode ----------------------------------------------------------------

def _files(tmp_path):
    """A JPEG, a PNG and a 1-channel JPEG, seeded."""
    rng = np.random.RandomState(0)
    paths = []
    for name, shape in (("a.jpg", (181, 263, 3)), ("b.png", (300, 170, 3)),
                        ("c.jpg", (90, 120))):
        p = str(tmp_path / name)
        cv2.imwrite(p, rng.randint(0, 255, shape).astype(np.uint8))
        paths.append(p)
    return paths


def test_decode_is_bit_equal_to_jax(tmp_path):
    means = (123.68, 116.779, 103.939)
    for path in _files(tmp_path):
        ours, theirs = timage.imread_rgb(path), jimage.imread_rgb(path)
        assert ours.dtype == np.uint8 and ours.shape[2] == 3
        np.testing.assert_array_equal(ours, theirs)
        for flipped in (False, True):
            # shrink to fit when the bucket is below the resize target
            for scale, max_size, bucket in ((128, 160, (128, 160)),
                                            (200, 300, (160, 128)),
                                            (96, 96, (96, 96))):
                got = timage.load_resized_uint8(path, flipped, scale,
                                                max_size, bucket)
                want = jimage.load_resized_uint8(path, flipped, scale,
                                                 max_size, bucket)
                np.testing.assert_array_equal(got[0], want[0])
                assert got[1] == want[1] == plan_scale(
                    *ours.shape[:2], scale, max_size, bucket)
                assert got[0].flags.c_contiguous
                got = timage.load_and_transform(path, flipped, means, scale,
                                                max_size, bucket)
                want = jimage.load_and_transform(path, flipped, means, scale,
                                                 max_size, bucket)
                np.testing.assert_array_equal(got[0], want[0])
    with pytest.raises(FileNotFoundError):
        timage.imread_rgb(str(tmp_path / "missing.jpg"))


# ---- the decoded-image cache -------------------------------------------

def test_cache_ram_and_disk_tiers(tmp_path):
    path = _files(tmp_path)[0]
    args = (False, 128, 160, (128, 160))
    direct, direct_scale = timage.load_resized_uint8(path, *args)
    cache = DecodedImageCache(ram_bytes=1 << 30,
                              cache_dir=str(tmp_path / "c"))
    np.testing.assert_array_equal(cache.load(path, *args), direct)
    assert (cache.misses, cache.hits) == (1, 0)
    np.testing.assert_array_equal(cache.load(path, *args), direct)
    assert cache.hits == 1
    fresh = DecodedImageCache(ram_bytes=0, cache_dir=str(tmp_path / "c"))
    np.testing.assert_array_equal(fresh.load(path, *args), direct)
    assert (fresh.hits, fresh.misses) == (1, 0)
    assert plan_scale(181, 263, 128, 160, (128, 160)) == direct_scale
    assert (cache.load(path, True, 128, 160, (128, 160)) != direct).any()
    # the key is the JAX cache's: either package reads the other's files
    from mx_rcnn_tpu.data.cache import DecodedImageCache as JCache

    assert JCache._key(path, *args) == DecodedImageCache._key(path, *args)
    jfresh = JCache(ram_bytes=0, cache_dir=str(tmp_path / "c"))
    np.testing.assert_array_equal(jfresh.load(path, *args), direct)
    assert jfresh.hits == 1


def test_cache_ram_tier_evicts_least_recent(tmp_path):
    paths = _files(tmp_path)[:2]
    args = (False, 128, 160, (128, 160))
    sizes = [timage.load_resized_uint8(p, *args)[0].nbytes for p in paths]
    cache = DecodedImageCache(ram_bytes=max(sizes) + 1)
    cache.load(paths[0], *args)
    cache.load(paths[1], *args)       # evicts the first
    cache.load(paths[1], *args)
    cache.load(paths[0], *args)
    assert (cache.hits, cache.misses) == (1, 3)
    assert cache._ram_used <= cache.ram_bytes


def test_torn_disk_entry_falls_through_to_decode(tmp_path):
    path = _files(tmp_path)[1]
    cache = DecodedImageCache(ram_bytes=0, cache_dir=str(tmp_path / "c"))
    good = cache.load(path, False, 32, 64, (32, 64))
    (entry,) = glob.glob(str(tmp_path / "c" / "*.npy"))
    full = open(entry, "rb").read()
    for torn in (full[: len(full) // 2], b""):
        with open(entry, "wb") as f:
            f.write(torn)
        fresh = DecodedImageCache(ram_bytes=0, cache_dir=str(tmp_path / "c"))
        np.testing.assert_array_equal(
            fresh.load(path, False, 32, 64, (32, 64)), good)
        assert fresh.misses == 1
        assert open(entry, "rb").read() == full


def test_cache_invalidates_on_source_change(tmp_path):
    p = str(tmp_path / "img.png")
    cv2.imwrite(p, np.full((40, 60, 3), 10, np.uint8))
    cache = DecodedImageCache(ram_bytes=0, cache_dir=str(tmp_path / "c"))
    assert cache.load(p, False, 32, 64, (32, 64)).mean() < 20
    cv2.imwrite(p, np.full((40, 60, 3), 200, np.uint8))
    os.utime(p, ns=(1, 1))
    assert cache.load(p, False, 32, 64, (32, 64)).mean() > 100
    assert cache.misses == 2
    (cur,) = glob.glob(str(tmp_path / "c" / "*.npy"))
    # a versionless entry of the same stable key is swept on rewrite
    legacy = tmp_path / "c" / (os.path.basename(cur).rsplit(".", 2)[0]
                               + ".npy")
    legacy.write_bytes(b"old-format")
    os.utime(p, ns=(2, 2))
    cache.load(p, False, 32, 64, (32, 64))
    assert not legacy.exists()
    assert len(glob.glob(str(tmp_path / "c" / "*.npy"))) == 1


def test_cache_budget_and_factories_follow_the_config():
    cfg = generate_config("tiny", "PascalVOC", default__image_cache_mb=64)
    cache = cache_from_config(cfg, n_images=4, image_bytes=1 << 20)
    assert cache.ram_bytes == 4 << 20 and cache.cache_dir is None
    assert cache_from_config(cfg.replace_in("default",
                                            image_cache_mb=0)) is None
    ceiling = cfg.replace_in("data", ram_ceiling_mb=1024 + 32)
    assert cache_from_config(ceiling, batch_bytes=1 << 20).ram_bytes == \
        (32 - 4 - 4 - 2 - 1) << 20
    assert decode_pool_from_config(cfg) is None


# ---- loaders: cache, decode pool, raw_images --------------------------------

def test_cached_and_pooled_loaders_equal_in_thread_and_jax(voc, tmp_path):
    """AnchorLoader batches (two buckets) through a RAM cache, a disk
    cache, and a 2-process decode pool, with and without assembly
    threads, equal the in-thread decode and the JAX loader's; a worker's
    failed decode raises in the loader."""
    cfg, imdb, roidb = voc["cfg"], voc["imdb"], voc["roidb"]
    kw = dict(batch_images=2, seed=5)

    def run(**source):
        loader = AnchorLoader(roidb, cfg, imdb.load_image, **kw, **source)
        return [list(loader) for _ in range(2)], loader

    (want, _) = run(num_workers=0)
    assert len({b.images.shape for b in want[0]}) == 2
    jl = JAnchorLoader(roidb, voc["jcfg"], shuffle=True, num_workers=0,
                       raw_images=True, **kw)
    for epoch in range(2):
        _same_batches(want[epoch], list(jl))
    ram = DecodedImageCache(ram_bytes=1 << 30)
    disk = DecodedImageCache(ram_bytes=0, cache_dir=str(tmp_path / "c"))
    with DecodePool(2, cache_dir=str(tmp_path / "pc")) as pool:
        for source in (dict(cache=ram), dict(cache=disk),
                       dict(cache=ram, num_workers=0),
                       dict(decode_pool=pool)):
            got, loader = run(**source)
            for g, w in zip(got, want):
                _same_batches(g, w)
            assert loader.images_decoded == 2 * len(loader) * 2
        assert ram.hits > 0 and disk.hits > 0
        assert pool._ex.submit(eval, "'torch' in __import__('sys').modules"
                               ).result() is False
        bad = [dict(roidb[0], image=str(tmp_path / "missing.jpg"))] * 2
        with pytest.raises(FileNotFoundError):
            list(AnchorLoader(bad, cfg, imdb.load_image, decode_pool=pool,
                              **kw))
    with pytest.raises(ValueError, match="reads each record's image file"):
        AnchorLoader(roidb, cfg, lambda rec: None, cache=ram)


def test_test_loader_and_host_normalise_equal_jax(voc):
    """TestLoader batches, with a short last batch per bucket, and the
    fp32 host-normalised canvases of ``raw_images=False``."""
    cfg, imdb, roidb = voc["cfg"], voc["imdb"], voc["roidb"]
    evals = [r for r in roidb if not r["flipped"]]
    for raw in (True, False):
        got = list(PortTestLoader(evals, cfg, imdb.load_image,
                                  batch_images=4, raw_images=raw))
        want = list(JTestLoader(evals, voc["jcfg"], batch_images=4,
                                num_workers=2, raw_images=raw))
        assert _same_batches(got, want) == len(evals)
        assert got[0][0].images.dtype == (np.uint8 if raw else np.float32)
    got = list(AnchorLoader(roidb, cfg, imdb.load_image, batch_images=2,
                            raw_images=False))
    want = list(JAnchorLoader(roidb, voc["jcfg"], batch_images=2,
                              raw_images=False))
    _same_batches(got, want)


def test_record_decodes_counts_each_image_once(voc):
    cfg, imdb, roidb = voc["cfg"], voc["imdb"], voc["roidb"]
    loader = StreamLoader(roidb, cfg, imdb.load_image, batch_images=1)
    loader.record_decodes()
    assert len(list(loader)) == len(roidb)
    assert sorted(loader.decoded_ids) == sorted(
        (int(r["index"]), r["flipped"]) for r in roidb)


# ---- the StreamLoader plan ---------------------------------------------------

def _geometry_roidb(n=40, seed=0):
    """Records only (no pixels): landscape and portrait sizes, so the toy
    config's two buckets are both used."""
    sizes = [(128, 160), (160, 128), (100, 170)]
    pick = np.random.RandomState(seed).randint(0, len(sizes), n)
    return [dict(image=f"im{i}", index=i, height=sizes[k][0],
                 width=sizes[k][1], boxes=np.zeros((1, 4), np.float32),
                 gt_classes=np.ones(1, np.int32), flipped=False)
            for i, k in enumerate(pick)]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("batch_images", [1, 2, 4])
def test_stream_plan_equals_jax(seed, batch_images):
    cfg = generate_config("tiny", "PascalVOC", **SMALL)
    jcfg = j_generate_config("tiny", "PascalVOC", **SMALL)
    roidb = _geometry_roidb(37 + seed, seed)
    for shuffle in (True, False):
        ours = StreamLoader(roidb, cfg, None, batch_images=batch_images,
                            shuffle=shuffle, seed=seed)
        theirs = JStreamLoader(roidb, jcfg, batch_images=batch_images,
                               shuffle=shuffle, seed=seed, num_workers=0)
        assert len(ours) == len(theirs)
        buckets = set()
        for epoch in range(3):
            got = ours._plan(epoch, batch_images)
            assert got == theirs._plan(epoch, batch_images)
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            assert ours.plan() == got == theirs._epoch_plan(epoch)
            buckets |= {b for b, _ in got}
        assert len(buckets) == 2
        # a skipped prefix trims the plan before any decode
        ours.set_epoch(1)
        ours.skip_next_batches(3)
        assert ours.plan() == ours._plan(1, batch_images)[3:]
        assert ours.plan() == ours._plan(2, batch_images)
    aq = AnchorLoader(roidb, cfg, None, batch_images=batch_images, seed=seed)
    if len(aq) > 2:
        assert aq.plan() != ours._plan(0, batch_images)


# ---- train_net's batches: the repair -----------------------------------------

def _captured(into: list, returns):
    """A ``fit`` for either package that records two epochs of its
    loader's batches (as numpy) instead of training."""
    def fake_fit(*args, **kw):
        loader = next(a for a in args if hasattr(a, "set_epoch"))
        into.append(type(loader).__name__)
        for epoch in range(2):
            loader.set_epoch(epoch)
            into.append([type(b)(*(np.asarray(x) for x in b))
                         for b in loader])
        return returns(args)
    return fake_fit


@pytest.mark.parametrize("streaming", [True, False])
def test_train_net_feeds_the_jax_train_nets_batches(voc, monkeypatch,
                                                    streaming):
    """The same config and seed: the port's ``train_net`` feeds the JAX
    ``train_net``'s batches in its order; by default both on the
    ``StreamLoader`` plan, with ``data__streaming=false`` both on the
    ``AnchorLoader`` plan."""
    over = dict(voc["over"], train__batch_images=2,
                data__streaming=streaming)
    ours, theirs = [], []
    monkeypatch.setattr(train_tool, "fit", _captured(ours, lambda a: {}))
    monkeypatch.setattr(jtrain_tool, "fit", _captured(theirs,
                                                      lambda a: a[2]))
    train_tool.train_net(generate_config("tiny", "PascalVOC", **over),
                         seed=3, end_epoch=2, device="cpu",
                         log=lambda line: None)
    jtrain_tool.train_net(j_generate_config("tiny", "PascalVOC", **over),
                          prefix=None, seed=3, end_epoch=2)
    kind = "StreamLoader" if streaming else "AnchorLoader"
    assert ours[0] == theirs[0] == kind
    for got, want in zip(ours[1:], theirs[1:]):
        assert _same_batches(got, want) == len(voc["roidb"])


# ---- the stager ----------------------------------------------------------------

class _Pair(NamedTuple):
    a: np.ndarray
    b: np.ndarray


def test_stager_passes_batches_through(voc):
    cfg, imdb, roidb = voc["cfg"], voc["imdb"], voc["roidb"]
    want = list(StreamLoader(roidb, cfg, imdb.load_image, batch_images=2,
                             seed=2))
    stager = DeviceStager(StreamLoader(roidb, cfg, imdb.load_image,
                                       batch_images=2, seed=2), "cpu", 2)
    got = list(stager)
    stager.close()
    assert all(isinstance(t, torch.Tensor) for b in got for t in b)
    assert _same_batches(got, want) == len(roidb)
    assert not stager._thread.is_alive()


def test_stager_reraises_source_errors():
    def boom():
        yield _Pair(np.zeros(2), np.ones(3))
        raise RuntimeError("decode failed")

    stager = DeviceStager(boom(), "cpu", depth=2)
    it = iter(stager)
    first = next(it)
    assert torch.equal(first.b, torch.ones(3, dtype=torch.float64))
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)
    stager.close()
    bad = DeviceStager(iter([_Pair(np.zeros(2), "not an array")]), "cpu")
    with pytest.raises(TypeError):
        list(bad)
    bad.close()


def test_stager_close_releases_its_thread():
    closed = []

    def endless():
        try:
            i = 0
            while True:
                yield _Pair(np.full(4, i), np.zeros(1))
                i += 1
        finally:
            closed.append(True)

    stager = DeviceStager(endless(), "cpu", depth=2)
    it = iter(stager)
    assert [int(next(it).a[0]) for _ in range(3)] == [0, 1, 2]
    stager.close()
    stager._thread.join(timeout=5)
    assert not stager._thread.is_alive() and closed == [True]
    stager.close()   # idempotent


def test_fit_with_and_without_staging_ends_bit_equal(voc):
    """Three steps of the tiny network on the real-layout batches: the
    staged run and the plain one end with equal weights and traces."""
    states = []
    for staging in (True, False):
        cfg = voc["cfg"].replace_in("data", staging=staging)
        loader = StreamLoader(voc["roidb"], cfg, voc["imdb"].load_image,
                              batch_images=2)
        state = ttrain.setup_training(cfg, "cpu", seed=1,
                                      steps_per_epoch=len(loader))
        fit(state, cfg, ttrain.make_train_step(cfg), loader, end_epoch=1,
            max_steps=3, log=lambda line: None)
        states.append(state)
    a, b = (s.model.state_dict() for s in states)
    assert states[0].step == states[1].step == 3
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for k, t in states[0].optimizer.trace.items():
        assert torch.equal(t, states[1].optimizer.trace[k]), k


def test_decode_workers_import_no_torch():
    """What a spawned decode worker imports (the decode pool, the cache,
    the data package) loads no torch."""
    code = ("import sys\n"
            "import mx_rcnn_tpu_torch.data.decode_pool as p\n"
            "import mx_rcnn_tpu_torch.data.cache\n"
            "p._init_worker(None, 1 << 20)\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_train_cli_reads_the_layout_with_a_decode_pool(voc, tmp_path,
                                                       capsys):
    """``tools/train.py`` without ``--synthetic`` over the devkit, with 2
    decode workers and a disk cache, streaming and staging at their
    defaults: one epoch of the images with gt and their flips at batch 2,
    every image decoded once, the checkpoint written."""
    from mx_rcnn_tpu_torch.utils.checkpoint import (checkpoint_path,
                                                    read_manifest)

    prefix = str(tmp_path / "m")
    argv = ["--device", "cpu", "--network", "tiny", "--dataset", "PascalVOC",
            "--root_path", voc["root"], "--dataset_path",
            voc["over"]["dataset__dataset_path"], "--image_set",
            "2007_trainval", "--batch_images", "2", "--end_epoch", "1",
            "--prefix", prefix, "--set", "default__decode_procs=2",
            "--set", f"default__image_cache_dir={tmp_path / 'c'}"] + [
        f"--set={k}={v}" for k, v in SMALL.items()]
    metrics = train_tool.main(argv)
    out = capsys.readouterr().out
    assert np.isfinite(metrics["loss"])
    assert "loader=StreamLoader" in out and "data wait" in out
    records = len(voc["roidb"])
    assert f"records={records} " in out
    assert f"images decoded: {records}" in out
    assert read_manifest(checkpoint_path(prefix, 1))["step"] == records // 2
    assert len(glob.glob(str(tmp_path / "c" / "*.npy"))) == records
