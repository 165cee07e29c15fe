"""The bulk scoring tier held against the JAX package's on the CPU.

``StreamTestLoader``: its plan equal to the JAX one with shuffle on and
off over several seeds, every image once, ``skip_next_batches`` resuming
identically, fp32 rows bit-equal to the JAX loader's and to the
engine's ``preprocess``.  The engine's seams: ``submit_prepared`` equal
to ``submit`` and its refusals, ``submit_source`` bit-equal to
``preprocess`` with its shed check before the pixel work, and
``add_done_callback``.  ``corpus_fingerprint`` and ``make_sink_manifest``
equal to the JAX strings.  The sink's prefix, tmp cleanup and refusals;
exactly-once accounting; an unservable image aborting the run; kill and
resume byte-identical, in process and by a SIGKILL in a spawned process;
and the port's shards byte-equal to the JAX ``BulkRunner``'s over the
same stub ``run_fn`` (the JAX side through ``build_fleet`` with stub
replicas, as ``tests/test_bulk.py`` drives it; the port side through one
``ServingEngine``; then both sides through 2-replica fleets).  The model
path is the content-dependent stub of ``tests/torch_bulk_workers.py``: no
model runs in this file.
"""

import json
import multiprocessing
import os
import signal
import threading

import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.data import load_gt_roidb as j_load_gt_roidb
from mx_rcnn_tpu.data.loader import StreamTestLoader as JStreamTestLoader
from mx_rcnn_tpu.serve import bulk as jbulk
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.data.image import (choose_bucket, fit_to_bucket,
                                          resize_keep_ratio)
from mx_rcnn_tpu_torch.data.loader import StreamTestLoader
from mx_rcnn_tpu_torch.obs.metrics import Registry
from mx_rcnn_tpu_torch.serve import bulk
from mx_rcnn_tpu_torch.serve.bulk import (BulkAborted, BulkSink,
                                          BulkSinkMismatch, auto_inflight,
                                          detections_line)
from mx_rcnn_tpu_torch.serve.queue import SERVED, SHED
from tests import torch_bulk_workers as w
from tests.test_torch_datasets import scenes, write_voc
from tests.test_torch_input_plane import _geometry_roidb

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def devkit(tmp_path_factory):
    """A VOCdevkit whose test set holds 13 JPEGs, both orientations."""
    root = str(tmp_path_factory.mktemp("bulk_voc"))
    return root, write_voc(root, scenes()[:13], {"test": range(13)})


@pytest.fixture(scope="module")
def corpus(devkit):
    return w.corpus(*devkit)


def _jax_cfg(devkit, **kw):
    return j_generate_config("tiny", "PascalVOC",
                             **w.bulk_overrides(*devkit, **kw))


def _shards(root):
    sink = BulkSink(str(root))
    return [open(sink.shard_path(k), "rb").read()
            for k in range(sink.committed_shards())]


# ---- StreamTestLoader -------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("batch_images", [1, 2, 3, 4])
@pytest.mark.parametrize("shuffle", [False, True])
def test_stream_test_plan_equals_jax(seed, batch_images, shuffle):
    over = dict(w.BULK)
    cfg = generate_config("tiny", "PascalVOC", **over)
    jcfg = j_generate_config("tiny", "PascalVOC", **over)
    roidb = _geometry_roidb(29 + seed, seed)
    ours = StreamTestLoader(roidb, cfg, None, batch_images=batch_images,
                            shuffle=shuffle, seed=seed)
    theirs = JStreamTestLoader(roidb, jcfg, batch_images=batch_images,
                               shuffle=shuffle, seed=seed, num_workers=0)
    assert len(ours) == len(theirs)
    plan = ours._plan(0, batch_images)
    assert plan == theirs._plan(0, batch_images)
    assert len(plan) == len(ours)
    assert sorted(i for _, idx in plan for i in idx) == list(range(
        len(roidb)))
    ours.set_epoch(0)
    ours.skip_next_batches(2)
    assert ours.plan() == plan[2:]


def test_stream_test_loader_yields_every_image_once(corpus):
    cfg, imdb, roidb = corpus
    loader = StreamTestLoader(roidb, cfg, imdb.load_image, batch_images=3,
                              num_workers=0)
    sizes, seen = [], []
    loader.set_epoch(0)
    for batch, indices, scales in loader:
        assert batch.images.shape[0] == len(indices) == len(scales)
        assert batch.images.dtype == np.uint8      # raw_images default
        sizes.append(len(indices))
        seen.extend(indices)
    assert sorted(seen) == list(range(len(roidb)))
    assert len(sizes) == len(loader) and min(sizes) < 3   # a partial tail


def test_skip_next_batches_resumes_identically(corpus):
    cfg, imdb, roidb = corpus

    def mk():
        loader = StreamTestLoader(roidb, cfg, imdb.load_image,
                                  batch_images=3, raw_images=False,
                                  num_workers=0)
        loader.set_epoch(0)
        return loader

    full = [(idx, b.images.copy(), s) for b, idx, s in mk()]
    resumed = mk()
    resumed.skip_next_batches(2)
    got = [(idx, b.images.copy(), s) for b, idx, s in resumed]
    assert len(got) == len(full) - 2
    for (gi, gim, gs), (fi, fim, fs) in zip(got, full[2:]):
        assert gi == fi
        np.testing.assert_array_equal(gim, fim)
        np.testing.assert_array_equal(gs, fs)


def test_fp32_rows_equal_jax_and_preprocess(devkit, corpus):
    cfg, imdb, roidb = corpus
    jcfg = _jax_cfg(devkit)
    _, jroidb = j_load_gt_roidb(jcfg, training=False)
    ours = StreamTestLoader(roidb, cfg, imdb.load_image, batch_images=2,
                            raw_images=False, num_workers=0)
    theirs = JStreamTestLoader(jroidb, jcfg, batch_images=2,
                               raw_images=False, num_workers=0)
    ours.set_epoch(0)
    theirs.set_epoch(0)
    engine = w.stub_engine(cfg, start=False)
    n = 0
    for (b, idx, s), (jb, jidx, js) in zip(ours, theirs):
        assert idx == jidx
        assert b.images.dtype == np.float32
        np.testing.assert_array_equal(b.images, np.asarray(jb.images))
        np.testing.assert_array_equal(b.im_info, np.asarray(jb.im_info))
        np.testing.assert_array_equal(s, np.asarray(js))
        for j, i in enumerate(idx):
            canvas, info, bucket = engine.preprocess(
                imdb.load_image(roidb[i]))
            assert bucket == tuple(b.images.shape[1:3])
            np.testing.assert_array_equal(b.images[j], canvas)
            np.testing.assert_array_equal(b.im_info[j], info)
            n += 1
    assert n == len(roidb)


# ---- the engine's seams ---------------------------------------------------------

def test_submit_prepared_equals_submit(corpus):
    cfg, imdb, roidb = corpus
    engine = w.stub_engine(cfg)
    try:
        for i in (0, 3):   # a landscape and a portrait image
            img = imdb.load_image(roidb[i])
            via_submit = engine.detect(img, timeout_ms=0)
            data, info, bucket = engine.preprocess(img)
            via_prepared = engine.submit_prepared(
                data, info, bucket, timeout_ms=0).wait(timeout=20.0)
            assert sorted(via_submit) == sorted(via_prepared)
            for c in via_submit:
                np.testing.assert_array_equal(via_submit[c],
                                              via_prepared[c])
    finally:
        engine.close()


def test_submit_prepared_refuses_wrong_bucket_shape_and_dtype(corpus):
    cfg = corpus[0]
    engine = w.stub_engine(cfg, start=False)
    info = np.array([128, 160, 1.0], np.float32)
    with pytest.raises(ValueError, match="float32"):
        engine.submit_prepared(np.zeros((128, 160, 3), np.uint8), info,
                               (128, 160))
    with pytest.raises(ValueError, match="float32"):
        engine.submit_prepared(np.zeros((160, 128, 3), np.float32), info,
                               (128, 160))
    with pytest.raises(ValueError, match="bucket"):
        engine.submit_prepared(np.zeros((64, 64, 3), np.float32), info,
                               (64, 64))
    assert engine.metrics.snapshot()["counters"].get("submitted", 0) == 0


def _resized(cfg, img):
    """The uint8 image and im_info a head resolves before padding."""
    resized, s = resize_keep_ratio(img, cfg.bucket.scale, cfg.bucket.max_size)
    bucket = choose_bucket(*resized.shape[:2],
                           tuple(tuple(b) for b in cfg.bucket.shapes))
    resized, s = fit_to_bucket(resized, s, bucket)
    h, w_ = img.shape[:2]
    return resized, np.array([round(h * s), round(w_ * s), s],
                             np.float32), bucket


def test_submit_source_is_bit_equal_to_preprocess(corpus):
    cfg, imdb, roidb = corpus
    engine = w.stub_engine(cfg, start=False)
    for i in range(len(roidb)):
        img = imdb.load_image(roidb[i])
        src, info, bucket = _resized(cfg, img)
        req = engine.submit_source(src, info, bucket, timeout_ms=0)
        canvas, pinfo, pbucket = engine.preprocess(img)
        assert req.bucket == pbucket == bucket
        assert req.image.dtype == np.float32
        np.testing.assert_array_equal(req.image, canvas)
        np.testing.assert_array_equal(req.im_info, pinfo)
    with pytest.raises(ValueError, match="uint8"):
        engine.submit_source(src.astype(np.float32), info, bucket)
    with pytest.raises(ValueError, match="does not fit"):
        engine.submit_source(np.zeros((200, 100, 3), np.uint8), info,
                             (128, 160))
    with pytest.raises(ValueError, match="bucket"):
        engine.submit_source(src, info, (64, 64))


def test_submit_source_sheds_before_the_pixel_work(corpus, monkeypatch):
    cfg, imdb, roidb = corpus
    cfg = cfg.replace_in("serve", shed_watermark=2, queue_depth=4)
    engine = w.stub_engine(cfg, start=False)
    src, info, bucket = _resized(cfg, imdb.load_image(roidb[0]))
    reqs = [engine.submit_source(src, info, bucket) for _ in range(2)]
    calls = []
    from mx_rcnn_tpu_torch.serve import engine as engine_mod
    monkeypatch.setattr(engine_mod, "pad_normalize",
                        lambda *a: calls.append(a))
    shed = engine.submit_source(src, info, bucket)
    assert shed.state == SHED and shed.image is None and not calls
    assert [r.state for r in reqs] == ["pending"] * 2
    counters = engine.metrics.snapshot()["counters"]
    assert counters["submitted"] == 3 and counters["shed"] == 1


def test_add_done_callback_once_and_at_once_when_terminal(corpus):
    cfg, imdb, roidb = corpus
    engine = w.stub_engine(cfg, start=False)
    data, info, bucket = engine.preprocess(imdb.load_image(roidb[0]))
    req = engine.submit_prepared(data, info, bucket, timeout_ms=0)
    seen = []
    req.add_done_callback(lambda r: seen.append((r.state,
                                                 threading.get_ident())))
    assert not seen
    engine._serve_batch(bucket, engine.queues[bucket].take_batch(2, 0.0))
    assert [s for s, _ in seen] == [SERVED]
    assert req._finish(SHED) is False and len(seen) == 1
    late = []
    req.add_done_callback(lambda r: late.append(r.state))
    assert late == [SERVED]
    engine.close()
    closed = engine.submit_prepared(data, info, bucket)
    closed.add_done_callback(lambda r: late.append(r.state))
    assert late == [SERVED, SHED]


# ---- identity strings ---------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"quant__enabled": True}, {"quant__enabled": True,
                                   "quant__dtype": "fp8"},
    {"serve__score_thresh": 0.2, "test__rpn_pre_nms_top_n": 128},
    {"bulk__shard_batches": 5}])
def test_identity_strings_equal_jax(devkit, corpus, kw):
    cfg = w.corpus(*devkit, **kw)[0]
    jcfg = _jax_cfg(devkit, **kw)
    roidb = corpus[2]
    for seed, bi, model in ((0, 2, None), (3, 4, "ckpt/e2e@5"),
                            (1, 1, "random-init@seed=0")):
        assert bulk.corpus_fingerprint(cfg, roidb, seed, bi, model) == \
            jbulk.corpus_fingerprint(jcfg, roidb, seed, bi, model)
        assert bulk.make_sink_manifest(cfg, roidb, seed, bi, model) == \
            jbulk.make_sink_manifest(jcfg, roidb, seed, bi, model)
    assert bulk.corpus_fingerprint(cfg, roidb, 0, 2) != \
        bulk.corpus_fingerprint(cfg, roidb[:-1], 0, 2)


def test_bulk_config_and_auto_inflight_equal_jax():
    for kw in ({"bulk__max_inflight": 7},
               {"fleet__replicas": 2, "serve__batch_size": 4,
                "serve__shed_watermark": 32},
               {"fleet__replicas": 8, "serve__batch_size": 8,
                "serve__shed_watermark": 16}, {}):
        cfg = generate_config("tiny", "synthetic", **kw)
        jcfg = j_generate_config("tiny", "synthetic", **kw)
        assert auto_inflight(cfg) == jbulk.auto_inflight(jcfg)
        assert repr(cfg.bulk) == repr(jcfg.bulk)
        assert repr(cfg.fleet) == repr(jcfg.fleet)


def test_detections_line_equals_jax():
    rng = np.random.RandomState(0)
    dets = {3: rng.rand(2, 5).astype(np.float32), 1: np.zeros((0, 5),
                                                              np.float32),
            12: rng.rand(1, 5).astype(np.float32)}
    assert detections_line(7, dets) == jbulk.detections_line(7, dets)
    assert detections_line(0, {}) == jbulk.detections_line(0, {})


# ---- the sink ------------------------------------------------------------------

def test_sink_commit_prefix_tmp_cleanup_and_refusals(tmp_path, corpus):
    cfg, _, roidb = corpus
    m = bulk.make_sink_manifest(cfg, roidb, 0, 2)
    sink = BulkSink(str(tmp_path), m)
    assert sink.committed_shards() == 0
    sink.commit(0, [detections_line(0, {1: np.ones((1, 5))})])
    sink.commit(1, [detections_line(1, {})])
    assert sink.committed_shards() == 2
    orphan = tmp_path / "shard-00002.jsonl.tmp"
    orphan.write_text("torn")
    sink2 = BulkSink(str(tmp_path), dict(m))
    assert not orphan.exists() and sink2.committed_shards() == 2
    with pytest.raises(BulkSinkMismatch, match="batch_images"):
        BulkSink(str(tmp_path), bulk.make_sink_manifest(cfg, roidb, 0, 4))
    with pytest.raises(BulkSinkMismatch, match="corpus"):
        BulkSink(str(tmp_path),
                 bulk.make_sink_manifest(cfg, roidb[:5], 0, 2))
    with pytest.raises(BulkSinkMismatch, match="model|corpus"):
        BulkSink(str(tmp_path),
                 bulk.make_sink_manifest(cfg, roidb, 0, 2, "ckpt/e2e@5"))
    with pytest.raises(BulkSinkMismatch, match="rpn_pre_nms|corpus"):
        BulkSink(str(tmp_path), bulk.make_sink_manifest(
            cfg.replace_in("test", rpn_pre_nms_top_n=128), roidb, 0, 2))
    (tmp_path / "shard-00005.jsonl").write_text("")
    with pytest.raises(BulkSinkMismatch, match="non-contiguous"):
        sink2.committed_shards()
    with pytest.raises(ValueError, match="no manifest"):
        BulkSink(str(tmp_path / "fresh"))


# ---- the runner -----------------------------------------------------------------

def test_exactly_once_accounting_and_gauges(tmp_path, corpus):
    cfg, imdb, roidb = corpus
    reg = Registry()
    stats = w.run_bulk(cfg, imdb, roidb, tmp_path / "sink", registry=reg)
    assert stats["planned_images"] == stats["accounted_images"] == 13
    assert stats["lost"] == 0 and stats["resumed_shards"] == 0
    sink = BulkSink(str(tmp_path / "sink"))
    seen = []
    for k in range(sink.committed_shards()):
        for line in sink.read_lines(k):
            rec = json.loads(line)
            seen.append(rec["i"])
            assert rec["dets"]["1"]            # the stub's one box
    assert sorted(seen) == list(range(13))
    snap = reg.snapshot()
    assert snap["counters"]["bulk.committed_images"] == 13
    assert snap["gauges"]["bulk.committed_shards"] == stats["shards"]
    assert snap["gauges"]["bulk.inflight"] == 0
    assert snap["hists"]["bulk.sink_commit_ms"]["count"] == \
        stats["shards"]


def test_unservable_image_aborts_and_is_never_dropped(tmp_path, corpus):
    cfg, imdb, roidb = corpus
    cfg = cfg.replace_in("bulk", retries=1)
    engine = w.stub_engine(cfg)
    engine.kill()                     # nothing left to serve
    try:
        with pytest.raises(BulkAborted, match="attempt"):
            w.run_bulk(cfg, imdb, roidb, tmp_path / "sink", engine=engine)
    finally:
        engine.close()
    assert BulkSink(str(tmp_path / "sink")).committed_shards() == 0


def test_kill_mid_corpus_resume_is_byte_identical(tmp_path, corpus):
    cfg, imdb, roidb = corpus
    w.run_bulk(cfg, imdb, roidb, tmp_path / "control")

    class _Stop(Exception):
        pass

    def fault(k):
        if k == 1:
            raise _Stop()

    with pytest.raises(_Stop):
        w.run_bulk(cfg, imdb, roidb, tmp_path / "kr", fault=fault)
    assert BulkSink(str(tmp_path / "kr")).committed_shards() == 2
    stats = w.run_bulk(cfg, imdb, roidb, tmp_path / "kr")
    assert stats["resumed_shards"] == 2
    assert stats["accounted_images"] == 13 and stats["lost"] == 0
    assert _shards(tmp_path / "kr") == _shards(tmp_path / "control")
    with pytest.raises(BulkSinkMismatch):
        w.run_bulk(cfg, imdb, roidb, tmp_path / "kr", batch_images=4)


def test_sigkill_in_a_spawned_process_then_resume(tmp_path, devkit, corpus):
    """A real SIGKILL right after shard 1 commits leaves shards 0 and 1
    whole and nothing else; the resume here completes the sink, byte
    for byte the control's."""
    cfg, imdb, roidb = corpus
    w.run_bulk(cfg, imdb, roidb, tmp_path / "control")
    sink_dir = str(tmp_path / "killed")
    ctx = multiprocessing.get_context("spawn")
    p = ctx.Process(target=w.sigkill_after_shard,
                    args=(*devkit, sink_dir, 1))
    p.start()
    p.join(240)
    assert p.exitcode == -signal.SIGKILL
    sink = BulkSink(sink_dir)
    assert sink.committed_shards() == 2
    assert not [n for n in os.listdir(sink_dir) if n.endswith(".tmp")]
    for k in range(2):
        for line in sink.read_lines(k):
            json.loads(line)
    stats = w.run_bulk(cfg, imdb, roidb, sink_dir)
    assert stats["resumed_shards"] == 2 and stats["lost"] == 0
    assert _shards(sink_dir) == _shards(tmp_path / "control")


def test_shards_byte_equal_to_the_jax_runner(tmp_path, devkit, corpus):
    from mx_rcnn_tpu.serve.fleet import build_fleet

    cfg, imdb, roidb = corpus
    jcfg = _jax_cfg(devkit)
    _, jroidb = j_load_gt_roidb(jcfg, training=False)
    run_fn = w.content_stub_run_fn(cfg)
    router = build_fleet(jcfg, None, {}, run_fn_factory=lambda rid: run_fn)
    try:
        loader = JStreamTestLoader(jroidb, jcfg, batch_images=2,
                                   raw_images=False, num_workers=0)
        sink = jbulk.BulkSink(str(tmp_path / "jax"), jbulk.make_sink_manifest(
            jcfg, jroidb, 0, 2))
        jstats = jbulk.BulkRunner(router, loader, sink, jcfg).run()
    finally:
        router.close()
    stats = w.run_bulk(cfg, imdb, roidb, tmp_path / "port")
    assert stats["accounted_images"] == jstats["accounted_images"] == 13
    ours, theirs = _shards(tmp_path / "port"), _shards(tmp_path / "jax")
    assert len(ours) == len(theirs) == stats["shards"]
    assert ours == theirs
    assert open(tmp_path / "port" / "MANIFEST.json").read() == \
        open(tmp_path / "jax" / "MANIFEST.json").read()
    # and with both sides scoring through 2-replica fleets
    from mx_rcnn_tpu_torch.serve.fleet import build_fleet as t_build_fleet

    cfg2 = cfg.replace_in("fleet", replicas=2)
    jcfg2 = jcfg.replace_in("fleet", replicas=2)
    out = {}
    for side, build, c, roids, mk in (
            ("jax2", lambda c: build_fleet(
                c, None, {}, run_fn_factory=lambda rid: run_fn),
             jcfg2, jroidb, lambda c, r: JStreamTestLoader(
                 r, c, batch_images=2, raw_images=False, num_workers=0)),
            ("port2", lambda c: t_build_fleet(
                c, None, run_fn_factory=lambda rid: run_fn, device="cpu"),
             cfg2, roidb, lambda c, r: StreamTestLoader(
                 r, c, imdb.load_image, batch_images=2, raw_images=False,
                 num_workers=0))):
        mod = jbulk if side == "jax2" else bulk
        router = build(c)
        try:
            sink = mod.BulkSink(str(tmp_path / side), mod.make_sink_manifest(
                c, roids, 0, 2))
            out[side] = mod.BulkRunner(router, mk(c, roids), sink, c).run()
            assert len(router.manager.replicas) == 2
            assert all(r.engine.metrics.counters["served"] > 0
                       for r in router.manager.replicas)
        finally:
            router.close()
    assert out["port2"]["accounted_images"] == \
        out["jax2"]["accounted_images"] == 13
    assert _shards(tmp_path / "port2") == _shards(tmp_path / "jax2") == ours
