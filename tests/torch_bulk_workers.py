"""Helpers of ``tests/test_torch_bulk.py`` and ``test_torch_export.py``
that import no JAX: a spawned process (the SIGKILL rig, the export join)
imports this module, not the test file.

``content_stub_run_fn`` is the content-dependent stub
(``tools/loadgen.py — make_content_stub_run_fn``, the JAX package's): each
output row a pure function of that row's pixels, so an image scores the
same in any batch and two images score differently, and byte-equal
sinks mean the same images in the same slots.
"""

import os
import signal
import types

import numpy as np
import torch

from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.data import load_gt_roidb
from mx_rcnn_tpu_torch.data.loader import StreamTestLoader
from mx_rcnn_tpu_torch.serve.bulk import (BulkRunner, BulkSink,
                                          make_sink_manifest)
from mx_rcnn_tpu_torch.serve.engine import ServingEngine
from mx_rcnn_tpu_torch.tools.loadgen import make_content_stub_run_fn

# the tiny toy recipe (tests/test_torch_datasets.py — SMALL) with the
# JAX bulk tests' serving and shard knobs
BULK = dict(train__rpn_pre_nms_top_n=256, train__rpn_post_nms_top_n=64,
            train__batch_rois=32, train__max_gt_boxes=8,
            test__rpn_pre_nms_top_n=256, test__rpn_post_nms_top_n=32,
            bucket__scale=128, bucket__max_size=160,
            bucket__shapes=((128, 160), (160, 128)),
            serve__batch_size=2, serve__max_delay_ms=5.0,
            bulk__shard_batches=2)


def content_stub_run_fn(cfg, model_ms: float = 0.0):
    return make_content_stub_run_fn(cfg, model_ms)


def bulk_overrides(root: str, devkit: str, **kw) -> dict:
    over = dict(BULK, dataset__root_path=root, dataset__dataset_path=devkit,
                dataset__test_image_set="2007_test")
    over.update(kw)
    return over


def corpus(root: str, devkit: str, **kw):
    """(cfg, imdb, roidb) of the devkit's test set."""
    cfg = generate_config("tiny", "PascalVOC",
                          **bulk_overrides(root, devkit, **kw))
    imdb, roidb = load_gt_roidb(cfg, training=False)
    return cfg, imdb, roidb


def stub_engine(cfg, model_ms: float = 0.0, start: bool = True):
    """A ServingEngine whose model path is the content stub (its
    predictor only names the device of the postprocess' tables)."""
    return ServingEngine(types.SimpleNamespace(device=torch.device("cpu")),
                         cfg, run_fn=content_stub_run_fn(cfg, model_ms),
                         start=start)


def run_bulk(cfg, imdb, roidb, sink_dir, engine=None, fault=None, seed=0,
             batch_images=2, registry=None):
    own = engine is None
    if own:
        engine = stub_engine(cfg)
    try:
        loader = StreamTestLoader(roidb, cfg, imdb.load_image,
                                  batch_images=batch_images, seed=seed,
                                  raw_images=False, num_workers=0)
        sink = BulkSink(str(sink_dir),
                        make_sink_manifest(cfg, roidb, seed, batch_images))
        return BulkRunner(engine, loader, sink, cfg, registry=registry,
                          fault=fault).run()
    finally:
        if own:
            engine.close()


def sigkill_after_shard(root: str, devkit: str, sink_dir: str,
                        shard: int) -> None:
    """The spawned child: run the corpus and SIGKILL this process right
    after shard ``shard`` commits."""
    torch.set_num_threads(1)
    cfg, imdb, roidb = corpus(root, devkit)

    def fault(k):
        if k == shard:
            os.kill(os.getpid(), signal.SIGKILL)

    run_bulk(cfg, imdb, roidb, sink_dir, fault=fault)


def warm_child(root: str, overrides: dict, image: np.ndarray, conn) -> None:
    """The spawned joiner: a fresh process builds the predictor from the
    store's bundled weights, joins with ``warm_from_export`` and serves
    ``image``; sends (join record, detections) or the error's text."""
    from mx_rcnn_tpu_torch.serve.export import (ExportStore,
                                                predictor_from_variables)

    torch.set_num_threads(1)
    try:
        cfg = generate_config("tiny", "synthetic", **overrides)
        store = ExportStore(root)
        pred = predictor_from_variables(store.load_variables(), cfg, "cpu")
        engine = ServingEngine(pred, cfg)
        try:
            join = engine.warm_from_export(store)
            dets = engine.detect(image, timeout_ms=0)
        finally:
            engine.close()
        conn.send((join, dets))
    except Exception as e:  # noqa: BLE001 — the parent asserts on it
        conn.send(("error", f"{type(e).__name__}: {e}"))
    finally:
        conn.close()
