"""The generated benchmark sets, their tools and the training CLI's flags,
held against the JAX package on the CPU.

``HardSyntheticDataset`` and ``StreamSyntheticDataset``
(``mx_rcnn_tpu_torch/data/synthetic.py``) generate the JAX sets' specs,
spec signatures and pixels, and write PNG files that decode to the same
pixels; ``load_gt_roidb`` builds the JAX package's roidbs for both
presets, and the port's loaders, reading the files through the decode
cache, give the JAX loader's batches bit for bit.  The training CLI's
``--no_shuffle``, ``--lr_step``, ``--dataset_kw``, ``--device_cache`` and
``--profile_dir`` give the JAX CLI's config and lr schedule and reach
``train_net``.  ``tools/data_bench.py --smoke --check`` and
``tools/loader_bench.py`` run on the CPU.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.core.optim import lr_schedule as j_lr_schedule
from mx_rcnn_tpu.core.optim import parse_lr_step as j_parse_lr_step
from mx_rcnn_tpu.data import load_gt_roidb as j_load_gt_roidb
from mx_rcnn_tpu.data.loader import StreamLoader as JStreamLoader
from mx_rcnn_tpu.data.synthetic import HardSyntheticDataset as JHard
from mx_rcnn_tpu.data.synthetic import StreamSyntheticDataset as JStream
from mx_rcnn_tpu.tools import train as j_train_cli
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core.optim import make_optimizer
from mx_rcnn_tpu_torch.data import (HardSyntheticDataset,
                                    StreamSyntheticDataset, load_gt_roidb,
                                    reads_files)
from mx_rcnn_tpu_torch.data.cache import DecodedImageCache
from mx_rcnn_tpu_torch.data.image import imread_rgb
from mx_rcnn_tpu_torch.data.loader import StreamLoader
from mx_rcnn_tpu_torch.data.synthetic import default_image_size
from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
from mx_rcnn_tpu_torch.tools import loader_bench
from mx_rcnn_tpu_torch.tools import train as train_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETS = {"synthetic_hard": (HardSyntheticDataset, JHard),
        "synthetic_stream": (StreamSyntheticDataset, JStream)}


@pytest.mark.parametrize("image_set", ["train", "test"])
@pytest.mark.parametrize("name", sorted(SETS))
def test_specs_signatures_pixels_and_pngs_equal_jax(name, image_set,
                                                    tmp_path):
    ours_cls, theirs_cls = SETS[name]
    ours = ours_cls(image_set, 12, root_path=str(tmp_path),
                    dataset_path=str(tmp_path / "port"))
    theirs = theirs_cls(image_set, str(tmp_path), str(tmp_path / "jax"),
                        num_images=12)
    assert (ours.num_classes, ours.image_size, ours.max_objects) == (
        theirs.num_classes, theirs.image_size, theirs.max_objects)
    assert ours._spec_signature() == theirs._spec_signature()
    for a, b in zip(ours.specs, theirs._specs, strict=True):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(ours._render(a), theirs._render(b))
    ours_roidb, theirs_roidb = ours.gt_roidb(), theirs.gt_roidb()
    for a, b in zip(ours_roidb, theirs_roidb, strict=True):
        assert os.path.basename(a["image"]) == os.path.basename(b["image"])
        np.testing.assert_array_equal(imread_rgb(a["image"]),
                                      imread_rgb(b["image"]))
    stamps = [sorted(f for f in os.listdir(os.path.dirname(r[0]["image"]))
                     if f.startswith(".spec-"))
              for r in (ours_roidb, theirs_roidb)]
    assert stamps[0] == stamps[1] == [f".spec-{ours._spec_signature()}"]
    assert reads_files(ours.load_image)


def test_a_stale_stamp_rewrites_the_pngs(tmp_path):
    """Another configuration in the same directory rewrites the files and
    leaves only its own stamp; a fresh stamp keeps them."""
    kw = dict(root_path=str(tmp_path), dataset_path=str(tmp_path / "h"))
    a = HardSyntheticDataset("train", 4, **kw)
    path = a.gt_roidb()[0]["image"]
    first = imread_rgb(path)
    b = HardSyntheticDataset("train", 4, max_objects=3, **kw)
    b.gt_roidb()
    assert not np.array_equal(imread_rgb(path), first)
    assert sorted(f for f in os.listdir(os.path.dirname(path))
                  if f.startswith(".spec-")) == [
        f".spec-{b._spec_signature()}"]
    mtime = os.stat(path).st_mtime_ns
    b.gt_roidb()
    assert os.stat(path).st_mtime_ns == mtime


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("name", sorted(SETS))
def test_load_gt_roidb_equals_jax(name, training, tmp_path):
    over = dict(dataset__root_path=str(tmp_path),
                dataset__dataset_path=str(tmp_path / name))
    _, ours = load_gt_roidb(generate_config("tiny", name, **over),
                            training=training, num_images=12)
    _, theirs = j_load_gt_roidb(j_generate_config("tiny", name, **over),
                                training=training, num_images=12)
    assert len(ours) == len(theirs) == (24 if training else 12)
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_the_generated_canvases_and_stand_in_images():
    assert default_image_size("synthetic_hard") == (240, 320)
    assert default_image_size("synthetic_stream") == (240, 320)
    assert default_image_size("synthetic") == (320, 400)
    assert default_image_size("PascalVOC") == (375, 500)
    # --synthetic N stand-ins take the preset's canvas and classes
    imdb, roidb = load_gt_roidb(generate_config("tiny", "synthetic_hard"),
                                synthetic=3)
    assert {(r["height"], r["width"]) for r in roidb} == {(240, 320)}
    assert imdb.num_classes == 9 and len(roidb) == 6


def test_the_loaders_read_the_files_as_the_jax_loader_does(tmp_path):
    """Two epochs of the streaming plan at batch 2 over the hard set's
    files, decoded through the cache (and its disk tier): the JAX
    loader's canvases, im_info and padded gt, bit for bit."""
    over = dict(dataset__root_path=str(tmp_path),
                dataset__dataset_path=str(tmp_path / "h"),
                train__max_gt_boxes=8)
    cfg = generate_config("tiny", "synthetic_hard", **over)
    imdb, roidb = load_gt_roidb(cfg, num_images=6)
    _, jroidb = j_load_gt_roidb(j_generate_config("tiny", "synthetic_hard",
                                                  **over), num_images=6)
    cache = DecodedImageCache(ram_bytes=0, cache_dir=str(tmp_path / "c"))
    ours = StreamLoader(roidb, cfg, imdb.load_image, batch_images=2, seed=3,
                        cache=cache)
    theirs = JStreamLoader(jroidb, j_generate_config(
        "tiny", "synthetic_hard", **over), batch_images=2, seed=3,
        num_workers=0, raw_images=True)
    for epoch in range(2):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        pairs = list(zip(ours, theirs, strict=True))
        assert len(pairs) == 6
        for got, want in pairs:
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, np.asarray(b))
    assert cache.misses == 12 and cache.hits == 12


# ---- the training CLI -------------------------------------------------------

ARGV = ["--network", "tiny", "--dataset", "synthetic_hard", "--no_shuffle",
        "--lr", "0.01", "--lr_step", "2,3", "--dataset_kw",
        "{'num_images': 8}", "--device_cache", "--profile_dir", "prof",
        "--no_flip"]


def test_the_new_flags_give_the_jax_clis_config_and_lr_schedule():
    ours_args = train_cli.parse_args(ARGV)
    theirs_args = j_train_cli.parse_args(ARGV)
    ours, theirs = (train_cli.config_from_args(ours_args),
                    j_train_cli.config_from_args(theirs_args))
    assert ours.train.shuffle is theirs.train.shuffle is False
    assert ours.train.flip is theirs.train.flip is False
    assert (ours.dataset.name, ours.num_classes) == (theirs.dataset.name,
                                                     theirs.num_classes)
    for k in ("lr_step", "lr", "device_cache", "profile_dir", "dataset_kw"):
        assert getattr(ours_args, k) == getattr(theirs_args, k), k
    spe = 5
    opt = make_optimizer(ours, build_model(ours, "cpu", seed=0, train=True),
                         spe, base_lr=ours_args.lr,
                         lr_step=ours_args.lr_step)
    d = theirs.default
    want = j_lr_schedule(theirs_args.lr, j_parse_lr_step(
        theirs_args.lr_step), spe, d.lr_factor, d.warmup_step, d.warmup_lr)
    for count in range(0, 4 * spe + 1):
        assert opt.lr(count) == float(want(count)), count
    assert opt.lr(2 * spe) < opt.lr(2 * spe - 1)


def test_main_passes_the_new_flags_to_train_net(monkeypatch):
    seen = {}

    def fake_train_net(cfg, **kw):
        seen.update(kw, cfg=cfg)
        return None, {"loss": 1.0}

    monkeypatch.setattr(train_cli, "train_net", fake_train_net)
    train_cli.main(ARGV + ["--device", "cpu"])
    assert seen["cfg"].train.shuffle is False
    assert seen["dataset_kw"] == {"num_images": 8}
    assert (seen["lr_step"], seen["device_cache"], seen["profile_dir"]) == (
        "2,3", True, "prof")


def test_the_train_cli_trains_the_hard_set_from_the_device_cache(tmp_path):
    """In its own interpreter, as a user runs it: 16 records (8 images
    and their flips) of one 240x320 bucket, staged once."""
    out = subprocess.run(
        [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.train", "--device",
         "cpu", "--network", "tiny", "--dataset", "synthetic_hard",
         "--root_path", str(tmp_path), "--dataset_path",
         str(tmp_path / "h"), "--dataset_kw", "{'num_images': 8}",
         "--device_cache", "--batch_images", "2", "--steps", "3",
         "--frequent", "1", "--set", "train__rpn_pre_nms_top_n=256",
         "--set", "train__rpn_post_nms_top_n=64"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "device cache: 8 batches of 2 images" in out.stdout
    assert "records=16" in out.stdout
    assert out.stdout.count(" Speed: ") == 3


# ---- the tools --------------------------------------------------------------

def test_data_bench_smoke_checks_pass_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.data_bench",
         "--smoke", "--check", "--device", "cpu", "--root_path",
         str(tmp_path), "--out", str(tmp_path / "record.json")],
        capture_output=True, text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    with open(tmp_path / "record.json") as f:
        record = json.load(f)
    assert record["ok"] and all(record["checks"].values())
    assert record["shard_rig"]["per_process_decoded"] == [120, 120]
    assert record["stream_epoch"]["images"] == 240
    assert record["eval_leg"]["images"] == 60
    assert os.listdir(tmp_path / "synthetic_stream_smoke" / "train")


def test_loader_bench_runs_each_configuration(tmp_path, capsys):
    summary = loader_bench.main(
        ["--root_path", str(tmp_path), "--dataset_path", str(tmp_path / "h"),
         "--network", "tiny", "--limit", "8", "--threads", "0", "2",
         "--procs", "1", "--cache_dir", str(tmp_path / "cache")])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"event": "setup", "images": 8,
                        "host_cores": os.cpu_count(), "bucket": [240, 320]}
    assert [x["config"] for x in lines[1:-1]] == ["threads=0", "threads=2",
                                                  "procs=1"]
    assert lines[-1] == summary
    assert all(v["cold"] > 0 and v["warm"] > 0
               for v in summary["configs"].values())
    assert sorted(os.listdir(tmp_path / "cache")) == ["procs1", "threads0",
                                                      "threads2"]
