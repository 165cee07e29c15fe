"""The port's VOC and COCO readers held against the JAX package's.

The datasets are generated in the real on-disk layouts from the JAX
package's scenes (``tests/test_e2e_formats.py — _render_images``: coloured
rectangles of three classes on 128x160 noise): a VOCdevkit (JPEGs, XML
with ``difficult`` flags, ``ImageSets/Main``) and a COCO tree (instances
json with non-contiguous category ids, crowd and zero-area boxes, an
image without annotations), each with a few portrait (transposed) images
so both buckets are used.  Held: the roidbs record for record, each
package reading the other's gt_roidb pickle, the detection files byte
for byte, the evaluators' numbers (VOC APs to 1e-12, COCO's exactly),
'+'-joined train sets, and ``tools/train.py`` → ``tools/test.py`` on the
CPU against the JAX package's ``test_rcnn`` on the same checkpoint.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.data import COCODataset as JCOCO
from mx_rcnn_tpu.data import PascalVOC as JVOC
from mx_rcnn_tpu.data import load_gt_roidb as j_load_gt_roidb
from mx_rcnn_tpu.tools.test import test_rcnn as j_test_rcnn
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.data import COCODataset, PascalVOC, load_gt_roidb
from mx_rcnn_tpu_torch.tools import test as test_cli
from mx_rcnn_tpu_torch.tools import train as train_cli
from tests.test_e2e_formats import _render_images

torch.set_num_threads(1)

# the tiny network on the scenes' 128x160 canvas (tests/conftest.py —
# shrink_tiny_cfg's numbers, flips kept)
SMALL = dict(train__rpn_pre_nms_top_n=256, train__rpn_post_nms_top_n=64,
             train__batch_rois=32, train__max_gt_boxes=8,
             test__rpn_pre_nms_top_n=256, test__rpn_post_nms_top_n=32,
             bucket__scale=128, bucket__max_size=160,
             bucket__shapes=((128, 160), (160, 128)))
COCO_CATS = ("dog", "person", "car", "cat", "bird")   # the last two unused


def scenes(seed: int = 0, portrait_every: int = 4):
    """The JAX package's scenes, every ``portrait_every``-th transposed
    (boxes too): [(RGB image, [(name, (x1, y1, x2, y2))])]."""
    out = []
    for i, (img, objs) in enumerate(_render_images(np.random.RandomState(
            seed))):
        if i % portrait_every == portrait_every - 1:
            img = np.ascontiguousarray(img.transpose(1, 0, 2))
            objs = [(n, (b[1], b[0], b[3], b[2])) for n, b in objs]
        out.append((img, objs))
    return out


def write_voc(root: str, scenes_, sets) -> str:
    """A VOCdevkit under ``root``: VOC2007 JPEGs, XML (1-based boxes,
    every fifth object ``difficult``) and ``ImageSets/Main/<set>.txt``
    for each ``sets`` name → scene indices.  Returns the devkit path."""
    voc = os.path.join(root, "VOCdevkit", "VOC2007")
    for sub in ("ImageSets/Main", "Annotations", "JPEGImages"):
        os.makedirs(os.path.join(voc, sub), exist_ok=True)
    k = 0
    for i, (img, objs) in enumerate(scenes_):
        idx = f"{i:06d}"
        cv2.imwrite(os.path.join(voc, "JPEGImages", idx + ".jpg"),
                    img[:, :, ::-1])
        xml = []
        for name, b in objs:
            xml.append(f"<object><name>{name}</name><difficult>"
                       f"{int(k % 5 == 2)}</difficult><bndbox>"
                       f"<xmin>{b[0] + 1}</xmin><ymin>{b[1] + 1}</ymin>"
                       f"<xmax>{b[2] + 1}</xmax><ymax>{b[3] + 1}</ymax>"
                       f"</bndbox></object>")
            k += 1
        h, w = img.shape[:2]
        with open(os.path.join(voc, "Annotations", idx + ".xml"), "w") as f:
            f.write(f"<annotation><size><width>{w}</width><height>{h}"
                    f"</height><depth>3</depth></size>{''.join(xml)}"
                    f"</annotation>")
    for name, ids in sets.items():
        with open(os.path.join(voc, "ImageSets", "Main", name + ".txt"),
                  "w") as f:
            f.write("".join(f"{i:06d}\n" for i in ids))
    return os.path.join(root, "VOCdevkit")


def write_coco(root: str, scenes_, image_set: str) -> str:
    """A COCO tree under ``root``: ``<image_set>/`` JPEGs and
    ``annotations/instances_<image_set>.json`` (category ids 7, 14, ...;
    every fourth annotation a crowd, one zero-area box, the last image
    without annotations).  Returns the dataset path."""
    ds = os.path.join(root, "coco")
    os.makedirs(os.path.join(ds, "annotations"), exist_ok=True)
    os.makedirs(os.path.join(ds, image_set), exist_ok=True)
    cats = [{"id": 7 * (i + 1), "name": n} for i, n in enumerate(COCO_CATS)]
    cat_of = {c["name"]: c["id"] for c in cats}
    images, anns = [], []
    for i, (img, objs) in enumerate(scenes_):
        fname = f"{i:012d}.jpg"
        cv2.imwrite(os.path.join(ds, image_set, fname), img[:, :, ::-1])
        h, w = img.shape[:2]
        images.append({"id": 100 + i, "file_name": fname, "width": w,
                       "height": h})
        if i == len(scenes_) - 1:
            continue
        for name, (x1, y1, x2, y2) in objs:
            bw, bh = x2 - x1 + 1, y2 - y1 + 1
            anns.append({"id": len(anns) + 1, "image_id": 100 + i,
                         "category_id": cat_of[name],
                         "bbox": [float(x1), float(y1), float(bw),
                                  float(bh)],
                         "area": float(bw * bh),
                         "iscrowd": int(len(anns) % 4 == 3)})
    anns.append({"id": len(anns) + 1, "image_id": 100, "category_id": 7,
                 "bbox": [5.0, 5.0, 0.0, 0.0], "area": 0.0, "iscrowd": 0})
    with open(os.path.join(ds, "annotations",
                           f"instances_{image_set}.json"), "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": cats}, f)
    return ds


def assert_same_roidb(got, want) -> None:
    """Equal records: the same keys, equal arrays of equal dtypes, equal
    scalars and paths."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    """The devkit: 12 trainval and 8 test images."""
    root = str(tmp_path_factory.mktemp("voc"))
    devkit = write_voc(root, scenes()[:20], {"trainval": range(12),
                                             "test": range(12, 20)})
    return root, devkit


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """The COCO tree: 12 ``minitrain`` and 8 ``minival`` images."""
    root = str(tmp_path_factory.mktemp("coco"))
    s = scenes()
    write_coco(root, s[:12], "minitrain")
    return root, write_coco(root, s[12:20], "minival")


def _cfgs(network, dataset, root, path, **kw):
    over = dict(SMALL, dataset__root_path=root, dataset__dataset_path=path,
                **kw)
    return (j_generate_config(network, dataset, **over),
            generate_config(network, dataset, **over))


def _voc_cfgs(root, devkit, **kw):
    return _cfgs("tiny", "PascalVOC", root, devkit,
                 dataset__image_set="2007_trainval",
                 dataset__test_image_set="2007_test", **kw)


def _coco_cfgs(root, path, **kw):
    return _cfgs("tiny", "coco", root, path, dataset__num_classes=6,
                 dataset__image_set="minitrain",
                 dataset__test_image_set="minival", **kw)


# ---- the roidbs ------------------------------------------------------------

@pytest.mark.parametrize("use_difficult", [False, True])
@pytest.mark.parametrize("sset", ["2007_trainval", "2007_test"])
def test_voc_records_equal_jax(voc, tmp_path, use_difficult, sset):
    _, devkit = voc
    ours = PascalVOC(sset, str(tmp_path / "t"), devkit,
                     use_difficult=use_difficult)
    theirs = JVOC(sset, str(tmp_path / "j"), devkit,
                  use_difficult=use_difficult)
    assert ours.name == theirs.name and ours.classes == theirs.classes
    assert ours.image_index == theirs.image_index
    assert_same_roidb(ours.gt_roidb(), theirs.gt_roidb())
    for index in ours.image_index:
        g, w = ours._gt_for_eval(index), theirs._gt_for_eval(index)
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    boxes = sum(len(r["boxes"]) for r in ours.gt_roidb())
    every = sum(len(ours._gt_for_eval(i)["boxes"]) for i in ours.image_index)
    assert (boxes == every) == use_difficult


def test_coco_records_equal_jax(coco, tmp_path):
    _, path = coco
    for sset in ("minitrain", "minival"):
        ours = COCODataset(sset, str(tmp_path / "t"), path)
        theirs = JCOCO(sset, str(tmp_path / "j"), path)
        assert ours.classes == theirs.classes
        assert ours.cat_to_class == theirs.cat_to_class == {
            7 * (i + 1): i + 1 for i in range(5)}
        assert ours.image_index == theirs.image_index
        assert_same_roidb(ours.gt_roidb(), theirs.gt_roidb())
    anns = [a for v in ours.anns_by_image.values() for a in v]
    crowds = sum(a["iscrowd"] for a in anns)
    kept = sum(len(r["boxes"]) for r in ours.gt_roidb())
    assert crowds and kept == len(anns) - crowds - 1   # and zero-area


@pytest.mark.parametrize("dataset", ["PascalVOC", "coco"])
@pytest.mark.parametrize("training", [True, False])
def test_load_gt_roidb_equals_jax(voc, coco, tmp_path, dataset, training):
    """Training roidbs drop images without gt and append flipped copies;
    eval roidbs keep every image unflipped."""
    make = _voc_cfgs if dataset == "PascalVOC" else _coco_cfgs
    _, path = voc if dataset == "PascalVOC" else coco
    jcfg, _ = make(str(tmp_path / "j"), path)
    _, cfg = make(str(tmp_path / "t"), path)
    jimdb, jroidb = j_load_gt_roidb(jcfg, training=training)
    imdb, roidb = load_gt_roidb(cfg, training=training)
    assert type(imdb).__name__ == type(jimdb).__name__
    assert_same_roidb(roidb, jroidb)
    flipped = sum(r["flipped"] for r in roidb)
    assert flipped == (len(roidb) // 2 if training else 0)
    with_gt = sum(len(r["boxes"]) > 0 for r in imdb.gt_roidb())
    assert len(roidb) == (2 * with_gt if training else imdb.num_images)
    assert with_gt < imdb.num_images or dataset == "PascalVOC"


def test_plus_joined_train_set_equals_jax(voc, tmp_path):
    _, devkit = voc
    jcfg, _ = _voc_cfgs(str(tmp_path / "j"), devkit)
    _, cfg = _voc_cfgs(str(tmp_path / "t"), devkit)
    sets = "2007_trainval+2007_test"
    jimdb, jroidb = j_load_gt_roidb(jcfg, image_set=sets, training=True)
    imdb, roidb = load_gt_roidb(cfg, image_set=sets, training=True)
    assert imdb.name == jimdb.name == "voc_2007_trainval"
    assert_same_roidb(roidb, jroidb)
    with_gt = sum(len(r["boxes"]) > 0 for r in PascalVOC(
        "2007_trainval", str(tmp_path / "t"), devkit).gt_roidb() + PascalVOC(
        "2007_test", str(tmp_path / "t"), devkit).gt_roidb())
    assert len(roidb) == 2 * with_gt > 20
    with pytest.raises(ValueError, match="train-only"):
        load_gt_roidb(cfg, image_set=sets, training=False)


@pytest.mark.parametrize("dataset", ["PascalVOC", "coco"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_gt_roidb_cache(voc, coco, tmp_path,
                                                      dataset, writer):
    """The same file name under ``<root>/cache``; the reader loads the
    writer's pickle (it would parse the annotations otherwise) and gets
    the same records."""
    _, path = voc if dataset == "PascalVOC" else coco
    root = str(tmp_path)
    if dataset == "PascalVOC":
        ours, theirs = (PascalVOC("2007_trainval", root, path),
                        JVOC("2007_trainval", root, path))
    else:
        ours, theirs = (COCODataset("minitrain", root, path),
                        JCOCO("minitrain", root, path))
    first, second = (ours, theirs) if writer == "port" else (theirs, ours)
    want = first.gt_roidb()
    cache = os.path.join(root, "cache", f"{first.name}_gt_roidb.pkl")
    assert os.listdir(os.path.join(root, "cache")) == [
        os.path.basename(cache)]
    with open(cache, "rb") as f:
        marked = pickle.load(f)
    marked[0] = dict(marked[0], marker=True)
    with open(cache, "wb") as f:
        pickle.dump(marked, f, pickle.HIGHEST_PROTOCOL)
    got = second.gt_roidb()
    assert got[0].pop("marker") is True
    assert_same_roidb(got, want)


# ---- detection files and evaluators ----------------------------------------

def seeded_all_boxes(roidb, num_classes: int, seed: int, xyxy_plus1=False):
    """all_boxes[class][image]: jittered copies of each gt box (some
    duplicated, scores on a few levels so some tie) and random misses."""
    rng = np.random.RandomState(seed)
    out = [[np.zeros((0, 5), np.float32) for _ in roidb]
           for _ in range(num_classes)]
    for i, rec in enumerate(roidb):
        for c in range(1, num_classes):
            rows = []
            for b in rec["boxes"][rec["gt_classes"] == c]:
                for _ in range(rng.randint(0, 3)):
                    rows.append(np.r_[b + rng.normal(0, 3, 4) + xyxy_plus1,
                                      np.round(rng.uniform(), 2)])
            for _ in range(rng.randint(0, 3)):
                x, y = rng.uniform(0, 100, 2)
                rows.append([x, y, x + rng.uniform(8, 60),
                             y + rng.uniform(8, 60), rng.uniform()])
            if rows:
                out[c][i] = np.asarray(rows, np.float32)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_voc_detection_files_and_aps_equal_jax(voc, tmp_path, seed):
    root, devkit = voc
    ours = PascalVOC("2007_test", root, devkit)
    theirs = JVOC("2007_test", root, devkit)
    all_boxes = seeded_all_boxes(ours.gt_roidb(), 21, seed)
    got = ours.evaluate_detections(all_boxes, str(tmp_path / "t"))
    want = theirs.evaluate_detections(all_boxes, str(tmp_path / "j"))
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, k
    assert got["mAP"] > 0
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names
    assert len(names) == 20 and "comp4_det_test_dog.txt" in names
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name


@pytest.mark.parametrize("seed", range(4))
def test_coco_results_and_numbers_equal_jax(coco, tmp_path, seed):
    root, path = coco
    ours = COCODataset("minival", root, path)
    theirs = JCOCO("minival", root, path)
    all_boxes = seeded_all_boxes(ours.gt_roidb(), 6, seed, xyxy_plus1=True)
    got = ours.evaluate_detections(all_boxes, str(tmp_path / "t"))
    want = theirs.evaluate_detections(all_boxes, str(tmp_path / "j"))
    np.testing.assert_equal(got, want)
    assert got["AP"] > 0
    name = "detections_results.json"
    assert (tmp_path / "t" / name).read_bytes() == \
        (tmp_path / "j" / name).read_bytes()


# ---- tools/train.py → tools/test.py against the JAX package ---------------

def _cli_set(**kw):
    return [f"--set={k}={v}" for k, v in dict(SMALL, **kw).items()]


@pytest.mark.parametrize("dataset", ["PascalVOC", "coco"])
def test_train_then_test_cli_equals_jax(voc, coco, tmp_path, dataset):
    """One epoch of ``tools/train.py --device cpu`` over the layout (12
    images and their flips, 6 steps at batch 2, through the cache) → a
    checkpoint → ``tools/test.py`` over the test set, and the JAX
    package's ``test_rcnn`` on the same checkpoint: equal counts per
    (class, image), boxes within 1e-2 px and scores within 1e-5
    (``tests/test_torch_eval.py``'s tolerances: the two frameworks' fp32
    conv sums differ in order), and equal numbers; the detection files
    are the same set."""
    root, path = voc if dataset == "PascalVOC" else coco
    if dataset == "PascalVOC":
        sets = ["--image_set", "2007_trainval"]
        test_set, extra = "2007_test", {}
        jcfg, _ = _voc_cfgs(root, path)
    else:
        sets = ["--image_set", "minitrain"]
        test_set, extra = "minival", {"dataset__num_classes": 6}
        jcfg, _ = _coco_cfgs(root, path)
    common = ["--device", "cpu", "--network", "tiny", "--dataset", dataset,
              "--root_path", root, "--dataset_path", path] + _cli_set(**extra)
    prefix = str(tmp_path / "m")
    train_cli.main(common + sets + ["--batch_images", "2", "--end_epoch",
                                    "1", "--lr", "0.01", "--prefix", prefix])
    got = test_cli.main(common + [
        "--image_set", test_set, "--prefix", prefix, "--epoch", "1",
        "--out_dir", str(tmp_path / "t"), "--save_dets",
        str(tmp_path / "t.pkl")])
    want = j_test_rcnn(jcfg, prefix=prefix, epoch=1, image_set=test_set,
                       out_dir=str(tmp_path / "j"), verbose=False,
                       save_dets=str(tmp_path / "j.pkl"))
    with open(tmp_path / "t.pkl", "rb") as f:
        t = pickle.load(f)
    with open(tmp_path / "j.pkl", "rb") as f:
        j = pickle.load(f)
    assert t["classes"] == list(j["classes"])
    total = 0
    for c, (tc, jc) in enumerate(zip(t["all_boxes"], j["all_boxes"])):
        for i, (g, w) in enumerate(zip(tc, jc)):
            assert g.shape == w.shape, (c, i)
            np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=1e-2)
            np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=0, atol=1e-5)
            total += len(g)
    assert total > 0
    assert got.keys() == want.keys()
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            assert got[k] == pytest.approx(want[k], abs=1e-6), k
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j"))


def test_real_layout_entry_points_default_to_the_card(voc, coco):
    """Without ``--device cpu`` the CLIs raise without a card, before they
    read the dataset or a checkpoint."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    for dataset, (root, path) in (("PascalVOC", voc), ("coco", coco)):
        args = ["--network", "tiny", "--dataset", dataset, "--root_path",
                root, "--dataset_path", path]
        with pytest.raises(RuntimeError, match="CUDA"):
            train_cli.main(args + ["--steps", "1"])
        with pytest.raises(RuntimeError, match="CUDA"):
            test_cli.main(args + ["--prefix", "/nonexistent/m", "--epoch",
                                  "1"])
