"""The checkpoint demo held against the JAX package's on the CPU.

Both packages' ``tools/demo.py — demo`` read one port checkpoint of the
tiny network (random weights from a seed, the JAX layout) and one image
file, and must give the same detections within the tolerance
``tests/test_torch_eval.py`` holds ``test_rcnn`` to: equal classes and
counts, boxes within 1e-2 px, scores within 1e-5 (the frameworks' fp32
conv sums differ in order).  The drawn PNG has the image's size, and the
command line writes it where ``--out`` says.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.tools.demo import demo as j_demo
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core import train as ttrain
from mx_rcnn_tpu_torch.data.image import imwrite_rgb
from mx_rcnn_tpu_torch.tools import demo as tdemo
from mx_rcnn_tpu_torch.utils.checkpoint import save_checkpoint

torch.set_num_threads(1)

_TOY = dict(dataset__num_classes=4, bucket__scale=128, bucket__max_size=160,
            bucket__shapes=((128, 160), (160, 128)),
            test__rpn_pre_nms_top_n=256, test__rpn_post_nms_top_n=32)
_VIS = 0.05   # random weights score ~1/num_classes


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("demo")
    cfg = generate_config("tiny", "synthetic", **_TOY)
    prefix = str(tmp / "e2e")
    save_checkpoint(prefix, 1, ttrain.setup_training(cfg, "cpu", seed=4))
    img = tdemo.synthetic_images(1, seed=3, size=(150, 200))[0]
    path = str(tmp / "street.png")
    imwrite_rgb(path, img)
    return tmp, cfg, prefix, path, img.shape


def test_demo_equals_jax_and_draws_the_image_size(setup):
    tmp, cfg, prefix, path, shape = setup
    jcfg = j_generate_config("tiny", "synthetic", **_TOY)
    want = j_demo(jcfg, prefix=prefix, epoch=1, image=path,
                  out_path=str(tmp / "j.png"), vis_thresh=_VIS)
    got = tdemo.demo(cfg, prefix=prefix, epoch=1, image=path,
                     out_path=str(tmp / "t.png"), vis_thresh=_VIS,
                     device="cpu")
    assert sorted(got) == sorted(want)
    assert sum(len(v) for v in got.values()) > 0
    for c in want:
        assert got[c].shape == want[c].shape, c
        np.testing.assert_allclose(got[c][:, :4], want[c][:, :4], rtol=0,
                                   atol=1e-2)
        np.testing.assert_allclose(got[c][:, 4], want[c][:, 4], rtol=0,
                                   atol=1e-5)
    with Image.open(tmp / "t.png") as im:
        assert im.size == (shape[1], shape[0]) and im.mode == "RGB"


def test_demo_cli_writes_out(setup, capsys):
    tmp, _, prefix, path, shape = setup
    out = str(tmp / "cli.png")
    dets = tdemo.main([
        "--device", "cpu", "--network", "tiny", "--dataset", "synthetic",
        "--prefix", prefix, "--epoch", "1", "--image", path, "--out", out,
        "--vis_thresh", str(_VIS)] + sum(
        (["--set", f"{k}={v}"] for k, v in _TOY.items()), []))
    assert len(dets) == 1 and sum(len(v) for v in dets[0].values()) > 0
    with Image.open(out) as im:
        assert im.size == (shape[1], shape[0])
    assert "wrote the annotated image" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--epoch"):
        tdemo.main(["--device", "cpu", "--prefix", prefix])


def test_draw_detections_keeps_the_size():
    img = np.zeros((40, 60, 3), np.uint8)
    out = tdemo.draw_detections(
        img, {1: np.array([[5, 5, 30, 20, 0.9]], np.float32),
              2: np.array([[0, 0, 80, 50, 0.5]], np.float32)}, ["bg", "a"])
    assert out.shape == img.shape and out.dtype == np.uint8
    assert out.any() and not img.any()
