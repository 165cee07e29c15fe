"""The PyTorch port's detection forward held against the JAX model.

Weights cross with the bridge (``mx_rcnn_tpu_torch.utils.bridge``): flax
variables as nested dicts of numpy arrays go into the port's state_dict,
and the same numpy images go through both forwards on the CPU in fp32.

Tolerances come from the order of fp32 summation: torch's CPU convolutions
and XLA's sum in different orders, so features differ by a few ulps per
layer.  Through ResNet-101 that reaches a relative 2e-6 at the backbone's
output; the decoded rois carry it times the box size (hundreds of pixels),
so rois are held at atol 1e-2 px -- far below the pixels that separate two
distinct proposals, which ``roi_valid`` equality and the per-slot check
pin -- and ``cls_prob`` and the deltas at atol = rtol = 1e-4.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.core import tester as jtester
from mx_rcnn_tpu.models import build_model as j_build_model
from mx_rcnn_tpu_torch.config import generate_config, parse_set_overrides
from mx_rcnn_tpu_torch.core import tester as ttester
from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
from mx_rcnn_tpu_torch.utils.bridge import from_flax, to_flax

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core would crowd out the other workers
torch.set_num_threads(1)

_SMALL = {
    # the tiny network on a 128x160 canvas
    "tiny": (dict(test__rpn_pre_nms_top_n=256, test__rpn_post_nms_top_n=32),
             (128, 160)),
    # ResNet-101 at the flagship smoke shape, post-NMS cut to 16 rois
    "resnet101": (dict(test__rpn_pre_nms_top_n=256,
                       test__rpn_post_nms_top_n=16,
                       network__compute_dtype="float32"), (224, 320)),
}


def _configs(network):
    overrides, _ = _SMALL[network]
    return (j_generate_config(network, "PascalVOC", **overrides),
            generate_config(network, "PascalVOC", **overrides))


def _tree_items(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tree_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _exercised_variables(model, seed):
    """The port's random init as a flax tree, with the residual branches
    switched on: ``conv3`` (zero at init) and the RPN classifier get
    non-zero numpy weights, small enough that activations stay O(10)."""
    rng = np.random.RandomState(seed)
    variables = to_flax(model.state_dict())
    for path, arr in _tree_items(variables["params"]):
        if path[-1] != "kernel":
            continue
        if "conv3" in path:
            std = 0.5 / np.sqrt(arr.shape[2])
        elif "rpn_cls_score" in path:
            std = 0.5
        else:
            continue
        node = variables["params"]
        for key in path[:-1]:
            node = node[key]
        node["kernel"] = (rng.standard_normal(arr.shape) * std).astype(
            np.float32)
    return variables


def _forward_pair(network, variables, images, im_info):
    jcfg, tcfg = _configs(network)
    jout = jax.device_get(j_build_model(jcfg).apply(
        variables, jnp.asarray(images), jnp.asarray(im_info)))
    model = build_model(tcfg, device="cpu")
    model.load_state_dict(from_flax(variables), strict=True)
    with torch.inference_mode():
        tout = model(torch.from_numpy(images), torch.from_numpy(im_info))
    return [np.asarray(x) for x in jout], [t.numpy() for t in tout]


def _assert_forward_close(jout, tout, roi_atol):
    rois_j, valid_j, prob_j, deltas_j = jout
    rois_t, valid_t, prob_t, deltas_t = tout
    np.testing.assert_array_equal(valid_t, valid_j)
    assert valid_j.sum() > 0
    np.testing.assert_allclose(rois_t, rois_j, rtol=0, atol=roi_atol)
    np.testing.assert_allclose(prob_t, prob_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(deltas_t, deltas_j, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("network", ["tiny", "resnet101"])
def test_bridge_round_trip_and_flax_layout(network):
    """to_flax(port) has exactly the flax model's tree (names and shapes,
    from ``eval_shape`` of its init), and from_flax inverts it."""
    jcfg, tcfg = _configs(network)
    _, (h, w) = _SMALL[network]
    images = jnp.zeros((1, h, w, 3), jnp.float32)
    im_info = jnp.array([[h, w, 1.0]], jnp.float32)
    shapes = jax.eval_shape(j_build_model(jcfg).init, jax.random.PRNGKey(0),
                            images, im_info)
    model = build_model(tcfg, device="cpu")
    tree = to_flax(model.state_dict())
    want = {p: tuple(s.shape) for p, s in _tree_items(
        {"params": shapes["params"],
         "batch_stats": shapes.get("batch_stats", {})})}
    got = {p: a.shape for p, a in _tree_items(tree)}
    assert got == want
    back = from_flax(tree)
    sd = model.state_dict()
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v.to(torch.float32),
                                   rtol=0, atol=0)


def test_tiny_forward_matches_jax():
    """Weights from the flax model's own init cross the bridge."""
    jcfg, _ = _configs("tiny")
    rng = np.random.RandomState(0)
    images = rng.uniform(-120, 130, (2, 128, 160, 3)).astype(np.float32)
    im_info = np.array([[128, 160, 1.0], [100, 140, 0.8]], np.float32)
    variables = jax.device_get(jax.jit(j_build_model(jcfg).init)(
        jax.random.PRNGKey(0), images, im_info))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    rpn = variables["params"]["rpn"]["rpn_cls_score"]
    rpn["kernel"] = (rng.standard_normal(rpn["kernel"].shape)
                     * 0.5).astype(np.float32)
    jout, tout = _forward_pair("tiny", variables, images, im_info)
    _assert_forward_close(jout, tout, roi_atol=1e-3)


def test_resnet101_forward_matches_jax():
    _, tcfg = _configs("resnet101")
    variables = _exercised_variables(build_model(tcfg, device="cpu", seed=3),
                                     seed=3)
    rng = np.random.RandomState(1)
    images = rng.uniform(-1, 1, (1, 224, 320, 3)).astype(np.float32)
    im_info = np.array([[224, 320, 1.0]], np.float32)
    jout, tout = _forward_pair("resnet101", variables, images, im_info)
    _assert_forward_close(jout, tout, roi_atol=1e-2)


def _postprocess_inputs(seed, n=2, r=40, c=5):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 200, (n, r, 2))
    wh = rng.uniform(8, 120, (n, r, 2))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[:, ::7] = rois[:, :1]                       # duplicate boxes
    valid = rng.uniform(size=(n, r)) > 0.15
    logits = rng.standard_normal((n, r, c)) * 2
    prob = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    deltas = (rng.standard_normal((n, r, 4 * c)) * 0.5).astype(np.float32)
    im_info = np.array([[256, 320, 1.25], [240, 300, 0.9]], np.float32)[:n]
    return (rois, valid, prob.astype(np.float32), deltas, im_info,
            im_info[:, 2].copy())


@pytest.mark.parametrize("seed", [0, 1])
def test_postprocess_and_detections_match(seed):
    """Same decode arithmetic: boxes agree to the one-ulp ``exp``
    difference between XLA and torch (atol 1e-3 px); scores and the
    per-class keep masks are equal, and so are the detections."""
    rois, valid, prob, deltas, im_info, scales = _postprocess_inputs(seed)
    cfg = generate_config("tiny", "PascalVOC")
    jcfg = j_generate_config("tiny", "PascalVOC")
    c = prob.shape[-1]
    kw = dict(nms_thresh=0.3, score_thresh=0.05)
    jstds, jmeans = jtester.tiled_bbox_stats(jcfg, c)
    want = [np.asarray(x) for x in jtester._postprocess_batch(
        *(jnp.asarray(a) for a in (rois, valid, prob, deltas, im_info,
                                   scales)), jstds, jmeans, **kw)]
    stds, means = ttester.tiled_bbox_stats(cfg, c)
    np.testing.assert_array_equal(stds.numpy(), np.asarray(jstds))
    got = [t.numpy() for t in ttester._postprocess_batch(
        *(torch.from_numpy(a) for a in (rois, valid, prob, deltas, im_info,
                                        scales)), stds, means, **kw)]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert want[2].sum() > 5
    for j in range(rois.shape[0]):
        dj = jtester.detections_from_keep(*want, j)
        dt = ttester.detections_from_keep(*got, j)
        assert dj.keys() == dt.keys()
        for k in dj:
            np.testing.assert_allclose(dt[k], dj[k], rtol=0, atol=1e-3)


@pytest.mark.parametrize("network,dataset", [
    ("resnet101", "PascalVOC"), ("resnet50", "coco"), ("tiny", "synthetic")])
def test_config_presets_agree_with_jax(network, dataset):
    """Every field of the port's config equals the JAX package's."""
    ours = generate_config(network, dataset)
    theirs = j_generate_config(network, dataset)
    for section in ("train", "test", "network", "dataset", "default",
                    "bucket"):
        node = getattr(ours, section)
        for f in dataclasses.fields(node):
            assert getattr(node, f.name) == \
                getattr(getattr(theirs, section), f.name), (section, f.name)


def test_set_overrides_parse_like_the_cli():
    cfg = generate_config("tiny", "PascalVOC", **parse_set_overrides(
        ["test__rpn_post_nms_top_n=12", "bucket__shapes=[[64,96],[96,64]]",
         "network__compute_dtype=bfloat16"]))
    assert cfg.test.rpn_post_nms_top_n == 12
    assert cfg.bucket.shapes == ((64, 96), (96, 64))
    with pytest.raises(ValueError):
        generate_config("tiny", "PascalVOC", network__compute_dtype="bf16")


def test_demo_runs_on_cpu():
    """``tools/demo.py --device cpu --synthetic 2 --network tiny``, in its
    own interpreter as a user would run it."""
    out = subprocess.run(
        [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.demo", "--device",
         "cpu", "--synthetic", "2", "--network", "tiny", "--batch", "2",
         "--vis_thresh", "0.0", "--set", "bucket__scale=160",
         "--set", "bucket__max_size=224",
         "--set", "bucket__shapes=[[160,224],[224,160]]"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "synthetic0:" in out.stdout and "synthetic1:" in out.stdout
    assert "device=cpu" in out.stdout
