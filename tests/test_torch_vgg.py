"""VGG16 at full width, held against the JAX package's on the CPU.

One set of random weights (the port's seeded init, 137.1 M parameters of
which fc6 holds 102.8 M) crosses the bridge once per module; the same
numpy inputs go through both packages in fp32 on a small 96x128 image.

Tolerances: the two frameworks sum fp32 convolutions and dense layers in
other orders, ~1e-6 relative per layer through 13 convs and fc6's 25,088
inputs, so ``cls_prob``, the deltas and the head's logits are held at
rtol = atol = 1e-4.  The RPN's box regressor is zeroed so that the
proposals are the clipped anchors in both packages: the rois and their
mask are then held equal.
"""

import dataclasses
from collections.abc import Mapping

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.models import build_model as j_build_model
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
from mx_rcnn_tpu_torch.models.vgg import VGGBackbone
from mx_rcnn_tpu_torch.utils.bridge import from_flax, to_flax

torch.set_num_threads(1)

_OVERRIDES = dict(test__rpn_pre_nms_top_n=256, test__rpn_post_nms_top_n=16,
                  network__compute_dtype="float32")
H, W = 96, 128


def _configs():
    return (j_generate_config("vgg", "PascalVOC", **_OVERRIDES),
            generate_config("vgg", "PascalVOC", **_OVERRIDES))


def _tree_items(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _tree_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module")
def vgg():
    """The port's VGG16 test model (seed 0, the RPN box regressor zeroed)
    and the same weights as a flax tree of jax arrays."""
    _, cfg = _configs()
    model = build_model(cfg, device="cpu", seed=0)
    with torch.no_grad():
        model.rpn.rpn_bbox_pred.weight.zero_()
    variables = jax.tree_util.tree_map(jnp.asarray,
                                       to_flax(model.state_dict()))
    return model, variables


def test_vgg_preset_agrees_with_jax():
    """Every field of the port's vgg config equals the JAX package's."""
    ours, theirs = generate_config("vgg"), j_generate_config("vgg")
    for section in ("train", "test", "network", "dataset", "default",
                    "bucket"):
        node = getattr(ours, section)
        for f in dataclasses.fields(node):
            assert getattr(node, f.name) == \
                getattr(getattr(theirs, section), f.name), (section, f.name)
    assert ours.network.rcnn_pooled_size == (7, 7)


def test_bridge_round_trip_and_flax_layout(vgg):
    """Both directions at full width: the flax VGG16's own random init
    (fc6's kernel is (25088, 4096)) → from_flax has the port's names and
    shapes, and to_flax gives back every leaf bit for bit; the port's
    init → to_flax has the flax tree's names and shapes, and from_flax
    gives back every tensor."""
    model, _ = vgg
    jcfg, _ = _configs()
    init = jax.jit(j_build_model(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)),
        jnp.array([[H, W, 1.0]]))
    flax_tree = {"params": jax.tree_util.tree_map(np.asarray, init["params"]),
                 "batch_stats": {}}
    del init
    leaves = dict(_tree_items(flax_tree))
    assert leaves[("params", "head", "fc6", "kernel")].shape == (
        7 * 7 * 512, 4096)
    assert sum(p[1] == "backbone" for p in leaves) == 2 * 13
    sd = model.state_dict()
    from_init = from_flax(flax_tree)
    assert {k: v.shape for k, v in from_init.items()} == \
        {k: v.shape for k, v in sd.items()}
    back = dict(_tree_items(to_flax(from_init)))
    del from_init, flax_tree
    assert back.keys() == leaves.keys()
    for path, arr in leaves.items():
        np.testing.assert_array_equal(back[path], arr, err_msg=str(path))
    del back

    tree = to_flax(sd)
    assert {p: a.shape for p, a in _tree_items(tree)} == \
        {p: a.shape for p, a in leaves.items()}
    del leaves
    back = from_flax(tree)
    del tree
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_backbone_stride_and_floor_pooling():
    """Four 2x2 VALID pools, no pool5: stride 16, odd extents floored."""
    x = torch.zeros(1, 3, 100, 70)
    assert VGGBackbone()(x).shape == (1, 512, 100 // 16, 70 // 16)


def test_test_forward_matches_jax(vgg):
    """The whole test forward at batch 2: equal rois and roi_valid,
    cls_prob and deltas within 1e-4."""
    model, variables = vgg
    jcfg, _ = _configs()
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (2, H, W, 3)).astype(np.uint8)
    im_info = np.array([[H, W, 1.0], [80, 112, 0.8]], np.float32)
    want = jax.device_get(jax.jit(j_build_model(jcfg).apply)(
        variables, jnp.asarray(images), jnp.asarray(im_info)))
    with torch.inference_mode():
        got = [t.numpy() for t in model(torch.from_numpy(images),
                                        torch.from_numpy(im_info))]
    rois_j, valid_j, prob_j, deltas_j = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got[1], valid_j)
    assert valid_j.sum() > 0
    np.testing.assert_array_equal(got[0], rois_j)
    np.testing.assert_allclose(got[2], prob_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[3], deltas_j, rtol=1e-4, atol=1e-4)


def _jax_head_with_masks(jmodel, variables, pooled, key):
    """The JAX ``roi_head(train=True)`` eagerly, recording each dropout's
    input and output through ``flax.linen.intercept_methods``."""
    seen = []

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, fnn.Dropout) and \
                context.method_name == "__call__":
            seen.append((np.asarray(args[0]), np.asarray(out)))
        return out

    with fnn.intercept_methods(record):
        out = jmodel.apply(variables, jnp.asarray(pooled), True,
                           method=jmodel.roi_head,
                           rngs={"dropout": key})
    return [np.asarray(o) for o in out], seen


@pytest.mark.parametrize("seed", [0, 1])
def test_roi_head_in_train_mode_matches_jax_under_its_dropout(vgg, seed):
    """fc6 → dropout → fc7 → dropout with flax's masks: an element is
    dropped where its output is 0 and its input is not; the port gets
    uniforms that keep exactly the others (an element whose input is 0
    is 0 either way).  Logits and deltas within 1e-4, about half of each
    dropout's inputs dropped, and with other uniforms the outputs
    differ."""
    model, variables = vgg
    jmodel = j_build_model(_configs()[0])
    rng = np.random.RandomState(seed)
    pooled = rng.standard_normal((16, 7, 7, 512)).astype(np.float32)
    (cls_j, box_j), seen = _jax_head_with_masks(
        jmodel, variables, pooled, jax.random.PRNGKey(seed))
    assert len(seen) == 2
    uniforms = []
    for x, y in seen:
        dropped = (y == 0) & (x != 0)
        assert 0.4 < dropped.sum() / max((x != 0).sum(), 1) < 0.6
        uniforms.append(torch.from_numpy(
            np.where(dropped, 0.75, 0.25).astype(np.float32)))
    with torch.no_grad():
        cls_t, box_t = model.roi_head(torch.from_numpy(pooled),
                                      tuple(uniforms))
        np.testing.assert_allclose(cls_t.numpy(), cls_j, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(box_t.numpy(), box_j, rtol=1e-4,
                                   atol=1e-4)
        other = model.roi_head(torch.from_numpy(pooled),
                               tuple(1 - u for u in uniforms))[0]
        assert not np.allclose(other.numpy(), cls_j, rtol=1e-4, atol=1e-4)
        # one uniform per site the head names, in the draws' site order
        assert model.head.dropout_sites == ("dropout_fc6", "dropout_fc7")
        with pytest.raises(ValueError, match="dropout"):
            model.roi_head(torch.from_numpy(pooled), tuple(uniforms[:1]))
        # test mode has no dropout: the head's plain forward
        plain = model.roi_head(torch.from_numpy(pooled))[0]
        np.testing.assert_allclose(plain.numpy(), np.asarray(
            jmodel.apply(variables, jnp.asarray(pooled), False,
                         method=jmodel.roi_head)[0]),
            rtol=1e-4, atol=1e-4)
