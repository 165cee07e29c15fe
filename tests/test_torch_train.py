"""The port's training slice held against the JAX package on the CPU.

Weights cross with the bridge, batches come from the port's synthetic
loader (held against the JAX loader here too), and the subsampling draws
are the JAX step's own: :func:`_jax_draws` repeats the key splits of
``core/train.py`` (``fold_in`` by step, ``split`` into the anchor and
RCNN keys, ``split`` per image, then ``split`` into the fg and bg keys of
each target function), so the port's step samples exactly what the JAX
step samples.  Everything runs in fp32.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.core import train as jtrain
from mx_rcnn_tpu.core.optim import make_optimizer as j_make_optimizer
from mx_rcnn_tpu.data.loader import AnchorLoader as JAnchorLoader
from mx_rcnn_tpu.data.synthetic import SyntheticDataset as JSynthetic
from mx_rcnn_tpu.models import build_model as j_build_model
from mx_rcnn_tpu.ops.proposal import propose_batch as j_propose_batch
from mx_rcnn_tpu.ops.targets import proposal_target as j_proposal_target
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core import train as ttrain
from mx_rcnn_tpu_torch.data.loader import AnchorLoader
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
from mx_rcnn_tpu_torch.ops.proposal import propose_batch
from mx_rcnn_tpu_torch.ops.targets import proposal_pool_size, proposal_target
from mx_rcnn_tpu_torch.utils.bridge import from_flax, to_flax

torch.set_num_threads(1)
CPU = torch.device("cpu")

_SMALL = {
    # the tiny network on the synthetic set's 320x416 bucket, batch 2
    "tiny": (dict(train__rpn_pre_nms_top_n=600,
                  train__rpn_post_nms_top_n=100, train__batch_rois=32),
             "synthetic", (320, 400), 2),
    # ResNet-101 at a 224x320 canvas, batch 1
    "resnet101": (dict(train__rpn_pre_nms_top_n=300,
                       train__rpn_post_nms_top_n=64, train__batch_rois=16,
                       network__compute_dtype="float32", bucket__scale=224,
                       bucket__max_size=320,
                       bucket__shapes=((224, 320), (320, 224))),
                  "PascalVOC", (375, 500), 1),
}


def _configs(network):
    overrides, dataset, _, _ = _SMALL[network]
    return (j_generate_config(network, dataset, **overrides),
            generate_config(network, dataset, **overrides))


def _batches(network, count=1, seed=0):
    _, cfg = _configs(network)
    _, _, size, batch = _SMALL[network]
    ds = SyntheticDataset(cfg.dataset.image_set, batch * count,
                          cfg.num_classes, size)
    return list(AnchorLoader(ds.gt_roidb(), cfg, ds.load_image,
                             batch_images=batch, seed=seed))


def _jax_draws(key, n, step=None):
    """``draws`` for the port's step that returns the uniforms the JAX
    step draws: ``fold_in(key, step)`` (train.py:421), ``split`` into
    (k_anchor, k_rcnn) (:222), ``split(k_anchor, n)`` (:114), ``split(
    k_rcnn)`` then ``split(k_prop, n)`` (:141, :158), and inside each
    target function ``kf, kb = split(key_i)``."""
    if step is not None:
        key = jax.random.fold_in(key, step)
    k_anchor, k_rcnn = jax.random.split(key)
    anchor_keys = jax.random.split(k_anchor, n)
    k_prop, _ = jax.random.split(k_rcnn)
    prop_keys = jax.random.split(k_prop, n)

    def draws(site, image, shape):
        base = (anchor_keys if site.startswith("anchor") else prop_keys)[image]
        kf, kb = jax.random.split(base)
        u = jax.random.uniform(kf if site.endswith("fg") else kb, shape)
        return torch.from_numpy(np.array(u))

    return draws


def _tree_items(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tree_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _tree_get(tree, path):
    for k in path:
        tree = tree[getattr(k, "key", k)]
    return tree


def _variables(network, model):
    """The port's random init as a flax tree.  For ResNet-101 the data BN
    scales the input by 0.02 and the zero-initialised ``conv3`` of each
    residual branch gets small non-zero weights, so every unit takes part
    and the activations stay O(1)."""
    variables = to_flax(model.state_dict())
    if network == "resnet101":
        rng = np.random.RandomState(3)
        for path, arr in list(_tree_items(variables["params"])):
            node = _tree_get(variables["params"], path[:-1])
            if "conv3" in path and path[-1] == "kernel":
                node["kernel"] = (rng.standard_normal(arr.shape) * 0.1
                                  / np.sqrt(arr.shape[2])).astype(np.float32)
            elif path[-2] == "bn_data" and path[-1] == "scale":
                node["scale"] = np.full_like(arr, 0.02)
    return variables


def _grads_tree(model):
    """The port's gradients as a flax params tree."""
    sd = {n: p.grad for n, p in model.named_parameters()}
    sd.update({k: v for k, v in model.state_dict().items()
               if "running" in k})
    return to_flax(sd)["params"]


# ---- data ----------------------------------------------------------------

@pytest.mark.parametrize("image_set,n,classes,size", [
    ("train", 12, 4, (320, 400)), ("2007_trainval", 5, 21, (375, 500))])
def test_synthetic_specs_and_pixels_equal_jax(image_set, n, classes, size,
                                              tmp_path):
    ours = SyntheticDataset(image_set, n, classes, size)
    theirs = JSynthetic(image_set, str(tmp_path), str(tmp_path / "s"),
                        num_images=n, num_classes=classes, image_size=size)
    assert len(ours.specs) == len(theirs._specs) == n
    for i, (a, b) in enumerate(zip(ours.specs, theirs._specs)):
        np.testing.assert_array_equal(a["boxes"], b["boxes"])
        np.testing.assert_array_equal(a["gt_classes"], b["gt_classes"])
        assert a["noise_seed"] == b["noise_seed"]
        np.testing.assert_array_equal(ours.render(i), theirs._render(b))


def test_loader_batches_equal_jax(tmp_path):
    """Same plan for (seed, epoch) and the same uint8 canvases, im_info and
    padded gt as the JAX loader over the PNG-cached roidb of the same
    synthetic set (two epochs, batch 2)."""
    jcfg = j_generate_config("tiny", "synthetic", train__max_gt_boxes=4)
    cfg = generate_config("tiny", "synthetic", train__max_gt_boxes=4)
    jds = JSynthetic("train", str(tmp_path), str(tmp_path / "s"),
                     num_images=6, num_classes=4)
    jl = JAnchorLoader(jds.gt_roidb(), jcfg, batch_images=2, seed=3,
                       num_workers=0, raw_images=True)
    ds = SyntheticDataset("train", 6, 4)
    tl = AnchorLoader(ds.gt_roidb(), cfg, ds.load_image, batch_images=2,
                      seed=3)
    assert len(tl) == len(jl) == 3
    for _ in range(2):
        for want, got in zip(jl, tl):
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, np.asarray(b))


# ---- the train-mode forward ----------------------------------------------

def test_sampling_stages_match_jax():
    """Tiny, batch 2: with the RPN box regressor zeroed, the proposals are
    the clipped anchors in both, so the proposal set (K1's plain version
    against the jnp sweep) and the sampled rois, labels and fg masks are
    equal; the RPN outputs agree to rtol 1e-5 (conv summation order)."""
    jcfg, cfg = _configs("tiny")
    tr = cfg.train
    batch = _batches("tiny")[0]
    model = build_model(cfg, "cpu", seed=1, train=True)
    with torch.no_grad():
        model.rpn.rpn_bbox_pred.weight.zero_()
    variables = to_flax(model.state_dict())
    jmodel = j_build_model(jcfg)
    images, im_info = jnp.asarray(batch.images), jnp.asarray(batch.im_info)
    jfeat = jmodel.apply(variables, images, im_info, method=jmodel.features)
    jcls, jbox = jmodel.apply(variables, jfeat, method=jmodel.rpn_raw)
    anchors = jmodel.anchors_for(*jfeat.shape[1:3])
    prop_kw = dict(pre_nms_top_n=tr.rpn_pre_nms_top_n,
                   post_nms_top_n=tr.rpn_post_nms_top_n,
                   nms_thresh=tr.rpn_nms_thresh, min_size=tr.rpn_min_size)
    jrois, _, jvalid = j_propose_batch(
        jax.nn.softmax(jcls, axis=-1)[..., 1], jbox, anchors, im_info,
        **prop_kw)
    n = batch.images.shape[0]
    keys = jax.random.split(jax.random.PRNGKey(5), n)
    pt_kw = dict(num_classes=cfg.num_classes, batch_rois=tr.batch_rois)
    want = jax.vmap(lambda r, v, b, c, g, k: j_proposal_target(
        r, v, b, c, g, k, **pt_kw))(
        jrois, jvalid, jnp.asarray(batch.gt_boxes),
        jnp.asarray(batch.gt_classes), jnp.asarray(batch.gt_valid), keys)

    tb = ttrain.to_device(batch, CPU)
    with torch.no_grad():
        feat = model.features(tb.images, tb.im_info)
        tcls, tbox = model.rpn_raw(feat)
        rois, _, valid = propose_batch(
            torch.softmax(tcls, -1)[..., 1], tbox,
            model.anchors_for(*feat.shape[1:3]), tb.im_info, **prop_kw)
    np.testing.assert_allclose(tcls.numpy(), np.asarray(jcls), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(rois.numpy(), np.asarray(jrois))
    pool = proposal_pool_size(rois.shape[1], tb.gt_boxes.shape[1],
                              tr.batch_rois)
    u = [[np.asarray(jax.random.uniform(k, (pool,)))
          for k in jax.random.split(key)] for key in keys]
    got = proposal_target(
        rois, valid, tb.gt_boxes, tb.gt_classes, tb.gt_valid,
        uniforms=tuple(torch.from_numpy(np.stack([x[j] for x in u]))
                       for j in range(2)), **pt_kw)
    np.testing.assert_array_equal(got.rois.numpy(), np.asarray(want.rois))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.fg_mask.numpy(),
                                  np.asarray(want.fg_mask))
    assert got.fg_mask.sum() > 0 and (got.labels == 0).sum() > 0


# (metric and loss rtol, per-leaf relative L2 error of the gradients):
# tiny is a few layers deep and agrees to fp32 summation order; through
# ResNet-101 the two frameworks' conv sums drift apart by ~1e-5 relative,
# enough to flip a few ReLUs near zero, which moves some small gradient
# leaves by up to ~8e-4 of their norm
_LOSS_TOL = {"tiny": (1e-5, 1e-5), "resnet101": (2e-5, 2e-3)}


@pytest.mark.parametrize("network", ["tiny", "resnet101"])
def test_loss_and_grads_match_jax(network):
    jcfg, cfg = _configs(network)
    batch = _batches(network)[0]
    model = build_model(cfg, "cpu", seed=1, train=True)
    variables = _variables(network, model)
    model.load_state_dict(from_flax(variables))
    key = jax.random.PRNGKey(3)
    jmodel = j_build_model(jcfg)
    jbatch = jtrain.Batch(*(jnp.asarray(x) for x in batch))

    def loss_fn(params):
        return jtrain.loss_and_metrics(jmodel, params,
                                       variables["batch_stats"], jbatch, key,
                                       jcfg)

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    for p in model.parameters():
        p.requires_grad_(True)
    total, got = ttrain.loss_and_metrics(
        model, ttrain.to_device(batch, CPU), cfg,
        _jax_draws(key, batch.images.shape[0]))
    total.backward()

    loss_rtol, grad_rel = _LOSS_TOL[network]
    assert list(got) == ["rpn_acc", "rpn_logloss", "rpn_l1loss", "rcnn_acc",
                         "rcnn_logloss", "rcnn_l1loss", "num_fg", "loss"]
    for k in ("rpn_acc", "rcnn_acc", "num_fg"):
        assert float(got[k]) == float(want[k]), k
    for k in ("rpn_logloss", "rpn_l1loss", "rcnn_logloss", "rcnn_l1loss",
              "loss"):
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=loss_rtol, err_msg=k)
    assert float(got["num_fg"]) > 0
    tgrads = _grads_tree(model)
    leaves = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(leaves) == len(list(model.parameters()))
    for path, want_g in leaves:
        want_g = np.asarray(want_g)
        err = np.linalg.norm(_tree_get(tgrads, path) - want_g)
        assert err <= grad_rel * max(np.linalg.norm(want_g), 1e-12), path


def test_three_train_steps_match_jax():
    """Tiny, three steps from the same weights and draws, base lr 0.01
    dropping x0.1 after two steps, bf16 momentum: the metrics of every
    step agree to rtol 1e-5 and each parameter's total change to a
    relative L2 error of 1e-4 (fp32 summation order, and the bf16 trace
    rounding the rare element that sits on a rounding boundary in only
    one of the two)."""
    jcfg, cfg = _configs("tiny")
    batches = _batches("tiny", count=3)
    model = build_model(cfg, "cpu", seed=2, train=True)
    variables = to_flax(model.state_dict())
    jmodel = j_build_model(jcfg)
    tx = j_make_optimizer(jcfg, variables["params"], 2, base_lr=0.01,
                          lr_step="1")
    jstate = jtrain.TrainState(jnp.zeros((), jnp.int32),
                               variables["params"], variables["batch_stats"],
                               tx.init(variables["params"]))
    jstep = jax.jit(jtrain.make_train_step(jmodel, jcfg, tx))
    state = ttrain.init_state(model, cfg, 2, base_lr=0.01, lr_step="1")
    step = ttrain.make_train_step(cfg)
    key = jax.random.PRNGKey(11)
    for k, batch in enumerate(batches):
        jstate, want = jstep(jstate, jtrain.Batch(*map(jnp.asarray, batch)),
                             key)
        got = step(state, ttrain.to_device(batch, CPU),
                   draws=_jax_draws(key, batch.images.shape[0], step=k))
        for name in want:
            np.testing.assert_allclose(float(got[name]), float(want[name]),
                                       rtol=1e-5, err_msg=(k, name))
    assert state.step == int(jstate.step) == 3
    tparams = to_flax(model.state_dict())["params"]
    for path, want_p in jax.tree_util.tree_leaves_with_path(jstate.params):
        start = _tree_get(variables["params"], path)
        moved = np.asarray(want_p) - start
        err = np.linalg.norm(_tree_get(tparams, path) - np.asarray(want_p))
        assert np.linalg.norm(moved) > 0, path
        assert err <= 1e-4 * np.linalg.norm(moved), path


def test_train_cli_runs_on_cpu():
    """``tools/train.py --device cpu``, in its own interpreter as a user
    would run it: two steps of the tiny network, finite losses."""
    out = subprocess.run(
        [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.train", "--device",
         "cpu", "--network", "tiny", "--dataset", "synthetic",
         "--synthetic", "4", "--batch_images", "2", "--steps", "2",
         "--frequent", "1", "--set", "train__rpn_pre_nms_top_n=600",
         "--set", "train__rpn_post_nms_top_n=100"],
        capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert "device=cpu" in lines[0]
    assert sum(line.startswith("Epoch[") for line in lines) == 2
    final = dict(kv.split("=") for kv in lines[-1][len("final "):]
                 .split(", "))
    assert set(final) >= {"rpn_acc", "rcnn_logloss", "loss"}
    assert all(np.isfinite(float(v)) for v in final.values())
