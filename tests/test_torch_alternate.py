"""The alternate schedule's modules held against the JAX package's on the
CPU: the proposal-fed loaders, the ``rpn`` and ``rcnn`` modes of the
train step, the proposal dump, ``combine_model``, ``test_rcnn_stage``,
and the whole four-stage schedule with its checkpoints and pickles read
across the two packages.

Everything runs the tiny network in fp32 on the synthetic set at the toy
size (4 classes, 128x160 canvases, flipped copies on).  The port's step
takes the JAX step's own uniforms (``_jax_draws`` repeats the key splits
of ``mx_rcnn_tpu/core/train.py`` for each mode).  Decisions (anchor and
proposal labels, proposals, keep masks) are held equal; losses to rtol
1e-5 and gradients to a relative L2 error of 1e-5 (fp32 summation order
through two convs); after two SGD steps each parameter's change to a
relative L2 error of 1e-4 (the bf16 momentum trace rounds the rare
element on a rounding boundary in only one package).
"""

import os
import pickle
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
from mx_rcnn_tpu.core.tester import generate_proposals as j_generate_proposals
from mx_rcnn_tpu.data import TestLoader as JTestLoader
from mx_rcnn_tpu.data import load_gt_roidb as j_load_gt_roidb
from mx_rcnn_tpu.data.loader import ROIIter as JROIIter
from mx_rcnn_tpu.data.loader import ROITestLoader as JROITestLoader
from mx_rcnn_tpu.data.loader import _fill_rois as j_fill_rois
from mx_rcnn_tpu.models import build_model as j_build_model
from mx_rcnn_tpu.ops.targets import anchor_target as j_anchor_target
from mx_rcnn_tpu.ops.targets import proposal_target as j_proposal_target
from mx_rcnn_tpu.tools.test_rcnn import test_rcnn_stage as j_test_rcnn_stage
from mx_rcnn_tpu.utils import checkpoint as jckpt
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core import train as ttrain
from mx_rcnn_tpu_torch.core.tester import generate_proposals
from mx_rcnn_tpu_torch.data import load_gt_roidb
from mx_rcnn_tpu_torch.data.loader import (ROIIter, ROITestLoader,
                                           _fill_rois)
from mx_rcnn_tpu_torch.data.loader import TestLoader as PortTestLoader
from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
from mx_rcnn_tpu_torch.tools import (test_rcnn, test_rpn, train_alternate,
                                     train_rcnn, train_rpn)
from mx_rcnn_tpu_torch.tools.train import train_net
from mx_rcnn_tpu_torch.utils import checkpoint as tckpt
from mx_rcnn_tpu_torch.utils.bridge import from_flax, to_flax

torch.set_num_threads(1)
CPU = torch.device("cpu")

_TOY = dict(dataset__num_classes=4, bucket__scale=128, bucket__max_size=160,
            bucket__shapes=((128, 160), (160, 128)), train__max_gt_boxes=8,
            train__rpn_pre_nms_top_n=512, train__rpn_post_nms_top_n=128,
            train__batch_rois=32, test__rpn_pre_nms_top_n=256,
            test__rpn_post_nms_top_n=32, test__proposal_pre_nms_top_n=512,
            test__proposal_post_nms_top_n=96)
_KW = dict(num_images=4, image_size=(128, 160))
# the same toy numbers for the command lines
_SET = [f"--set={k}={v}" for k, v in _TOY.items()
        if k != "dataset__num_classes"]


def _configs(tmp_path, **extra):
    kw = dict(_TOY, **extra)
    jcfg = j_generate_config("tiny", "synthetic", **kw)
    jcfg = jcfg.replace_in("dataset", root_path=str(tmp_path),
                           dataset_path=str(tmp_path / "synthetic"))
    return jcfg, generate_config("tiny", "synthetic", **kw)


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


def _assert_same_tree(got, want):
    got, want = dict(_tree_items(got)), dict(_tree_items(want))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=str(k))


def _proposals(roidb, seed, max_k=12):
    """Raw-coordinate (k, 5) proposals per record: jittered gt boxes (so
    some are foreground), random boxes, some records empty or longer
    than the slots they get."""
    rng = np.random.RandomState(seed)
    out = []
    for i, rec in enumerate(roidb):
        if i % 5 == 3:
            out.append(np.zeros((0, 5), np.float32))
            continue
        gt = rec["boxes"] + rng.uniform(-6, 6, rec["boxes"].shape)
        k = rng.randint(1, max_k)
        xy = rng.uniform(0, [rec["width"] - 20, rec["height"] - 20], (k, 2))
        rand = np.concatenate([xy, xy + rng.uniform(8, 60, (k, 2))], 1)
        boxes = np.concatenate([gt, rand])
        scores = np.sort(rng.uniform(size=len(boxes)))[::-1, None]
        out.append(np.hstack([boxes, scores]).astype(np.float32))
    return out


# ---- the proposal-fed loaders ----------------------------------------------

def test_fill_rois_equals_jax():
    rng = np.random.RandomState(0)
    props = [rng.uniform(0, 200, (k, 5)).astype(np.float32)
             for k in (0, 3, 9, 20)]
    scales = np.array([0.5, 1.25, 0.8], np.float32)
    for max_rois in (1, 8, 32):
        got = _fill_rois(props, [3, 0, 2], scales, max_rois)
        want = j_fill_rois(props, [3, 0, 2], scales, max_rois)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert got[1].sum() == 20 + 0 + 9


@pytest.mark.parametrize("seed", [0, 5])
def test_roiiter_batches_equal_jax(seed, tmp_path):
    """The flipped training roidb with its proposals, batch 2, 8 slots:
    both epochs' RCNN batches equal, field for field."""
    jcfg, cfg = _configs(tmp_path)
    _, jroidb = j_load_gt_roidb(jcfg, training=True, **_KW)
    imdb, roidb = load_gt_roidb(cfg, training=True, **_KW)
    props = _proposals(roidb, seed)
    jl = JROIIter(jroidb, jcfg, props, batch_images=2, seed=seed,
                  max_rois=8, num_workers=0, raw_images=True)
    tl = ROIIter(roidb, cfg, imdb.load_image, props, batch_images=2,
                 seed=seed, max_rois=8)
    assert len(tl) == len(jl) == 4
    for _ in range(2):
        pairs = list(zip(jl, tl))
        assert len(pairs) == 4
        for want, got in pairs:
            assert type(got).__name__ == "RCNNBatch"
            assert got._fields == want._fields
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(ValueError, match="proposal sets"):
        ROIIter(roidb, cfg, imdb.load_image, props[:-1])
    # by default, as many slots as the proposal dump keeps
    assert ROIIter(roidb, cfg, imdb.load_image, props).max_rois == 96


def test_roi_test_loader_equals_jax(tmp_path):
    jcfg, cfg = _configs(tmp_path, test__batch_images=3)
    _, jroidb = j_load_gt_roidb(jcfg, training=False, **_KW)
    imdb, roidb = load_gt_roidb(cfg, training=False, **_KW)
    props = _proposals(roidb, 1, max_k=200)
    jl = list(JROITestLoader(jroidb, jcfg, props, num_workers=0,
                             raw_images=True))
    tl = list(ROITestLoader(roidb, cfg, imdb.load_image, props))
    assert len(tl) == len(jl) == 2
    for (tb, ti, ts), (jb, ji, js) in zip(tl, jl):
        assert ti == ji
        np.testing.assert_array_equal(ts, js)
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a, np.asarray(b))


# ---- the rpn and rcnn steps ------------------------------------------------

def _jax_draws(key, n, mode, step=None):
    """``draws`` giving the uniforms the JAX step of ``mode`` draws:
    ``fold_in(key, step)``, then for 'rpn' ``split(key, n)`` into each
    image's anchor key (``_rpn_losses``), for 'rcnn' ``split(key)`` into
    (k_prop, k_drop) and ``split(k_prop, n)`` (``_rcnn_losses``); inside
    each target function ``kf, kb = split(key_i)``."""
    if step is not None:
        key = jax.random.fold_in(key, step)
    if mode == "rpn":
        keys = jax.random.split(key, n)
    else:
        keys = jax.random.split(jax.random.split(key)[0], n)

    def draws(site, image, shape):
        kf, kb = jax.random.split(keys[image])
        u = jax.random.uniform(kf if site.endswith("fg") else kb, shape)
        return torch.from_numpy(np.array(u))

    return draws


def _jax_labels(mode, jmodel, variables, jbatch, key, cfg):
    """The JAX step's sampled labels, from its target function on its
    own keys: anchor labels (N, A) for 'rpn', proposal labels (N, B)
    for 'rcnn'."""
    n = jbatch.images.shape[0]
    tr = cfg.train
    if mode == "rpn":
        feat = jmodel.apply(variables, jbatch.images, jbatch.im_info,
                            method=jmodel.features)
        anchors = jmodel.anchors_for(*feat.shape[1:3])
        return jax.vmap(lambda b, v, i, k: j_anchor_target(
            anchors, b, v, i, k, rpn_batch_size=tr.rpn_batch_size,
            rpn_fg_fraction=tr.rpn_fg_fraction,
            positive_overlap=tr.rpn_positive_overlap,
            negative_overlap=tr.rpn_negative_overlap,
            clobber_positives=tr.rpn_clobber_positives,
            allowed_border=tr.rpn_allowed_border,
            bbox_weights=tr.rpn_bbox_weights))(
            jbatch.gt_boxes, jbatch.gt_valid, jbatch.im_info,
            jax.random.split(key, n)).labels
    keys = jax.random.split(jax.random.split(key)[0], n)
    return jax.vmap(lambda r, v, b, c, g, k: j_proposal_target(
        r, v, b, c, g, k, num_classes=cfg.num_classes,
        batch_rois=tr.batch_rois, fg_fraction=tr.fg_fraction,
        fg_thresh=tr.fg_thresh, bg_thresh_hi=tr.bg_thresh_hi,
        bg_thresh_lo=tr.bg_thresh_lo, bbox_means=tr.bbox_means,
        bbox_stds=tr.bbox_stds, gt_append=tr.gt_append))(
        jbatch.rois, jbatch.rois_valid, jbatch.gt_boxes, jbatch.gt_classes,
        jbatch.gt_valid, keys).labels


def _mode_batches(mode, tmp_path, count=2):
    """``count`` batches of 2 from the flipped training roidb: Batch for
    'rpn', RCNNBatch with jittered-gt proposals for 'rcnn'."""
    jcfg, cfg = _configs(tmp_path)
    imdb, roidb = load_gt_roidb(cfg, training=True, **_KW)
    if mode == "rpn":
        from mx_rcnn_tpu_torch.data.loader import AnchorLoader

        loader = AnchorLoader(roidb, cfg, imdb.load_image, batch_images=2)
        jtype = jtrain.Batch
    else:
        loader = ROIIter(roidb, cfg, imdb.load_image, _proposals(roidb, 2),
                         batch_images=2)
        jtype = jtrain.RCNNBatch
    batches = list(loader)[:count]
    return jcfg, cfg, batches, [jtype(*map(jnp.asarray, b))
                                for b in batches]


@pytest.mark.parametrize("mode", ["rpn", "rcnn"])
def test_mode_loss_grads_and_labels_match_jax(mode, tmp_path):
    jcfg, cfg, batches, jbatches = _mode_batches(mode, tmp_path, 1)
    model = build_model(cfg, "cpu", seed=1, train=True)
    variables = to_flax(model.state_dict())
    jmodel = j_build_model(jcfg)
    key = jax.random.PRNGKey(7)

    def loss_fn(params):
        return jtrain.LOSS_FNS[mode](jmodel, params,
                                     variables["batch_stats"], jbatches[0],
                                     key, jcfg)

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    want_labels = np.asarray(_jax_labels(mode, jmodel, variables,
                                         jbatches[0], key, jcfg))

    target = "anchor_target" if mode == "rpn" else "proposal_target"
    seen = []
    original = getattr(ttrain, target)

    def record(*args, **kw):
        seen.append(original(*args, **kw))
        return seen[-1]

    setattr(ttrain, target, record)
    try:
        total, got = ttrain.LOSS_FNS[mode](
            model, ttrain.to_device(batches[0], CPU), cfg,
            _jax_draws(key, 2, mode))
    finally:
        setattr(ttrain, target, original)
    total.backward()

    np.testing.assert_array_equal(seen[0].labels.numpy(), want_labels)
    assert (want_labels == 1).sum() > 0 and (want_labels == 0).sum() > 0
    assert sorted(got) == sorted(want)
    for k in want:
        if k.endswith("acc") or k == "num_fg":
            assert float(got[k]) == float(want[k]), k
        else:
            np.testing.assert_allclose(float(got[k].detach()),
                                       float(want[k]), rtol=1e-5, err_msg=k)
    grads = {n: p.grad for n, p in model.named_parameters()}
    tgrads = to_flax({n: torch.zeros_like(p) if p.grad is None else p.grad
                      for n, p in model.named_parameters()})["params"]
    leaves = jax.tree_util.tree_leaves_with_path(jgrads)
    used = 0
    for path, want_g in leaves:
        want_g = np.asarray(want_g)
        err = np.linalg.norm(_tree_get(tgrads, path) - want_g)
        assert err <= 1e-5 * max(np.linalg.norm(want_g), 1e-12), path
        used += np.linalg.norm(want_g) > 0
    # the rpn loss never reaches the head, the rcnn loss never the RPN
    idle = "head" if mode == "rpn" else "rpn"
    assert all(g is None for n, g in grads.items() if n.startswith(idle))
    assert used > 0


@pytest.mark.parametrize("mode", ["rpn", "rcnn"])
def test_two_frozen_shared_steps_match_jax(mode, tmp_path):
    """Two steps of ``mode`` with the shared convs frozen (stages 3 and
    4), lr 0.01 and bf16 momentum: metrics within 1e-5 each step, every
    trainable parameter's change within 1e-4 of the JAX step's, and the
    frozen convs bit-identical to their init in both packages."""
    jcfg, cfg, batches, jbatches = _mode_batches(mode, tmp_path)
    shared = cfg.network.fixed_params_shared
    model = build_model(cfg, "cpu", seed=3, train=True)
    variables = to_flax(model.state_dict())
    jmodel = j_build_model(jcfg)
    tx = j_make_optimizer(jcfg, variables["params"], 2, base_lr=0.01,
                          lr_step="1", frozen_prefixes=shared)
    jstate = jtrain.TrainState(jnp.zeros((), jnp.int32), variables["params"],
                               variables["batch_stats"],
                               tx.init(variables["params"]))
    jstep = jax.jit(jtrain.make_train_step(jmodel, jcfg, tx, mode=mode))
    state = ttrain.init_state(model, cfg, 2, base_lr=0.01, lr_step="1",
                              frozen_prefixes=shared)
    step = ttrain.make_train_step(cfg, mode)
    key = jax.random.PRNGKey(11)
    for k, (batch, jbatch) in enumerate(zip(batches, jbatches)):
        jstate, want = jstep(jstate, jbatch, key)
        got = step(state, ttrain.to_device(batch, CPU),
                   draws=_jax_draws(key, 2, mode, step=k))
        for name in want:
            np.testing.assert_allclose(float(got[name]), float(want[name]),
                                       rtol=1e-5, err_msg=(k, name))
    tparams = to_flax(model.state_dict())["params"]
    moved = 0
    for path, want_p in jax.tree_util.tree_leaves_with_path(jstate.params):
        start = _tree_get(variables["params"], path)
        got_p, want_p = _tree_get(tparams, path), np.asarray(want_p)
        if path[0].key == "backbone":
            np.testing.assert_array_equal(want_p, start)
            np.testing.assert_array_equal(got_p, start)
            continue
        change = np.linalg.norm(want_p - start)
        assert np.linalg.norm(got_p - want_p) <= 1e-4 * max(change, 1e-12)
        moved += change > 0
    assert moved > 0
    with pytest.raises(ValueError, match="mode"):
        ttrain.make_train_step(cfg, "rcnn2")


# ---- proposals, combine and the RCNN-stage eval ----------------------------

def _zeroed_box_regressor(cfg, seed):
    model = build_model(cfg, "cpu", seed=seed)
    with torch.no_grad():
        model.rpn.rpn_bbox_pred.weight.zero_()
    return model


def test_generate_proposals_equals_jax(tmp_path):
    """rpn_proposals over the flipped training roidb at the dump's
    numbers (pre/post 512/96): with the RPN box regressor zeroed the
    proposals are clipped anchors in both packages, so the arrays are
    equal in count and boxes (raw coordinates, float32) and the scores
    agree to 1e-6."""
    jcfg, cfg = _configs(tmp_path, test__batch_images=3)
    jimdb, jroidb = j_load_gt_roidb(jcfg, training=True, **_KW)
    imdb, roidb = load_gt_roidb(cfg, training=True, **_KW)
    model = _zeroed_box_regressor(cfg, 2)
    want = j_generate_proposals(j_build_model(jcfg),
                                to_flax(model.state_dict()),
                                JTestLoader(jroidb, jcfg, num_workers=0),
                                jcfg)
    got = generate_proposals(model, PortTestLoader(roidb, cfg,
                                                   imdb.load_image),
                             cfg, "cpu")
    assert len(got) == len(want) == len(roidb) == 8
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        assert 0 < len(g) <= 96
        np.testing.assert_array_equal(g[:, :4], w[:, :4])
        np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=0, atol=1e-6)


def test_combine_model_equals_jax():
    """ResNet-50 (it has batch statistics): the port's combine of two
    state_dicts through to_flax is the JAX combine of the two trees."""
    cfg = generate_config("resnet50", "PascalVOC",
                          network__compute_dtype="float32")
    a = build_model(cfg, "cpu", seed=1).state_dict()
    b = build_model(cfg, "cpu", seed=2).state_dict()
    got = to_flax(tckpt.combine_model(a, b, from_a=("rpn", "backbone")))
    fa, fb = to_flax(a), to_flax(b)
    want = {"params": jckpt.combine_model(fa["params"], fb["params"],
                                          from_a=("rpn", "backbone")),
            "batch_stats": jckpt.combine_model(
                fa["batch_stats"], fb["batch_stats"], from_a=("backbone",))}
    _assert_same_tree(got, want)
    assert torch.equal(tckpt.combine_model(a, b, ("rpn", "backbone"))[
        "head.stage4_unit1.conv1.weight"], b["head.stage4_unit1.conv1.weight"])


def test_test_rcnn_stage_equals_jax(tmp_path):
    """Both packages' ``test_rcnn_stage`` on one port checkpoint and one
    proposal pickle (jittered gt boxes and random boxes, so the random
    head scores some classes): equal counts per (class, image), boxes
    within 1e-2 px, scores within 1e-5, APs within 1e-6."""
    jcfg, cfg = _configs(tmp_path)
    prefix = str(tmp_path / "rcnn")
    tckpt.save_checkpoint(prefix, 1, ttrain.setup_training(cfg, "cpu",
                                                           seed=4))
    _, roidb = load_gt_roidb(cfg, training=False, **_KW)
    props = _proposals(roidb, 3)
    want = j_test_rcnn_stage(jcfg, prefix=prefix, epoch=1, proposals=props,
                             verbose=False, dataset_kw=_KW,
                             save_dets=str(tmp_path / "j.pkl"))
    got = test_rcnn.test_rcnn_stage(cfg, prefix=prefix, epoch=1,
                                    proposals=props, verbose=False,
                                    dataset_kw=_KW, device="cpu",
                                    save_dets=str(tmp_path / "t.pkl"))
    dets = []
    for tag in ("t", "j"):
        with open(tmp_path / f"{tag}.pkl", "rb") as f:
            dets.append(pickle.load(f)["all_boxes"])
    total = 0
    for tc, jc in zip(*dets):
        for g, w in zip(tc, jc):
            assert g.shape == w.shape
            np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=1e-2)
            np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=0, atol=1e-5)
            total += len(g)
    assert total > 0
    assert got.keys() == want.keys() and want["mAP"] > 0
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k


# ---- the whole schedule ----------------------------------------------------

def _backbone(prefix, epoch):
    return {k: v for k, v in tckpt.load_state_dict(prefix, epoch).items()
            if k.startswith("backbone.")}


def test_alternate_train_four_stages_and_combine(tmp_path):
    """``tools/train_alternate.py`` on 4 images and their flips, one epoch
    a stage: every artifact exists; stage 3 leaves the shared convs
    bit-identical to rcnn1's and stage 4 to rpn2's, while stage 3 moves
    the RPN; the final model is rpn2's RPN and backbone with rcnn2's
    head; the JAX package reads the final and a stage checkpoint, and
    its ROIIter takes the port's proposal pickle."""
    jcfg, _ = _configs(tmp_path)
    prefix = str(tmp_path / "alt")
    final = train_alternate.main(
        ["--device", "cpu", "--network", "tiny", "--dataset", "synthetic",
         "--synthetic", "4", "--batch_images", "2", "--prefix", prefix,
         "--rpn_epoch", "1", "--rcnn_epoch", "1", "--rpn_lr", "0.01",
         "--rcnn_lr", "0.01", "--set", "dataset__num_classes=4"] + _SET)
    assert final == prefix + "-final"
    for stage in ("rpn1", "rcnn1", "rpn2", "rcnn2"):
        assert os.path.exists(tckpt.checkpoint_path(f"{prefix}-{stage}", 1))
    assert os.path.exists(tckpt.checkpoint_path(final, 1))
    for stage in ("rpn1", "rpn2"):
        with open(f"{prefix}-{stage}-proposals.pkl", "rb") as f:
            props = pickle.load(f)
        assert len(props) == 8
        assert all(p.dtype == np.float32 and p.shape[1] == 5 for p in props)

    rcnn1, rpn2, rcnn2 = (tckpt.load_state_dict(f"{prefix}-{s}", 1)
                          for s in ("rcnn1", "rpn2", "rcnn2"))
    for k in rcnn1:
        if k.startswith("backbone."):
            assert torch.equal(rcnn1[k], rpn2[k]), k
            assert torch.equal(rpn2[k], rcnn2[k]), k
    assert any(not torch.equal(rcnn1[k], rpn2[k]) for k in rcnn1
               if k.startswith("rpn."))
    p_final, _ = jckpt.load_param(final, 1)
    p_rpn2, _ = jckpt.load_param(f"{prefix}-rpn2", 1)
    p_rcnn2, _ = jckpt.load_param(f"{prefix}-rcnn2", 1)
    _assert_same_tree({k: p_final[k] for k in ("rpn", "backbone")},
                      {k: p_rpn2[k] for k in ("rpn", "backbone")})
    _assert_same_tree({k: p_final[k] for k in ("head", "cls_score",
                                               "bbox_pred")},
                      {k: p_rcnn2[k] for k in ("head", "cls_score",
                                               "bbox_pred")})
    raw = jckpt.load_checkpoint(final, 1)
    assert int(raw["step"]) == 0 and raw["opt_state"] == {}
    # the stage-4 file restores onto a JAX template with the same freeze
    template, _ = jtrain.setup_training(
        j_build_model(jcfg), jcfg, jax.random.PRNGKey(0), (1, 128, 160, 3),
        4, frozen_prefixes=jcfg.network.fixed_params_shared)
    restored = jckpt.restore_state(template, f"{prefix}-rcnn2", 1)
    assert int(restored.step) == 4
    _assert_same_tree(restored.params, p_rcnn2)
    # the JAX ROIIter reads the port's pickle
    _, jroidb = j_load_gt_roidb(jcfg, training=True, **_KW)
    with open(f"{prefix}-rpn2-proposals.pkl", "rb") as f:
        jl = JROIIter(jroidb, jcfg, pickle.load(f), batch_images=2,
                      num_workers=0)
    assert next(iter(jl)).rois_valid.sum() > 0
    # and the final model evaluates through tools/test.py
    from mx_rcnn_tpu_torch.tools import test as test_cli

    results = test_cli.main(["--device", "cpu", "--network", "tiny",
                             "--dataset", "synthetic", "--synthetic", "4",
                             "--prefix", final, "--epoch", "1",
                             "--set", "dataset__num_classes=4"] + _SET)
    assert np.isfinite(results["mAP"])


def test_stage2_init_and_a_jax_stage_checkpoint(tmp_path):
    """Stage 2 starts from rpn1's weights with ``stage2_init='rpn1'``
    and from the seeded init with 'fresh' (rcnn lr 0 keeps them); and
    ``init_from`` reads a JAX stage checkpoint (its params and a masked
    optimizer state) into the port bit for bit."""
    jcfg, cfg = _configs(tmp_path, train__batch_images=2)
    for init in ("rpn1", "fresh"):
        prefix = str(tmp_path / init)
        train_alternate.alternate_train(
            cfg, prefix=prefix, synthetic=4, rpn_epoch=1, rcnn_epoch=1,
            rpn_lr=0.01, rcnn_lr=0.0, stage2_init=init, device="cpu",
            log=lambda line: None)
        rpn1, rcnn1 = _backbone(prefix + "-rpn1", 1), _backbone(
            prefix + "-rcnn1", 1)
        same = all(torch.equal(rpn1[k], rcnn1[k]) for k in rpn1)
        assert same == (init == "rpn1")
    with pytest.raises(ValueError, match="stage2_init"):
        train_alternate.alternate_train(cfg, prefix=prefix, stage2_init="x",
                                        device="cpu")

    model = build_model(cfg, "cpu", seed=9, train=True)
    variables = to_flax(model.state_dict())
    tx = j_make_optimizer(jcfg, variables["params"], 4,
                          frozen_prefixes=jcfg.network.fixed_params_shared)
    jstate = jtrain.TrainState(jnp.array(3, jnp.int32), variables["params"],
                               variables["batch_stats"],
                               tx.init(variables["params"]))
    jprefix = str(tmp_path / "jax-rpn2")
    jckpt.save_checkpoint(jprefix, 1, jstate)
    _, roidb = load_gt_roidb(cfg, training=True, synthetic=4)
    state, _ = train_net(cfg, mode="rcnn", prefix=str(tmp_path / "r"),
                         proposals=_proposals(roidb, 4), synthetic=4,
                         init_from=(jprefix, 1), end_epoch=1, lr=0.0,
                         frozen_prefixes=cfg.network.fixed_params_shared,
                         device="cpu", log=lambda line: None)
    assert state.step == 4
    _assert_same_tree(to_flax(state.model.state_dict())["params"],
                      variables["params"])
    with pytest.raises(ValueError, match="proposals"):
        train_net(cfg, mode="rcnn", device="cpu")


def test_stage_clis_chain_on_cpu(tmp_path, capsys):
    """The stage tools one after another, as the reference's scripts
    chain them: train_rpn → test_rpn → train_rcnn (from rpn, shared
    frozen) → test_rpn --eval_set → test_rcnn."""
    common = ["--device", "cpu", "--network", "tiny", "--dataset",
              "synthetic", "--synthetic", "4", "--set",
              "dataset__num_classes=4"] + _SET
    rpn, rcnn = str(tmp_path / "rpn"), str(tmp_path / "rcnn")
    train_rpn.main(common + ["--prefix", rpn, "--end_epoch", "1",
                             "--batch_images", "2"])
    props = str(tmp_path / "props.pkl")
    assert len(test_rpn.main(common + ["--prefix", rpn, "--epoch", "1",
                                       "--out", props])) == 8
    train_rcnn.main(common + ["--prefix", rcnn, "--end_epoch", "1",
                              "--proposals", props, "--init_from", rpn,
                              "--init_from_epoch", "1", "--frozen_shared",
                              "--batch_images", "2"])
    for a, b in zip(_backbone(rpn, 1).values(), _backbone(rcnn, 1).values()):
        assert torch.equal(a, b)
    eval_props = str(tmp_path / "eval.pkl")
    assert len(test_rpn.main(common + ["--prefix", rpn, "--epoch", "1",
                                       "--out", eval_props,
                                       "--eval_set"])) == 4
    results = test_rcnn.main(common + ["--prefix", rcnn, "--epoch", "1",
                                       "--proposals", eval_props])
    assert np.isfinite(results["mAP"])
    assert "mAP = " in capsys.readouterr().out


def test_train_alternate_cli_runs_on_cpu(tmp_path):
    """``tools/train_alternate.py --device cpu`` in its own interpreter,
    as a user would run it."""
    prefix = str(tmp_path / "alt")
    out = subprocess.run(
        [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.train_alternate",
         "--device", "cpu", "--network", "tiny", "--dataset", "synthetic",
         "--synthetic", "2", "--batch_images", "2", "--rpn_epoch", "1",
         "--rcnn_epoch", "1", "--no_flip", "--prefix", prefix,
         "--set", "dataset__num_classes=4"] + _SET,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "=== Stage 4" in out.stdout
    assert os.path.exists(tckpt.checkpoint_path(prefix + "-final", 1))
    manifest = tckpt.read_manifest(tckpt.checkpoint_path(prefix + "-rpn1",
                                                         1))
    assert manifest["step"] == 1       # 2 images, no flips, batch 2
