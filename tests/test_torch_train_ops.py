"""The port's training ops held against the JAX package on the CPU.

The same numpy inputs, made from a seed, go through each JAX function and
its counterpart in ``mx_rcnn_tpu_torch`` in fp32.  The random subsampling
of the target functions is fed the uniforms ``jax.random.uniform`` draws
from the JAX function's own keys, so labels, sampled rois and fg masks are
compared exactly.  Float tolerances are stated per test.  The ROIAlign
backward's plain version (the CPU side of kernel K3) is held against
``jax.grad`` of the einsum pair and of the Pallas kernel in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.core.optim import make_optimizer as j_make_optimizer
from mx_rcnn_tpu.ops import losses as jlosses
from mx_rcnn_tpu.ops import targets as jtargets
from mx_rcnn_tpu.ops.anchors import generate_shifted_anchors
from mx_rcnn_tpu.ops.boxes import bbox_transform as j_bbox_transform
from mx_rcnn_tpu.ops.roi_align_pallas import roi_align_pallas
from mx_rcnn_tpu.ops.roi_pool import roi_align as j_roi_align
from mx_rcnn_tpu_torch import kernels
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core import optim as toptim
from mx_rcnn_tpu_torch.models.layers import Conv2dSame, Dense, FrozenBatchNorm
from mx_rcnn_tpu_torch.ops import boxes as tboxes
from mx_rcnn_tpu_torch.ops import losses as tlosses
from mx_rcnn_tpu_torch.ops import roi_pool as troi
from mx_rcnn_tpu_torch.ops import targets as ttargets
from mx_rcnn_tpu_torch.utils.bridge import from_flax, to_flax

torch.set_num_threads(1)
T = torch.from_numpy


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _boxes(rng, k, span=(300.0, 400.0), lo=8.0, hi=160.0):
    xy = rng.uniform(0, 1, (k, 2)) * np.asarray(span)[::-1]
    wh = rng.uniform(lo, hi, (k, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# ---- losses --------------------------------------------------------------

def _loss_inputs(seed, n=37, c=5):
    rng = np.random.RandomState(seed)
    logits = (rng.standard_normal((n, c)) * 2).astype(np.float32)
    labels = rng.randint(-1, c, n).astype(np.int32)
    logits[3, 1] = logits[3, 2] = logits[3].max() + 1.0   # an argmax tie
    pred = rng.standard_normal((n, 4 * c)).astype(np.float32)
    target = (pred + rng.standard_normal((n, 4 * c)) * 0.6).astype(np.float32)
    weight = (rng.uniform(size=(n, 4 * c)) > 0.5).astype(np.float32)
    return logits, labels, pred, target, weight


@pytest.mark.parametrize("normalization", ["valid", "batch", "null"])
def test_cross_entropy_value_and_grad(normalization):
    """fp32 at rtol 1e-6: the same log-softmax, summed in another order."""
    logits, labels, *_ = _loss_inputs(0)
    jf = lambda x: jlosses.softmax_cross_entropy_with_ignore(
        x, jnp.asarray(labels), -1, normalization)
    want, want_g = jax.value_and_grad(jf)(jnp.asarray(logits))
    x = T(logits).requires_grad_()
    got = tlosses.softmax_cross_entropy_with_ignore(x, T(labels).long(), -1,
                                                    normalization)
    got.backward()
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)
    np.testing.assert_allclose(_np(x.grad), _np(want_g), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("sigma", [1.0, 3.0])
def test_weighted_smooth_l1_value_and_grad(sigma):
    """fp32 at rtol 1e-6 for the value (a sum in another order); the
    gradient is elementwise and is compared at rtol 1e-6."""
    _, _, pred, target, weight = _loss_inputs(1)
    jf = lambda p: jlosses.weighted_smooth_l1(
        p, jnp.asarray(target), jnp.asarray(weight), sigma, 128.0)
    want, want_g = jax.value_and_grad(jf)(jnp.asarray(pred))
    p = T(pred).requires_grad_()
    got = tlosses.weighted_smooth_l1(p, T(target), T(weight), sigma, 128.0)
    got.backward()
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)
    np.testing.assert_allclose(_np(p.grad), _np(want_g), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_array_equal(
        _np(tlosses.smooth_l1(T(pred), T(target), sigma)),
        _np(jlosses.smooth_l1(jnp.asarray(pred), jnp.asarray(target), sigma)))


def test_accuracy_with_ignore_and_ties():
    """Exact: argmax ties go to the first index in both."""
    logits, labels, *_ = _loss_inputs(2)
    labels[3] = 1
    want = jlosses.accuracy_with_ignore(jnp.asarray(logits),
                                        jnp.asarray(labels))
    got = tlosses.accuracy_with_ignore(T(logits), T(labels).long())
    assert float(got) == float(want)
    assert int(torch.argmax(T(logits)[3])) == 1


# ---- boxes ---------------------------------------------------------------

def test_bbox_transform_matches():
    """dx, dy are the same fp32 operations (bit-equal); dw, dh go through
    ``log``, where XLA and torch may differ by one ulp (rtol 1e-6)."""
    rng = np.random.RandomState(3)
    ex = _boxes(rng, 50)
    gt = _boxes(rng, 50)
    ex[0] = [5, 5, 5, 5]                     # a one-pixel example box
    gt[1] = [10, 10, 9, 9]                   # a degenerate gt box
    want = _np(j_bbox_transform(jnp.asarray(ex), jnp.asarray(gt)))
    got = _np(tboxes.bbox_transform(T(ex), T(gt)))
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got[:, 2:], want[:, 2:], rtol=1e-6, atol=1e-7)
    batched = _np(tboxes.bbox_transform(T(ex).reshape(2, 25, 4),
                                        T(gt).reshape(2, 25, 4)))
    np.testing.assert_array_equal(batched.reshape(50, 4), got)


# ---- targets -------------------------------------------------------------

def _anchor_case(seed, n=2, fh=16, fw=20, max_gt=6):
    rng = np.random.RandomState(seed)
    anchors = generate_shifted_anchors(fh, fw, 16, scales=(2, 4, 8))
    gt = np.zeros((n, max_gt, 4), np.float32)
    valid = np.zeros((n, max_gt), bool)
    for i in range(n):
        k = [4, 1, 0][i % 3]
        gt[i, :k] = _boxes(rng, k, span=(fh * 16 - 170, fw * 16 - 170),
                           lo=20, hi=160)
        valid[i, :k] = True
        gt[i, k] = [30, 30, 90, 90]          # an invalid row with a real box
    im_info = np.array([[fh * 16, fw * 16, 1.0],
                        [fh * 16 - 40, fw * 16 - 60, 0.8],
                        [fh * 16, fw * 16 - 20, 1.2]], np.float32)[:n]
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return anchors, gt, valid, im_info, keys


def _split_uniforms(keys, size):
    """The (u_fg, u_bg) the JAX target functions draw from each image key:
    ``kf, kb = split(key)``, then ``uniform(k, (size,))``."""
    u = [[np.asarray(jax.random.uniform(k, (size,)))
          for k in jax.random.split(key)] for key in keys]
    return tuple(T(np.stack([ui[j] for ui in u])) for j in range(2))


@pytest.mark.parametrize("seed,kw", [
    (0, dict(rpn_batch_size=256)),
    (1, dict(rpn_batch_size=32)),             # the quotas bind hard
    (2, dict(rpn_batch_size=64, clobber_positives=True)),
    (3, dict(rpn_batch_size=64, allowed_border=16, positive_overlap=0.5)),
])
def test_anchor_target_matches(seed, kw):
    """Labels equal; targets and weights at atol 1e-5 (``log`` may differ
    by one ulp between XLA and torch)."""
    anchors, gt, valid, im_info, keys = _anchor_case(seed, n=3)
    got = ttargets.anchor_target(
        T(anchors), T(gt), T(valid), T(im_info),
        uniforms=_split_uniforms(keys, anchors.shape[0]), **kw)
    for i in range(gt.shape[0]):
        want = jtargets.anchor_target(
            jnp.asarray(anchors), jnp.asarray(gt[i]), jnp.asarray(valid[i]),
            jnp.asarray(im_info[i]), keys[i], **kw)
        np.testing.assert_array_equal(_np(got.labels[i]), _np(want.labels))
        np.testing.assert_allclose(_np(got.bbox_targets[i]),
                                   _np(want.bbox_targets), rtol=1e-6,
                                   atol=1e-5)
        np.testing.assert_array_equal(_np(got.bbox_weights[i]),
                                      _np(want.bbox_weights))
    labels = _np(got.labels)
    assert (labels == 1).sum() > 0 and (labels == 0).sum() > 0
    assert ((labels >= 0).sum(-1) <= kw["rpn_batch_size"]).all()


def _proposal_case(seed, n=2, r=40, max_gt=5):
    rng = np.random.RandomState(seed)
    gt = np.zeros((n, max_gt, 4), np.float32)
    gt_cls = np.zeros((n, max_gt), np.int32)
    gt_valid = np.zeros((n, max_gt), bool)
    rois = np.zeros((n, r, 4), np.float32)
    for i in range(n):
        k = 3 - i
        gt[i, :k] = _boxes(rng, k, lo=30, hi=120)
        gt_cls[i, :k] = rng.randint(1, 5, k)
        gt_valid[i, :k] = True
        # proposals jittered around the gt and random ones
        near = gt[i, rng.randint(0, k, r // 2)] + rng.uniform(-15, 15,
                                                            (r // 2, 4))
        rois[i] = np.concatenate([near, _boxes(rng, r - r // 2)])
    roi_valid = rng.uniform(size=(n, r)) > 0.1
    keys = jax.random.split(jax.random.PRNGKey(100 + seed), n)
    return rois, roi_valid, gt, gt_cls, gt_valid, keys


@pytest.mark.parametrize("seed,kw", [
    (0, dict(batch_rois=32)),
    (1, dict(batch_rois=16, fg_fraction=0.5)),
    (2, dict(batch_rois=64)),                 # pool of 45 < 64: padded
    (3, dict(batch_rois=24, gt_append=False)),
])
def test_proposal_target_matches(seed, kw):
    """Sampled rois, labels and fg_mask equal; targets and weights at
    atol 1e-5 (``log``)."""
    rois, roi_valid, gt, gt_cls, gt_valid, keys = _proposal_case(seed)
    kw = dict(num_classes=5, **kw)
    pool = ttargets.proposal_pool_size(rois.shape[1], gt.shape[1],
                                       kw["batch_rois"],
                                       kw.get("gt_append", True))
    got = ttargets.proposal_target(
        T(rois), T(roi_valid), T(gt), T(gt_cls), T(gt_valid),
        uniforms=_split_uniforms(keys, pool), **kw)
    for i in range(rois.shape[0]):
        want = jtargets.proposal_target(
            jnp.asarray(rois[i]), jnp.asarray(roi_valid[i]),
            jnp.asarray(gt[i]), jnp.asarray(gt_cls[i]),
            jnp.asarray(gt_valid[i]), keys[i], **kw)
        np.testing.assert_array_equal(_np(got.rois[i]), _np(want.rois))
        np.testing.assert_array_equal(_np(got.labels[i]), _np(want.labels))
        np.testing.assert_array_equal(_np(got.fg_mask[i]), _np(want.fg_mask))
        np.testing.assert_allclose(_np(got.bbox_targets[i]),
                                   _np(want.bbox_targets), rtol=1e-6,
                                   atol=1e-5)
        np.testing.assert_array_equal(_np(got.bbox_weights[i]),
                                      _np(want.bbox_weights))
    assert _np(got.fg_mask).sum() > 0


def test_choose_k_and_rank_break_ties_to_the_lower_index():
    """Tied uniforms: the selection and the ranks follow a stable sort."""
    u = T(np.array([[0.5, 0.25, 0.5, 0.25, 0.5, 0.75]], np.float32))
    mask = T(np.array([[True, True, True, False, True, True]]))
    keep = ttargets._choose_k(u, mask, 3, 3)
    np.testing.assert_array_equal(_np(keep), [[True, True, True, False,
                                               False, False]])
    ranks = ttargets._rank_of_uniform(u, mask)
    np.testing.assert_array_equal(_np(ranks), [[1, 0, 2, 5, 3, 4]])
    quota = T(np.array([1]))
    np.testing.assert_array_equal(
        _np(ttargets._choose_k(u, mask, 3, quota)),
        [[False, True, False, False, False, False]])


def test_targets_draw_from_a_generator_when_given_no_uniforms():
    anchors, gt, valid, im_info, _ = _anchor_case(4, n=2)
    runs = [ttargets.anchor_target(
        T(anchors), T(gt), T(valid), T(im_info),
        generator=torch.Generator().manual_seed(7)).labels for _ in range(2)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)


# ---- ROIAlign backward (the plain version of K3) --------------------------

def _roi_case(seed, n=2, r=13, h=10, w=16, c=24, size=(7, 7)):
    rng = np.random.RandomState(seed)
    feat = rng.standard_normal((n, h, w, c)).astype(np.float32)
    xy = rng.uniform(-20, 16 * w, (n, r, 2))
    wh = rng.uniform(0, 120, (n, r, 2))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[0, 0] = [5, 5, 5, 5]
    g = rng.standard_normal((n, r) + size + (c,)).astype(np.float32)
    return feat, rois, g


@pytest.mark.parametrize("size,sr", [((7, 7), 2), ((14, 14), 2), ((5, 3), 1)])
def test_roi_align_bwd_plain_matches_jax_grads(size, sr):
    """R = 13, not a multiple of the Pallas kernel's ROI block of 8.
    fp32 at atol = rtol = 1e-5: the same sum in another order."""
    feat, rois, g = _roi_case(sum(size) + sr, size=size)
    n, h, w, _ = feat.shape

    def loss_ein(f):
        p = jax.vmap(lambda fi, b: j_roi_align(fi, b, size, 1 / 16, sr))(
            f, jnp.asarray(rois))
        return jnp.sum(p * jnp.asarray(g))

    def loss_pal(f):
        p = roi_align_pallas(f, jnp.asarray(rois), size, 1 / 16, sr, True)
        return jnp.sum(p * jnp.asarray(g))

    want_ein = _np(jax.grad(loss_ein)(jnp.asarray(feat)))
    want_pal = _np(jax.grad(loss_pal)(jnp.asarray(feat)))
    got = _np(troi.roi_align_bwd_plain(T(g), T(rois), (h, w), 1 / 16, sr))
    np.testing.assert_allclose(got, want_ein, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_pal, rtol=1e-5, atol=1e-5)

    # the autograd of roi_align_batched on the CPU is the einsum pair's
    f = T(feat).requires_grad_()
    pooled = troi.roi_align_batched(f, T(rois), size, 1 / 16, sr)
    (pooled * T(g)).sum().backward()
    np.testing.assert_allclose(_np(f.grad), want_ein, rtol=1e-5, atol=1e-5)


def test_roi_align_bwd_plain_casts_once():
    """bf16 g: summed in fp32 and rounded once, so it equals the fp32 sum
    of the same bf16 values cast to bf16."""
    feat, rois, g = _roi_case(9)
    g16 = T(g).to(torch.bfloat16)
    got = troi.roi_align_bwd_plain(g16, T(rois), feat.shape[1:3])
    want = troi.roi_align_bwd_plain(g16.float(), T(rois), feat.shape[1:3])
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.to(torch.bfloat16), rtol=0, atol=0)


def test_k3_wrapper_takes_plain_version_on_cpu_and_refuses_cpu_tensors():
    kernels.reset_launch_counts()
    feat, rois, g = _roi_case(5)
    f = T(feat).requires_grad_()
    troi.roi_align_batched(f, T(rois), (7, 7)).sum().backward()
    assert kernels.launch_counts() == {k.name: 0 for k in kernels.KERNELS}
    assert kernels.ROI_ALIGN_BWD.replaces == \
        "mx_rcnn_tpu/ops/roi_align_pallas.py:126"
    with pytest.raises(ValueError, match="CUDA"):
        troi.roi_align_bwd_cuda(T(g), T(rois), feat.shape[1:3])


# ---- optimizer -----------------------------------------------------------

class _Unit(nn.Module):
    def __init__(self):
        super().__init__()
        self.bn1 = FrozenBatchNorm(4)
        self.conv1 = Conv2dSame(4, 6, 3, bias=False)


class _Backbone(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv0 = Conv2dSame(3, 4, 3, bias=False)
        self.stage1_unit1 = _Unit()
        self.stage2_unit1 = _Unit()


class _Net(nn.Module):
    """Names like the ResNet model's: frozen by prefix (conv0, stage1),
    frozen by the gamma/beta tokens (every bn), and trainable."""

    def __init__(self):
        super().__init__()
        self.backbone = _Backbone()
        self.cls_score = Dense(6, 3)


@pytest.mark.parametrize("momentum_dtype", ["bfloat16", "float32"])
def test_sgd_matches_the_optax_chain(momentum_dtype):
    """Five updates crossing two lr steps (steps_per_epoch 2, lr_step
    '1,2'), grads large enough to clip, the optax chain jitted as in the
    train step: parameters agree to rtol 2.4e-7 (2 ulps) plus atol 1e-7
    (the elementwise operations are the same, but XLA contracts some
    multiply-adds, which moves a result by an ulp of its largest term)."""
    jcfg = j_generate_config("resnet101", "PascalVOC",
                             default__momentum_dtype=momentum_dtype)
    cfg = generate_config("resnet101", "PascalVOC",
                          default__momentum_dtype=momentum_dtype)
    rng = np.random.RandomState(0)
    net = _Net()
    for p in net.parameters():
        p.data = T(rng.standard_normal(p.shape).astype(np.float32))
    params = to_flax(net.state_dict())["params"]
    opt = toptim.make_optimizer(cfg, net, 2, base_lr=0.05, lr_step="1,2")
    tx = j_make_optimizer(jcfg, params, 2, base_lr=0.05, lr_step="1,2")
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    update = jax.jit(tx.update)
    trainable = {n for n, p in net.named_parameters() if p.requires_grad}
    assert trainable == {"backbone.stage2_unit1.conv1.weight",
                         "cls_score.weight", "cls_score.bias"}
    before = {k: v.clone() for k, v in net.state_dict().items()}
    for _ in range(5):
        grads = {n: T((rng.standard_normal(p.shape) * 4).astype(np.float32))
                 for n, p in net.named_parameters()}
        jgrads = to_flax({**grads, **{k: v for k, v in net.state_dict()
                                      .items() if "running" in k}})["params"]
        updates, opt_state = update(
            jax.tree_util.tree_map(jnp.asarray, jgrads), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for n, p in net.named_parameters():
            p.grad = grads[n] if n in trainable else None
        opt.step()
        got = to_flax(net.state_dict())["params"]
        for path, want in jax.tree_util.tree_leaves_with_path(jparams):
            node = got
            for k in path:
                node = node[k.key]
            np.testing.assert_allclose(node, _np(want), rtol=2.4e-7,
                                       atol=1e-7)
    assert opt.count == 5
    for n, v in net.state_dict().items():
        moved = not torch.equal(v, before[n])
        assert moved == (n in trainable), n


def test_lr_schedule_and_frozen_mask():
    sched = toptim.lr_schedule(0.01, (1, 3), 4, 0.1)
    lrs = [sched(c) for c in range(14)]
    assert lrs[:4] == [np.float32(0.01)] * 4
    assert lrs[4] == float(np.float32(np.float32(0.1) * np.float32(0.01)))
    assert lrs[12] < lrs[11] < lrs[0]
    warm = toptim.lr_schedule(0.01, (), 4, warmup_step=4, warmup_lr=0.001)
    assert warm(0) == float(np.float32(0.001)) and warm(4) == \
        float(np.float32(0.01))
    assert toptim.parse_lr_step("5, 7") == (5, 7)
    mask = toptim.frozen_mask(
        ["backbone.conv0.weight", "backbone.bn_data.weight",
         "backbone.stage2_unit1.bn1.weight", "backbone.stage2_unit1.bn1.bias",
         "backbone.stage2_unit1.conv1.weight", "bbox_pred.bias",
         "head.stage4_unit1.conv1.weight"],
        generate_config("resnet101").network.fixed_params)
    assert [k for k, v in mask.items() if v] == [
        "backbone.stage2_unit1.conv1.weight", "bbox_pred.bias",
        "head.stage4_unit1.conv1.weight"]
    assert all(toptim.frozen_mask(["backbone.conv1.weight"], ()).values())
