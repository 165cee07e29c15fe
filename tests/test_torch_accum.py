"""Gradient accumulation and backbone remat in the port's train step,
held against the JAX package on the CPU.

One tiny step at ``grad_accum=2`` from the same weights and the same
per-microbatch draws as the JAX ``make_train_step(grad_accum=2)``: the
metrics agree to rtol 1e-5 and each parameter's change to a relative L2
error of 1e-4 (fp32 summation order: the port scales each microbatch's
loss by 1/2 before its backward, the JAX step averages the two
gradients).  ``train.remat_backbone`` recomputes the backbone in the
backward pass and leaves the gradients bit-equal.  On a two-bucket set
the JAX step's ``np.stack`` of consecutive batches fails; the port's
list of microbatches does not stack (ROADMAP Queue C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.core import train as jtrain
from mx_rcnn_tpu.core.fit import _accum_iter as j_accum_iter
from mx_rcnn_tpu.core.optim import make_optimizer as j_make_optimizer
from mx_rcnn_tpu.data.loader import StreamLoader as JStreamLoader
from mx_rcnn_tpu.data.synthetic import SyntheticDataset as JSynthetic
from mx_rcnn_tpu.models import build_model as j_build_model
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core import train as ttrain
from mx_rcnn_tpu_torch.core.fit import _accum_iter, fit
from mx_rcnn_tpu_torch.data.loader import StreamLoader
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
from mx_rcnn_tpu_torch.utils.bridge import to_flax
from tests.test_torch_train import (CPU, _batches, _configs, _jax_draws,
                                    _tree_get)

torch.set_num_threads(1)


def test_an_accumulating_step_matches_jax():
    jcfg, cfg = _configs("tiny")
    b0, b1 = _batches("tiny", count=2)
    model = build_model(cfg, "cpu", seed=2, train=True)
    variables = to_flax(model.state_dict())
    jmodel = j_build_model(jcfg)
    tx = j_make_optimizer(jcfg, variables["params"], 2, base_lr=0.01)
    jstate = jtrain.TrainState(jnp.zeros((), jnp.int32),
                               variables["params"], variables["batch_stats"],
                               tx.init(variables["params"]))
    jstep = jax.jit(jtrain.make_train_step(jmodel, jcfg, tx, grad_accum=2))
    key = jax.random.PRNGKey(5)
    stacked = jtrain.Batch(*(jnp.stack([jnp.asarray(a), jnp.asarray(b)])
                             for a, b in zip(b0, b1)))
    jstate, want = jstep(jstate, stacked, key)

    state = ttrain.init_state(model, cfg, 2, base_lr=0.01)
    step = ttrain.make_train_step(cfg, grad_accum=2)
    # the JAX step's keys: fold_in(fold_in(key, step), microbatch)
    step_key = jax.random.fold_in(key, 0)
    draws = [_jax_draws(jax.random.fold_in(step_key, i), 2)
             for i in range(2)]
    got = step(state, [ttrain.to_device(b, CPU) for b in (b0, b1)],
               draws=draws)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=1e-5, err_msg=name)
    assert state.step == int(jstate.step) == 1
    tparams = to_flax(model.state_dict())["params"]
    for path, want_p in jax.tree_util.tree_leaves_with_path(jstate.params):
        start = _tree_get(variables["params"], path)
        moved = np.asarray(want_p) - start
        err = np.linalg.norm(_tree_get(tparams, path) - np.asarray(want_p))
        assert np.linalg.norm(moved) > 0, path
        assert err <= 1e-4 * np.linalg.norm(moved), path


def test_accumulation_takes_its_microbatch_count_and_seeds():
    _, cfg = _configs("tiny")
    b0, b1 = (ttrain.to_device(b, CPU) for b in _batches("tiny", count=2))
    step = ttrain.make_train_step(cfg, grad_accum=2)
    state = ttrain.setup_training(cfg, "cpu", seed=1)
    with pytest.raises(ValueError, match="2 microbatches"):
        step(state, [b0])
    with pytest.raises(ValueError, match=">= 1"):
        ttrain.make_train_step(cfg, grad_accum=0)
    # by default each microbatch draws from its own seed, and none from
    # the grad_accum=1 step's
    seeds = {ttrain.microbatch_seed(0, s, i) for s in range(50)
             for i in range(4)}
    assert len(seeds) == 200
    assert not seeds & {ttrain.step_seed(0, s) for s in range(50)}
    metrics = step(state, [b0, b1])
    assert state.step == 1 and all(torch.isfinite(v) for v in
                                   metrics.values())


@pytest.mark.parametrize("mode", ["e2e", "rpn"])
def test_remat_backbone_gives_bit_equal_gradients(mode):
    _, cfg = _configs("tiny")
    batch = ttrain.to_device(_batches("tiny")[0], CPU)
    key = jax.random.PRNGKey(3)
    grads, calls = {}, {}
    for remat in (False, True):
        c = cfg.replace_in("train", remat_backbone=remat)
        model = build_model(c, "cpu", seed=1, train=True)
        for p in model.parameters():
            p.requires_grad_(True)
        n = [0]
        model.backbone.register_forward_pre_hook(
            lambda *a: n.__setitem__(0, n[0] + 1))
        total, _ = ttrain.LOSS_FNS[mode](model, batch, c,
                                         _jax_draws(key, 2))
        total.backward()
        grads[remat] = {k: p.grad for k, p in model.named_parameters()}
        calls[remat] = n[0]
    # the backbone runs again in the backward pass only under remat
    assert calls == {False: 1, True: 2}
    assert grads[False].keys() == grads[True].keys()
    for k, g in grads[False].items():
        if g is None:   # the RPN mode leaves the head out
            assert grads[True][k] is None and mode == "rpn", k
        else:
            assert torch.equal(g, grads[True][k]), k


def test_set_override_turns_on_remat_and_sync_snapshots():
    from mx_rcnn_tpu_torch.config import parse_set_overrides

    cfg = generate_config("tiny", "synthetic", **parse_set_overrides(
        ["train__remat_backbone=true", "ft__async_snapshots=false"]))
    assert cfg.train.remat_backbone and not cfg.ft.async_snapshots
    assert generate_config("tiny", "synthetic").ft.async_snapshots


# ---- two buckets ------------------------------------------------------------

def test_two_bucket_microbatches_stack_in_jax_only(tmp_path):
    """Batch 1 over landscape and portrait images: consecutive batches
    change bucket.  The JAX accumulation stacks them and fails; the
    port's list of microbatches trains."""
    jcfg = j_generate_config("tiny", "synthetic",
                             train__rpn_pre_nms_top_n=600,
                             train__rpn_post_nms_top_n=100)
    roidb = []
    for set_, size in (("train", (320, 400)), ("trainp", (400, 320))):
        ds = JSynthetic(set_, str(tmp_path), str(tmp_path / set_),
                        num_images=2, num_classes=4, image_size=size)
        roidb += ds.gt_roidb()
    jl = JStreamLoader(roidb, jcfg, batch_images=1, seed=0, num_workers=0)
    with pytest.raises(ValueError):
        next(j_accum_iter(iter(jl), 2))

    _, cfg = _configs("tiny")
    sets = {(h > w): SyntheticDataset(s, 2, 4, (h, w)) for s, (h, w) in
            (("train", (320, 400)), ("trainp", (400, 320)))}
    roidb = [rec for ds in sets.values() for rec in ds.gt_roidb()]
    load = lambda rec: sets[rec["height"] > rec["width"]].load_image(rec)
    loader = StreamLoader(roidb, cfg, load, batch_images=1, seed=0)
    groups = list(_accum_iter(iter(loader), 2))
    assert len(groups) == 2
    assert {g[0].images.shape != g[1].images.shape for g in groups} == {True}
    state = ttrain.setup_training(cfg, "cpu", seed=1, steps_per_epoch=2)
    metrics = fit(state, cfg, ttrain.make_train_step(cfg, grad_accum=2),
                  loader, end_epoch=1, grad_accum=2, log=lambda line: None)
    assert state.step == 2
    assert all(np.isfinite(v) for v in metrics.values())


def test_the_train_cli_accumulates(tmp_path):
    """``tools/train.py --grad_accum 2``: 8 records at batch 2 are 4
    loader batches, 2 optimizer steps an epoch, recorded in the
    manifest's topology."""
    from mx_rcnn_tpu_torch.tools import train as train_cli
    from mx_rcnn_tpu_torch.utils import checkpoint as tckpt

    prefix = str(tmp_path / "m")
    metrics = train_cli.main([
        "--device", "cpu", "--network", "tiny", "--dataset", "synthetic",
        "--synthetic", "4", "--batch_images", "2", "--grad_accum", "2",
        "--prefix", prefix, "--end_epoch", "1",
        "--set", "train__rpn_pre_nms_top_n=600",
        "--set", "train__rpn_post_nms_top_n=100"])
    m = tckpt.read_manifest(tckpt.checkpoint_path(prefix, 1))
    assert m["step"] == m["steps_per_epoch"] == 2
    assert m["topology"] == {"devices": 1, "processes": 1, "grad_accum": 2,
                             "global_batch": 4}
    assert all(np.isfinite(v) for v in metrics.values())
