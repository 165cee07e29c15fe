"""The port's device-resident epoch held against the JAX package on the CPU.

``data/device_cache.py`` and ``parallel/dp.py — make_dp_cached_step``
against ``mx_rcnn_tpu/data/device_cache.py`` and the JAX
``make_dp_cached_step``: the tiny network on 128x160 synthetic images,
fp32, weights through ``utils/bridge.py``, the JAX step's draws replayed
(``tests/test_torch_train.py — _jax_draws``) and, at ``shuffle=True``,
the JAX permutation ``permutation(fold_in(fold_in(key, 0x5A5A5A5),
epoch), n)`` injected through the cached step's ``permutation`` hook.
Metrics agree to rtol 1e-5 and each parameter's change to a relative L2
error of 1e-4 (``tests/test_torch_train.py``'s tolerance: fp32
summation order); gathered batches are equal bit for bit.  In the port,
the cached run is byte-equal to the streamed one at ``shuffle=False``,
on one process and on a two-rank gloo world.
"""

import hashlib
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.core import train as jtrain
from mx_rcnn_tpu.core.optim import make_optimizer as j_make_optimizer
from mx_rcnn_tpu.data import device_cache as jdc
from mx_rcnn_tpu.models import build_model as j_build_model
from mx_rcnn_tpu.parallel import device_mesh
from mx_rcnn_tpu.parallel import replicate as j_replicate
from mx_rcnn_tpu.parallel.dp import make_dp_cached_step as j_dp_cached_step
from mx_rcnn_tpu_torch.core import train as ttrain
from mx_rcnn_tpu_torch.core.fit import fit
from mx_rcnn_tpu_torch.data.device_cache import (DeviceEpochCache,
                                                 build_caches,
                                                 epoch_permutation,
                                                 make_cached_step)
from mx_rcnn_tpu_torch.data.loader import AnchorLoader
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
from mx_rcnn_tpu_torch.parallel import dp
from mx_rcnn_tpu_torch.tools import train as train_cli
from mx_rcnn_tpu_torch.utils import checkpoint as tckpt
from mx_rcnn_tpu_torch.utils.bridge import to_flax
from tests import torch_parallel_workers as workers
from tests.test_torch_parallel import _recorded
from tests.test_torch_train import _jax_draws, _tree_get

torch.set_num_threads(1)
CPU = torch.device("cpu")
KEY = jax.random.PRNGKey(7)


def _jcfg(**over):
    return j_generate_config("tiny", "synthetic", **{**workers.SMALL, **over})


def _batches(n_images: int, per_batch: int):
    """Seeded synthetic 128x160 images in batches of ``per_batch``: the
    port loader's numpy batches (no flips, no shuffle)."""
    cfg = workers.small_config()
    ds = SyntheticDataset("train", n_images, cfg.num_classes, workers.SIZE)
    return list(AnchorLoader(ds.gt_roidb(), cfg, ds.load_image,
                             batch_images=per_batch, shuffle=False))


def _jax_permutation(key):
    """The cached step's ``permutation`` hook giving the JAX package's
    ``perm_e`` of a run keyed ``key``."""
    def permutation(seed, epoch, n, device):
        k = jax.random.fold_in(jax.random.fold_in(key, 0x5A5A5A5), epoch)
        return torch.from_numpy(
            np.asarray(jax.random.permutation(k, n)).astype(np.int64))
    return permutation


def _tagged_batches(n_batches=5, bi=2, seed=0):
    """Numpy batches of distinct random images and gt fields."""
    rng = np.random.RandomState(seed)
    return [ttrain.Batch(
        rng.randint(0, 256, (bi, 4, 6, 3)).astype(np.uint8),
        rng.rand(bi, 3).astype(np.float32),
        rng.rand(bi, 3, 4).astype(np.float32),
        rng.randint(0, 9, (bi, 3)).astype(np.int32),
        rng.rand(bi, 3) > 0.5) for _ in range(n_batches)]


class _Stub:
    """The state fields the cached step reads."""

    def __init__(self, seed=0):
        self.step, self.seed = 0, seed


def _spy(into):
    def step(stub, batch, **kw):
        into.append([x.clone() for x in batch])
        stub.step += 1
    return step


def _assert_params_moved_like(want_params, start, tparams):
    for path, want_p in jax.tree_util.tree_leaves_with_path(want_params):
        moved = np.asarray(want_p) - _tree_get(start, path)
        err = np.linalg.norm(_tree_get(tparams, path) - np.asarray(want_p))
        assert np.linalg.norm(moved) > 0, path
        assert err <= 1e-4 * np.linalg.norm(moved), path


# ---- the step's seeds -------------------------------------------------------

@pytest.mark.parametrize("grad_accum", [1, 2])
def test_two_cpu_seeds_draw_different_uniforms_at_one_step(grad_accum,
                                                           monkeypatch):
    """Runs seeded 0 and 1 at step 3 of the same weights and batch: the
    CPU generator keeps only the low 32 bits of its seed, which must
    therefore carry the run's seed (the step seed put it in the high 32
    bits, and every --seed drew the same uniforms on the CPU)."""
    cfg = workers.small_config()
    batch = ttrain.to_device(_batches(1, 1)[0], CPU)
    plain, first = ttrain.generator_draws, []

    def recording(generator):
        fn = plain(generator)

        def draw(site, image, shape):
            u = fn(site, image, shape)
            first.append(u.clone())
            return u
        return draw

    monkeypatch.setattr(ttrain, "generator_draws", recording)
    drawn = {}
    for seed in (0, 1, 0):
        state = ttrain.setup_training(cfg, "cpu", seed=seed)
        state.optimizer.count = 3
        first.clear()
        ttrain.make_train_step(cfg, grad_accum=grad_accum)(
            state, batch if grad_accum == 1 else [batch, batch])
        drawn.setdefault(seed, []).append(first[0])
    assert not torch.equal(drawn[0][0], drawn[1][0])
    assert torch.equal(drawn[0][0], drawn[0][1])


# ---- the gather and the permutation -----------------------------------------

@pytest.mark.parametrize("shuffle", [False, True])
def test_the_gathered_batches_equal_jaxs_at_every_step(shuffle):
    """Three epochs of five staged batches: every field of every gathered
    batch equals the JAX cached step's, with its permutation injected."""
    batches = _tagged_batches()
    jcache = jdc.DeviceEpochCache([jtrain.Batch(*b) for b in batches])
    jstep = jax.jit(jdc.make_cached_step(
        lambda state, batch, key: (state, batch), 5, shuffle=shuffle))
    got = []
    step = make_cached_step(_spy(got), 5, shuffle,
                            permutation=_jax_permutation(KEY))
    cache, stub = DeviceEpochCache(batches, CPU), _Stub()
    state, idx = jnp.zeros(()), jcache.index_handle()
    for k in range(15):
        state, idx, want = jstep(state, jcache.data, idx, KEY)
        step(stub, cache)
        for name, a, b in zip(ttrain.Batch._fields, want, got[k]):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=(k, name))
    assert stub.step == int(idx) == 15


def test_the_ports_permutation_is_once_per_image_and_follows_epoch_and_seed():
    """Drawn on the CPU here, where the generator keeps only the low 32
    bits of a seed: each epoch's order holds every staged image once,
    and the order changes with the epoch and with the run's seed."""
    n = 24
    perms = {(s, e): epoch_permutation(s, e, n, "cpu")
             for s in (0, 1) for e in (0, 1)}
    for p in perms.values():
        assert sorted(p.tolist()) == list(range(n))
    assert not torch.equal(perms[0, 0], perms[0, 1])
    assert not torch.equal(perms[0, 0], perms[1, 0])
    assert torch.equal(perms[0, 1], epoch_permutation(0, 1, n, "cpu"))
    # through the step: every image once an epoch, batches regrouped
    batches = _tagged_batches(n_batches=6)
    got = []
    step = make_cached_step(_spy(got), 6, shuffle=True)
    cache, stub = DeviceEpochCache(batches, CPU), _Stub()
    for _ in range(12):
        step(stub, cache)
    flat = cache.data.images.flatten(0, 1)

    def position(img):
        return next(j for j in range(len(flat)) if torch.equal(flat[j], img))

    epochs = [[[position(img) for img in b[0]] for b in got[e * 6:
                                                               (e + 1) * 6]]
              for e in range(2)]
    for e in epochs:
        assert sorted(j for b in e for j in b) == list(range(12))
    assert ({frozenset(b) for b in epochs[0]}
            != {frozenset(b) for b in epochs[1]})


def test_build_caches_groups_by_bucket_and_refuses_past_its_budget():
    land = _tagged_batches(n_batches=3, seed=1)
    port = [ttrain.Batch(b.images.transpose(0, 2, 1, 3).copy(), *b[1:])
            for b in _tagged_batches(n_batches=2, seed=2)]
    mixed = [land[0], port[0], land[1], port[1], land[2]]
    caches = build_caches(mixed, device=CPU)
    assert [c.num_batches for c in caches] == [3, 2]
    assert [tuple(c.data.images.shape) for c in caches] == [
        (3, 2, 4, 6, 3), (2, 2, 6, 4, 3)]
    assert caches[0].nbytes == sum(x.nbytes for b in land for x in b)
    for p in range(2):
        for a, b in zip(caches[1].batch(p), port[p]):
            np.testing.assert_array_equal(a.numpy(), b)
    budget = sum(x.nbytes for b in mixed[:2] for x in b)
    with pytest.raises(MemoryError, match="device cache budget"):
        build_caches(mixed, max_bytes=budget, device=CPU)
    with pytest.raises(ValueError, match="mixed bucket shapes"):
        DeviceEpochCache(mixed[:2], CPU)
    with pytest.raises(ValueError, match="empty"):
        DeviceEpochCache([], CPU)


# ---- the train step against the JAX package --------------------------------

@pytest.mark.parametrize("shuffle", [False, True])
def test_cached_steps_match_jax_make_cached_step(shuffle):
    """Four cached steps over a three-batch epoch (into the second epoch)
    from the same weights, draws and permutation: metrics to rtol 1e-5,
    each parameter's change to a relative L2 error of 1e-4."""
    cfg = workers.small_config(train__batch_images=2)
    jcfg = _jcfg(train__batch_images=2)
    batches = _batches(6, 2)
    model = build_model(cfg, "cpu", seed=2, train=True)
    variables = to_flax(model.state_dict())
    tx = j_make_optimizer(jcfg, variables["params"], 3, base_lr=0.01)
    jstate = jtrain.TrainState(jnp.zeros((), jnp.int32),
                               variables["params"], variables["batch_stats"],
                               tx.init(variables["params"]))
    jcache = jdc.DeviceEpochCache([jtrain.Batch(*b) for b in batches])
    jstep = jax.jit(jdc.make_cached_step(
        jtrain.make_train_step(j_build_model(jcfg), jcfg, tx), 3,
        shuffle=shuffle))
    idx = jcache.index_handle()
    state = ttrain.init_state(model, cfg, 3, base_lr=0.01)
    cache = DeviceEpochCache(batches, CPU)
    step = make_cached_step(ttrain.make_train_step(cfg), 3, shuffle,
                            permutation=_jax_permutation(KEY))
    for k in range(4):
        jstate, idx, want = jstep(jstate, jcache.data, idx, KEY)
        got = step(state, cache, draws=_jax_draws(KEY, 2, step=k))
        for name in want:
            np.testing.assert_allclose(float(got[name]), float(want[name]),
                                       rtol=1e-5, err_msg=(k, name))
    assert state.step == int(jstate.step) == 4
    _assert_params_moved_like(jstate.params, variables["params"],
                              to_flax(model.state_dict())["params"])


# ---- fit and the training CLI -----------------------------------------------

def _train(prefix=None, *, stop_after=None, shuffle=True, **kw):
    """``train_net`` of the tiny network on 4 synthetic images and their
    flips at batch 2 (4 steps an epoch); ``stop_after`` polls set the
    stop flag.  Returns the state and the log lines."""
    calls, lines = [], []

    def stop_flag():
        calls.append(1)
        return stop_after is not None and len(calls) >= stop_after

    state, _ = train_cli.train_net(
        workers.small_config(train__batch_images=2, train__shuffle=shuffle),
        prefix=prefix, synthetic=4, lr=0.01, seed=0, device="cpu",
        frequent=1, stop_flag=stop_flag, log=lines.append, **kw)
    return state, lines


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_fit_with_the_cache_equals_streaming_at_shuffle_false(tmp_path):
    streamed, cached = (str(tmp_path / name) for name in ("s", "c"))
    _, s_lines = _train(streamed, end_epoch=2, shuffle=False)
    _, c_lines = _train(cached, end_epoch=2, shuffle=False,
                        device_cache=True)
    for e in (1, 2):
        assert _digest(tckpt.checkpoint_path(streamed, e)) == \
            _digest(tckpt.checkpoint_path(cached, e)), e
    assert any(line.startswith("device cache: 4 batches of 2 images")
               for line in c_lines)
    # the same Speedometer lines, each step's metrics equal
    pick = lambda lines: [ln.split("%, ")[1] for ln in lines  # noqa: E731
                          if " Speed: " in ln]
    assert pick(c_lines) == pick(s_lines) and len(pick(c_lines)) == 8
    assert all("data wait 0.0%" in ln for ln in c_lines if " Speed: " in ln)


def test_a_shuffled_cached_run_is_deterministic_and_regroups(tmp_path):
    a, _ = _train(end_epoch=2, device_cache=True)
    b, _ = _train(end_epoch=2, device_cache=True)
    c, _ = _train(end_epoch=2, device_cache=True, shuffle=False)
    assert workers.state_sha(a) == workers.state_sha(b)
    assert workers.state_sha(a) != workers.state_sha(c)


def test_a_mid_epoch_interrupt_resumes_byte_equal(tmp_path):
    """Stopped after 6 of 8 steps (mid epoch 1) then ``--resume auto``:
    both epoch checkpoints equal those of an unbroken cached run."""
    straight, broken = str(tmp_path / "u"), str(tmp_path / "b")
    _train(straight, end_epoch=2, device_cache=True)
    _, lines = _train(broken, end_epoch=2, device_cache=True, stop_after=6)
    assert any("saved interrupt checkpoint" in ln for ln in lines)
    assert tckpt.read_manifest(tckpt.interrupt_path(broken))["step"] == 6
    _, lines = _train(broken, end_epoch=2, device_cache=True, resume="auto")
    assert any("skipping 2 consumed steps" in ln for ln in lines)
    for e in (1, 2):
        assert _digest(tckpt.checkpoint_path(broken, e)) == \
            _digest(tckpt.checkpoint_path(straight, e)), e


def test_fit_refuses_several_buckets_several_batches_a_step_and_hosts():
    cfg = workers.small_config()
    state = ttrain.setup_training(cfg, "cpu", seed=0, steps_per_epoch=2)
    roidb = [dict(image=str(i), index=i, height=h, width=w, flipped=False,
                  boxes=np.array([[4, 4, 40, 40]], np.float32),
                  gt_classes=np.array([1], np.int32))
             for i, (h, w) in enumerate([(128, 160)] * 2 + [(160, 128)] * 2)]
    blank = lambda rec: np.zeros((rec["height"], rec["width"], 3),  # noqa
                                 np.uint8)
    step = ttrain.make_train_step(cfg)
    loader = AnchorLoader(roidb, cfg, blank, batch_images=1)
    with pytest.raises(ValueError, match="single-bucket dataset"):
        fit(state, cfg, step, loader, 1, device_cache=True,
            log=lambda line: None)
    with pytest.raises(ValueError, match="grad_accum"):
        fit(state, cfg, ttrain.make_train_step(cfg, grad_accum=2), loader,
            1, grad_accum=2, device_cache=True, log=lambda line: None)
    assert state.step == 0
    with pytest.raises(ValueError, match="several hosts"):
        train_cli.train_net(cfg, device="cpu", synthetic=4, num_devices=2,
                            coordinator="localhost:1", num_processes=2,
                            device_cache=True)


def test_profile_dir_writes_a_trace(tmp_path):
    _, lines = _train(end_epoch=2, device_cache=True,
                      profile_dir=str(tmp_path / "prof"))
    path = tmp_path / "prof" / "trace.json"
    assert f"profiler trace written to {path}" in lines
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


# ---- the two-rank world -----------------------------------------------------

def _jax_dp_cached(steps: int = 3):
    """The JAX ``make_dp_cached_step`` on 2 CPU devices from the port's
    seed-2 weights over a two-batch epoch of 1 image a device at
    ``shuffle=True``, ``steps`` steps (into the second epoch): its params
    and metrics, and for each rank its staged rows, the permutations and
    the draws of the batch it gathers at each step."""
    cfg, jcfg = workers.small_config(), _jcfg()
    batches = _batches(4, 2)
    model = build_model(cfg, "cpu", seed=2, train=True)
    variables = to_flax(model.state_dict())
    tx = j_make_optimizer(jcfg, variables["params"], 2, base_lr=0.01)
    jstate = jtrain.TrainState(jnp.zeros((), jnp.int32),
                               variables["params"], variables["batch_stats"],
                               tx.init(variables["params"]))
    mesh = device_mesh(2)
    (jcache,) = jdc.build_caches([jtrain.Batch(*b) for b in batches],
                                 mesh=mesh)
    cstep = j_dp_cached_step(j_build_model(jcfg), jcfg, tx, mesh, 2,
                             shuffle=True)
    s, idx, metrics = j_replicate(jstate, mesh), jnp.zeros((), jnp.int32), []
    for _ in range(steps):
        s, idx, m = cstep(s, jcache.data, idx, KEY)
        metrics.append({k: float(v) for k, v in m.items()})
    perms = {e: _jax_permutation(KEY)(0, e, 2, CPU).numpy()
             for e in range(2)}
    rows = [[ttrain.Batch(*(x[d:d + 1] for x in b)) for b in batches]
            for d in range(2)]
    draws = [[_recorded(_jax_draws(jax.random.fold_in(KEY, d), 1, step=k),
                        model, rows[d][perms[k // 2][k % 2]], cfg)
              for k in range(steps)] for d in range(2)]
    return dict(params=jax.device_get(s.params), metrics=metrics,
                start=variables["params"], rows=rows, perms=perms,
                draws=draws)


@pytest.fixture(scope="module")
def cached_ranks():
    """One two-rank gloo world running ``workers.cached_world``."""
    want = _jax_dp_cached()
    spec = {k: want[k] for k in ("rows", "perms", "draws")}
    t0 = time.perf_counter()
    ranks = dp.launch(workers.cached_world, 2, args=(spec,), timeout_s=600)
    return dict(want=want, ranks=ranks, seconds=time.perf_counter() - t0)


def test_the_two_rank_cached_step_matches_the_jax_dp_cached_step(
        cached_ranks):
    want = cached_ranks["want"]
    for rank in cached_ranks["ranks"]:
        got = rank["jax"]
        assert got["step"] == 3
        for k, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
            for name in w:
                np.testing.assert_allclose(g[name], w[name], rtol=1e-5,
                                           err_msg=(k, name))
        _assert_params_moved_like(want["params"], want["start"],
                                  to_flax(got["params"])["params"])
    a, b = (r["jax"]["params"] for r in cached_ranks["ranks"])
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_the_cached_world_equals_the_streamed_world_at_shuffle_false(
        cached_ranks):
    shas = [r["fit"] for r in cached_ranks["ranks"]]
    assert shas[0][True] == shas[0][False] == shas[1][True] == shas[1][False]


def test_each_rank_regroups_only_its_own_shard(cached_ranks):
    staged = [r["staged"] for r in cached_ranks["ranks"]]
    # the shards split the epoch: 8 records, 4 on each rank
    assert sorted(staged[0] + staged[1]) == sorted(
        (i, f) for i in range(4) for f in (False, True))
    for rank, own in zip(cached_ranks["ranks"], staged):
        bi = rank["batch_images"]
        comps = []
        for epoch in rank["gathered"]:
            assert sorted(epoch) == sorted(own)  # once each, none moved
            comps.append({frozenset(epoch[i:i + bi])
                          for i in range(0, len(epoch), bi)})
        assert len({frozenset(c) for c in comps}) > 1
