"""The port's data parallelism held against the JAX package on the CPU.

Worlds of 2 and 4 ranks are spawned by ``parallel/dp.py — launch`` over
gloo, a few per module (each costs seconds): ``parity_world`` in
``tests/torch_parallel_workers.py`` runs every two-rank check at once and
the cases assert on what it returned.  The tiny network on 128x160
synthetic images, fp32, one image per rank.

- The two-rank step against ``mx_rcnn_tpu.parallel.make_dp_train_step``
  on 2 of the conftest's 8 CPU devices, from the same weights, rank d
  replaying JAX device d's draws (``fold_in(KEY, d)``, then the step and
  microbatch folds): each parameter's change to a relative L2 error of
  1e-4 (``tests/test_torch_accum.py``'s tolerance: fp32 summation order)
  and the metrics to rtol 1e-5, at ``grad_accum`` 1 and 2.
- The all-reduced gradient is the hand-computed mean of the two ranks'
  gradients, bit for bit; replicas are bit-equal after 3 steps; the ranks
  draw different uniforms, and a world of one draws what the
  single-process step draws.
- Loader shards, manifests' topology and data cursor and the resize
  check equal the JAX package's exactly.
"""

import os
import pickle
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.core import train as jtrain
from mx_rcnn_tpu.core.optim import make_optimizer as j_make_optimizer
from mx_rcnn_tpu.data.loader import AnchorLoader as JAnchorLoader
from mx_rcnn_tpu.data.loader import ROIIter as JROIIter
from mx_rcnn_tpu.data.loader import StreamLoader as JStreamLoader
from mx_rcnn_tpu.data.synthetic import SyntheticDataset as JSynthetic
from mx_rcnn_tpu.models import build_model as j_build_model
from mx_rcnn_tpu.parallel import (device_mesh, make_dp_train_step, replicate,
                                  shard_batch)
from mx_rcnn_tpu.parallel.dp import shard_accum_batch
from mx_rcnn_tpu.tools.train import _check_topology as j_check_topology
from mx_rcnn_tpu.utils.checkpoint import make_topology as j_make_topology
from mx_rcnn_tpu.utils.checkpoint import write_manifest as j_write_manifest
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core import train as ttrain
from mx_rcnn_tpu_torch.core.tester import Predictor, pred_eval
from mx_rcnn_tpu_torch.data.loader import AnchorLoader, ROIIter, StreamLoader
from mx_rcnn_tpu_torch.data.loader import TestLoader as PortTestLoader
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
from mx_rcnn_tpu_torch.parallel import dp, multihost
from mx_rcnn_tpu_torch.tools import train as train_cli
from mx_rcnn_tpu_torch.utils import checkpoint as tckpt
from mx_rcnn_tpu_torch.utils.bridge import to_flax
from tests import torch_parallel_workers as workers
from tests.test_torch_train import _jax_draws, _tree_get

torch.set_num_threads(1)
CPU = torch.device("cpu")
KEY = jax.random.PRNGKey(7)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jcfg(**over):
    return j_generate_config("tiny", "synthetic", **{**workers.SMALL, **over})


def _global_batches(n_images: int, per_batch: int, seed: int = 0):
    """Seeded synthetic 128x160 images in batches of ``per_batch``, as
    numpy ``Batch`` es of the port's loader (no flips, no shuffle)."""
    cfg = workers.small_config()
    ds = SyntheticDataset("train", n_images, cfg.num_classes, workers.SIZE)
    return list(AnchorLoader(ds.gt_roidb(), cfg, ds.load_image,
                             batch_images=per_batch, shuffle=False,
                             seed=seed))


def _rows(batch, rank: int, per: int):
    return ttrain.Batch(*(x[rank * per:(rank + 1) * per] for x in batch))


def _recorded(draws, model, batch, cfg):
    """The uniforms ``draws`` gives the port's loss on ``batch``, keyed
    by (site, image), as numpy arrays."""
    out = {}

    def record(site, image, shape):
        u = draws(site, image, shape)
        out[(site, image)] = np.asarray(u, np.float32)
        return u

    ttrain.loss_and_metrics(model, ttrain.to_device(batch, CPU), cfg, record)
    return out


def _jax_dp_step(grad_accum: int):
    """The JAX DP step on 2 CPU devices from the port's seed-2 weights:
    (its params, metrics, global microbatches, rank rows and draws)."""
    cfg = workers.small_config()
    jcfg = _jcfg()
    model = build_model(cfg, "cpu", seed=2, train=True)
    variables = to_flax(model.state_dict())
    jmodel = j_build_model(jcfg)
    tx = j_make_optimizer(jcfg, variables["params"], 2, base_lr=0.01)
    jstate = jtrain.TrainState(jnp.zeros((), jnp.int32), variables["params"],
                               variables["batch_stats"],
                               tx.init(variables["params"]))
    mesh = device_mesh(2)
    step = make_dp_train_step(jmodel, jcfg, tx, mesh, grad_accum=grad_accum)
    micro = _global_batches(2 * grad_accum, 2, seed=grad_accum)
    if grad_accum == 1:
        batch = shard_batch(jtrain.Batch(*micro[0]), mesh)
    else:
        batch = shard_accum_batch(jtrain.Batch(*(
            np.stack(xs) for xs in zip(*micro))), mesh)
    new, metrics = step(replicate(jstate, mesh), batch, KEY)
    rows, draws = [], []
    for d in range(2):
        key = jax.random.fold_in(jax.random.fold_in(KEY, d), 0)
        keys = ([key] if grad_accum == 1 else
                [jax.random.fold_in(key, i) for i in range(grad_accum)])
        rows.append([_rows(mb, d, 1) for mb in micro])
        draws.append([_recorded(_jax_draws(k, 1), model, r, cfg)
                      for k, r in zip(keys, rows[-1])])
    return dict(params=jax.device_get(new.params),
                metrics={k: float(v) for k, v in metrics.items()},
                start=variables["params"], rows=rows, draws=draws)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One two-rank gloo world running ``workers.parity_world``, with the
    JAX DP steps it is held against."""
    want = {ga: _jax_dp_step(ga) for ga in (1, 2)}
    steps = _global_batches(6, 2, seed=5)
    prefix = str(tmp_path_factory.mktemp("stop") / "m")
    spec = dict(jax={ga: (w["rows"], w["draws"]) for ga, w in want.items()},
                steps=[[_rows(b, r, 1) for r in range(2)] for b in steps],
                stop_poll=6, prefix=prefix)
    t0 = time.perf_counter()
    ranks = dp.launch(workers.parity_world, 2, args=(spec,), timeout_s=600)
    return dict(want=want, ranks=ranks, prefix=prefix,
                seconds=time.perf_counter() - t0)


# ---- the step ---------------------------------------------------------------

@pytest.mark.parametrize("grad_accum", [1, 2])
def test_two_rank_step_matches_the_jax_dp_step(two_ranks, grad_accum):
    want = two_ranks["want"][grad_accum]
    for rank in two_ranks["ranks"]:
        got = rank[f"jax{grad_accum}"]
        assert got["step"] == 1
        assert sorted(got["metrics"]) == sorted(want["metrics"])
        for name, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][name], v, rtol=1e-5,
                                       err_msg=name)
        tparams = to_flax(got["params"])["params"]
        for path, want_p in jax.tree_util.tree_leaves_with_path(
                want["params"]):
            moved = np.asarray(want_p) - _tree_get(want["start"], path)
            err = np.linalg.norm(_tree_get(tparams, path) - np.asarray(want_p))
            assert np.linalg.norm(moved) > 0, path
            assert err <= 1e-4 * np.linalg.norm(moved), path
    # the two replicas applied the same update
    a, b = (r[f"jax{grad_accum}"]["params"] for r in two_ranks["ranks"])
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_no_rank_imports_jax(two_ranks):
    assert [r["jax_loaded"] for r in two_ranks["ranks"]] == [False, False]


def test_the_all_reduce_is_the_exact_mean(two_ranks):
    r0, r1 = two_ranks["ranks"]
    assert r0["local_grads"].keys() == r0["mean_grads"].keys()
    for name, g0 in r0["local_grads"].items():
        mean = (g0 + r1["local_grads"][name]) / 2
        assert torch.equal(r0["mean_grads"][name], mean), name
        assert torch.equal(r1["mean_grads"][name], mean), name
    assert any(not torch.equal(g, r1["local_grads"][n])
               for n, g in r0["local_grads"].items())


def test_replicas_are_bit_equal_after_three_steps(two_ranks):
    r0, r1 = two_ranks["ranks"]
    assert r0["sha"] == r1["sha"]


def test_ranks_draw_differently_and_a_world_of_one_as_before(two_ranks):
    r0, r1 = two_ranks["ranks"]
    assert r0["first_draws"].shape == r1["first_draws"].shape
    assert not np.array_equal(r0["first_draws"], r1["first_draws"])
    # rank 0 keeps the seed; the others differ in all 64 bits and in the
    # low 32, all that seeds the CPU generator
    seed = ttrain.step_seed(9, 3)
    assert dp.rank_seed(seed, 0) == seed
    assert len({dp.rank_seed(seed, r) % 2 ** 32 for r in range(64)}) == 64
    assert max(dp.rank_seed(ttrain.microbatch_seed(9, 3, 1), r)
               for r in range(64)) < 2 ** 64
    # World.single leaves the step and its draws as they were, bit for bit
    cfg = workers.small_config()
    batch = ttrain.to_device(_global_batches(2, 2)[0], CPU)
    shas = []
    for world in (None, dp.World.single("cpu")):
        state = ttrain.setup_training(cfg, "cpu", seed=3, steps_per_epoch=2)
        step = ttrain.make_train_step(cfg, world=world)
        for _ in range(2):
            step(state, batch)
        shas.append(workers.state_sha(state))
    assert shas[0] == shas[1]


# ---- fit: the collective stop, the topology, resuming at another size ------

def test_a_stop_on_one_rank_stops_both_with_one_interrupt(two_ranks):
    assert [r["stopped_at"] for r in two_ranks["ranks"]] == [6, 6]
    prefix = two_ranks["prefix"]
    files = sorted(os.listdir(os.path.dirname(prefix)))
    assert files == ["m-0001.ckpt", "m-0001.ckpt.manifest.json",
                     "m-interrupt.ckpt", "m-interrupt.ckpt.manifest.json"]
    assert tckpt.read_manifest(tckpt.interrupt_path(prefix))["step"] == 6


@pytest.mark.parametrize("kind", ["epoch", "interrupt"])
def test_manifests_record_the_world_as_jax_does(two_ranks, kind, tmp_path):
    prefix = two_ranks["prefix"]
    path = (tckpt.checkpoint_path(prefix, 1) if kind == "epoch"
            else tckpt.interrupt_path(prefix))
    got = tckpt.read_manifest(path)
    topo = j_make_topology(2, num_processes=2, grad_accum=1, batch_images=1)
    assert got["topology"] == topo
    ref = str(tmp_path / os.path.basename(path))
    j_write_manifest(ref, b"", kind=got["kind"], step=got["step"],
                     epoch=got["epoch"], steps_per_epoch=4, topology=topo)
    want = tckpt.read_manifest(ref)
    assert got["data_cursor"] == want["data_cursor"]
    assert got["steps_per_epoch"] == want["steps_per_epoch"] == 4


def test_a_two_rank_checkpoint_resumes_in_a_world_of_one(two_ranks,
                                                          tmp_path):
    """Global batch 2 = 2 ranks x 1 image: a world of one resumes the
    interrupt at 2 images a step and finishes; at 1 image a step it is
    refused unless ft.allow_resize_resume is set."""
    import shutil

    src = os.path.dirname(two_ranks["prefix"])
    for name in ("ok", "refused", "allowed"):
        shutil.copytree(src, tmp_path / name)
    # at 1 image a step the epoch has 8 steps: the interrupt's step 6 of 4
    # a step cannot resume, epoch 1's checkpoint can
    tckpt.clear_interrupt(str(tmp_path / "allowed" / "m"))
    lines = []
    state, _ = train_cli.train_net(
        workers.small_config(train__batch_images=2),
        prefix=str(tmp_path / "ok" / "m"), synthetic=4, end_epoch=3,
        lr=0.01, device="cpu", resume="auto", log=lines.append)
    assert state.step == 12
    assert any("resumed mid-epoch from verified" in ln for ln in lines)
    with pytest.raises(ValueError, match="effective global batch 2"):
        train_cli.train_net(workers.small_config(), device="cpu",
                            prefix=str(tmp_path / "refused" / "m"),
                            synthetic=4, end_epoch=3, resume="auto")
    state, _ = train_cli.train_net(
        workers.small_config(ft__allow_resize_resume=True), device="cpu",
        prefix=str(tmp_path / "allowed" / "m"), synthetic=4, end_epoch=2,
        lr=0.01, resume="auto", log=lines.append)
    assert state.step == 8 + 4


@pytest.mark.parametrize("then,now", [
    ((2, 1, 1), (1, 2, 1)), ((2, 1, 1), (1, 1, 2)), ((2, 2, 1), (4, 1, 1)),
    ((2, 1, 1), (1, 1, 1)), ((4, 2, 2), (2, 2, 2)), ((1, 2, 2), (2, 1, 1)),
])
def test_the_resize_check_equals_jax(then, now):
    manifest = {"topology": j_make_topology(then[0], grad_accum=then[2],
                                            batch_images=then[1])}
    devices, per, accum = now
    jcfg = _jcfg(train__batch_images=per)
    cfg = workers.small_config(train__batch_images=per)

    def outcome(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return None

    theirs = outcome(lambda: j_check_topology(manifest, jcfg, devices, accum,
                                              "p"))
    ours = outcome(lambda: train_cli._check_topology(
        manifest, cfg, devices, per, accum, "p", lambda line: None))
    assert (theirs is None) == (ours is None)
    assert (then[0] * then[1] * then[2] == devices * per * accum) == \
        (ours is None)
    if ours is not None:
        assert ours == theirs
    # ft.allow_resize_resume relents in both
    j_check_topology(manifest, jcfg.replace_in("ft", allow_resize_resume=True),
                     devices, accum, "p")
    train_cli._check_topology(
        manifest, cfg.replace_in("ft", allow_resize_resume=True), devices,
        per, accum, "p", lambda line: None)


# ---- loader shards ----------------------------------------------------------

@pytest.fixture(scope="module")
def jax_roidb(tmp_path_factory):
    d = tmp_path_factory.mktemp("jsyn")
    jds = JSynthetic("train", str(d), str(d / "s"), num_images=10,
                     num_classes=4, image_size=(320, 400))
    ours = SyntheticDataset("train", 10, 4, (320, 400))
    return jds.gt_roidb(), ours


def _loaders(kind, roidb, ours, shard, jshard):
    jcfg = j_generate_config("tiny", "synthetic", train__max_gt_boxes=4)
    cfg = generate_config("tiny", "synthetic", train__max_gt_boxes=4)
    kw = dict(batch_images=4, seed=3)
    props = [np.float32([[8, 8, 90, 120, 0.9], [20, 30, 200, 260, 0.5]])
             * (1 + i % 3) for i in range(len(roidb))]
    if kind == "roi":
        return (ROIIter(ours.gt_roidb(), cfg, ours.load_image, props,
                        shard=shard, **kw),
                JROIIter(roidb, jcfg, props, num_workers=0, raw_images=True,
                         shard=jshard, **kw))
    cls, jcls = ((AnchorLoader, JAnchorLoader) if kind == "anchor"
                 else (StreamLoader, JStreamLoader))
    return (cls(ours.gt_roidb(), cfg, ours.load_image, shard=shard, **kw),
            jcls(roidb, jcfg, num_workers=0, raw_images=True, shard=jshard,
                 **kw))


def _epoch(loader, epoch, resume=None):
    loader.set_epoch(epoch)
    if resume is not None:
        loader.resume_at(*resume)
    return list(loader)


@pytest.mark.parametrize("kind", ["anchor", "stream", "roi"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_the_union_of_the_shards_is_the_batch_and_jax_shards(kind, n,
                                                              jax_roidb):
    roidb, ours = jax_roidb
    resumes = [None] + ([(4, 4), (4, 2)] if kind == "stream" else [])
    for resume in resumes:
        whole = _epoch(_loaders(kind, roidb, ours, None, None)[0], 1, resume)
        shards = []
        for r in range(n):
            mine, theirs = _loaders(kind, roidb, ours, (r, n), (r, n))
            got = _epoch(mine, 1, resume)
            want = _epoch(theirs, 1, resume)
            assert len(got) == len(want) == len(whole) > 0
            for g, w in zip(got, want):
                assert len(g.images) == 4 // n
                for a, b in zip(g, w):
                    np.testing.assert_array_equal(a, np.asarray(b))
            shards.append(got)
        for i, batch in enumerate(whole):
            for f, field in enumerate(batch):
                joined = np.concatenate([s[i][f] for s in shards])
                assert joined.dtype == field.dtype
                assert joined.tobytes() == field.tobytes()


@pytest.mark.parametrize("shard,match", [((2, 2), "out of range"),
                                         ((-1, 2), "out of range"),
                                         ((0, 3), "not divisible")])
def test_shards_refuse_as_jax_does(shard, match, jax_roidb):
    roidb, ours = jax_roidb
    with pytest.raises(ValueError, match=match) as theirs:
        _loaders("anchor", roidb, ours, None, shard)
    with pytest.raises(ValueError, match=match) as mine:
        _loaders("anchor", roidb, ours, shard, None)
    assert str(mine.value) == str(theirs.value)


# ---- the rig, dcn_size and the launchers ------------------------------------

@pytest.mark.parametrize("how", ["raise", "exit", "hang"])
def test_a_failed_rank_fails_the_launch_in_time(how):
    t0 = time.perf_counter()
    with pytest.raises((RuntimeError, TimeoutError)) as e:
        dp.launch(workers.failing_rank, 2, args=(how,), timeout_s=20)
    elapsed = time.perf_counter() - t0
    assert elapsed < 60
    want = {"raise": "a planted failure on rank 1",
            "exit": "exited with code 3", "hang": "no result within"}[how]
    assert want in str(e.value)


def test_dcn_size_is_recorded_and_equals_the_flat_world():
    rows = [_rows(_global_batches(4, 4)[0], r, 1) for r in range(4)]
    ranks = dp.launch(workers.dcn_world, 4, args=(rows,), dcn_size=2,
                      timeout_s=300)
    assert {r["dcn_size"] for r in ranks} == {2}
    assert len({r["dcn"] for r in ranks} | {r["flat"] for r in ranks}) == 1
    with pytest.raises(RuntimeError, match="not divisible by dcn_size=3"):
        dp.launch(workers.rank_of, 2, dcn_size=3, timeout_s=60)


def test_multihost_maps_hosts_to_ranks():
    assert [multihost.global_rank(p, r, 4) for p in range(2)
            for r in range(4)] == list(range(8))
    with pytest.raises(ValueError):
        multihost.global_rank(0, 4, 4)
    # the train CLI's share of each host, through the same map
    assert [list(multihost.host_ranks(8, 2, p)) for p in range(2)] == \
        [[multihost.global_rank(p, r, 4) for r in range(4)]
         for p in range(2)]
    assert list(multihost.host_ranks(3, 1, 0)) == [0, 1, 2]
    with pytest.raises(ValueError, match="not a multiple"):
        multihost.host_ranks(3, 2, 0)
    with pytest.raises(ValueError, match="out of range"):
        multihost.host_ranks(4, 2, 2)
    batch = _global_batches(4, 4)[0]
    world = dp.World(rank=1, size=2, device=CPU)
    got = multihost.local_image_slice([batch, batch], world)
    assert len(got) == 2
    np.testing.assert_array_equal(got[0].images, batch.images[2:])


@pytest.mark.parametrize("init_method,pinned", [
    ("file:///tmp/mx_rcnn_world/store", True),
    ("tcp://localhost:29500", True),
    ("tcp://127.0.0.1:29500", True),
    ("tcp://node0.cluster:29500", False),
    ("tcp://10.1.2.3:29500", False),
])
def test_only_a_local_world_pins_the_loopback_interface(init_method, pinned):
    """A rank binds gloo and NCCL's bootstrap to ``lo`` only when every
    rank must be on this host; a ``tcp://`` coordinator elsewhere leaves
    the interface variables as the user set them (or unset)."""
    want = ({"GLOO_SOCKET_IFNAME": "lo", "NCCL_SOCKET_IFNAME": "lo"}
            if pinned else {})
    assert dp.loopback_env(init_method) == want


def test_a_rank_keeps_the_interface_the_user_named(monkeypatch):
    """A spawned rank of a local launch sets the loopback interface only
    where the environment names none."""
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    monkeypatch.setenv("NCCL_SOCKET_IFNAME", "eth7")
    got = dp.launch(workers.interface_env, 1, timeout_s=120)
    assert got == [{"GLOO_SOCKET_IFNAME": "lo", "NCCL_SOCKET_IFNAME": "eth7"}]
    monkeypatch.delenv("NCCL_SOCKET_IFNAME")
    got = dp.launch(workers.interface_env, 1, timeout_s=120)
    assert got == [{"GLOO_SOCKET_IFNAME": "lo", "NCCL_SOCKET_IFNAME": "lo"}]


def test_two_hosts_each_launch_their_share_of_the_world(tmp_path):
    """``train_net`` over a world of 2 ranks spread over 2 "hosts" (two
    launchers in threads of this process, one rank each), meeting at a
    ``tcp://`` coordinator: rank 0 (host 0's) alone writes the epoch
    checkpoint, which records 2 devices."""
    import threading

    from mx_rcnn_tpu_torch.tools.multihost_demo import _free_port

    coordinator = f"localhost:{_free_port()}"
    results, errors = {}, []

    def host(i):
        try:
            results[i] = train_cli.train_net(
                workers.small_config(), prefix=str(tmp_path / f"h{i}" / "m"),
                synthetic=2, end_epoch=1, lr=0.01, device="cpu",
                num_devices=2, num_processes=2, process_id=i,
                coordinator=coordinator, log=lambda line: None)
        except Exception as e:      # reported below, on the test's thread
            errors.append(e)

    threads = [threading.Thread(target=host, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors and not any(t.is_alive() for t in threads)
    assert results[0][0] is None and results[0][1] == results[1][1]
    manifest = tckpt.read_manifest(
        tckpt.checkpoint_path(str(tmp_path / "h0" / "m"), 1))
    assert manifest["topology"]["devices"] == 2
    assert not (tmp_path / "h1").exists()


def test_the_port_demo_agrees_across_two_processes():
    from mx_rcnn_tpu_torch.tools import multihost_demo

    assert multihost_demo.launch(2, steps=2, device="cpu") == 0


def test_dryrun_multichip_on_two_cpu_ranks():
    from mx_rcnn_tpu_torch.parallel.dryrun import dryrun_multichip

    lines = []
    out = dryrun_multichip(2, devices=["cpu", "cpu"], log=lines.append)
    assert np.isfinite(out["loss"]) and out["images"] == 3
    assert len(lines) == 3 and all("OK" in ln for ln in lines)


def test_too_few_cards_raise(monkeypatch):
    from mx_rcnn_tpu_torch.tools.test import test_rcnn

    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        train_cli.train_net(workers.small_config(), num_devices=2,
                            synthetic=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    from mx_rcnn_tpu_torch.tools import multihost_demo

    for call in (lambda: train_cli.train_net(workers.small_config(),
                                             num_devices=2, synthetic=2),
                 lambda: test_rcnn(workers.small_config(), prefix="p",
                                   epoch=1, synthetic=2, num_devices=2),
                 lambda: multihost_demo.launch(2, steps=1)):
        with pytest.raises(RuntimeError, match="2 CUDA devices wanted but "
                           "torch.cuda.device_count\\(\\) is 1"):
            call()
    assert dp.local_devices("cuda", 1) == ["cuda:0"]
    assert dp.local_devices("cpu", 3) == ["cpu"] * 3
    assert dp.local_devices("cuda", 2, ["cuda:0", "cuda:0"]) == \
        ["cuda:0", "cuda:0"]
    with pytest.raises(ValueError, match="requires num_devices > 1"):
        train_cli.train_net(workers.small_config(), dcn_size=2,
                            num_devices=1, device="cpu", synthetic=2)
    with pytest.raises(ValueError, match="requires num_devices > 1"):
        train_cli.train_net(workers.small_config(), dcn_size=2,
                            device="cpu", synthetic=2)


def _cli(images: int) -> list:
    """``tools/train.py``'s flags for the tiny network on ``images``
    synthetic images (and their flips) at 128x160, 1 image a rank."""
    return ["--device", "cpu", "--network", "tiny", "--dataset",
            "synthetic", "--synthetic", str(images), "--batch_images", "1",
            "--frequent", "1", "--set", "train__rpn_pre_nms_top_n=256",
            "--set", "train__rpn_post_nms_top_n=64",
            "--set", "bucket__scale=128", "--set", "bucket__max_size=160",
            "--set", "bucket__shapes=((128, 160), (160, 128))"]


def test_a_spawned_world_of_one_writes_the_plain_runs_bytes(tmp_path):
    """``--num_devices 1``: one spawned rank in a gloo group of one ends
    byte-equal to the run without a group."""
    for name, extra in (("plain", []), ("world", ["--num_devices", "1"])):
        train_cli.main(_cli(2) + ["--prefix", str(tmp_path / name / "m"),
                               "--end_epoch", "1", *extra])
    paths = [tckpt.checkpoint_path(str(tmp_path / n / "m"), 1)
             for n in ("plain", "world")]
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    assert tckpt.read_manifest(paths[1])["topology"]["devices"] == 1


def test_sigterm_to_the_launcher_stops_every_rank(tmp_path):
    """``tools/train.py --num_devices 2`` in a process of its own (8
    images and their flips: 8 steps an epoch), SIGTERM at epoch 1's first
    step: exit 0, both ranks ended at the interrupt's step, one interrupt
    checkpoint from rank 0 with ``topology.devices = 2``."""
    prefix = str(tmp_path / "m")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.train", *_cli(8),
         "--num_devices", "2", "--prefix", prefix, "--end_epoch", "50"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines, sent = [], False
    try:
        for line in proc.stdout:
            lines.append(line)
            if not sent and line.startswith("Epoch[1] Batch [0]"):
                proc.send_signal(signal.SIGTERM)
                sent = True
        rc = proc.wait(timeout=120)
    finally:
        proc.kill()
        proc.wait()
    text = "".join(lines)
    assert sent and rc == 0, text
    manifest = tckpt.read_manifest(tckpt.interrupt_path(prefix))
    assert manifest["topology"]["devices"] == 2, text
    step = manifest["step"]
    assert 8 < step < 16
    assert f"ended at steps [{step}, {step}]" in text
    assert text.count("saved interrupt checkpoint") == 1


# ---- the split predictor ----------------------------------------------------

def test_a_split_predictor_equals_one_device(tmp_path):
    """Three CPU "devices", one image each of a 3-image eval batch: 5
    images give batches of 3 and 2 (one pad row).  The detections and
    APs equal the single-device eval at one image a batch; the forward
    equals one device's forward of each slice."""
    cfg = workers.small_config(test__batch_images=1)
    ds = SyntheticDataset("test", 5, cfg.num_classes, workers.SIZE)
    model = build_model(cfg, "cpu", seed=4)
    single = Predictor(model, cfg, "cpu")
    split = Predictor(build_model(cfg, "cpu", seed=4), cfg,
                      devices=["cpu"] * 3)
    assert [d.type for d, _ in split.replicas] == ["cpu"] * 3
    runs = {}
    for name, pred, n in (("single", single, 1), ("split", split, 3)):
        save = str(tmp_path / f"{name}.pkl")
        runs[name] = pred_eval(pred, PortTestLoader(ds.gt_roidb(), cfg,
                                                ds.load_image,
                                                batch_images=n),
                               ds, cfg, verbose=False, save_dets=save)
        with open(save, "rb") as f:
            runs[name + "_dets"] = pickle.load(f)["all_boxes"]
    assert runs["single"] == runs["split"]
    for a, b in zip(runs["single_dets"], runs["split_dets"]):
        for x, y in zip(a, b):
            assert x.tobytes() == y.tobytes()
    batch = next(iter(PortTestLoader(ds.gt_roidb(), cfg, ds.load_image,
                                 batch_images=5)))[0]
    got = split.raw(batch.images, batch.im_info)
    pad = lambda a, fill: np.concatenate(
        [a, np.full((1,) + a.shape[1:], fill, a.dtype)])
    images, im_info = pad(batch.images, 0), pad(batch.im_info, 1)
    parts = [single.raw(images[i:i + 2], im_info[i:i + 2])
             for i in (0, 2, 4)]
    for j, t in enumerate(got):
        assert t.shape[0] == 5
        assert torch.equal(t, torch.cat([p[j] for p in parts])[:5])
