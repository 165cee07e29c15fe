"""Public names the port's ported modules carry as the JAX ones do, held
against them on the CPU: ``serve/queue.py — ServeRequest.queue_wait_s``
and ``total_s``, ``utils/checkpoint.py — tree_size_bytes``, and the
``serve/metrics.py`` back-compat shim.
"""

import numpy as np
import pytest
import torch

from mx_rcnn_tpu.serve import metrics as j_serve_metrics
from mx_rcnn_tpu.serve import queue as j_queue
from mx_rcnn_tpu.utils import checkpoint as j_ckpt
from mx_rcnn_tpu_torch.obs import metrics as t_obs_metrics
from mx_rcnn_tpu_torch.serve import metrics as t_serve_metrics
from mx_rcnn_tpu_torch.serve import queue as t_queue
from mx_rcnn_tpu_torch.utils import checkpoint as t_ckpt


def _walk(mod, dispatch_at, done, now=10.0):
    """A request admitted at ``now``, dispatched at ``dispatch_at``
    (None: never) and ended ``done`` = (state, at) (None: pending):
    (queue_wait_s, total_s)."""
    req = mod.ServeRequest(np.zeros((4, 4, 3), np.float32),
                           np.array([4, 4, 1], np.float32), (4, 4), None, now)
    before = (req.queue_wait_s, req.total_s)
    if dispatch_at is not None:
        req.dispatch_t = dispatch_at
    if done is not None:
        req._finish(done[0], now=done[1])
    return before, (req.queue_wait_s, req.total_s)


@pytest.mark.parametrize("dispatch_at,done", [
    (None, None),
    (10.25, None),
    (10.25, ("served", 11.5)),
    (None, ("shed", 10.0)),
    (None, ("expired", 12.75)),
    (10.5, ("failed", 10.75)),
])
def test_request_latency_accounting_equals_jax(dispatch_at, done):
    want = _walk(j_queue, dispatch_at, done)
    got = _walk(t_queue, dispatch_at, done)
    assert got == want
    assert got[0] == (None, None)


def _tree(rng, as_torch):
    conv = rng.rand(3, 3, 4, 8).astype(np.float32)
    trace = rng.rand(8).astype(np.float32)
    tree = {"params": {"conv": {"kernel": conv,
                                "bias": np.zeros(8, np.float32)}},
            "batch_stats": {"bn": {"mean": rng.rand(4).astype(np.float64)}},
            "opt": [trace, (np.int32(3), None)],
            "step": np.array(7, np.int32), "empty": {}}
    if as_torch:
        tree["params"]["conv"]["kernel"] = torch.from_numpy(conv)
        tree["opt"][0] = torch.from_numpy(trace).to(torch.bfloat16)
    return tree


@pytest.mark.parametrize("seed", [0, 1])
def test_tree_size_bytes_equals_jax(seed):
    tree = _tree(np.random.RandomState(seed), as_torch=False)
    assert t_ckpt.tree_size_bytes(tree) == j_ckpt.tree_size_bytes(tree) \
        == 3 * 3 * 4 * 8 * 4 + 8 * 4 + 4 * 8 + 8 * 4 + 4 + 4


def test_tree_size_bytes_counts_tensors_by_their_dtype():
    """A tensor leaf counts its own bytes (a bf16 trace two a value), as
    the JAX function counts a jnp array's."""
    np_tree = _tree(np.random.RandomState(0), as_torch=False)
    t_tree = _tree(np.random.RandomState(0), as_torch=True)
    assert t_ckpt.tree_size_bytes(t_tree) == \
        j_ckpt.tree_size_bytes(np_tree) - 8 * 2
    model = torch.nn.Linear(3, 2)
    assert t_ckpt.tree_size_bytes(model.state_dict()) == (6 + 2) * 4


SHIM_NAMES = ("Histogram", "Registry", "ServeMetrics")


@pytest.mark.parametrize("name", SHIM_NAMES)
def test_serve_metrics_shim_reexports_obs_metrics(name):
    """``serve/metrics.py`` carries the JAX shim's names, each the very
    object ``obs/metrics.py`` defines."""
    assert getattr(t_serve_metrics, name) is getattr(t_obs_metrics, name)
    assert hasattr(j_serve_metrics, name)


def test_serve_metrics_shim_has_the_jax_names_but_lowering_counter():
    def public(mod):
        return {n for n in vars(mod) if not n.startswith("_")
                and isinstance(getattr(mod, n), type)}

    assert public(j_serve_metrics) - public(t_serve_metrics) == \
        {"LoweringCounter"}
    assert public(t_serve_metrics) == set(SHIM_NAMES)
    # the port counts kernel builds in LoweringCounter's place
    from mx_rcnn_tpu_torch import kernels

    assert set(kernels.load_events()) >= {"builds"}


def test_serve_metrics_shim_snapshot_equals_jax():
    """A ServeMetrics through each shim: the same snapshot after the
    same traffic."""
    snaps = []
    for mod in (j_serve_metrics, t_serve_metrics):
        m = mod.ServeMetrics()
        for _ in range(3):
            m.count("submitted")
        m.count("served", 2)
        m.count("shed")
        for v in (0.5, 3.0, 120.0):
            m.observe("queue_wait_ms", v)
        m.observe_batch(3, 4, 12.5)
        snaps.append(m.snapshot())
    assert snaps[1] == snaps[0]
