"""Public names the port's ported modules carry as the JAX ones do, held
against them on the CPU: ``serve/queue.py — ServeRequest.queue_wait_s``
and ``total_s``, and ``utils/checkpoint.py — tree_size_bytes``.
"""

import numpy as np
import pytest
import torch

from mx_rcnn_tpu.serve import queue as j_queue
from mx_rcnn_tpu.utils import checkpoint as j_ckpt
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
