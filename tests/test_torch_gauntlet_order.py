"""The gauntlet's cells draw the JAX cells' data: at each seed of the
production recipe (``script/torch_gauntlet.sh``: seeds 0-4, 30 epochs)
the port's ``train_net`` on the gauntlet's config (``tools/gauntlet.py —
_base_cfg``, the generated ``synthetic_hard`` set, 400 images and their
flips) feeds the JAX ``train_net``'s records in its order and flips,
epoch for epoch.  ``fit`` is replaced in both packages by a recorder of
the loader's plan, so nothing trains.
"""

import argparse

import numpy as np
import pytest

from mx_rcnn_tpu.tools import gauntlet as jg
from mx_rcnn_tpu.tools import train as jtrain_tool
from mx_rcnn_tpu_torch.tools import gauntlet as tg
from mx_rcnn_tpu_torch.tools import train as train_tool

EPOCHS = 30     # the production recipe's


def _recorded(into: dict, returns):
    """A ``fit`` for either package that records the loader's records
    and its plan of every epoch instead of training."""
    def fake_fit(*args, **kw):
        loader = next(a for a in args if hasattr(a, "set_epoch"))
        into["kind"] = type(loader).__name__
        into["records"] = [
            (r["image"], bool(r["flipped"]), r["height"], r["width"],
             np.asarray(r["boxes"]).tobytes(),
             np.asarray(r["gt_classes"]).tobytes()) for r in loader.roidb]
        plans = []
        for epoch in range(EPOCHS):
            loader.set_epoch(epoch)
            plan = (loader.plan() if hasattr(loader, "plan")
                    else loader._epoch_plan(epoch))
            plans.append([(tuple(b), [int(i) for i in idx])
                          for b, idx in plan])
        into["plans"] = plans
        return returns(args)
    return fake_fit


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("hard"))


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_cell_draws_the_jax_cells_order_and_flips(root, monkeypatch, seed):
    args = argparse.Namespace(network="tiny", root=root, batch_images=2)
    ours, theirs = {}, {}
    monkeypatch.setattr(train_tool, "fit", _recorded(ours, lambda a: {}))
    monkeypatch.setattr(jtrain_tool, "fit", _recorded(theirs,
                                                      lambda a: a[2]))
    train_tool.train_net(tg._base_cfg(args), prefix=None, end_epoch=EPOCHS,
                         lr=3e-3, lr_step=str(EPOCHS - 6), seed=seed,
                         device="cpu", log=lambda line: None)
    jtrain_tool.train_net(jg._base_cfg(args), prefix=None, end_epoch=EPOCHS,
                          lr=3e-3, lr_step=str(EPOCHS - 6), seed=seed)
    assert ours["kind"] == theirs["kind"] == "StreamLoader"
    assert len(ours["records"]) == 800
    assert sum(r[1] for r in ours["records"]) == 400
    assert ours["records"] == theirs["records"]
    assert len(ours["plans"]) == EPOCHS
    for epoch, (got, want) in enumerate(zip(ours["plans"],
                                            theirs["plans"])):
        assert got == want, f"seed {seed}, epoch {epoch}"
        assert sorted(i for _, idx in got for i in idx) == list(range(800))
    assert ours["plans"][0] != ours["plans"][1]
