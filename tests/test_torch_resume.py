"""Stopping and resuming a port training run on the CPU.

A tiny ``train_net`` stopped by its ``stop_flag`` in the middle of an
epoch writes the interrupt checkpoint; ``resume='auto'`` continues from
it, through the manifest's data cursor, and ends with the checkpoint
bytes of a run without a break, also past a corrupt newest file and from
a SIGTERM sent to the CLI in a process of its own.  A resume at another
effective batch fails unless ``ft.allow_resize_resume``.
``StreamLoader.resume_at`` plans equal the JAX package's, at the
recording run's batch size and at another.
"""

import hashlib
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.data.loader import StreamLoader as JStreamLoader
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.data.loader import StreamLoader
from mx_rcnn_tpu_torch.tools import train as train_cli
from mx_rcnn_tpu_torch.utils import checkpoint as tckpt
from tests.test_torch_datasets import SMALL

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the tiny network on 4 synthetic images and their flips: 8 records, 4
# steps an epoch at batch 2
TINY = dict(train__rpn_pre_nms_top_n=600, train__rpn_post_nms_top_n=100)
ARGV = ["--device", "cpu", "--network", "tiny", "--dataset", "synthetic",
        "--synthetic", "4", "--batch_images", "2", "--lr", "0.01",
        "--frequent", "1", "--set", "train__rpn_pre_nms_top_n=600",
        "--set", "train__rpn_post_nms_top_n=100"]


def _cfg(**over):
    return generate_config("tiny", "synthetic",
                           **{"train__batch_images": 2, **TINY, **over})


def _train(prefix, *, stop_after=None, cfg=None, **kw):
    """``train_net`` on the tiny set; ``stop_after`` steps sets the stop
    flag."""
    calls = []

    def stop_flag():
        calls.append(1)
        return stop_after is not None and len(calls) >= stop_after

    lines = []
    train_cli.train_net(cfg or _cfg(), prefix=prefix, synthetic=4, lr=0.01,
                        seed=0, device="cpu", stop_flag=stop_flag,
                        log=lines.append, **kw)
    return lines


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """Two epochs without a break."""
    prefix = str(tmp_path_factory.mktemp("straight") / "m")
    _train(prefix, end_epoch=2)
    return prefix


def test_a_stopped_run_resumes_mid_epoch_bit_exact(tmp_path, straight):
    prefix = str(tmp_path / "m")
    lines = _train(prefix, end_epoch=2, stop_after=6)
    ipath = tckpt.interrupt_path(prefix)
    assert any("saved interrupt checkpoint" in ln for ln in lines)
    m = tckpt.read_manifest(ipath)
    assert m["kind"] == "interrupt" and m["step"] == 6
    assert m["topology"] == tckpt.make_topology(1, grad_accum=1,
                                                batch_images=2)
    assert m["data_cursor"] == {"epoch": 1, "steps_in_epoch": 2,
                                "batches_consumed": 2, "images_consumed": 12}
    assert [e for e, _ in tckpt.list_checkpoints(prefix)] == [1]
    lines = _train(prefix, end_epoch=2, resume="auto")
    assert any("resumed mid-epoch from verified" in ln for ln in lines)
    assert any("skipping 2 consumed steps" in ln for ln in lines)
    # the epoch checkpoint supersedes the interrupt, which is removed
    assert not os.path.exists(ipath)
    for e in (1, 2):
        assert _digest(tckpt.checkpoint_path(prefix, e)) == \
            _digest(tckpt.checkpoint_path(straight, e)), e


@pytest.mark.parametrize("corrupt", ["newest epoch", "interrupt"])
def test_resume_auto_falls_back_past_a_corrupt_file(tmp_path, straight,
                                                    corrupt, caplog):
    prefix = str(tmp_path / "m")
    if corrupt == "newest epoch":
        _train(prefix, end_epoch=2)
        bad = tckpt.checkpoint_path(prefix, 2)
    else:
        _train(prefix, end_epoch=2, stop_after=7)
        bad = tckpt.interrupt_path(prefix)
    data = bytearray(open(bad, "rb").read())
    data[len(data) // 3] ^= 0x10
    open(bad, "wb").write(bytes(data))
    with caplog.at_level("WARNING", logger="mx_rcnn_tpu_torch"):
        lines = _train(prefix, end_epoch=2, resume="auto")
    assert any("SKIPPING" in r.getMessage() and bad in r.getMessage()
               for r in caplog.records)
    assert any("resumed from verified" in ln and "epoch 1" in ln
               for ln in lines)
    assert _digest(tckpt.checkpoint_path(prefix, 2)) == \
        _digest(tckpt.checkpoint_path(straight, 2))


def test_a_resume_at_another_effective_batch_is_refused(tmp_path):
    prefix = str(tmp_path / "m")
    _train(prefix, end_epoch=1)
    with pytest.raises(ValueError, match="effective global batch"):
        _train(prefix, end_epoch=2, resume="auto",
               cfg=_cfg(train__batch_images=1))
    # the same effective batch by accumulation is admitted ...
    lines = _train(prefix + "x", end_epoch=1)
    lines = _train(prefix + "x", end_epoch=2, resume="auto",
                   cfg=_cfg(train__batch_images=1), grad_accum=2)
    assert any("resumed from verified" in ln for ln in lines)
    # ... and another one with ft.allow_resize_resume, with a warning
    lines = _train(prefix, end_epoch=2, resume="auto",
                   cfg=_cfg(train__batch_images=1,
                            ft__allow_resize_resume=True))
    assert any("continuing anyway" in ln for ln in lines)
    assert tckpt.read_manifest(tckpt.checkpoint_path(prefix, 2))[
        "topology"]["global_batch"] == 1


def test_an_interrupt_at_other_steps_per_epoch_is_refused(tmp_path):
    prefix = str(tmp_path / "m")
    _train(prefix, end_epoch=2, stop_after=6)
    with pytest.raises(ValueError, match="steps/epoch"):
        _train(prefix, end_epoch=2, resume="auto",
               cfg=_cfg(train__batch_images=1,
                        ft__allow_resize_resume=True))


def test_sigterm_to_the_cli_then_resume_auto(tmp_path, straight):
    """``tools/train.py`` in a process of its own: SIGTERM after its
    fifth step; it exits 0 with the interrupt checkpoint, and
    ``--resume auto`` ends with the bytes of the run without a break."""
    prefix = str(tmp_path / "m")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.train", *ARGV,
         "--prefix", prefix, "--end_epoch", "2"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})   # as this process
    try:
        out = []
        for line in proc.stdout:
            out.append(line)
            if line.startswith("Epoch[1] Batch [0]"):
                proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=300)
    finally:
        proc.kill()
    assert rc == 0, proc.stderr.read()
    text = "".join(out)
    assert "saved interrupt checkpoint" in text
    step = tckpt.read_manifest(tckpt.interrupt_path(prefix))["step"]
    assert 5 <= step < 8, text
    train_cli.main(ARGV + ["--prefix", prefix, "--end_epoch", "2",
                           "--resume", "auto"])
    assert _digest(tckpt.checkpoint_path(prefix, 2)) == \
        _digest(tckpt.checkpoint_path(straight, 2))


def test_main_installs_a_sigterm_handler_that_sets_the_flag():
    before = signal.getsignal(signal.SIGTERM)
    with train_cli.sigterm_stop_flag() as stop:
        assert not stop()
        handler = signal.getsignal(signal.SIGTERM)
        assert handler is not before and callable(handler)
        handler(signal.SIGTERM, None)
        assert stop()
    assert signal.getsignal(signal.SIGTERM) is before


def test_the_resume_flag_parses_as_the_jax_clis():
    assert train_cli.parse_args([]).resume is False
    assert train_cli.parse_args(["--resume"]).resume is True
    assert train_cli.parse_args(["--resume", "auto"]).resume == "auto"
    with pytest.raises(SystemExit):
        train_cli.parse_args(["--resume", "newest"])
    args = train_cli.parse_args(["--pretrained", "w.params",
                                 "--grad_accum", "2"])
    assert (args.pretrained, args.pretrained_epoch, args.grad_accum) == \
        ("w.params", 0, 2)


# ---- StreamLoader.resume_at ------------------------------------------------

def _geometry_roidb(n, seed):
    """Records without pixels, of both buckets' orientations."""
    sizes = [(128, 160), (160, 128), (100, 170)]
    pick = np.random.RandomState(seed).randint(0, len(sizes), n)
    return [dict(image=f"im{i}", index=i, height=sizes[k][0],
                 width=sizes[k][1], boxes=np.zeros((1, 4), np.float32),
                 gt_classes=np.ones(1, np.int32), flipped=False)
            for i, k in enumerate(pick)]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("old_bi,new_bi", [(2, 2), (4, 2), (2, 4), (1, 3),
                                           (3, 1)])
def test_resume_at_plans_equal_the_jax_packages(seed, old_bi, new_bi):
    cfg = generate_config("tiny", "PascalVOC", **SMALL)
    jcfg = j_generate_config("tiny", "PascalVOC", **SMALL)
    roidb = _geometry_roidb(41 + seed, seed)
    ours = StreamLoader(roidb, cfg, None, batch_images=new_bi, seed=seed)
    theirs = JStreamLoader(roidb, jcfg, batch_images=new_bi, seed=seed,
                           num_workers=0)
    old = StreamLoader(roidb, cfg, None, batch_images=old_bi, seed=seed)
    epoch = 1
    n_old = len(old._plan(epoch, old_bi))
    for consumed in sorted({0, 1, n_old // 2, n_old - 1, n_old}):
        images = consumed * old_bi
        ours.set_epoch(epoch)
        ours.resume_at(images, old_bi)
        got = ours.plan()
        theirs.resume_at(images, old_bi)
        assert got == theirs._epoch_plan(epoch)
        # each image of the epoch's full batches at most once
        done = [i for _, idx in old._plan(epoch, old_bi)[:consumed]
                for i in idx]
        rest = [i for _, idx in got for i in idx]
        assert not set(done) & set(rest)
        if old_bi == new_bi:
            assert got == old._plan(epoch, old_bi)[consumed:]
        # the resume is consumed: the next epoch is whole
        assert ours.plan() == ours._plan(epoch + 1, new_bi)
    with pytest.raises(ValueError, match="batch boundary"):
        ours.resume_at(old_bi + 1, old_bi) if old_bi > 1 else \
            ours.resume_at(1, 2)
    ours.set_epoch(epoch)
    ours.resume_at((n_old + 1) * old_bi, old_bi)
    if old_bi != new_bi:
        with pytest.raises(ValueError, match="wrong epoch"):
            ours.plan()
