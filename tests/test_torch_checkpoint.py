"""The port's checkpoints held against the JAX package's on the CPU.

The port's own msgpack codec (``utils/flax_msgpack.py``) writes the bytes
flax writes and reads what flax writes; a checkpoint written by either
package is read by the other with bit-equal weights, momentum trace (bf16),
optimizer count and step; a payload that does not match its manifest is
refused; and a run resumed from a checkpoint ends bit-equal to an unbroken
one.
"""

import hashlib
import shutil

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from mx_rcnn_tpu.core.train import make_train_step as j_make_train_step
from mx_rcnn_tpu.core.train import setup_training as j_setup_training
from mx_rcnn_tpu.models import build_model as j_build_model
from mx_rcnn_tpu.utils import checkpoint as jckpt
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core import train as ttrain
from mx_rcnn_tpu_torch.data.loader import AnchorLoader
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from mx_rcnn_tpu_torch.tools import train as train_cli
from mx_rcnn_tpu_torch.utils import checkpoint as tckpt
from mx_rcnn_tpu_torch.utils import flax_msgpack
from mx_rcnn_tpu_torch.utils.bridge import (load_train_state, to_flax,
                                            train_state_to_flax)
from tests.test_train_step import KEY, make_batch, tiny_setup

torch.set_num_threads(1)

# tiny_setup's train overrides, so the two packages build the same model
_TINY = dict(train__rpn_pre_nms_top_n=256, train__rpn_post_nms_top_n=64,
             train__batch_rois=32, train__max_gt_boxes=8,
             train__rpn_min_size=2, bucket__scale=128, bucket__max_size=160,
             bucket__shapes=((128, 160), (160, 128)))


def _bf16(values) -> np.ndarray:
    """A numpy bfloat16 array (ml_dtypes, through jax) of ``values``."""
    return np.asarray(jnp.asarray(values, jnp.bfloat16))


def _as_torch_bf16(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)


def _bits(x) -> np.ndarray:
    """The raw bits of a leaf: numpy (any dtype, bfloat16 included) or a
    torch tensor."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        if not tree:
            yield prefix, "{}"
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _assert_same_tree(got, want):
    """Same paths (empty maps included), same dtype names and equal bits."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for path in want:
        g, w = got[path], want[path]
        if isinstance(w, str) or isinstance(g, str):
            assert g == w, path
            continue
        gb, wb = _bits(g), _bits(w)
        assert gb.dtype == wb.dtype and gb.shape == wb.shape, path
        np.testing.assert_array_equal(gb, wb, err_msg=str(path))


# ---- the codec -------------------------------------------------------------

def _codec_case(name):
    rng = np.random.RandomState(len(name))
    bf = _bf16(rng.standard_normal((5, 7)))
    cases = {
        "f32 arrays and a 0-d int32": (
            {"w": rng.standard_normal((3, 4, 2)).astype(np.float32),
             "step": np.array(7, np.int32)}, None),
        "bf16 arrays": ({"trace": {"k": bf}}, {"trace": {"k":
                                                         _as_torch_bf16(bf)}}),
        "nested and empty maps": (
            {"opt_state": {"0": {"inner_state": {"0": {}, "1": {},
                                                 "2": {"count": np.array(
                                                     3, np.int32)}}},
                           "1": {"inner_state": {}}},
             "b": {"z": np.arange(6, dtype=np.int64).reshape(2, 3),
                   "a": np.array([True, False])}}, None),
        "numpy scalars": ({"f": np.float32(1.5), "d": np.float64(-2.25),
                           "i": np.int64(-3), "u": np.uint8(200)}, None),
        "python values and long containers": (
            {"n": None, "t": True, "f": False, "s": "x" * 40, "e": "",
             "ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32,
                      -33, -128, -129, -32768, -32769, -2 ** 31 - 1],
             "floats": [0.5, -1e300], "raw": bytes(range(256)) * 300,
             "many": {f"k{i:02d}": i for i in range(40)},
             "list": list(range(20)),
             "big": rng.standard_normal(20000).astype(np.float32)}, None),
    }
    return cases[name]


@pytest.mark.parametrize("case", [
    "f32 arrays and a 0-d int32", "bf16 arrays", "nested and empty maps",
    "numpy scalars", "python values and long containers"])
def test_codec_writes_and_reads_the_bytes_of_flax_msgpack(case):
    """Against the ``msgpack`` library (through flax): the port writes the
    same bytes for the same tree, reads flax's bytes into the same
    values, and msgpack reads the port's bytes."""
    tree, ours = _codec_case(case)
    want = serialization.msgpack_serialize(tree)
    got = flax_msgpack.packb(ours if ours is not None else tree)
    assert got == want
    _assert_same_tree(flax_msgpack.unpackb(want),
                      serialization.msgpack_restore(want))
    assert msgpack.unpackb(got, raw=False) == msgpack.unpackb(want,
                                                              raw=False)


def test_codec_refuses_an_array_flax_would_chunk(monkeypatch):
    """flax splits an array above ``MAX_CHUNK_SIZE`` bytes into chunks,
    which the codec does not write: with the limit lowered, such an
    array (numpy or bf16) is refused and a smaller one is written as
    flax writes it."""
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    small = np.arange(16, dtype=np.float32)
    assert flax_msgpack.packb({"a": small}) == \
        serialization.msgpack_serialize({"a": small})
    for big in (np.zeros(17, np.float32), torch.zeros(33, dtype=torch.bfloat16)):
        with pytest.raises(ValueError, match="chunk"):
            flax_msgpack.packb({"a": big})


def test_codec_refuses_what_flax_cannot_write():
    with pytest.raises(TypeError):
        flax_msgpack.packb({"a": {1, 2}})
    with pytest.raises(TypeError):
        flax_msgpack.packb({"a": (1, 2)})
    with pytest.raises(TypeError):
        flax_msgpack.packb({3: 4})
    with pytest.raises(ValueError):
        flax_msgpack.unpackb(flax_msgpack.packb({"a": 1}) + b"\x00")
    with pytest.raises(ValueError):
        flax_msgpack.unpackb(flax_msgpack.packb({"a": np.zeros(4)})[:-3])


# ---- checkpoints across the packages ---------------------------------------

@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """The JAX package's ``save_checkpoint`` of a ``tiny_setup`` state
    after two of its own train steps (nonzero trace and count)."""
    cfg, model, tx, state = tiny_setup()
    step = jax.jit(j_make_train_step(model, cfg, tx))
    batch = make_batch()
    for _ in range(2):
        state, _ = step(state, batch, KEY)
    prefix = str(tmp_path_factory.mktemp("jax") / "e2e")
    jckpt.save_checkpoint(prefix, 1, state, steps_per_epoch=100)
    return prefix, jax.device_get(state)


def _port_state(seed=5, **optimizer_kw):
    cfg = generate_config("tiny", "PascalVOC", **_TINY)
    return cfg, ttrain.setup_training(cfg, "cpu", seed=seed,
                                      steps_per_epoch=100, **optimizer_kw)


def _trace_tree(tree):
    return tree["opt_state"]["0"]["inner_state"]["2"]


def test_a_jax_checkpoint_restores_into_the_port_bit_for_bit(jax_checkpoint):
    prefix, jstate = jax_checkpoint
    want = serialization.to_state_dict(jstate)
    assert float(jnp.abs(jax.tree_util.tree_leaves(
        _trace_tree(want)["0"]["trace"])[0]).max()) > 0
    _, state = _port_state()
    params, stats = tckpt.load_param(prefix, 1)
    _assert_same_tree(params, want["params"])
    tckpt.restore_state(state, prefix, 1)
    assert state.step == state.optimizer.count == 2
    got = train_state_to_flax(state.model, state.optimizer)
    _assert_same_tree(got, want)
    # and written back, the port's file is the JAX package's byte for byte
    with open(jckpt.checkpoint_path(prefix, 1), "rb") as f:
        assert flax_msgpack.packb(got) == f.read()


def test_a_port_checkpoint_restores_into_the_jax_package(tmp_path):
    """Two port train steps with conv1 and the RPN's 3x3 conv frozen (so
    the trace holds empty maps), saved by the port, then read by the JAX
    package's ``load_param`` and ``restore_state`` onto a template built
    with the same freeze: every leaf bit-equal."""
    frozen = ("conv1", "rpn_conv")
    cfg, state = _port_state(seed=3, base_lr=0.01, frozen_prefixes=frozen)
    ds = SyntheticDataset("train", 2, cfg.num_classes, (128, 160))
    step = ttrain.make_train_step(cfg)
    for batch in AnchorLoader(ds.gt_roidb(), cfg, ds.load_image,
                              batch_images=1, seed=0):
        step(state, ttrain.to_device(batch, torch.device("cpu")))
    prefix = str(tmp_path / "port")
    path = tckpt.save_checkpoint(prefix, 3, state, steps_per_epoch=2,
                                 config_fp=tckpt.config_fingerprint(cfg))
    manifest = tckpt.read_manifest(path)
    assert manifest["step"] == 2 and manifest["epoch"] == 3

    jcfg, _, _, _ = tiny_setup()
    template, _ = j_setup_training(j_build_model(jcfg), jcfg, KEY,
                                   (1, 128, 128, 3), 100,
                                   frozen_prefixes=frozen)
    restored = serialization.to_state_dict(
        jckpt.restore_state(template, prefix, 3))
    want = train_state_to_flax(state.model, state.optimizer)
    _assert_same_tree(restored, want)
    trace = _trace_tree(restored)["0"]["trace"]
    assert trace["backbone"]["conv1"]["kernel"] == {}
    assert trace["rpn"]["rpn_conv_3x3"]["kernel"] == {}
    assert np.abs(np.asarray(trace["head"]["fc"]["kernel"],
                             np.float32)).max() > 0
    jparams, jstats = jckpt.load_param(prefix, 3)
    _assert_same_tree({"params": jparams, "batch_stats": jstats},
                      to_flax(state.model.state_dict()))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_payload_that_differs_from_its_manifest_is_refused(
        writer, jax_checkpoint, tmp_path):
    if writer == "jax":
        src = jckpt.checkpoint_path(jax_checkpoint[0], 1)
    else:
        _, state = _port_state()
        src = tckpt.save_checkpoint(str(tmp_path / "w"), 1, state)
    # a copy in another directory (the manifest names the file's basename)
    (tmp_path / "copy").mkdir()
    prefix = str(tmp_path / "copy" / src.rsplit("/", 1)[1][:-len("-0001.ckpt")])
    path = tckpt.checkpoint_path(prefix, 1)
    shutil.copy(src, path)
    shutil.copy(tckpt.manifest_path(src), tckpt.manifest_path(path))
    tckpt.load_param(prefix, 1)                  # intact: accepted
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 1
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="manifest"):
        tckpt.load_param(prefix, 1)
    with pytest.raises(ValueError, match="manifest"):
        tckpt.restore_state(_port_state()[1], prefix, 1)


def test_restore_refuses_another_freeze_or_trace_dtype(tmp_path):
    _, state = _port_state()
    prefix = str(tmp_path / "p")
    tckpt.save_checkpoint(prefix, 1, state)
    _, frozen = _port_state(frozen_prefixes=("conv1",))
    with pytest.raises(ValueError, match="trainable"):
        tckpt.restore_state(frozen, prefix, 1)
    cfg = generate_config("tiny", "PascalVOC",
                          default__momentum_dtype="float32", **_TINY)
    fp32 = ttrain.setup_training(cfg, "cpu", steps_per_epoch=100)
    with pytest.raises(ValueError, match="trace"):
        tckpt.restore_state(fp32, prefix, 1)


def test_train_state_bridge_round_trips_bits():
    """Port → tree → port: weights, a random bf16 trace and the count come
    back with equal bits (conv traces go OIHW → HWIO → OIHW)."""
    _, state = _port_state(seed=1)
    gen = torch.Generator().manual_seed(0)
    for t in state.optimizer.trace.values():
        t.copy_(torch.randn(t.shape, generator=gen))
    state.optimizer.count = 7
    tree = train_state_to_flax(state.model, state.optimizer)
    _, other = _port_state(seed=2)
    load_train_state(flax_msgpack.unpackb(flax_msgpack.packb(tree)),
                     other.model, other.optimizer)
    assert other.step == 7
    for (n, a), (m, b) in zip(state.model.state_dict().items(),
                              other.model.state_dict().items()):
        assert n == m and torch.equal(a, b), n
    for name, t in state.optimizer.trace.items():
        assert torch.equal(t.view(torch.int16),
                           other.optimizer.trace[name].view(torch.int16))


def test_list_and_latest_checkpoint(tmp_path):
    _, state = _port_state()
    prefix = str(tmp_path / "m")
    assert tckpt.latest_checkpoint(prefix) is None
    for epoch in (2, 1, 10):
        tckpt.save_checkpoint(prefix, epoch, state)
    assert [e for e, _ in tckpt.list_checkpoints(prefix)] == [1, 2, 10]
    assert tckpt.latest_checkpoint(prefix) == (
        10, tckpt.checkpoint_path(prefix, 10))
    assert [e for e, _ in jckpt.list_checkpoints(prefix)] == [1, 2, 10]


# ---- resume ----------------------------------------------------------------

def test_resume_is_bit_exact(tmp_path, capsys):
    """``tools/train.py``: one epoch, then ``--resume`` for a second, ends
    with the checkpoint bytes (weights, trace, count) of two epochs
    straight; the draws and the batch plan follow the position."""
    argv = ["--device", "cpu", "--network", "tiny", "--dataset", "synthetic",
            "--synthetic", "4", "--batch_images", "2", "--lr", "0.01",
            "--set", "train__rpn_pre_nms_top_n=600",
            "--set", "train__rpn_post_nms_top_n=100"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    train_cli.main(argv + ["--prefix", a, "--end_epoch", "1"])
    train_cli.main(argv + ["--prefix", a, "--end_epoch", "2", "--resume"])
    assert "resumed from" in capsys.readouterr().out
    train_cli.main(argv + ["--prefix", b, "--end_epoch", "2"])

    def digest(prefix, epoch):
        with open(tckpt.checkpoint_path(prefix, epoch), "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    assert digest(a, 1) == digest(b, 1)
    assert digest(a, 2) == digest(b, 2)
    assert digest(a, 1) != digest(a, 2)
    pa, _ = tckpt.load_param(a, 2)
    pb, _ = tckpt.load_param(b, 2)
    _assert_same_tree(pa, pb)
    # 4 images and their flipped copies at batch 2: 4 steps an epoch
    assert tckpt.read_manifest(tckpt.checkpoint_path(a, 2))["step"] == 8
