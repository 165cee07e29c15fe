"""ImageNet weights grafted by the port, held against the JAX package.

One ``.params``, one ``.npz`` (ResNet-50, the MXNet zoo's full name set)
and one torchvision VGG16 ``.pth``, written here, are loaded by both
packages' ``load_pretrained_into``; the port's state_dict equals
``bridge.from_flax`` of the JAX state exactly, on every leaf.  Both
refuse a file that leaves a backbone or head leaf uncovered and one with
arrays that map to nothing; both parsers read every MXNet header form
to the same arrays.  The VGG16 fc6 keeps torchvision's function through
the CHW → NHWC permutation, at a 2x2 pooled size so the test stays small.
"""

import struct

import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.core.train import TrainState as JTrainState
from mx_rcnn_tpu.utils import pretrained as jpre
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core import train as ttrain
from mx_rcnn_tpu_torch.utils import pretrained as tpre
from mx_rcnn_tpu_torch.utils.bridge import from_flax, to_flax
from tests.test_pretrained import _zoo_resnet_v2_names, write_mxnet_params

torch.set_num_threads(1)

POOLED = (2, 2)        # VGG16's fc6 at 2x2x512 inputs, not 7x7x512


def _configs(network):
    over = {"network__compute_dtype": "float32"}
    if network == "vgg":
        over["network__rcnn_pooled_size"] = POOLED
    jcfg = j_generate_config(network, "PascalVOC")
    jcfg = jcfg.replace_in("network", compute_dtype="float32",
                           rcnn_pooled_size=(POOLED if network == "vgg"
                                             else (14, 14)))
    return jcfg, generate_config(network, "PascalVOC", **over)


def _resnet50_file_arrays(seed=0):
    """The full ResNet-50 zoo name set (fc1 included), seeded values."""
    rng = np.random.RandomState(seed)
    named = {}
    for k, shp in _zoo_resnet_v2_names(units=(3, 4, 6, 3)).items():
        a = rng.randn(*shp).astype(np.float32)
        named[k] = np.abs(a) + 0.5 if k.endswith("_moving_var") else a
    return named


def _vgg16_torchvision(seed=1):
    """A torchvision VGG16 state_dict (classifier.6, ImageNet's fc8,
    included) with fc6 sized for ``POOLED``."""
    rng = np.random.RandomState(seed)
    sd, cin = {}, 3
    for idx, name in sorted(tpre._TV_VGG16.items()):
        cout = {"conv1": 64, "conv2": 128, "conv3": 256, "conv4": 512,
                "conv5": 512}[name.split("_")[0]]
        sd[f"features.{idx}.weight"] = rng.randn(cout, cin, 3, 3)
        sd[f"features.{idx}.bias"] = rng.randn(cout)
        cin = cout
    shapes = {0: (4096, 512 * POOLED[0] * POOLED[1]), 3: (4096, 4096),
              6: (1000, 4096)}
    for idx, shp in shapes.items():
        sd[f"classifier.{idx}.weight"] = rng.randn(*shp)
        sd[f"classifier.{idx}.bias"] = rng.randn(shp[0])
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}


def _write(tmp_path, fmt, named):
    if fmt == "params":
        write_mxnet_params(str(tmp_path / "zoo-0000.params"), named)
        return str(tmp_path / "zoo")           # prefix + epoch 0
    if fmt == "npz":
        path = str(tmp_path / "zoo.npz")
        np.savez(path, **named)
        return path
    path = str(tmp_path / "vgg16.pth")
    torch.save(named, path)
    return path


def _port_state(cfg):
    return ttrain.setup_training(cfg, "cpu", seed=3, steps_per_epoch=10)


def _jax_state_of(state):
    """The JAX package's ``TrainState`` holding the port state's weights."""
    tree = to_flax(state.model.state_dict())
    return JTrainState(np.zeros((), np.int32), tree["params"],
                       tree["batch_stats"], {})


@pytest.mark.parametrize("network,fmt", [("resnet50", "params"),
                                         ("resnet50", "npz"),
                                         ("vgg", "pth")])
def test_both_packages_graft_a_file_to_the_same_weights(tmp_path, network,
                                                        fmt):
    jcfg, cfg = _configs(network)
    named = (_vgg16_torchvision() if network == "vgg"
             else _resnet50_file_arrays())
    path = _write(tmp_path, fmt, named)
    state = _port_state(cfg)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    jstate = jpre.load_pretrained_into(_jax_state_of(state), path, 0, jcfg)
    assert tpre.load_pretrained_into(state, path, 0, cfg) is state
    got = state.model.state_dict()
    want = from_flax({"params": jstate.params,
                      "batch_stats": jstate.batch_stats})
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
        grafted = k.split(".")[0] in ("backbone", "head")
        assert torch.equal(got[k], before[k]) != grafted, k
    if network == "vgg":
        # torchvision's fc6 on a CHW flatten equals ours on an NHWC one
        x = torch.randn(1, *POOLED, 512, generator=torch.Generator()
                        .manual_seed(0))
        ours = state.model.head.fc6(x.reshape(1, -1))
        theirs = torch.nn.functional.linear(
            x.permute(0, 3, 1, 2).reshape(1, -1),
            named["classifier.0.weight"], named["classifier.0.bias"])
        torch.testing.assert_close(ours, theirs, rtol=1e-5, atol=1e-4)


def test_a_pth_graft_owns_its_tensors(tmp_path, monkeypatch):
    """The grafted weights share no memory with the loaded file's
    tensors: changing those afterwards changes nothing."""
    _, cfg = _configs("vgg")
    sd = _vgg16_torchvision()
    monkeypatch.setattr(tpre.torch, "load", lambda *a, **kw: sd)
    state = _port_state(cfg)
    tpre.load_pretrained_into(state, str(tmp_path / "v.pth"), 0, cfg)
    snapshot = {k: v.clone() for k, v in state.model.state_dict().items()}
    for t in sd.values():
        t.add_(1.0)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, snapshot[k]), k


def _drop_stage2_gamma(named):
    named.pop("arg:stage2_unit1_bn1_gamma")


def _drop_stage4(named):
    for k in [k for k in named if "stage4" in k]:
        named.pop(k)


def _add_mystery_blob(named):
    named["arg:mystery_blob"] = np.zeros((3, 3), np.float32)


def _add_mystery_weight(named):
    named["arg:mystery_weight"] = np.zeros((3, 3, 1, 1), np.float32)


@pytest.mark.parametrize("edit,error,match", [
    (_drop_stage2_gamma, ValueError, "backbone leaves"),
    (_drop_stage4, ValueError, "head leaves"),
    (_add_mystery_blob, ValueError, "map to nothing"),
    (_add_mystery_weight, KeyError, "mystery"),
])
def test_both_packages_refuse_the_same_files(tmp_path, edit, error, match):
    jcfg, cfg = _configs("resnet50")
    named = _resnet50_file_arrays()
    edit(named)
    path = _write(tmp_path, "npz", named)
    state = _port_state(cfg)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    with pytest.raises(error, match=match):
        jpre.load_pretrained_into(_jax_state_of(state), path, 0, jcfg)
    with pytest.raises(error, match=match):
        tpre.load_pretrained_into(state, path, 0, cfg)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_a_vgg_file_missing_fc7_is_refused(tmp_path):
    jcfg, cfg = _configs("vgg")
    sd = _vgg16_torchvision()
    del sd["classifier.3.weight"]
    path = _write(tmp_path, "pth", sd)
    state = _port_state(cfg)
    with pytest.raises(ValueError, match="head leaves"):
        jpre.load_pretrained_into(_jax_state_of(state), path, 0, jcfg)
    with pytest.raises(ValueError, match="head leaves"):
        tpre.load_pretrained_into(state, path, 0, cfg)


def _write_header_form(path, named, form):
    """The container with each array in one NDArray header form: V2, V3,
    V1 (int64 dims, no storage type) or legacy (the magic is the ndim,
    uint32 dims); float32, float16 and int32 data."""
    flags = {np.dtype(np.float32): 0, np.dtype(np.float16): 2,
             np.dtype(np.int32): 4}
    with open(path, "wb") as f:
        f.write(struct.pack("<QQQ", 0x112, 0, len(named)))
        for arr in named.values():
            if form in ("v2", "v3"):
                f.write(struct.pack("<Ii", {"v2": 0xF993FAC9,
                                            "v3": 0xF993FACA}[form], -1))
                f.write(struct.pack("<I", arr.ndim))
                f.write(struct.pack(f"<{arr.ndim}q", *arr.shape))
            elif form == "v1":
                f.write(struct.pack("<II", 0xF993FAC8, arr.ndim))
                f.write(struct.pack(f"<{arr.ndim}q", *arr.shape))
            else:
                f.write(struct.pack("<I", arr.ndim))
                f.write(struct.pack(f"<{arr.ndim}I", *arr.shape))
            f.write(struct.pack("<iii", 1, 0, flags[arr.dtype]))
            f.write(arr.tobytes())
        f.write(struct.pack("<Q", len(named)))
        for name in named:
            f.write(struct.pack("<Q", len(name)) + name.encode())


@pytest.mark.parametrize("form", ["v2", "v3", "v1", "legacy"])
def test_the_mxnet_parser_round_trips_every_header_form(tmp_path, form):
    rng = np.random.RandomState(4)
    named = {"arg:conv0_weight": rng.randn(8, 3, 7, 7).astype(np.float32),
             "aux:bn0_moving_mean": np.arange(8, dtype=np.float32),
             "arg:half": rng.randn(5, 2).astype(np.float16),
             "arg:ids": np.arange(6, dtype=np.int32).reshape(2, 3)}
    path = str(tmp_path / f"{form}.params")
    _write_header_form(path, named, form)
    got, want = tpre._parse_mxnet_params(path), jpre._parse_mxnet_params(path)
    assert list(got) == list(want) == list(named)
    for k, v in named.items():
        assert got[k].dtype == want[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], v)
        np.testing.assert_array_equal(want[k], v)
    # and the JAX package's own writer
    write_mxnet_params(str(tmp_path / "w.params"), named)
    for k, v in tpre._parse_mxnet_params(str(tmp_path / "w.params")).items():
        np.testing.assert_array_equal(v, named[k].astype(np.float32))


@pytest.mark.parametrize("cut", [3, 40, -40])
def test_a_truncated_params_file_is_refused(tmp_path, cut):
    path = str(tmp_path / "t.params")
    write_mxnet_params(path, {"arg:conv0_weight": np.ones((4, 3, 3, 3))})
    data = open(path, "rb").read()
    open(path, "wb").write(data[:cut])
    with pytest.raises((ValueError, struct.error)):
        jpre._parse_mxnet_params(path)
    with pytest.raises(ValueError):
        tpre._parse_mxnet_params(path)


def test_the_train_cli_starts_from_a_params_file(tmp_path, capsys):
    """``tools/train.py --pretrained`` on the CPU: ResNet-50 at a 224x320
    canvas, one step from a test-written zoo file."""
    from mx_rcnn_tpu_torch.tools import train as train_cli

    named = _resnet50_file_arrays()
    for k, a in named.items():     # trainable scales: unit BNs, small convs
        if k.endswith(("_moving_var", "_gamma")):
            named[k] = np.full_like(a, 0.02 if "bn_data" in k else 1.0)
        elif k.endswith(("_moving_mean", "_beta")):
            named[k] = np.zeros_like(a)
        elif a.ndim == 4:
            named[k] = a * (0.1 if "conv3" in k else 1.0) / np.sqrt(
                a[0].size)
    write_mxnet_params(str(tmp_path / "resnet-50-0000.params"), named)
    metrics = train_cli.main([
        "--device", "cpu", "--network", "resnet50", "--synthetic", "1",
        "--batch_images", "1", "--steps", "1", "--no_flip",
        "--pretrained", str(tmp_path / "resnet-50"),
        "--set", "network__compute_dtype=float32",
        "--set", "bucket__scale=224", "--set", "bucket__max_size=320",
        "--set", "bucket__shapes=((224, 320), (320, 224))",
        "--set", "train__rpn_pre_nms_top_n=300",
        "--set", "train__rpn_post_nms_top_n=64",
        "--set", "train__batch_rois=16"])
    assert "grafted pretrained backbone from" in capsys.readouterr().out
    assert all(np.isfinite(v) for v in metrics.values())


def test_the_tiny_network_has_no_imagenet_mapping(tmp_path):
    jcfg = j_generate_config("tiny", "synthetic")
    cfg = generate_config("tiny", "synthetic")
    path = _write(tmp_path, "npz", {"arg:conv0_weight": np.zeros(3)})
    state = _port_state(cfg)
    for load, c, s in ((jpre.load_pretrained_into, jcfg,
                        _jax_state_of(state)),
                       (tpre.load_pretrained_into, cfg, state)):
        with pytest.raises(ValueError, match="no pretrained mapping"):
            load(s, path, 0, c)
