"""ImageNet backbone weights grafted onto a fresh train state.

Counterpart of ``mx_rcnn_tpu/utils/pretrained.py``: the reference's
``train_end2end.py`` starts from ``resnet-101-0000.params`` or
``vgg16-0000.params`` and initialises only the detection layers (rpn,
cls_score, bbox_pred) at random.  Three weight files are read:

* ``*.params``, MXNet's NDArray container, parsed here without MXNet
  (:func:`_parse_mxnet_params` documents the layout);
* ``*.npz`` with the same ``arg:<name>`` / ``aux:<name>`` keys;
* ``*.pth`` / ``*.pt``, a torchvision VGG16 state_dict.  torchvision's
  ResNets are post-activation and the reference's are pre-activation, so
  ResNet weights come from the MXNet formats only.

The names map to the flax-path tree the JAX package builds
(:func:`map_mxnet_resnet`, :func:`map_vgg16`: ``stage4_*`` and the
closing ``bn1`` go to the per-ROI ``head``, the ImageNet classifier is
dropped), and :func:`load_pretrained_into` takes that tree onto the
port's state_dict through ``utils/bridge.py``'s layout rules.  A file
with arrays that map to nothing, or one that covers fewer than every
``backbone`` and ``head`` leaf (frozen-BN statistics included for
ResNet), is refused: a partly random trunk trains to garbage silently.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Tuple

import numpy as np
import torch

from mx_rcnn_tpu_torch.utils.bridge import from_flax

# MXNet serialisation constants (dmlc/mxnet ndarray.cc)
_LIST_MAGIC = 0x112
_NDARRAY_V1 = 0xF993FAC8  # int64 shape
_NDARRAY_V2 = 0xF993FAC9  # + storage type
_NDARRAY_V3 = 0xF993FACA
_DTYPES = {0: np.float32, 1: np.float64, 2: np.float16, 3: np.uint8,
           4: np.int32, 5: np.int8, 6: np.int64}


def _parse_mxnet_params(path: str) -> Dict[str, np.ndarray]:
    """MXNet's NDArray container, little-endian:

      uint64 list_magic (0x112), uint64 reserved
      uint64 n_arrays, then per array (NDArray::Save):
        uint32 magic
          V2/V3: int32 storage_type (-1 dense), uint32 ndim, int64 dims[]
          V1:    uint32 ndim, int64 dims[]
          legacy: the magic is the ndim, uint32 dims[]
        int32 dev_type, int32 dev_id, int32 type_flag
        prod(shape) * sizeof(dtype) bytes of data
      uint64 n_names, then per name: uint64 len, bytes
    """
    with open(path, "rb") as f:
        data = f.read()
    off = 0

    def take(fmt: str):
        nonlocal off
        size = struct.calcsize(fmt)
        if off + size > len(data):
            raise ValueError(f"{path}: truncated params file")
        vals = struct.unpack_from(fmt, data, off)
        off += size
        return vals

    if take("<Q")[0] != _LIST_MAGIC:
        raise ValueError(f"{path}: not an MXNet NDArray container")
    take("<Q")  # reserved
    (n,) = take("<Q")
    arrays = []
    for _ in range(n):
        (magic,) = take("<I")
        if magic in (_NDARRAY_V2, _NDARRAY_V3):
            (stype,) = take("<i")
            if stype != -1:
                raise ValueError(f"{path}: sparse arrays unsupported")
            (ndim,) = take("<I")
            shape = take(f"<{ndim}q")
        elif magic == _NDARRAY_V1:
            (ndim,) = take("<I")
            shape = take(f"<{ndim}q")
        else:  # legacy: the magic was the ndim of a uint32 shape
            ndim = magic
            if ndim > 8:
                raise ValueError(f"{path}: unrecognized ndarray header")
            shape = take(f"<{ndim}I")
        take("<i")  # dev_type
        take("<i")  # dev_id
        (type_flag,) = take("<i")
        dt = np.dtype(_DTYPES[type_flag])
        count = int(np.prod(shape)) if ndim else 1
        if off + count * dt.itemsize > len(data):
            raise ValueError(f"{path}: truncated params file")
        arrays.append(np.frombuffer(data, dt, count, off)
                      .reshape(shape).copy())
        off += count * dt.itemsize
    (n_names,) = take("<Q")
    names = []
    for _ in range(n_names):
        (ln,) = take("<Q")
        names.append(data[off:off + ln].decode())
        off += ln
    return dict(zip(names, arrays))


def load_raw(path: str) -> Dict[str, np.ndarray]:
    """A weight file as a flat name → array dict."""
    ext = os.path.splitext(path)[1]
    if ext == ".params":
        return _parse_mxnet_params(path)
    if ext == ".npz":
        return dict(np.load(path))
    if ext in (".pth", ".pt"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return {k: v.numpy() for k, v in sd.items()}
    raise ValueError(f"unsupported pretrained format: {path}")


def _strip(raw: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Drop MXNet's ``arg:``/``aux:`` prefixes."""
    return {k.split(":", 1)[-1]: v for k, v in raw.items()}


def _conv_kernel(w: np.ndarray) -> np.ndarray:
    """OIHW (MXNet, torch) → HWIO (flax)."""
    return np.transpose(w, (2, 3, 1, 0))


def map_mxnet_resnet(raw: Dict[str, np.ndarray]
                     ) -> Tuple[Dict, Dict, list]:
    """MXNet ResNet-v2 zoo names → (params tree, batch_stats tree,
    leftover names).  ``stage4_*`` and the closing ``bn1`` belong to the
    per-ROI head.  ``leftover`` lists arrays that map nowhere; the
    ImageNet classifier (``fc1_*``, ``softmax*``) is expected and not
    listed."""
    raw = _strip(raw)
    params: Dict = {"backbone": {}, "head": {}}
    stats: Dict = {"backbone": {}, "head": {}}
    leftover: list = []

    def put(tree, module, scope, leaf, value):
        node = tree.setdefault(module, {})
        parts = scope.split("/") + [leaf]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(value, np.float32)

    for name, arr in raw.items():
        if name.startswith("fc1_") or name.startswith("softmax"):
            continue
        module = "head" if name.startswith(("stage4_", "bn1_")) else \
            "backbone"
        for suffix, dest, leaf in (
            ("_gamma", "params", "scale"), ("_beta", "params", "bias"),
            ("_moving_mean", "stats", "mean"),
            ("_moving_var", "stats", "var"),
            ("_weight", "params", "kernel"), ("_bias", "params", "bias"),
        ):
            if name.endswith(suffix):
                base = name[: -len(suffix)]
                # stageX_unitY_bnZ → stageX_unitY/bnZ; conv0, bn0 flat
                if base.startswith("stage"):
                    parts = base.split("_")
                    scope = "_".join(parts[:2]) + "/" + "_".join(parts[2:])
                else:
                    scope = base
                value = arr
                if leaf == "kernel" and arr.ndim == 4:
                    value = _conv_kernel(arr)
                put(params if dest == "params" else stats, module, scope,
                    leaf, value)
                break
        else:
            leftover.append(name)
    return params, stats, leftover


# torchvision vgg16 'features.N' indices → the reference's conv names
_TV_VGG16 = {
    0: "conv1_1", 2: "conv1_2", 5: "conv2_1", 7: "conv2_2",
    10: "conv3_1", 12: "conv3_2", 14: "conv3_3",
    17: "conv4_1", 19: "conv4_2", 21: "conv4_3",
    24: "conv5_1", 26: "conv5_2", 28: "conv5_3",
}


def _fc_kernel_chw_to_hwc(w: np.ndarray, c: int, h: int, w_: int
                          ) -> np.ndarray:
    """(out, C*H*W) fc weight → (H*W*C, out) for an NHWC flatten."""
    out = w.shape[0]
    return (w.reshape(out, c, h, w_).transpose(2, 3, 1, 0)
            .reshape(h * w_ * c, out))


def _vgg_fc(fc: str, leaf: str, arr: np.ndarray, pooled) -> np.ndarray:
    """An fc6/fc7 array in the flax layout: fc6's kernel permuted from
    the source's CHW flatten to the NHWC one, fc7's transposed."""
    if leaf != "weight":
        return arr
    if fc == "fc6":
        return _fc_kernel_chw_to_hwc(arr, 512, *pooled)
    return arr.T


def map_vgg16(raw: Dict[str, np.ndarray], pooled=(7, 7)
              ) -> Tuple[Dict, Dict, list]:
    """VGG16 weights, torchvision (``features.N.weight``,
    ``classifier.N.weight``) or MXNet zoo (``conv1_1_weight``,
    ``fc6_weight``) names → (params tree, {}, leftover names).  The
    ImageNet classifier (``classifier.6``, ``fc8_*``) is expected and not
    listed."""
    raw = _strip(raw)
    params: Dict = {"backbone": {}, "head": {}}
    leftover: list = []

    def put(module, scope, leaf, value):
        params[module].setdefault(scope, {})[
            "kernel" if leaf == "weight" else "bias"] = np.asarray(
                value, np.float32)

    for name, arr in raw.items():
        if name.startswith("features."):
            idx, leaf = int(name.split(".")[1]), name.split(".")[2]
            conv = _TV_VGG16.get(idx)
            if conv is None:
                leftover.append(name)
                continue
            put("backbone", conv, leaf,
                _conv_kernel(arr) if leaf == "weight" else arr)
        elif name.startswith("classifier."):
            idx, leaf = int(name.split(".")[1]), name.split(".")[2]
            fc = {0: "fc6", 3: "fc7"}.get(idx)
            if fc is None:
                if idx != 6:
                    leftover.append(name)
                continue
            put("head", fc, leaf, _vgg_fc(fc, leaf, arr, pooled))
        elif name.split("_")[0].startswith("conv"):
            base, leaf = name.rsplit("_", 1)
            put("backbone", base, leaf,
                _conv_kernel(arr) if leaf == "weight" and arr.ndim == 4
                else arr)
        elif name.startswith(("fc6_", "fc7_")):
            fc, leaf = name.split("_", 1)
            put("head", fc, leaf, _vgg_fc(fc, leaf, arr, pooled))
        elif not name.startswith("fc8_"):
            leftover.append(name)
    return params, {}, leftover


def _count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def load_pretrained_into(state, path: str, epoch: int, cfg):
    """Graft the backbone and head-trunk weights of ``path`` onto a
    ``core/train.py — TrainState`` in place (the reference's
    ``load_param`` and selective init); returns the state.  A ``path``
    without an extension names ``{path}-{epoch:04d}.params``.  The
    copies own their memory: nothing aliases the loaded file's arrays."""
    if not os.path.splitext(path)[1]:
        path = f"{path}-{epoch:04d}.params"
    raw = load_raw(path)
    name = cfg.network.name
    if name.startswith("resnet"):
        p_up, s_up, leftover = map_mxnet_resnet(raw)
    elif name == "vgg":
        p_up, s_up, leftover = map_vgg16(raw, cfg.network.rcnn_pooled_size)
    else:
        raise ValueError(f"no pretrained mapping for network {name!r}")
    if leftover:
        raise ValueError(
            f"{path}: {len(leftover)} arrays map to nothing in the model "
            f"(e.g. {sorted(leftover)[:5]}) — the file does not follow a "
            f"supported zoo naming; refusing to silently drop weights")
    sd = state.model.state_dict()
    updates = from_flax({"params": p_up, "batch_stats": s_up})
    for key, val in updates.items():
        if key not in sd:
            raise KeyError(f"pretrained leaf {key} not in model")
        if tuple(sd[key].shape) != tuple(val.shape):
            raise ValueError(
                f"shape mismatch at {key}: model {tuple(sd[key].shape)} vs "
                f"pretrained {tuple(val.shape)}")
    # every backbone and head-trunk leaf must come from the file, the
    # frozen-BN statistics included
    for module in ("backbone", "head"):
        need = sum(1 for k in sd if k.startswith(module + "."))
        got = (_count_leaves(p_up.get(module, {}))
               + _count_leaves(s_up.get(module, {})))
        if got < need:
            raise ValueError(
                f"pretrained file covers {got}/{need} {module} leaves — "
                f"refusing a partly-initialized {module}")
    with torch.no_grad():
        for key, val in updates.items():
            sd[key].copy_(val)
    return state
