"""Weight bridge between flax variable trees and the port's state_dict.

The port's module names mirror the flax names, so a flax leaf
``params/backbone/stage1_unit1/conv1/kernel`` is the port's
``backbone.stage1_unit1.conv1.weight``.  Conv kernels go HWIO ↔ OIHW,
dense kernels (in, out) ↔ (out, in), frozen-BN ``scale``/``bias``/``mean``/
``var`` ↔ ``weight``/``bias``/``running_mean``/``running_var``.

Both directions work on nested dicts of numpy arrays, so neither side
needs the other framework.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_PARAM_LEAF = {"scale": "weight", "bias": "bias", "kernel": "weight"}
_STATS_LEAF = {"mean": "running_mean", "var": "running_var"}


def _walk(tree: Mapping, prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _walk(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` tree of numpy arrays → state_dict
    of fp32 tensors."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _walk(variables.get("params", {})):
        leaf = path[-1]
        if leaf not in _PARAM_LEAF:
            raise KeyError(f"unexpected flax param {'/'.join(path)}")
        if leaf == "kernel" and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)    # HWIO → OIHW
        elif leaf == "kernel" and arr.ndim == 2:
            arr = arr.T                        # (in, out) → (out, in)
        out[".".join(path[:-1] + (_PARAM_LEAF[leaf],))] = torch.from_numpy(
            np.array(arr, np.float32))
    for path, arr in _walk(variables.get("batch_stats", {})):
        leaf = path[-1]
        if leaf not in _STATS_LEAF:
            raise KeyError(f"unexpected flax batch stat {'/'.join(path)}")
        out[".".join(path[:-1] + (_STATS_LEAF[leaf],))] = torch.from_numpy(
            np.array(arr, np.float32))
    return out


def _set(tree: dict, path, val) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = val


def to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of :func:`from_flax`: state_dict → flax tree of fp32
    numpy arrays.  A module holding ``running_mean`` is a frozen BN."""
    bn_modules = {k.rsplit(".", 1)[0] for k in state_dict
                  if k.endswith(".running_mean")}
    params: dict = {}
    stats: dict = {}
    for key, t in state_dict.items():
        mod, leaf = key.rsplit(".", 1)
        path = tuple(mod.split("."))
        arr = t.detach().to(torch.float32).cpu().numpy().copy()
        if leaf == "running_mean":
            _set(stats, path + ("mean",), arr)
        elif leaf == "running_var":
            _set(stats, path + ("var",), arr)
        elif mod in bn_modules:
            _set(params, path + ({"weight": "scale", "bias": "bias"}[leaf],),
                 arr)
        elif leaf == "weight" and arr.ndim == 4:
            _set(params, path + ("kernel",), arr.transpose(2, 3, 1, 0))
        elif leaf == "weight" and arr.ndim == 2:
            _set(params, path + ("kernel",), np.ascontiguousarray(arr.T))
        elif leaf == "bias":
            _set(params, path + ("bias",), arr)
        else:
            raise KeyError(f"cannot map {key} to a flax leaf")
    return {"params": params, "batch_stats": stats}
