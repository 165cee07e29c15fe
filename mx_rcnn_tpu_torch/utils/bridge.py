"""Weight bridge between flax variable trees and the port's state_dict.

The port's module names mirror the flax names, so a flax leaf
``params/backbone/stage1_unit1/conv1/kernel`` is the port's
``backbone.stage1_unit1.conv1.weight``.  Conv kernels go HWIO ↔ OIHW,
dense kernels (in, out) ↔ (out, in), frozen-BN ``scale``/``bias``/``mean``/
``var`` ↔ ``weight``/``bias``/``running_mean``/``running_var``.

Both directions work on nested dicts of numpy arrays, so neither side
needs the other framework.  :func:`train_state_to_flax` (through
:func:`host_train_state`, owned host copies taken at one step, and
:func:`host_state_to_flax`) and :func:`load_train_state` carry the
whole train state: the weights, the
SGD momentum trace in the layouts of the weights (a bfloat16 trace as
``torch.bfloat16`` tensors, which numpy cannot hold), the optimizer's
update count and ``step``, in the tree ``flax.serialization.to_state_dict``
makes of the JAX package's ``TrainState``.  Both directions copy bits.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, NamedTuple, Tuple

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


def _bn_modules(state_dict: Mapping[str, torch.Tensor]) -> set:
    """Modules holding ``running_mean``: the frozen BNs."""
    return {k.rsplit(".", 1)[0] for k in state_dict
            if k.endswith(".running_mean")}


def _param_path(key: str, ndim: int, bn_modules: set) -> Tuple[str, ...]:
    """A parameter's state_dict name → its path in the flax params tree."""
    mod, leaf = key.rsplit(".", 1)
    path = tuple(mod.split("."))
    if mod in bn_modules:
        return path + ({"weight": "scale", "bias": "bias"}[leaf],)
    if leaf == "weight" and ndim in (2, 4):
        return path + ("kernel",)
    if leaf == "bias":
        return path + ("bias",)
    raise KeyError(f"cannot map {key} to a flax leaf")


def _flax_layout(t: torch.Tensor) -> torch.Tensor:
    """OIHW → HWIO, (out, in) → (in, out), contiguous on the host (every
    4-D parameter is a conv kernel, every 2-D one a dense kernel)."""
    t = t.detach().cpu()
    if t.ndim == 4:
        t = t.permute(2, 3, 1, 0)
    elif t.ndim == 2:
        t = t.t()
    return t.contiguous()


def _torch_layout(t: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`_flax_layout`."""
    if t.ndim == 4:
        t = t.permute(3, 2, 0, 1)
    elif t.ndim == 2:
        t = t.t()
    return t.contiguous()


def to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of :func:`from_flax`: state_dict → flax tree of fp32
    numpy arrays.  A module holding ``running_mean`` is a frozen BN."""
    bn_modules = _bn_modules(state_dict)
    params: dict = {}
    stats: dict = {}
    for key, t in state_dict.items():
        mod, leaf = key.rsplit(".", 1)
        path = tuple(mod.split("."))
        if leaf == "running_mean":
            _set(stats, path + ("mean",), _host_fp32(t))
        elif leaf == "running_var":
            _set(stats, path + ("var",), _host_fp32(t))
        else:
            _set(params, _param_path(key, t.ndim, bn_modules),
                 _host_fp32(_flax_layout(t)))
    return {"params": params, "batch_stats": stats}


def _host_fp32(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().contiguous().numpy().copy()


def _host(t: torch.Tensor):
    """A host copy: a numpy array, or a torch tensor for bfloat16."""
    t = t.detach().cpu().contiguous()
    return t.clone() if t.dtype == torch.bfloat16 else t.numpy().copy()


def _leaves(tree: Mapping, prefix=()) -> Iterator[Tuple[Tuple[str, ...],
                                                         Any]]:
    """(path, leaf) pairs; an empty map (a frozen leaf's masked trace) has
    none."""
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


_FLAX_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}


class HostTrainState(NamedTuple):
    """Owned host copies of a train state, taken at one step: the model's
    state_dict (weights, frozen-BN statistics), the names of its
    parameters in order, the SGD momentum trace of the trained ones and
    the update count.  Nothing in it shares memory with the live state,
    so the step may run on while another thread serialises it."""

    state_dict: Dict[str, torch.Tensor]
    param_names: Tuple[str, ...]
    trace: Dict[str, torch.Tensor]
    count: int

    @property
    def step(self) -> int:
        return self.count


def _owned_copies(tensors: Mapping[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """Host copies that own their memory: a CUDA tensor is copied into
    pinned memory without blocking, each on the current stream, and the
    copies are waited for once, before this returns; a CPU tensor is
    cloned."""
    out: Dict[str, torch.Tensor] = {}
    on_card = False
    for name, t in tensors.items():
        t = t.detach()
        if t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            on_card = True
        else:
            host = t.clone(memory_format=torch.contiguous_format)
        out[name] = host
    if on_card:
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
    return out


def host_train_state(model: torch.nn.Module, optimizer) -> HostTrainState:
    """The :class:`HostTrainState` of ``model`` and its SGD
    (``core/optim.py``), copied now."""
    return HostTrainState(
        state_dict=_owned_copies(model.state_dict()),
        param_names=tuple(name for name, _ in model.named_parameters()),
        trace=_owned_copies(optimizer.trace), count=int(optimizer.count))


def host_state_to_flax(host: HostTrainState) -> dict:
    """A :class:`HostTrainState` → the state dict of the JAX package's
    ``TrainState``: ``step``, ``params``, ``batch_stats`` and
    ``opt_state``, the last laid out as the optax chain ``masked(chain(
    clip, add_decayed_weights, sgd)), masked(set_to_zero)`` stores it —
    the trace at ``opt_state/0/inner_state/2/0/trace/<param path>`` (an
    empty map for a frozen parameter) and the update count at
    ``opt_state/0/inner_state/2/1/count``."""
    sd = host.state_dict
    tree = to_flax(sd)
    bn_modules = _bn_modules(sd)
    trace: dict = {}
    for name in host.param_names:
        path = _param_path(name, sd[name].ndim, bn_modules)
        t = host.trace.get(name)
        _set(trace, path, {} if t is None else _host(_flax_layout(t)))
    count = np.array(host.count, np.int32)
    sgd = {"0": {"trace": trace}, "1": {"count": count}}
    return {"step": count.copy(), "params": tree["params"],
            "batch_stats": tree["batch_stats"],
            "opt_state": {"0": {"inner_state": {"0": {}, "1": {}, "2": sgd}},
                          "1": {"inner_state": {}}}}


def train_state_to_flax(model: torch.nn.Module, optimizer) -> dict:
    """:func:`host_state_to_flax` of the live ``model`` and optimizer."""
    return host_state_to_flax(host_train_state(model, optimizer))


def load_train_state(tree: Mapping, model: torch.nn.Module, optimizer) -> None:
    """Write a :func:`train_state_to_flax` tree (the port's or the JAX
    package's) into ``model`` and ``optimizer`` in place.  The traced
    parameters must be the optimizer's trainable ones, in its trace dtype,
    and ``step`` must equal the update count."""
    try:
        sgd = tree["opt_state"]["0"]["inner_state"]["2"]
        trace_tree, count = sgd["0"]["trace"], sgd["1"]["count"]
    except (KeyError, TypeError) as e:
        raise ValueError(f"opt_state is not the SGD chain's layout: {e!r}")
    step, count = int(np.asarray(tree["step"])), int(np.asarray(count))
    if step != count:
        raise ValueError(f"step {step} differs from the optimizer's update "
                         f"count {count}")
    traces = {".".join(path[:-1] + (_FLAX_LEAF[path[-1]],)): leaf
              for path, leaf in _leaves(trace_tree)}
    if set(traces) != set(optimizer.trace):
        raise ValueError(
            f"the traced parameters differ from the trainable ones: only "
            f"in the file {sorted(set(traces) - set(optimizer.trace))}, only "
            f"trainable here {sorted(set(optimizer.trace) - set(traces))}")
    model.load_state_dict(from_flax(tree))
    for name, leaf in traces.items():
        t = _torch_layout(leaf if isinstance(leaf, torch.Tensor)
                          else torch.from_numpy(np.array(leaf)))
        dst = optimizer.trace[name]
        if t.dtype != dst.dtype or t.shape != dst.shape:
            raise ValueError(f"trace of {name}: {t.dtype} {tuple(t.shape)} "
                             f"in the file, {dst.dtype} {tuple(dst.shape)} "
                             f"here")
        dst.copy_(t)
    optimizer.count = count
