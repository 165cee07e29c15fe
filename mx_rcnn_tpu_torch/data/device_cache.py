"""The device-resident training epoch: stage once, gather every step there.

Counterpart of ``mx_rcnn_tpu/data/device_cache.py``.  :func:`build_caches`
runs the loader's epoch once and stages it on the device, one
:class:`DeviceEpochCache` per bucket: each field of the batches stacked
along a leading batch axis (the uint8 images, ``im_info`` and the gt
fields).  :func:`make_cached_step` wraps a train step so that it takes
its batch from the staged epoch: the gather index is the state's step,
so a run resumed from a checkpoint, mid-epoch too, continues the batch
sequence exactly.  Once the epoch is staged, a step copies no data from
the host and reads nothing back: a step's batch is a view of the
resident tensors, or a gather (``index_select``) by a slice of a
permutation that lives on the device.

``shuffle=False`` replays staged batch ``step % num_batches`` verbatim,
so a run is bit-equal to the streamed one.  ``shuffle=True`` gathers at
image granularity: the batch at position p of epoch e is the images at
``perm_e[p*bi:(p+1)*bi]`` of a permutation of every staged image, so the
composition of the batches changes every epoch, as the streaming
loader's regrouping does.  ``perm_e`` is drawn on the device by
``torch.randperm`` from a generator seeded by (seed, tag, epoch), the tag
keeping it apart from the step's draws as the JAX package's
``fold_in(key, 0x5A5A5A5)`` does; it is drawn once an epoch.  The JAX
package's device-resident step counter has no counterpart: here the host
knows the step, and a Python int indexes the resident tensors without a
copy.

The epoch staged is the loader's plan of epoch 0; with ``shuffle`` each
epoch regroups its images.  In a data-parallel run each rank stages the
epoch of its own row shard on its own card and regroups within it, from
the same (seed, epoch) (``parallel/dp.py — make_dp_cached_step``):
images never move between cards, as in the JAX package, whose mesh
shards each staged batch's image axis.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from mx_rcnn_tpu_torch.core.train import mix64

# the permutation stream's tag (the JAX package's fold_in constant)
PERMUTATION_TAG = 0x5A5A5A5

Permutation = Callable[[int, int, int, torch.device], torch.Tensor]


class DeviceEpochCache:
    """One bucket's epoch of batches (namedtuples of numpy arrays of one
    shape), stacked and resident on ``device``: ``data`` is the batch
    type with a leading ``num_batches`` axis on every field."""

    def __init__(self, batches: List, device):
        if not batches:
            raise ValueError("empty batch list")
        shapes = {tuple(b.images.shape) for b in batches}
        if len(shapes) > 1:
            raise ValueError(f"mixed bucket shapes in one cache: {shapes}")
        self.device = torch.device(device)
        stacked = [np.stack(xs) for xs in zip(*batches)]
        self.nbytes = sum(x.nbytes for x in stacked)
        self.data = type(batches[0])(*(torch.from_numpy(x).to(self.device)
                                       for x in stacked))
        self.num_batches = len(batches)
        self.batch_images = int(batches[0].images.shape[0])

    @property
    def num_images(self) -> int:
        return self.num_batches * self.batch_images

    def batch(self, pos: int):
        """Staged batch ``pos`` as it was staged (views)."""
        return type(self.data)(*(x[pos] for x in self.data))

    def gather(self, index: torch.Tensor):
        """The batch of the staged images at flat positions ``index`` (a
        device tensor; image ``j`` of staged batch ``p`` is position
        ``p * batch_images + j``)."""
        return type(self.data)(*(
            x.flatten(0, 1).index_select(0, index) for x in self.data))


def build_caches(loader: Iterable, max_bytes: int = 4 << 30,
                 device="cuda") -> List[DeviceEpochCache]:
    """Run one epoch of ``loader`` and stage it on ``device``, grouped by
    bucket shape.  ``MemoryError`` once the epoch's bytes pass
    ``max_bytes`` (the caller trains from the streaming loader instead);
    in a data-parallel run the loader yields this rank's rows, so the
    budget is per card."""
    by_shape: Dict[tuple, list] = {}
    total = 0
    for b in loader:
        by_shape.setdefault(tuple(b.images.shape), []).append(b)
        total += sum(np.asarray(x).nbytes for x in b)
        if total > max_bytes:
            raise MemoryError(
                f"epoch exceeds device cache budget ({total} > {max_bytes} "
                f"bytes); use the streaming loader")
    return [DeviceEpochCache(bs, device) for bs in by_shape.values()]


def epoch_permutation(seed: int, epoch: int, n: int,
                      device) -> torch.Tensor:
    """The order of the ``n`` staged images in ``epoch`` of a run seeded
    ``seed``: ``torch.randperm`` on ``device`` from a generator seeded by
    ``mix64(seed, PERMUTATION_TAG, epoch)``."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(mix64(seed, PERMUTATION_TAG, epoch))
    return torch.randperm(n, generator=g, device=device)


def make_cached_step(base_step: Callable, num_batches: int,
                     shuffle: bool = True,
                     permutation: Optional[Permutation] = None) -> Callable:
    """Wrap ``base_step(state, batch, **kw) → metrics`` into
    ``step(state, cache, **kw) → metrics`` that takes its batch from the
    resident :class:`DeviceEpochCache` ``cache`` at position ``p =
    state.step % num_batches`` of epoch ``e = state.step //
    num_batches``: staged batch p, or with ``shuffle`` the images at
    ``perm_e[p*bi:(p+1)*bi]`` (module docstring).  ``permutation(seed,
    epoch, n, device)`` draws ``perm_e`` (default
    :func:`epoch_permutation`); a test injects the JAX package's through
    it, as the step's ``draws`` replays the JAX uniforms.  ``kw`` (the
    ``draws``, the ``stage_hook``) goes to ``base_step``."""
    permutation = permutation or epoch_permutation
    drawn: Dict[tuple, torch.Tensor] = {}

    def step(state, cache: DeviceEpochCache, **kw):
        if cache.num_batches != num_batches:
            raise ValueError(f"the step was made for {num_batches} staged "
                             f"batches; the cache holds {cache.num_batches}")
        pos, epoch = state.step % num_batches, state.step // num_batches
        if not shuffle:
            return base_step(state, cache.batch(pos), **kw)
        key = (state.seed, epoch)
        if key not in drawn:
            drawn.clear()
            drawn[key] = permutation(state.seed, epoch, cache.num_images,
                                     cache.device).to(cache.device)
        bi = cache.batch_images
        return base_step(state, cache.gather(drawn[key][pos * bi:
                                                        (pos + 1) * bi]),
                         **kw)

    return step
