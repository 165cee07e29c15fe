"""Train Faster R-CNN on a VOCdevkit, a COCO tree or synthetic images.

Counterpart of ``mx_rcnn_tpu/tools/train.py``: :func:`train_net` builds
the training roidb (``--dataset PascalVOC|coco``
read from ``--dataset_path`` with its gt_roidb cache under
``--root_path``, ``--image_set`` '+'-joined sets merged; ``--dataset
synthetic_hard|synthetic_stream``, the generated benchmark sets written
once as PNG files, ``--dataset_kw "{'num_images': 16}"`` sizing them; or
with ``--synthetic N`` that many synthetic images, the JAX package's
rectangles rendered in memory, 375x500 like VOC unless the dataset is a
generated one), with its flipped copies unless ``--no_flip`` → the
decode cache and pool of the config's ``default`` section for the
on-disk sets → ``StreamLoader`` (``data__streaming``, the default, as in
the JAX package) or ``AnchorLoader`` → epochs ``--begin_epoch ..
--end_epoch`` of train steps, each batch staged to the device ahead of
its step (``--grad_accum N`` batches an optimizer step; ``--no_shuffle``
keeps the plan's order), or with ``--device_cache`` the whole one-bucket
epoch staged on the device once and each step's batch gathered there
(``data/device_cache.py``) → Speedometer lines (``--profile_dir``: a
``torch.profiler`` trace of three early steps), and with ``--prefix`` a
checkpoint after each epoch
(``prefix-%04d.ckpt``, the JAX package's layout) written in the
background.  Weights start random, made from ``--seed``, unless
``--pretrained`` names an ImageNet file (MXNet ``.params`` or ``.npz``,
torchvision VGG16 ``.pth``; ``utils/pretrained.py``) whose backbone and
head trunk are grafted on.  The first SIGTERM finishes the step in
flight, writes ``prefix-interrupt.ckpt`` and exits 0.  ``--resume``
starts from the interrupt checkpoint or else the newest epoch
checkpoint under ``--prefix``; ``--resume auto`` verifies each
candidate against its manifest, falls back past a corrupt one, refuses
a different effective batch (``ft.allow_resize_resume`` relents) and
continues mid-epoch through the manifest's data cursor.  ``--begin_epoch
N`` starts from epoch N's checkpoint; a resumed run ends bit-equal to an
unbroken one.  ``--steps`` ends the run after that many steps.  The
alternate schedule's stage tools (``train_rpn.py``, ``train_rcnn.py``,
``train_alternate.py``) call :func:`train_net` with ``mode='rpn'`` or
``'rcnn'`` (``ROIIter``).

``--num_devices N`` trains one model on N cards, one process per card
(``parallel/dp.py``): the launcher builds the kernels and the roidb, then
spawns N ranks of a ``torch.distributed`` group (NCCL; gloo with
``--device cpu``), each owning one card and its row shard of the global
plan.  ``--batch_images`` stays per device, so the global batch is N x
``batch_images``; one all-reduce per optimizer step averages the
gradients, rank 0 alone writes the checkpoints, whose manifests record N
devices, and the launcher passes a SIGTERM on to every rank.  A
checkpoint resumes at another N when N x ``batch_images`` x
``grad_accum`` is kept.  Fewer than N cards is an error.  Across hosts,
each host runs its share of the ranks: ``--coordinator HOST:PORT
--num_processes P --process_id I`` (``parallel/multihost.py``), N being
the global count.  ``--device_cache`` stages each rank's row shard on its
card (``parallel/dp.py — make_dp_cached_step``); a world over several
hosts refuses it, as the JAX CLI refuses it with ``--coordinator``.

``--set obs__enabled=true`` opens the obs session (``obs/runrec.py —
cli_obs``) around the run, in each rank's process of ``--num_devices N``
(its own ``runs/<id>/``; ``obs__metrics_port`` + rank): the ``train.*``,
``loader.*`` and ``snapshot.*`` metrics, ``/metrics`` on
``obs__metrics_port``, spans (``obs__trace``), the profiler window
(``obs__profile_at_step``), the time series, health and flight recorder;
the summary carries ``train_samples_per_sec`` and the run's kernel
launches.  The flight recorder's SIGTERM trigger chains to the stop
flag, so the interrupt checkpoint is written as before.
``MXRCNN_THREAD_SANITIZER`` arms the lock sanitizer before the package
is imported.

``--export_train_step DIR`` exports the recipe's train step into an
export store at DIR (``serve/export.py — export_train_step``), prints
its report as one JSON line and exits.

``--fault_plan SPEC`` runs an ``ft/faults.py`` plan against the run
(crash-loop certification: ``tools/crashloop.py``); with ``--num_devices``
rank 0 runs it and its signals go to the launcher.  ``--elastic`` (or
``elastic__enabled=true``) trains under ``ft/elastic.py — run_elastic``:
topology directives at ``<prefix>.topology.json`` resize the run in
process, or, for a host of a world (``--coordinator``), drain it and
exit 77 (``EXIT_RESIZE``) for its supervisor to relaunch.

    python -m mx_rcnn_tpu_torch.tools.train --network resnet101 \\
        --dataset PascalVOC --root_path data --dataset_path data/VOCdevkit \\
        --batch_images 2 --prefix model/e2e --end_epoch 1             # card
    python -m mx_rcnn_tpu_torch.tools.train --num_devices 4 ...      # 4 cards
    python -m mx_rcnn_tpu_torch.tools.train --device cpu --network tiny \\
        --dataset synthetic --synthetic 4 --batch_images 2 \\
        --prefix /tmp/p --end_epoch 1
    python -m mx_rcnn_tpu_torch.tools.train --device cpu --network tiny \\
        --dataset synthetic_hard --dataset_kw "{'num_images': 16}" \\
        --device_cache --prefix /tmp/h --end_epoch 1
"""

from __future__ import annotations

# the lock sanitizer first: the locks the package allocates at import
# (kernels.py's) are born wrapped only if it is armed before
from mx_rcnn_tpu_torch.analysis import sanitizer  # isort: skip

sanitizer.maybe_install_from_env()

import argparse  # noqa: E402
import ast  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import threading  # noqa: E402
from typing import (Callable, Dict, Optional, Sequence, Tuple,  # noqa: E402
                    Union)

from mx_rcnn_tpu_torch import kernels  # noqa: E402
from mx_rcnn_tpu_torch.config import (NETWORKS, Config,  # noqa: E402
                                      generate_config, parse_set_overrides)
from mx_rcnn_tpu_torch.core.fit import fit  # noqa: E402
from mx_rcnn_tpu_torch.core.train import (TrainState,  # noqa: E402
                                          make_train_step, setup_training)
from mx_rcnn_tpu_torch.data import load_gt_roidb, reads_files  # noqa: E402
from mx_rcnn_tpu_torch.data.loader import (AnchorLoader,  # noqa: E402
                                           ROIIter, StreamLoader,
                                           cache_from_config,
                                           decode_pool_from_config)
from mx_rcnn_tpu_torch.ft.faults import (FaultInjector,  # noqa: E402
                                         parse_plan)
from mx_rcnn_tpu_torch.ft.integrity import (CheckpointRef,  # noqa: E402
                                            latest_valid_checkpoint)
from mx_rcnn_tpu_torch.obs.metrics import registry  # noqa: E402
from mx_rcnn_tpu_torch.obs.runrec import cli_obs  # noqa: E402
from mx_rcnn_tpu_torch.parallel.dp import (World,  # noqa: E402
                                           check_replicas, default_backend,
                                           launch, local_devices, replicate)
from mx_rcnn_tpu_torch.parallel.multihost import host_ranks  # noqa: E402
from mx_rcnn_tpu_torch.tools import (dataset_args,  # noqa: E402
                                     dataset_overrides)
from mx_rcnn_tpu_torch.utils.checkpoint import (  # noqa: E402
    config_fingerprint, interrupt_path, latest_checkpoint, load_state_dict,
    restore_interrupt, restore_state)
from mx_rcnn_tpu_torch.utils.device import resolve_device  # noqa: E402
from mx_rcnn_tpu_torch.utils.pretrained import (  # noqa: E402
    load_pretrained_into)


def _legacy_resume(state: TrainState, prefix: str, steps_per_epoch: int,
                   log: Callable[[str], None]) -> int:
    """Unverified resume (plain ``--resume``, and ``--resume auto`` in a
    directory without manifests): the interrupt checkpoint, step-exact,
    wins over the epoch checkpoints; a missing or corrupt file fails at
    restore.  Restores into ``state``; returns the begin epoch."""
    if os.path.exists(interrupt_path(prefix)):
        _, saved_spe = restore_interrupt(state, prefix)
        _check_spe(saved_spe, steps_per_epoch, prefix)
        begin_epoch = state.step // steps_per_epoch
        log(f"resumed mid-epoch from {interrupt_path(prefix)} (step "
            f"{state.step} → epoch {begin_epoch})")
        return begin_epoch
    found = latest_checkpoint(prefix)
    if found:
        restore_state(state, prefix, found[0])
        log(f"resumed from {prefix} epoch {found[0]} (step {state.step})")
        return found[0]
    log(f"--resume: nothing under {prefix}, starting fresh")
    return 0


def _check_topology(manifest: dict, cfg: Config, num_devices: int,
                    batch_images: int, grad_accum: int, path: str,
                    log: Callable[[str], None]) -> None:
    """A resume that would change the effective global batch (the images
    an optimizer step takes: devices x per-device ``batch_images`` x
    ``grad_accum``) changes the lr schedule and the step ↔ epoch mapping:
    an error, a warning under ``ft.allow_resize_resume``.  Another world
    size at the same global batch resumes.  A manifest without a topology
    has nothing to check."""
    topo = (manifest or {}).get("topology")
    if not topo or not topo.get("global_batch"):
        return
    now = num_devices * batch_images * grad_accum
    then = int(topo["global_batch"])
    if then == now:
        return
    msg = (f"checkpoint {path} was trained with effective global batch "
           f"{then} ({topo.get('devices')} devices x batch_images x "
           f"grad_accum {topo.get('grad_accum')}) but this run would "
           f"train with {now} ({num_devices} devices x {batch_images} "
           f"images x grad_accum {grad_accum}) — the LR schedule and "
           f"step↔epoch mapping would silently change")
    if cfg.ft.allow_resize_resume:
        log(f"resume: {msg} (ft.allow_resize_resume is set — continuing "
            f"anyway)")
        return
    raise ValueError(
        msg + "; rescale grad_accum to preserve the global batch, or set "
        "ft.allow_resize_resume=true to accept the resize")


def _check_spe(saved_spe: Optional[int], steps_per_epoch: int,
               prefix: str) -> None:
    """An interrupt checkpoint is step-exact only under the steps per
    epoch it was written with."""
    if saved_spe is not None and saved_spe != steps_per_epoch:
        raise ValueError(
            f"interrupt checkpoint was written with {saved_spe} "
            f"steps/epoch but this run has {steps_per_epoch} (different "
            f"batch size or dataset) — step-exact resume is impossible; "
            f"delete {interrupt_path(prefix)} to resume from the last "
            f"epoch checkpoint instead")


def _verified_resume(state: TrainState, cfg: Config, prefix: str,
                     steps_per_epoch: int, num_devices: int,
                     batch_images: int, grad_accum: int,
                     log: Callable[[str], None]
                     ) -> Tuple[int, Optional[Dict], Optional[CheckpointRef]]:
    """``--resume auto``: restore the newest checkpoint that verifies
    (``ft/integrity.py``), falling back past corrupt ones; an interrupt
    checkpoint also gives the data cursor.  ``batch_images`` is per
    device.  Returns (begin epoch, data cursor or None, the verified
    checkpoint restored or None)."""
    ref = latest_valid_checkpoint(prefix)
    if ref is None:
        if os.path.exists(interrupt_path(prefix)) or \
                latest_checkpoint(prefix):
            log(f"--resume auto: checkpoints exist under {prefix} but none "
                f"has a verifying manifest (pre-manifest run?) — falling "
                f"back to UNVERIFIED legacy resume instead of starting over")
            return (_legacy_resume(state, prefix, steps_per_epoch, log), None,
                    None)
        log(f"--resume auto: nothing restorable under {prefix}, starting "
            f"fresh")
        return 0, None, None
    fp_ckpt = ref.manifest.get("config_fingerprint")
    if fp_ckpt and fp_ckpt != config_fingerprint(cfg):
        log(f"resume: checkpoint {ref.path} was written under config "
            f"fingerprint {fp_ckpt} but this run is "
            f"{config_fingerprint(cfg)} — the recipe changed; the "
            f"continued run is NOT the same experiment")
    _check_topology(ref.manifest, cfg, num_devices, batch_images, grad_accum,
                    ref.path, log)
    if ref.kind != "interrupt":
        restore_state(state, prefix, ref.epoch)
        log(f"resumed from verified {ref.path} (epoch {ref.epoch}, step "
            f"{ref.step})")
        return ref.epoch, None, ref
    _, saved_spe = restore_interrupt(state, prefix)
    _check_spe(saved_spe, steps_per_epoch, prefix)
    step = state.step
    begin_epoch = step // steps_per_epoch
    log(f"resumed mid-epoch from verified {ref.path} (step {step} → epoch "
        f"{begin_epoch})")
    topo = ref.manifest.get("topology") or {}
    if not (topo.get("global_batch") and topo.get("grad_accum")):
        return begin_epoch, None, ref
    # the images consumed in this epoch, from the state's step under the
    # topology that wrote the checkpoint
    old_bi = int(topo["global_batch"]) // int(topo["grad_accum"])
    images = (step % steps_per_epoch) * int(topo["global_batch"])
    want = (ref.manifest.get("data_cursor") or {}).get("batches_consumed")
    if want is not None and int(want) * old_bi != images:
        log(f"resume: manifest data_cursor says {want} batches x {old_bi} "
            f"images consumed but state.step implies {images} images — "
            f"using the step-derived position")
    return begin_epoch, {"loader_batch_images": old_bi,
                         "images_consumed_in_epoch": images}, ref


# the arguments of train_net that only its launcher reads; the others go
# to every rank
_LAUNCHER_ARGS = ("cfg", "num_devices", "dcn_size", "coordinator",
                  "num_processes", "process_id", "world", "stop_flag", "log",
                  "run_record")


def train_net(cfg: Config, *, prefix: Optional[str] = None,
              mode: str = "e2e", proposals: Optional[Sequence] = None,
              init_from: Optional[Tuple[str, int]] = None,
              frozen_prefixes: Optional[Sequence[str]] = None,
              roidb=None, load_image: Optional[Callable] = None,
              synthetic: int = 0, dataset_kw: Optional[Dict] = None,
              begin_epoch: int = 0,
              end_epoch: Optional[int] = None,
              resume: Union[bool, str] = False,
              lr: Optional[float] = None, lr_step: Optional[str] = None,
              steps: Optional[int] = None, frequent: Optional[int] = None,
              seed: int = 0, device="cuda",
              pretrained: Optional[str] = None, pretrained_epoch: int = 0,
              grad_accum: int = 1, device_cache: bool = False,
              profile_dir: Optional[str] = None,
              num_devices: Optional[int] = None, dcn_size: int = 1,
              coordinator: Optional[str] = None, num_processes: int = 1,
              process_id: int = 0, world: Optional[World] = None,
              stop_flag: Optional[Callable[[], bool]] = None,
              log: Callable[[str], None] = print, run_record=None,
              step_callback: Optional[Callable[[int], None]] = None,
              fault_plan: Optional[str] = None,
              post_restore_callback: Optional[Callable] = None
              ) -> Tuple[Optional[TrainState], Dict[str, float]]:
    """Train on ``device`` (CUDA unless the caller asks for the CPU);
    returns the final state and the last log window's mean metrics.

    ``mode``: ``'e2e'``, ``'rpn'`` or ``'rcnn'``; ``'e2e'`` and ``'rpn'``
    train on :class:`StreamLoader`'s plan when ``cfg.data.streaming`` (the
    default) and on :class:`AnchorLoader`'s otherwise; ``'rcnn'`` trains
    on ``proposals`` (one raw-coordinate (k, 5) array per roidb record)
    through :class:`ROIIter`.  ``roidb`` and its ``load_image`` may be
    given (the alternate schedule does); by default the config's training
    roidb is read (``dataset_kw`` going to its reader, e.g. a generated
    set's ``num_images``), or that of ``synthetic`` synthetic images is
    built.
    Records read from files decode through the config's cache or decode
    pool (``default.image_cache_mb``, ``image_cache_dir``,
    ``decode_procs``); the pool is closed when the run ends.
    ``pretrained``: an ImageNet weight file (or a prefix naming
    ``{prefix}-{pretrained_epoch:04d}.params``) grafted onto the
    backbone and head trunk before ``init_from``.
    ``init_from``: a (prefix, epoch) checkpoint whose weights and
    statistics start the run, with a fresh optimizer.
    ``frozen_prefixes`` defaults to ``cfg.network.fixed_params``.  ``end_epoch`` defaults to
    ``default__e2e_epoch``, or to as many epochs as ``steps`` needs.
    ``resume``: True or ``'auto'`` (verified, with the data cursor; see
    the module docstring).  ``grad_accum``: loader batches an optimizer
    step accumulates; an epoch has ``len(loader) // grad_accum`` steps.
    ``device_cache``: stage the epoch on the device and gather each
    step's batch there (``core/fit.py``; one bucket, ``grad_accum`` 1, not
    across hosts).  ``profile_dir``: a ``torch.profiler`` trace of steps
    2-4 of the first epoch.  ``stop_flag``: polled after every step; True
    writes the interrupt checkpoint and returns.  ``run_record``: the
    obs session's ``RunRecord``, which the fit loop appends its events
    to (each rank of ``num_devices`` opens its own).  ``step_callback``:
    called with the global step after each step.  ``fault_plan``: an
    ``ft/faults.py`` plan this run executes against itself (crash-loop
    certification only; its injector runs before ``step_callback``).
    ``post_restore_callback(state, ref, steps_per_epoch)``: called after
    ``resume='auto'`` restored ``state`` from the verified checkpoint
    ``ref`` (``ft/integrity.py — CheckpointRef``), before the first step
    (the elastic controller's restore audit).  With ``num_devices`` the
    two callbacks and the plan run in rank 0 alone, so they must pickle;
    the plan's signals go to the launcher (``ft/faults.py``).

    ``num_devices``: train on that many devices, one spawned process
    each (:func:`_launch_ranks`, see the module docstring): the first
    ``num_devices`` cards over NCCL, or the CPU over gloo when ``device``
    is the CPU; the ranks run this function with their ``world``, rank 0
    prints the log, ``stop_flag`` sends every rank SIGTERM, and the
    returned state is None (the run's weights are in its checkpoints).
    ``coordinator``, ``num_processes`` and ``process_id``: this host's
    share of a world spread over ``num_processes`` hosts.  ``dcn_size``
    must divide the world and is recorded in each rank's ``World``; it
    changes no number (``parallel/dp.py``).  ``cfg.quant.enabled`` is
    refused: quantization is inference-only."""
    if cfg.quant.enabled:
        # the quantized model needs calibrated scales no training step
        # has; refuse before anything is built
        raise ValueError(
            "quant__enabled=true is inference-only — train with the fp "
            "config and enable quant at test/serve/export time")
    if device_cache and (num_processes > 1 or coordinator):
        raise ValueError(
            "device_cache does not compose with a world over several hosts "
            "(--coordinator/--num_processes; the JAX CLI refuses it with "
            "multiproc); use the streaming loader")
    if world is None and num_devices is not None:
        kw = {k: v for k, v in locals().items() if k not in _LAUNCHER_ARGS}
        return _launch_ranks(cfg, num_devices, dcn_size=dcn_size,
                             coordinator=coordinator,
                             num_processes=num_processes,
                             process_id=process_id, stop_flag=stop_flag,
                             log=log, **kw)
    if dcn_size > 1:
        raise ValueError(
            f"dcn_size={dcn_size} requires num_devices > 1 — the (dcn, "
            f"ici) split only exists in multi-device training")
    world = world or World.single(resolve_device(device))
    if not world.lead:
        log = lambda line: None  # noqa: E731
        step_callback = post_restore_callback = fault_plan = None
    if fault_plan:
        if not prefix:
            raise ValueError("a fault plan acts on checkpoints: it needs a "
                             "prefix")
        # in a rank, "this process" is the launcher the supervisor watches
        target = os.getpid() if world.group is None else os.getppid()
        injector = FaultInjector(parse_plan(fault_plan), prefix,
                                 kill_fn=lambda sig: os.kill(target, sig))
        user_cb = step_callback

        def step_callback(step, _inj=injector.on_step, _cb=user_cb):
            _inj(step)
            if _cb is not None:
                _cb(step)
        log(f"fault injection ACTIVE: {fault_plan}")
    if resume not in (False, True, "auto"):
        raise ValueError(f"resume must be False, True or 'auto', got "
                         f"{resume!r}")
    if mode == "rcnn" and proposals is None:
        raise ValueError("mode='rcnn' requires precomputed proposals")
    if (resume or begin_epoch) and not prefix:
        raise ValueError("resume and begin_epoch need a prefix")
    if roidb is None:
        imdb, roidb = load_gt_roidb(cfg, training=True, synthetic=synthetic,
                                    **(dataset_kw or {}))
        load_image = imdb.load_image
    elif load_image is None:
        raise ValueError("a roidb needs its load_image")
    source, pool = {}, None
    if reads_files(load_image):
        bh, bw = cfg.bucket.shapes[0]
        sizes = dict(n_images=len(roidb), image_bytes=bh * bw * 3,
                     batch_bytes=cfg.train.batch_images * bh * bw * 3)
        # with a pool the RAM tier lives in its workers, which start with
        # the first decode (inside fit)
        pool = decode_pool_from_config(cfg, **sizes)
        source = dict(decode_pool=pool, cache=None if pool else
                      cache_from_config(cfg, **sizes))
    # the plan is the global batch's; this rank decodes its rows of it
    source.update(batch_images=world.size * cfg.train.batch_images,
                  shard=(world.rank, world.size))
    if mode == "rcnn":
        loader = ROIIter(roidb, cfg, load_image, proposals, seed=seed,
                         **source)
    else:
        kind = StreamLoader if cfg.data.streaming else AnchorLoader
        loader = kind(roidb, cfg, load_image, seed=seed, **source)
    steps_per_epoch = max(len(loader) // grad_accum, 1)
    state = setup_training(cfg, world.device, seed, steps_per_epoch,
                           base_lr=lr, lr_step=lr_step,
                           frozen_prefixes=frozen_prefixes)
    if pretrained:
        load_pretrained_into(state, pretrained, pretrained_epoch, cfg)
        log(f"[{mode}] grafted pretrained backbone from {pretrained}")
    if init_from is not None:
        state.model.load_state_dict(load_state_dict(*init_from))
        log(f"[{mode}] initialised from {init_from[0]} epoch {init_from[1]}")
    replicate(state.model, state.optimizer, world)
    data_cursor = None
    if resume and begin_epoch == 0:
        if resume == "auto":
            begin_epoch, data_cursor, ref = _verified_resume(
                state, cfg, prefix, steps_per_epoch, world.size,
                cfg.train.batch_images, grad_accum, log)
            if ref is not None and post_restore_callback is not None:
                post_restore_callback(state, ref, steps_per_epoch)
        else:
            begin_epoch = _legacy_resume(state, prefix, steps_per_epoch, log)
        check_replicas(state.model, state.optimizer, world)
    elif begin_epoch > 0:
        restore_state(state, prefix, begin_epoch)
        log(f"resumed from {prefix} epoch {begin_epoch} (step {state.step})")
        check_replicas(state.model, state.optimizer, world)
    if end_epoch is None:
        end_epoch = (begin_epoch + math.ceil(steps / steps_per_epoch)
                     if steps else cfg.default.e2e_epoch)
    log(f"[{mode}] network={cfg.network.name} "
        f"dtype={cfg.network.compute_dtype} "
        f"device={next(state.model.parameters()).device} "
        f"batch_images={loader.batch_images} grad_accum={grad_accum} "
        f"records={len(roidb)} loader={type(loader).__name__} "
        f"epochs={begin_epoch}..{end_epoch} steps={steps}")
    if world.group is not None:
        log(f"[{mode}] {world.describe()}: {cfg.train.batch_images} images "
            f"per rank of each global batch of {loader.batch_images}")
    try:
        metrics = fit(state, cfg, make_train_step(cfg, mode, grad_accum,
                                                  world),
                      loader, end_epoch, begin_epoch, prefix, steps,
                      frequent, log=log, stop_flag=stop_flag,
                      grad_accum=grad_accum, data_cursor=data_cursor,
                      world=world, device_cache=device_cache,
                      profile_dir=profile_dir, run_record=run_record,
                      step_callback=step_callback)
    finally:
        if pool is not None:
            pool.close()
    log(f"[{mode}] images decoded: {loader.images_decoded}")
    return state, metrics


def _launch_ranks(cfg: Config, num_devices: int, *, dcn_size: int = 1,
                  devices: Optional[Sequence[str]] = None,
                  backend: Optional[str] = None,
                  coordinator: Optional[str] = None, num_processes: int = 1,
                  process_id: int = 0,
                  stop_flag: Optional[Callable[[], bool]] = None,
                  log: Callable[[str], None] = print, **kw
                  ) -> Tuple[None, Dict[str, float]]:
    """:func:`train_net` over ``num_devices`` ranks, each given ``kw``
    (the rest of :func:`train_net`'s arguments): this host's share of
    them (``parallel/multihost.py — host_ranks``) spawned by
    :func:`parallel.dp.launch`, after the kernels and the roidb were
    built here once.  ``devices`` and ``backend`` default to the first
    cards over NCCL (the CPU over gloo when ``kw['device']`` is the CPU);
    a test rig names one card twice over gloo, and every line says so.
    Logs each rank's final step and kernel launches."""
    if dcn_size > 1 and num_devices == 1:
        raise ValueError(
            f"dcn_size={dcn_size} requires num_devices > 1 — the (dcn, "
            f"ici) split only exists in multi-device training")
    if num_processes > 1 and not coordinator:
        raise ValueError("a world over several hosts needs a coordinator")
    ranks = host_ranks(num_devices, num_processes, process_id)
    devs = local_devices(kw.get("device", "cuda"), len(ranks), devices)
    if len(devs) != len(ranks):
        raise ValueError(f"{len(devs)} devices for {len(ranks)} ranks")
    backend = backend or default_backend(devs[0])
    rig = backend != default_backend(devs[0])
    if any(d.startswith("cuda") for d in devs):
        kernels.build_all()
    if kw.get("roidb") is None:
        # once here, so the ranks neither race on the gt_roidb cache nor
        # disagree on the records
        imdb, kw["roidb"] = load_gt_roidb(cfg, training=True,
                                          synthetic=kw.get("synthetic", 0),
                                          **(kw.get("dataset_kw") or {}))
        kw["load_image"] = imdb.load_image
    mode = kw.get("mode", "e2e")
    span = f"{ranks[0]}..{ranks[-1]}"
    log(f"[{mode}] launching ranks {span} of {num_devices} on {devs}, "
        f"backend {backend}"
        + (" (a test rig: gloo on a card, not NCCL)" if rig else ""))
    results = launch(
        _train_rank, len(ranks), devs, backend,
        init_method=f"tcp://{coordinator}" if coordinator else None,
        args=(cfg, kw), timeout_s=None, stop_flag=stop_flag,
        dcn_size=dcn_size, first_rank=ranks[0], world_size=num_devices)
    log(f"[{mode}] ranks {span} ended at steps "
        f"{[step for step, _, _ in results]}; kernel launches "
        f"{[launches for _, _, launches in results]}")
    return None, results[0][1]


def _train_rank(world: World, cfg: Config, kw: dict
                ) -> Tuple[int, Dict[str, float], Dict[str, int]]:
    """One rank of :func:`_launch_ranks`: :func:`train_net` with its
    world, rank 0's log on stdout, a SIGTERM stop flag and an obs
    session of its own; returns the rank's final step, its last metrics
    and its kernel launches (``kernels.launch_counts``: the whole run's,
    in a process that ran nothing else)."""
    with sigterm_stop_flag() as stop_flag, \
            train_obs(cfg, rank=world.rank) as record:
        state, metrics = train_net(cfg, world=world, stop_flag=stop_flag,
                                   log=lambda line: print(line, flush=True),
                                   run_record=record, **kw)
    return state.step, metrics, kernels.launch_counts()


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--network", default="resnet101", choices=NETWORKS)
    dataset_args(p)
    p.add_argument("--batch_images", type=int, default=None,
                   help="images per device and step")
    p.add_argument("--num_devices", type=int, default=None,
                   help="train on this many cards, one process each (the "
                        "global count across hosts); unset: one process, "
                        "no process group")
    p.add_argument("--dcn_size", type=int, default=1,
                   help="the JAX CLI's (dcn, ici) split: it must divide "
                        "--num_devices and is shown in the ranks' log, but "
                        "the all-reduce is flat over the world and NCCL "
                        "picks its own algorithm, so it changes no number "
                        "and no checkpoint records it")
    p.add_argument("--coordinator", default=None,
                   help="HOST:PORT where the ranks of a world over several "
                        "hosts meet (with --num_processes, --process_id)")
    p.add_argument("--num_processes", type=int, default=1,
                   help="hosts of the world, each launching its share of "
                        "the ranks")
    p.add_argument("--process_id", type=int, default=0,
                   help="this host's index among --num_processes")
    p.add_argument("--prefix", default=None,
                   help="checkpoint prefix: save prefix-%%04d.ckpt after "
                        "each epoch")
    p.add_argument("--begin_epoch", type=int, default=0,
                   help="start from this epoch's checkpoint under --prefix")
    p.add_argument("--end_epoch", type=int, default=None,
                   help="train up to this epoch (default: default__e2e_epoch,"
                        " or as many as --steps needs)")
    p.add_argument("--resume", nargs="?", const=True, default=False,
                   choices=[True, "auto"], metavar="auto",
                   help="start from the interrupt checkpoint under --prefix, "
                        "else the newest epoch checkpoint; 'auto' verifies "
                        "manifests and SHA-256, falls back past corrupt "
                        "files and continues mid-epoch")
    p.add_argument("--pretrained", default=None,
                   help="ImageNet weights for the backbone: a .params, .npz "
                        "or VGG16 .pth file, or a prefix of "
                        "PREFIX-%%04d.params")
    p.add_argument("--pretrained_epoch", type=int, default=0)
    p.add_argument("--grad_accum", type=int, default=1,
                   help="loader batches accumulated per optimizer step")
    p.add_argument("--steps", type=int, default=None,
                   help="end the run after this many steps")
    p.add_argument("--lr", type=float, default=None,
                   help="base learning rate (default: default__e2e_lr)")
    p.add_argument("--lr_step", default=None,
                   help="comma-separated epochs at which the lr drops by "
                        "default__lr_factor (default: default__e2e_lr_step)")
    p.add_argument("--frequent", type=int, default=None,
                   help="log every this many steps")
    p.add_argument("--no_flip", action="store_true",
                   help="train without the flipped copies")
    p.add_argument("--no_shuffle", action="store_true",
                   help="train on the plan's order, the same every epoch")
    p.add_argument("--dataset_kw", default=None,
                   help="Python-literal dict for the dataset's reader, e.g. "
                        "\"{'num_images': 16}\" for a generated set")
    p.add_argument("--device_cache", action="store_true",
                   help="stage the one-bucket epoch on the device once and "
                        "gather each step's batch there")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of three early steps "
                        "of the first epoch here")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the weights, the draws and the shuffle")
    p.add_argument("--fault_plan", default=None,
                   help="a fault plan this run executes against itself, "
                        "e.g. kill@step=5@sig=TERM (crash-loop "
                        "certification only; ft/faults.py)")
    p.add_argument("--elastic", action="store_true",
                   help="train under the elastic controller (ft/elastic.py, "
                        "also elastic__enabled=true): topology directives "
                        "at <prefix>.topology.json resize the run, with "
                        "grad_accum rescaled to keep the global batch")
    p.add_argument("--export_train_step", default=None, metavar="DIR",
                   help="export this recipe's train step into the store "
                        "DIR (serve/export.py — export_train_step: the "
                        "step's input spec and output digest, verified "
                        "bit-equal twice under pinned algorithms, and "
                        "the kernel libraries it launched), print the "
                        "report as one JSON line and exit")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--set", action="append", metavar="SEC__FIELD=VAL",
                   help="override a config field (repeatable)")
    return p.parse_args(argv)


def config_from_args(args) -> Config:
    """The config of the training CLIs' ``--network``, ``--dataset``,
    ``--image_set``, ``--root_path``, ``--dataset_path``,
    ``--batch_images``, ``--no_flip``, ``--no_shuffle`` and ``--set``
    flags."""
    overrides = dataset_overrides(args)
    if args.image_set:
        overrides["dataset__image_set"] = args.image_set
    overrides.update(parse_set_overrides(args.set))
    if args.batch_images:
        overrides["train__batch_images"] = args.batch_images
    if args.no_flip:
        overrides["train__flip"] = False
    if getattr(args, "no_shuffle", False):
        overrides["train__shuffle"] = False
    return generate_config(args.network, args.dataset, **overrides)


@contextlib.contextmanager
def sigterm_stop_flag():
    """A stop flag that the first SIGTERM sets: the step in flight
    finishes, the interrupt checkpoint is written and the run returns.
    The handler is installed from the main thread only (elsewhere the
    flag never sets) and the previous one is restored on exit."""
    stop = threading.Event()

    def on_sigterm(signum, frame):
        stop.set()

    previous = None
    if threading.current_thread() is threading.main_thread():
        previous = signal.signal(signal.SIGTERM, on_sigterm)
    try:
        yield stop.is_set
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)


@contextlib.contextmanager
def train_obs(cfg: Config, rank: int = 0):
    """The training process's obs session (None when ``cfg.obs`` is
    off), with the step counters as flight context; yields its
    ``RunRecord`` and closes it (summary: ``train_samples_per_sec``, the
    steps and the kernel launches and library loads) however the run
    ends.  Open it inside :func:`sigterm_stop_flag`, so that the flight
    recorder's SIGTERM trigger chains to the stop flag."""
    obs_sess = cli_obs(cfg, "train", rank=rank)
    if obs_sess is not None and obs_sess.flight is not None:
        reg = registry()
        obs_sess.flight.add_context(
            "train", lambda: {"step": reg.counter("train.steps"),
                              "epochs_done": reg.counter("train.epochs"),
                              "samples_per_sec": reg.gauge(
                                  "train.samples_per_sec")})
    try:
        yield None if obs_sess is None else obs_sess.record
    finally:
        if obs_sess is not None:
            reg = registry()
            obs_sess.close(metric="train_samples_per_sec",
                           value=reg.gauge("train.samples_per_sec"),
                           unit="imgs/s", steps=reg.counter("train.steps"),
                           kernel_launches=kernels.launch_counts(),
                           kernel_load_events=kernels.load_events())


def main(argv=None) -> Dict[str, float]:
    args = parse_args(argv)
    if (args.resume or args.begin_epoch) and not args.prefix:
        raise SystemExit("--resume and --begin_epoch need --prefix")
    cfg = config_from_args(args)
    if args.export_train_step:
        from mx_rcnn_tpu_torch.serve.export import export_train_step

        report = export_train_step(
            cfg, out_dir=args.export_train_step,
            num_devices=args.num_devices or 1, grad_accum=args.grad_accum,
            seed=args.seed, device=args.device)
        print(json.dumps(report), flush=True)
        return report
    dataset_kw = (ast.literal_eval(args.dataset_kw) if args.dataset_kw
                  else None)
    if args.elastic or cfg.elastic.enabled:
        if not args.prefix:
            raise SystemExit("--elastic needs --prefix")
        return _elastic_main(args, cfg, dataset_kw)
    # the ranks of --num_devices open their own sessions
    obs_cfg = cfg if args.num_devices is None else \
        cfg.replace_in("obs", enabled=False)
    with sigterm_stop_flag() as stop_flag, train_obs(obs_cfg) as record:
        _, metrics = train_net(
            cfg, prefix=args.prefix, synthetic=args.synthetic,
            dataset_kw=dataset_kw,
            begin_epoch=args.begin_epoch, end_epoch=args.end_epoch,
            resume=args.resume, lr=args.lr, lr_step=args.lr_step,
            steps=args.steps,
            frequent=args.frequent, seed=args.seed, device=args.device,
            pretrained=args.pretrained,
            pretrained_epoch=args.pretrained_epoch,
            grad_accum=args.grad_accum, device_cache=args.device_cache,
            profile_dir=args.profile_dir, stop_flag=stop_flag,
            log=lambda line: print(line, flush=True),
            num_devices=args.num_devices, dcn_size=args.dcn_size,
            coordinator=args.coordinator, num_processes=args.num_processes,
            process_id=args.process_id, run_record=record,
            fault_plan=args.fault_plan)
    print("final " + ", ".join(f"{k}={v:.4f}" for k, v in metrics.items()),
          flush=True)
    return metrics


def _elastic_main(args, cfg: Config, dataset_kw) -> Dict[str, float]:
    """``--elastic``: the run under ``ft/elastic.py — run_elastic``, which
    exits with its code (``EXIT_RESIZE`` when a world's process set must
    be relaunched) and returns no metrics.  ``--coordinator`` makes this
    process one host of a world over several (its share of the ranks)."""
    from mx_rcnn_tpu_torch.ft.elastic import run_elastic

    with sigterm_stop_flag() as stop_flag, train_obs(cfg) as record:
        code = run_elastic(
            cfg, prefix=args.prefix, end_epoch=args.end_epoch, lr=args.lr,
            lr_step=args.lr_step, frequent=args.frequent, seed=args.seed,
            dataset_kw=dataset_kw, synthetic=args.synthetic,
            pretrained=args.pretrained,
            pretrained_epoch=args.pretrained_epoch, stop_flag=stop_flag,
            run_record=record, fault_plan=args.fault_plan,
            device=args.device, num_devices=args.num_devices,
            coordinator=args.coordinator, num_processes=args.num_processes,
            process_id=args.process_id,
            log=lambda line: print(line, flush=True))
    if code:
        raise SystemExit(code)
    return {}


if __name__ == "__main__":
    main()
