"""Immutable configuration for the PyTorch port.

The port's own copy of the config fields and presets the detection
forward reads, with the JAX package's key names and default values, so a
config built here and one built by ``mx_rcnn_tpu.config`` agree on every
field they share.  The training, eval and serving slices add their
fields.
Three-level precedence: hardcoded defaults < network/dataset presets <
``section__field`` overrides (the CLIs' ``--set``).
"""

from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Iterable, Mapping, Tuple


@dataclass(frozen=True)
class TrainConfig:
    """Mirrors reference ``config.TRAIN``: sampling, RPN targets and the
    train-time proposal numbers."""

    batch_images: int = 1          # images per step
    flip: bool = True              # append horizontally flipped roidb copies
    shuffle: bool = True

    # R-CNN ROI sampling (proposal_target)
    batch_rois: int = 128
    fg_fraction: float = 0.25
    fg_thresh: float = 0.5
    bg_thresh_hi: float = 0.5
    bg_thresh_lo: float = 0.0

    # bbox regression target normalisation
    bbox_means: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    bbox_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)

    # RPN anchor target assignment (anchor_target)
    rpn_batch_size: int = 256
    rpn_fg_fraction: float = 0.5
    rpn_positive_overlap: float = 0.7
    rpn_negative_overlap: float = 0.3
    rpn_clobber_positives: bool = False
    rpn_allowed_border: int = 0
    rpn_bbox_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)

    # RPN proposals at train time
    rpn_pre_nms_top_n: int = 12000
    rpn_post_nms_top_n: int = 2000
    rpn_nms_thresh: float = 0.7
    rpn_min_size: int = 16

    max_gt_boxes: int = 100        # static pad for per-image gt boxes
    gt_append: bool = True         # gt boxes join the sampled ROI pool
    # recompute the backbone's activations in the backward pass
    # (torch.utils.checkpoint): the same gradients for less memory
    remat_backbone: bool = False


@dataclass(frozen=True)
class TestConfig:
    """Mirrors reference ``config.TEST``."""

    batch_images: int = 1           # images per eval forward
    nms: float = 0.3                # per-class NMS threshold at eval
    score_thresh: float = 1e-3
    max_per_image: int = 100        # detections kept per image, by score
    rpn_pre_nms_top_n: int = 6000
    rpn_post_nms_top_n: int = 300
    rpn_nms_thresh: float = 0.7
    rpn_min_size: int = 16
    # the alternate schedule's proposal dumps (tools/test_rpn.py); their
    # NMS shares rpn_nms_thresh
    proposal_pre_nms_top_n: int = 20000
    proposal_post_nms_top_n: int = 2000


@dataclass(frozen=True)
class NetworkConfig:
    """Per-network preset (anchor geometry, stride, pooled size, dtype)."""

    name: str = "resnet101"
    pixel_means: Tuple[float, ...] = (123.68, 116.779, 103.939)  # RGB
    rpn_feat_stride: int = 16
    anchor_scales: Tuple[int, ...] = (8, 16, 32)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    rcnn_pooled_size: Tuple[int, int] = (14, 14)
    # parameter-name prefixes frozen in training; 'gamma'/'beta' freeze
    # every BN affine (core/optim.py — frozen_mask)
    fixed_params: Tuple[str, ...] = (
        "conv0", "stage1", "bn0", "bn_data", "gamma", "beta")
    fixed_params_shared: Tuple[str, ...] = (
        "conv0", "stage1", "stage2", "stage3", "bn0", "bn_data",
        "gamma", "beta")
    compute_dtype: str = "bfloat16"


@dataclass(frozen=True)
class DatasetConfig:
    name: str = "PascalVOC"
    image_set: str = "2007_trainval"   # seeds the synthetic images
    test_image_set: str = "2007_test"
    root_path: str = "data"
    dataset_path: str = "data/VOCdevkit"
    num_classes: int = 21


@dataclass(frozen=True)
class DefaultConfig:
    """Mirrors reference ``default.*``: the training schedule and the
    optimizer constants (SGD, momentum 0.9, wd 5e-4, elementwise clip 5)."""

    frequent: int = 20            # log period, steps
    e2e_epoch: int = 10           # the training CLI's default end epoch
    e2e_lr: float = 0.001
    e2e_lr_step: str = "7"        # epochs at which lr drops by lr_factor
    # the alternate schedule's RPN and RCNN stages
    rpn_epoch: int = 8
    rpn_lr: float = 0.001
    rpn_lr_step: str = "6"
    rcnn_epoch: int = 8
    rcnn_lr: float = 0.001
    rcnn_lr_step: str = "6"
    lr_factor: float = 0.1
    momentum: float = 0.9
    wd: float = 0.0005
    clip_gradient: float = 5.0
    warmup_step: int = 0
    warmup_lr: float = 0.0
    # dtype of the stored momentum trace; parameters always stay fp32
    momentum_dtype: str = "bfloat16"
    # the host input plane (data/loader.py): batch-assembly threads and
    # batches kept in flight (0 workers: assembled on the step's thread)
    num_workers: int = 4
    prefetch: int = 4
    # ship uint8 batches and normalise on the device (ops/normalize.py);
    # False subtracts the means on the host into fp32 canvases
    raw_images: bool = True
    # decoded-uint8 image cache (data/cache.py): RAM tier in MiB (0
    # disables) and an optional disk tier directory
    image_cache_mb: int = 2048
    image_cache_dir: str = ""
    # decode worker processes (data/decode_pool.py); 0 decodes in the
    # assembly threads
    decode_procs: int = 0


@dataclass(frozen=True)
class BucketConfig:
    """Static (H, W) canvases images are resized and padded into."""

    scale: int = 600
    max_size: int = 1000
    shapes: Tuple[Tuple[int, int], ...] = ((608, 1024), (1024, 608))


@dataclass(frozen=True)
class DataConfig:
    """Mirrors ``mx_rcnn_tpu.config.DataConfig``: the training input
    plane's policy."""

    # StreamLoader's plan, a pure function of (seed, epoch) per bucket;
    # False trains on the classic AnchorLoader plan
    streaming: bool = True
    # copy batch k+1 to the device while step k runs (data/staging.py)
    staging: bool = True
    # staged batches kept in flight (>= 1), one batch of device memory each
    stage_depth: int = 2
    # host RAM ceiling in MiB for the cache budget (0 = unlimited;
    # data/loader.py — stream_cache_budget)
    ram_ceiling_mb: int = 0


@dataclass(frozen=True)
class ServeConfig:
    """Mirrors ``mx_rcnn_tpu.config.ServeConfig``: the online serving
    engine's policy (``serve/engine.py``).  Every micro-batch is padded
    to ``batch_size`` rows, so each bucket runs one batch shape."""

    batch_size: int = 4           # static micro-batch rows per dispatch
    max_delay_ms: float = 10.0    # longest wait to fill a micro-batch
    queue_depth: int = 64         # hard per-bucket admission cap
    shed_watermark: int = 32      # shed (HTTP 429) at this many queued
    default_timeout_ms: float = 2000.0   # per-request deadline; 0 = none
    score_thresh: float = 0.05    # detection floor of a response
    max_body_mb: float = 64.0     # request bodies over this are refused 413


@dataclass(frozen=True)
class FleetConfig:
    """Mirrors ``mx_rcnn_tpu.config.FleetConfig``: the serving fleet's
    policy (``serve/fleet.py``), N replica engines over device subsets
    behind a join-shortest-queue router, each joining from an export
    store (``serve/export.py``) or by running its warm-up.  Same 3-level
    precedence as every section (defaults < presets < ``--set
    fleet__field=value``); outside the config fingerprint."""

    # replica engines in the fleet (tools/fleet.py serve --replicas)
    replicas: int = 1
    # export store directory ("" = warm each replica by running it)
    export_dir: str = ""
    # cards per replica (0 = divide the cards evenly; replicas beyond the
    # supply share them round-robin).  A subset of several cards splits
    # each batch across them (core/tester.py — Predictor(devices=))
    devices_per_replica: int = 0
    # health monitor cadence: a dead replica is ejected from the routing
    # set and, with ``relaunch``, rebuilt on the RestartPolicy schedule
    health_interval_s: float = 1.0
    # re-dispatches of a request whose replica died under it (0 = fail
    # it); a reroute never extends the request's deadline
    reroute_retries: int = 1
    # relaunch dead replicas (RestartPolicy paces them and turns repeated
    # identical failures into a crash-loop verdict)
    relaunch: bool = True


@dataclass(frozen=True)
class CrosshostConfig:
    """Mirrors ``mx_rcnn_tpu.config.CrosshostConfig``: the cross-host
    serving tier (``serve/remote.py``, ``serve/agent.py``,
    ``serve/scheduler.py``), per-host agents behind the fleet's
    ``Replica`` seam over keep-alive HTTP and the binary wire, a store
    pull per joining host, and a scheduler that adds and drains replicas
    on the agents' gauges.  Same 3-level precedence as every section
    (defaults < presets < ``--set crosshost__field=value``); outside the
    config fingerprint."""

    # comma-separated agent URLs ("host:port,host:port"): the router's
    # membership when build_crosshost_router is given none
    agents: str = ""
    # keep-alive connections per remote replica, each a pipeline of its
    # own: up to connections x pipeline_depth frames in flight
    connections: int = 2
    # frames admitted per connection; past connections x pipeline_depth
    # the head sheds instead of queueing toward a slow host
    pipeline_depth: int = 4
    # frames packed into one MXE1 envelope per send (1: every frame
    # alone): one sendmsg, one round trip, one agent wakeup
    frames_per_send: int = 1
    # 0 keeps pipeline_depth fixed; >= 1 tunes each engine's depth in
    # [1, pipeline_depth_max] by AIMD on the windowed wire RTT
    pipeline_depth_max: int = 0
    # socket timeout of agent RPCs: a backstop above any deadline
    io_timeout_s: float = 60.0
    # the backlog feed's scrape cadence of every agent's /metrics
    scrape_interval_s: float = 0.25
    # consecutive transport or scrape failures before a remote replica
    # reads dead and the manager ejects it
    dead_after_failures: int = 3
    # the store server a joining agent pulls fleet.export_dir from
    # ("": the store is on local disk already)
    store_url: str = ""
    # replica engines each agent runs
    agent_replicas: int = 1
    # wire body cap (MB) both ways: the agent answers 413 above it, the
    # head fails a response above it
    max_body_mb: float = 64.0
    # the scheduler's resize RPC deadline (AgentAdminTimeout past it)
    admin_timeout_s: float = 5.0
    # deadline of every store-pull request (StorePullError past it)
    pull_timeout_s: float = 30.0
    # --- the scheduler (serve/scheduler.py) ----------------------------
    # ready replicas wanted fleet-wide (0: adopt what the fleet first
    # reports); ready < target is the host-death signal
    target_replicas: int = 0
    min_replicas: int = 1            # never drain below
    max_replicas: int = 8            # never add above
    # scale up when the windowed shed ratio passes this ...
    up_shed_ratio: float = 0.05
    # ... or the lane backlog per ready replica passes this many images
    up_backlog: float = 2.0
    # ticks a trigger must hold before the scheduler acts ...
    for_samples: int = 2
    # ... and quiet ticks before it drains
    idle_samples: int = 8
    # no further action until the last one is this old
    cooldown_s: float = 5.0
    interval_s: float = 0.5          # the scheduler's tick
    window_s: float = 10.0           # the rate and ratio window


@dataclass(frozen=True)
class BulkConfig:
    """Mirrors ``mx_rcnn_tpu.config.BulkConfig``: the bulk scoring tier
    (``serve/bulk.py``), a corpus streamed through the serving engine's
    bucket lanes into a sharded sink with exactly-once accounting."""

    # images between submit_prepared and their terminal state at once
    # (the feeder blocks past it); 0 = 2 x serve.batch_size x
    # fleet.replicas, clamped under the lane's shed watermark
    max_inflight: int = 0
    # plan batches per committed sink shard: the atomicity and resume
    # unit (tmp → fsync → rename; the cursor is the committed prefix)
    shard_batches: int = 16
    # resubmits per image after a FAILED or SHED end; past it the run
    # aborts, it never drops an image
    retries: int = 8


@dataclass(frozen=True)
class FTConfig:
    """Mirrors ``mx_rcnn_tpu.config.FTConfig``: the policy of the
    checkpoint writer and of ``--resume auto`` (``ft/``).  Its
    ``compile_cache_dir`` is left out: it names XLA's persistent
    compilation cache, which has no CUDA counterpart here (the kernels
    are built once per process by ``kernels.py``)."""

    # serialise and write checkpoints on a background thread; the step's
    # thread pays only the host copy
    async_snapshots: bool = True
    # one snapshot written and one queued; the next request waits this
    # long for the slot, then fails
    slot_timeout_s: float = 120.0
    # retention (ft/integrity.py — gc_checkpoints): the newest keep_last
    # epoch checkpoints and every keep_every-th epoch (the default 1
    # keeps every epoch); keep_last 0 disables it
    keep_last: int = 3
    keep_every: int = 1
    # --resume auto fails when the checkpoint's effective batch differs
    # from this run's; True makes it a warning
    allow_resize_resume: bool = False


@dataclass(frozen=True)
class QuantConfig:
    """Mirrors ``mx_rcnn_tpu.config.QuantConfig``: the post-training
    quantized inference forward (``ops/quant.py``), per-output-channel
    symmetric weights and per-tensor activation scales from a calibration
    sweep over held-out training batches.  Off by default, and then every
    output is the fp model's; training is never quantized.  Outside the
    config fingerprint, as in the JAX package."""

    # quantize the inference forward (eval Predictor, serving engine)
    enabled: bool = False
    # container: 'int8' (int32-accumulated) or 'fp8' (e4m3, fp32-accumulated)
    dtype: str = "int8"
    # 'native' runs the low-precision contraction (kernels K5/K6 on the
    # card); 'sim' runs the same quantized values in fp32 arithmetic
    mode: str = "native"
    # activation-scale estimator: 'absmax' (running max of |x|) or
    # 'percentile' (mean of the per-batch ``percentile``-th of |x|)
    estimator: str = "absmax"
    percentile: float = 99.9
    # integer bits of the int8 container, shared by weights and
    # activations (qmax = 2^(b-1) - 1); below 8 is the red-team arm
    weight_bits: int = 8
    # the calibration sweep: batches of a seeded subsample of the
    # training roidb, in roidb order
    calibration_batches: int = 2
    calibration_seed: int = 0
    # |mAP delta| the quantized eval may lose against the fp eval
    # (tools/quant_smoke.py)
    map_delta_budget: float = 0.05


@dataclass(frozen=True)
class ObsConfig:
    """Mirrors ``mx_rcnn_tpu.config.ObsConfig``: the observability plane
    (``obs/``), every field with the JAX package's default.  Everything
    is off by default, and then the hot paths pay one flag read (pinned
    by ``tests/test_torch_obs.py``)."""

    # master switch: the process registry records the fit loop, the
    # loaders and the snapshotter, and the CLIs write runs/<id>/
    # (events.jsonl and summary.json)
    enabled: bool = False
    run_dir: str = "runs"
    # JSON GET /metrics of the process registry from tools/train.py on
    # this port (0: off; tools/serve.py answers /metrics on its own port)
    metrics_port: int = 0
    # host spans (obs/trace.py), exported as a chrome trace on exit
    trace: bool = False
    trace_cap: int = 100_000     # span buffer bound (overflow counted)
    # a profile_steps-step torch.profiler window from this global step
    # (0: never), rolled up into device ms by scope and by op class
    profile_at_step: int = 0
    profile_steps: int = 3
    profile_dir: str = ""        # "" = <run record dir>/profile
    # SIGUSR2 toggles a profiler window in the CLIs
    sigusr2: bool = False
    # smoothing of the train.loss_ema gauge (one update a log window)
    loss_ema: float = 0.9
    # time-series plane (obs/timeseries.py): the sampler's ring store
    timeseries: bool = False
    sample_interval_s: float = 1.0
    ts_capacity: int = 600
    # SLO rules (obs/health.py) after every sample: health.* gauges,
    # transitions in the run record, the verdict on /healthz
    health: bool = False
    health_window_s: float = 30.0
    # flight recorder (obs/flightrec.py): dumps under runs/<id>/flight/
    # on a crash, SIGTERM, a lock-watchdog trip or a CRITICAL verdict
    flight: bool = False
    flight_window_s: float = 120.0
    flight_events: int = 512
    # comma-separated /metrics URLs (host:port, a URL, or name=url) for
    # obs/collect.py's merged view
    collect_urls: str = ""
    # distributed tracing: the head's sampling probability (0: off),
    # kept span trees, the slowest percentile kept, the skew alarm
    trace_sample: float = 0.0
    trace_ring: int = 256
    trace_slow_pct: float = 99.0
    skew_alarm_ms: float = 50.0


@dataclass(frozen=True)
class SimConfig:
    """Mirrors ``mx_rcnn_tpu.config.SimConfig``: the fleet simulator's
    knobs (``sim/``), a virtual-time harness that runs the port's own
    scheduler, health engine, collector and router key over hundreds of
    simulated hosts.  Request semantics (batch size, shed watermark,
    deadline) are read from ``cfg.serve`` and ``cfg.crosshost``, so a
    policy is judged under the knobs it ships with."""

    hosts: int = 100            # simulated agent hosts (one registry each)
    duration_s: float = 240.0   # trace length in virtual seconds
    seed: int = 0               # root seed of every sim RNG substream
    # collector scrape, health and scheduler cadence in virtual seconds
    scrape_interval_s: float = 1.0
    # the simulator's virtual service time of one dispatch at the
    # smallest bucket (a batch is padded to serve.batch_size rows, so
    # the cost follows the bucket, not the occupancy); larger buckets
    # scale by their pixel ratio
    service_ms: float = 430.0
    service_jitter: float = 0.10   # lognormal sigma on service draws
    warmup_s: float = 5.0          # resize(+1) cold-join delay (virtual)
    relaunch_s: float = 8.0        # host drain-to-relaunch dark time
    util: float = 0.65             # the generators' base demand, a
                                   # fraction of the boot fleet's capacity
    settle_s: float = 60.0         # post-trace drain budget before a
                                   # request still queued counts lost


@dataclass(frozen=True)
class RolloutConfig:
    """Mirrors ``mx_rcnn_tpu.config.RolloutConfig``: the rollout plane
    (``serve/rollout.py``): versioned export stores, per-host rolling
    updates, the canary lane with its online paired gate, rollback."""

    # the share of traffic the router sends down the canary version's
    # lane while the gate observes (a deterministic fraction accumulator)
    canary_fraction: float = 0.25
    # the online paired gate: the equivalence budget on the shadow-score
    # scale (CI inside +-budget) and the pairs needed before judging
    gate_budget: float = 0.02
    gate_min_pairs: int = 12
    # shadow-score every Nth controller tick of the canary phase
    gate_sample_every: int = 4
    # the canary's dwell before rolling, even once min_pairs is reached
    bake_s: float = 10.0
    # per-host swap step bound: a host silent this long is deferred and
    # re-checked in FINALIZE (the kill-mid-rollout path)
    step_timeout_s: float = 60.0
    # hosts rolled at once (the wave width)
    wave: int = 1
    # the controller's re-check cadence while pulls, warms and drains run
    settle_s: float = 1.0
    # the simulator's store-pull time (virtual seconds)
    pull_s: float = 3.0
    # the red-team arm's shadow-score damage to the canary (simulator and
    # rig only; 0.0: healthy)
    redteam_damage: float = 0.0


@dataclass(frozen=True)
class Config:
    train: TrainConfig = field(default_factory=TrainConfig)
    test: TestConfig = field(default_factory=TestConfig)
    network: NetworkConfig = field(default_factory=NetworkConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    default: DefaultConfig = field(default_factory=DefaultConfig)
    bucket: BucketConfig = field(default_factory=BucketConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    fleet: FleetConfig = field(default_factory=FleetConfig)
    crosshost: CrosshostConfig = field(default_factory=CrosshostConfig)
    bulk: BulkConfig = field(default_factory=BulkConfig)
    data: DataConfig = field(default_factory=DataConfig)
    ft: FTConfig = field(default_factory=FTConfig)
    quant: QuantConfig = field(default_factory=QuantConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)
    sim: SimConfig = field(default_factory=SimConfig)
    rollout: RolloutConfig = field(default_factory=RolloutConfig)

    @property
    def num_classes(self) -> int:
        return self.dataset.num_classes

    def replace(self, **kw: Any) -> "Config":
        """New Config with whole sections replaced."""
        return dataclasses.replace(self, **kw)

    def replace_in(self, section: str, **kw: Any) -> "Config":
        """New Config with fields replaced inside one section."""
        return dataclasses.replace(
            self, **{section: dataclasses.replace(getattr(self, section), **kw)})


_NETWORKS: Mapping[str, Mapping[str, Any]] = {
    # VGG16: the first two blocks frozen; the alternate schedule's shared
    # convs are all five
    "vgg": dict(name="vgg", rcnn_pooled_size=(7, 7),
                fixed_params=("conv1", "conv2"),
                fixed_params_shared=("conv1", "conv2", "conv3", "conv4",
                                     "conv5")),
    "resnet50": dict(name="resnet50", rcnn_pooled_size=(14, 14)),
    "resnet101": dict(name="resnet101", rcnn_pooled_size=(14, 14)),
    # test-only miniature network (models/tiny.py)
    "tiny": dict(name="tiny", rcnn_pooled_size=(7, 7),
                 anchor_scales=(2, 4, 8), fixed_params=(),
                 fixed_params_shared=("conv1", "conv2"),
                 compute_dtype="float32"),
}

# every CLI's --network choices
NETWORKS: Tuple[str, ...] = tuple(_NETWORKS)

_DATASETS: Mapping[str, Mapping[str, Any]] = {
    "PascalVOC": dict(name="PascalVOC", image_set="2007_trainval",
                      test_image_set="2007_test",
                      dataset_path="data/VOCdevkit", num_classes=21),
    "coco": dict(name="coco", image_set="train2017",
                 test_image_set="val2017", dataset_path="data/coco",
                 num_classes=81),
    "synthetic": dict(name="synthetic", image_set="train",
                      test_image_set="test", dataset_path="data/synthetic",
                      num_classes=4),
    "synthetic_hard": dict(name="synthetic_hard", image_set="train",
                           test_image_set="test",
                           dataset_path="data/synthetic_hard",
                           num_classes=9),
    "synthetic_stream": dict(name="synthetic_stream", image_set="train",
                             test_image_set="test",
                             dataset_path="data/synthetic_stream",
                             num_classes=81),
}

_DATASET_BUCKETS: Mapping[str, Mapping[str, Any]] = {
    "synthetic": dict(scale=320, max_size=416,
                      shapes=((320, 416), (416, 320))),
    "synthetic_hard": dict(scale=240, max_size=320,
                           shapes=((240, 320), (320, 240))),
    "synthetic_stream": dict(scale=240, max_size=320,
                             shapes=((240, 320), (320, 240))),
}


def generate_config(network: str = "resnet101", dataset: str = "PascalVOC",
                    **overrides: Any) -> Config:
    """Config from network+dataset presets plus ``section__field``
    overrides, e.g. ``generate_config('tiny', test__rpn_post_nms_top_n=16)``.
    """
    if network not in _NETWORKS:
        raise KeyError(f"unknown network {network!r}; have {sorted(_NETWORKS)}")
    if dataset not in _DATASETS:
        raise KeyError(f"unknown dataset {dataset!r}; have {sorted(_DATASETS)}")
    cfg = Config(network=NetworkConfig(**_NETWORKS[network]),
                 dataset=DatasetConfig(**_DATASETS[dataset]))
    if dataset in _DATASET_BUCKETS:
        cfg = cfg.replace_in("bucket", **_DATASET_BUCKETS[dataset])
    by_section: dict = {}
    for key, val in overrides.items():
        if "__" not in key:
            raise KeyError(f"override {key!r} must be 'section__field'")
        section, fname = key.split("__", 1)
        by_section.setdefault(section, {})[fname] = val
    for section, kw in by_section.items():
        node = getattr(cfg, section, None)
        if node is None:
            raise KeyError(f"unknown config section {section!r}")
        kw = {f: _coerce_override(getattr(node, f, None), v,
                                  f"{section}__{f}")
              for f, v in kw.items()}
        cfg = cfg.replace_in(section, **kw)
    validate_dtype_string(cfg.network.compute_dtype, "network__compute_dtype")
    validate_dtype_string(cfg.default.momentum_dtype,
                          "default__momentum_dtype")
    return cfg


def parse_set_overrides(items: Iterable[str]) -> dict:
    """``--set section__field=value`` items → :func:`generate_config`
    overrides; values parse as Python literals, else stay strings."""
    overrides = {}
    for item in items or ():
        key, sep, val = item.partition("=")
        if not sep or "__" not in key:
            raise ValueError(
                f"--set expects section__field=value, got {item!r}")
        try:
            overrides[key] = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            overrides[key] = val
    return overrides


_BOOL_STRINGS = {"true": True, "yes": True, "1": True,
                 "false": False, "no": False, "0": False}

_DTYPE_STRINGS = ("float32", "bfloat16")


def validate_dtype_string(val: str, key: str) -> str:
    """Dtype fields accept exactly two spellings; a typo fails loudly."""
    if val not in _DTYPE_STRINGS:
        raise ValueError(
            f"{key} must be one of {_DTYPE_STRINGS}, got {val!r}")
    return val


def _coerce_override(cur: Any, val: Any, key: str) -> Any:
    """Coerce an override (possibly a CLI string) to the field's type."""
    if val is None or cur is None:
        return val
    if isinstance(cur, bool):
        if isinstance(val, bool):
            return val
        if isinstance(val, int) and val in (0, 1):
            return bool(val)
        if isinstance(val, str) and val.lower() in _BOOL_STRINGS:
            return _BOOL_STRINGS[val.lower()]
        raise TypeError(f"{key} expects a bool, got {val!r}")
    if isinstance(cur, int):
        if isinstance(val, bool) or (isinstance(val, float)
                                     and not val.is_integer()):
            raise TypeError(f"{key} expects an int, got {val!r}")
        try:
            return int(val)
        except (TypeError, ValueError):
            raise TypeError(f"{key} expects an int, got {val!r}")
    if isinstance(cur, float):
        if isinstance(val, bool):
            raise TypeError(f"{key} expects a float, got {val!r}")
        try:
            return float(val)
        except (TypeError, ValueError):
            raise TypeError(f"{key} expects a float, got {val!r}")
    if isinstance(cur, tuple):
        if isinstance(val, (list, tuple)):
            return tuple(tuple(v) if isinstance(v, (list, tuple)) else v
                         for v in val)
        raise TypeError(f"{key} expects a tuple/list, got {val!r}")
    if isinstance(cur, str) and not isinstance(val, str):
        raise TypeError(f"{key} expects a string, got {val!r}")
    return val
