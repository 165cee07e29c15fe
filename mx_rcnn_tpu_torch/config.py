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
class Config:
    train: TrainConfig = field(default_factory=TrainConfig)
    test: TestConfig = field(default_factory=TestConfig)
    network: NetworkConfig = field(default_factory=NetworkConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    default: DefaultConfig = field(default_factory=DefaultConfig)
    bucket: BucketConfig = field(default_factory=BucketConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    data: DataConfig = field(default_factory=DataConfig)
    ft: FTConfig = field(default_factory=FTConfig)
    quant: QuantConfig = field(default_factory=QuantConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)

    @property
    def num_classes(self) -> int:
        return self.dataset.num_classes

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
