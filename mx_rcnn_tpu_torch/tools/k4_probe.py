"""Time kernel K4's quotient routes on the card.

K4 (``csrc/quantize.cu``) multiplies by the reciprocal of the unit and
takes the IEEE quotient only for a vector holding a value near a rounding
boundary of the container.  This tool builds two copies of its source
under other names: ``divide``, in which every vector takes the quotient
(the division per element the plain version does), and ``multiply``, in
which none does (a floor: not exact at the boundaries).  At the per-ROI
stage-4 shapes of the quantized ResNet-101 (600 rois of 14x14 and 7x7,
batch 2 of 300 an image) and a stage-3 one, it checks that ``divide``
writes K4's bytes, then times the three in CUDA graphs in turns, beside a
copy of the input (``clone``, the card's own rate for the bytes read) and
the bound (the bytes read and written at 3.35 TB/s).  The inputs are a
random frozen BN and ReLU on bf16 activations with units that are not
powers of two, as a calibrated model gives them.  Runs only on the card.

    python -m mx_rcnn_tpu_torch.tools.k4_probe [--out k4_probe.json]
"""

from __future__ import annotations

import argparse
import json

import torch

from mx_rcnn_tpu_torch import kernels
from mx_rcnn_tpu_torch.models.layers import FrozenBatchNorm
from mx_rcnn_tpu_torch.ops import quant as tq

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
# (label, NCHW shape, outputs): stage-4 unit 1's bn1 (conv1 and the
# shortcut), its bn2, unit 2's bn1, and stage 3's bn1
SHAPES = (("stage4 bn1", (600, 1024, 14, 14), 2),
          ("stage4 bn2", (600, 512, 14, 14), 1),
          ("stage4 bn1 7x7", (600, 2048, 7, 7), 1),
          ("stage3 bn1", (2, 1024, 38, 64), 1))
GUARDS = ("    if (product_e4m3(y, rcp, t)) {",
          "    if (product_s8(y, rcp, a.qmax, s)) {")


def variant(name: str, always: bool) -> kernels.CudaKernel:
    """K4's source with every vector (``always``) or none taking the
    quotient, built under ``name``."""
    src = kernels.QUANTIZE_ACT.source.read_text()
    for guard in GUARDS:
        if src.count(guard) != 1:
            raise RuntimeError(f"K4's source no longer holds {guard!r}")
        # "    if (cond) {" -> "    if (cond || true) {"
        src = src.replace(guard, guard[:-len(") {")]
                          + (" || true) {" if always else " && false) {"))
    path = kernels.BUILD_DIR / f"{name}.cu"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    return kernels.CudaKernel(name, str(path), "quantize_act_launch",
                              kernels.QUANTIZE_ACT.argtypes,
                              replaces=kernels.QUANTIZE_ACT.replaces)


def graph_ms(fn, iters: int = 20) -> float:
    """Device time of ``fn()`` a call: ``iters`` calls in one CUDA graph."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def case(dev, shape, outs: int, spec: tq.QuantSpec, seed: int):
    g = torch.Generator(device=dev).manual_seed(seed)
    n, c, h, w = shape
    bn = FrozenBatchNorm(c, torch.bfloat16).to(dev)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 2.0, generator=g)
        bn.bias.uniform_(-1.0, 1.0, generator=g)
        bn.running_mean.uniform_(-1.0, 1.0, generator=g)
        bn.running_var.uniform_(0.2, 3.0, generator=g)
    x = (torch.randn((n, h, w, c), generator=g, device=dev) * 4.0).to(
        torch.bfloat16).permute(0, 3, 1, 2)
    units = [tq._unit(torch.tensor(spec.qmax * f, device=dev), spec.qmax)
             for f in (0.0371, 0.0529)[:outs]]
    return x, bn.folded(), units


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the record here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k4_probe runs only on the card")
    dev = torch.device("cuda", 0)
    routes = {"kernel": kernels.QUANTIZE_ACT,
              "divide": variant("k4_divide", True),
              "multiply": variant("k4_multiply", False)}
    started = [k.start_build() for k in routes.values()]
    for k, st in zip(routes.values(), started):
        k.finish_build(st)
        k.fn()
    record = {"card": torch.cuda.get_device_name(0), "shapes": {}}
    try:
        for dtype in ("int8", "fp8"):
            spec = tq.QuantSpec(dtype=dtype)
            for i, (label, shape, outs) in enumerate(SHAPES):
                x, affine, units = case(dev, shape, outs, spec, i)

                def run():
                    return tq.quantize_act_fused_cuda(
                        x, units, spec, affine=affine, dtype=torch.bfloat16,
                        relu=True)

                got = {}
                times = {name: [] for name in routes}
                for _ in range(2):          # in turns, twice
                    for name, k in routes.items():
                        tq.QUANTIZE_ACT = k
                        got[name] = [q.view(torch.uint8) for q in run()]
                        times[name].append(graph_ms(run))
                tq.QUANTIZE_ACT = routes["kernel"]
                if not all(torch.equal(a, b) for a, b in
                           zip(got["kernel"], got["divide"])):
                    raise AssertionError(f"{dtype} {label}: the divide copy "
                                         f"and K4 write different bytes")
                clone = graph_ms(lambda: x.clone())
                nbytes = x.numel() * (2 + outs)
                rec = dict(shape=list(shape), outputs=outs,
                           graph_ms=times, clone_ms=clone,
                           bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3)
                record["shapes"][f"{dtype} {label}"] = rec
                print(f"{dtype} {label} {shape} out{outs}: " + ", ".join(
                    f"{k} {min(v):.4f}" for k, v in times.items())
                    + f" ms; clone {clone:.4f}, bound {rec['bound_ms']:.4f}",
                    flush=True)
    finally:
        tq.QUANTIZE_ACT = routes["kernel"]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
