#!/usr/bin/env python3
"""Where the device time of the PyTorch port's one-step slice goes, on one GPU.

    python3 scripts/profile_torch_slice.py [--int8 | --fused] [--out FILE.json]

Builds the configuration of chip_smoke.py (SD2.1 at full width, seeded
random weights), warms a GenPerceptPipeline up with one .batch of two
768x768 images, then traces one more such .batch with torch.profiler, in
f32 (TF32 off) and in bf16; with --int8, W8A8 inference in bf16 instead
(chip_smoke.INT8_CFG: the warm-up .batch calibrates, the traced one runs
int8); with --fused, the fused-VAE path (PipelineConfig(fused_vae=True)) in
f32 and bf16. From the device events of the trace (kernels,
copies, memsets; profiler overhead and annotations left out) it prints one
JSON line per dtype:

  wall_ms          host time of the traced .batch (synchronized)
  device_busy_ms   union of the device events' intervals
  idle_share       1 - device_busy_ms / wall_ms
  families         device ms per kernel family and its share of the summed
                   device time (more than busy time where events overlap),
                   grouped by kernel name with FAMILIES below (first match)
  top              the 15 kernels with the most device time

and, given --out, writes the same records with the whole kernel table there.
"""

from __future__ import annotations

import argparse
import copy
import json
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import INT8_CFG, SEED, build_models, phase_device  # noqa: E402
from genpercept_tpu_torch.pipeline import (  # noqa: E402
    GenPerceptModels, GenPerceptPipeline, PipelineConfig)

FAMILIES = [  # (family, pattern on the kernel name); first match wins
    ("K8 fused_gn_silu_conv3x3", r"gn_silu_conv"),
    ("K7 quantized_conv3x3", r"qconv3x3_kernel"),
    ("K5 fused_geglu_ff_int8", r"ff_int8_(wgmma_)?kernel"),
    ("K6 flash_attn_int8", r"flash_int8_(wgmma_)?kernel"),
    ("K1 flash_attn_fwd", r"flash_attn_fwd"),
    ("K2 fused_geglu_ff", r"fused_geglu_ff"),
    ("convolution (cuDNN, incl. layout transposes)",
     r"conv|fprop|nchwToNhwc|nhwcToNchw|cudnn"),
    ("GEMM (cuBLAS)", r"gemm|cutlass|cublas"),
    ("copies, concatenations (incl. int8 im2col) and dtype casts",
     r"copy|Copy|Memcpy|Memset|CatArray"),
    ("reductions (GN/LN statistics)", r"reduce|welford|norm"),
    ("elementwise", r"elementwise"),
]
NOT_DEVICE_WORK = re.compile(r"Command Buffer Full")


def family(name: str) -> str:
    for fam, pat in FAMILIES:
        if re.search(pat, name):
            return fam
    return "other"


def device_events(prof):
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation and not NOT_DEVICE_WORK.search(e.name)):
            yield e


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def summarize(prof, wall_ms: float) -> dict:
    per_kernel, intervals = {}, []
    for e in device_events(prof):
        t0, t1 = e.time_range.start, e.time_range.end
        intervals.append((t0, t1))
        ms, n = per_kernel.get(e.name, (0.0, 0))
        per_kernel[e.name] = (ms + (t1 - t0) / 1000.0, n + 1)
    busy_ms = busy_us(intervals) / 1000.0
    kernel_ms = sum(ms for ms, _ in per_kernel.values())
    fams = {}
    for name, (ms, _) in per_kernel.items():
        fams[family(name)] = fams.get(family(name), 0.0) + ms
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_kernel_ms": kernel_ms, "idle_share": 1.0 - busy_ms / wall_ms,
        "device_events": len(intervals),
        "families": {f: {"ms": ms, "share": ms / kernel_ms}
                     for f, ms in sorted(fams.items(), key=lambda kv: -kv[1])},
        "top": [{"name": name[:120], "ms": ms, "count": n}
                for name, (ms, n) in ranked[:15]],
        "all": [{"name": name, "ms": ms, "count": n} for name, (ms, n) in ranked],
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="JSON file for the full kernel tables")
    parser.add_argument("--int8", action="store_true", help="profile W8A8 inference (bf16)")
    parser.add_argument("--fused", action="store_true",
                        help="profile the fused-VAE path (f32 and bf16)")
    args = parser.parse_args()
    phase_device()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    images = [(rng.uniform(size=(768, 768, 3)) * 255).astype(np.uint8) for _ in range(2)]
    unet, vae, clip = build_models(gen)
    records = []
    extra = {"fused_vae": True} if args.fused else {}
    runs = [(torch.bfloat16, INT8_CFG)] if args.int8 else [(torch.float32, extra),
                                                           (torch.bfloat16, extra)]
    for dt, cfg in runs:
        models = GenPerceptModels(
            unet=copy.deepcopy(unet).to(dt), vae=copy.deepcopy(vae).to(dt),
            clip=copy.deepcopy(clip).to(dt))
        pipe = GenPerceptPipeline(models, PipelineConfig(dtype=dt, **cfg), device="cuda")
        pipe.batch(images, batch_size=2)  # warm-up: kernel build, cuDNN plans, calibration
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pipe.batch(images, batch_size=2)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1000.0
        rec = {"dtype": str(dt), "int8": args.int8, "fused_vae": args.fused,
               "images": len(images), "batch_size": 2,
               **summarize(prof, wall_ms)}
        records.append(rec)
        print(json.dumps({k: v for k, v in rec.items() if k != "all"}), flush=True)
        del models, pipe, prof
        torch.cuda.empty_cache()
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(records, indent=1))


if __name__ == "__main__":
    main()
