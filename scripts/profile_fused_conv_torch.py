#!/usr/bin/env python3
"""K8, the fused GroupNorm -> SiLU -> conv3x3 + residual, against the unfused
composition, on one GPU.

    python3 scripts/profile_fused_conv_torch.py [--batch 16] [--reps 10] [--f32]

The PyTorch port of scripts/profile_fused_conv.py, at its three VAE levels
(768^2@128, 384^2@256, 192^2@512, C = Co), bf16 (f32 with --f32, TF32 off):
x, |GN scale|, GN bias, conv weight * 0.05, conv bias and a residual from a
seed. Each function is timed with CUDA events (one warm-up, then the mean of
--reps calls):

  fused_ms     fused_conv.fused_gn_silu_conv3x3: the GroupNorm statistics
               (torch) and K8, what the fused VAE path runs
  kernel_ms    fused_conv.fused_conv_apply on precomputed statistics: K8 alone
  unfused_ms   group_norm -> silu -> conv2d (cuDNN) -> + residual, the port's
               unfused resblock ops in x's dtype

and printed as one JSON line per level with TFLOP/s (2*9*H*W*C*Co*batch over
each time), after chip_smoke's device lines (the card's name and power
limit) and a line naming K8's body of the dtype (the bf16 body, or with
--f32 the f32 body). Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import cuda_ms, phase_device  # noqa: E402
from genpercept_tpu_torch import _build  # noqa: E402
from genpercept_tpu_torch.ops import conv2d, group_norm  # noqa: E402
from genpercept_tpu_torch.ops import fused_conv as fc  # noqa: E402

LEVELS = ((768, 128), (384, 256), (192, 512))  # scripts/profile_fused_conv.py's


def profile(batch: int = 16, reps: int = 10, dtype=torch.bfloat16, seed: int = 0) -> list:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    records = []
    for hw, c in LEVELS:
        def randn(*shape):
            return torch.randn(*shape, device="cuda", generator=gen)

        x = randn(batch, c, hw, hw).to(dtype)
        gs, gb = randn(c).abs(), randn(c)
        cw, cb = (randn(c, c, 3, 3) * 0.05).to(dtype), randn(c)
        res = randn(batch, c, hw, hw).to(dtype)
        a, b = fc.gn_affine(x, gs, gb)
        times = {
            "fused_ms": cuda_ms(lambda: fc.fused_gn_silu_conv3x3(x, gs, gb, cw, cb,
                                                                 residual=res), reps),
            "kernel_ms": cuda_ms(lambda: fc.fused_conv_apply(x, a, b, cw, cb, res), reps),
            "unfused_ms": cuda_ms(lambda: conv2d(F.silu(group_norm(x, gs, gb, 32, 1e-6)),
                                                 cw, cb) + res, reps),
        }
        ops = 2.0 * 9 * batch * hw * hw * c * c
        rec = {"level": f"{hw}@{c}", "batch": batch, "dtype": str(dtype), **times}
        rec.update({k.replace("_ms", "_tflops"): ops / (v * 1e-3) / 1e12
                    for k, v in times.items()})
        records.append(rec)
        del x, res, a, b
        torch.cuda.empty_cache()
    return records


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--f32", action="store_true")
    args = ap.parse_args()
    phase_device()  # TF32 off for --f32
    dtype = torch.float32 if args.f32 else torch.bfloat16
    lib = _build.load()
    if args.f32:
        print(json.dumps({"f32_body": lib.fused_gn_silu_conv3x3_f32_body().decode()}), flush=True)
    else:
        print(json.dumps({"bf16_body": lib.fused_gn_silu_conv3x3_bf16_body().decode()}),
              flush=True)
    for rec in profile(args.batch, args.reps, dtype):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
