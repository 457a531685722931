#!/usr/bin/env python3
"""K7, the W8A8 conv3x3 with in-kernel quantize, against the composed int8
convolution and cuDNN's bf16 convolution, on one GPU.

    python3 scripts/profile_quant_conv_torch.py [--batch 16] [--reps 10]

The PyTorch port of scripts/profile_quant_conv.py, at its shapes: per
(H, W, C, Co) at batch --batch, bf16 activations x, a random OIHW weight
quantized on x's absmax statistics (symmetric, margin 1.0), bias zero. Each
of three functions is timed with CUDA events (one warm-up, then the mean of
--reps calls):

  k7_ms             quant_conv.quantized_conv3x3 (the kernel)
  qconv_apply_ms    quant.qconv_apply (quantize pass, int8 im2col,
                    torch._int_mm, f32 epilogue: the int8 pipeline's path and
                    K7's plain version)
  cudnn_bf16_ms     F.conv2d in bf16 on the same x (the full-precision
                    convolution K7 would replace; a yardstick, not the same
                    function)

and printed as one JSON line per shape with TFLOP/s (2*9*H*W*C*Co*batch
operations over each time), after chip_smoke's device lines (the card's
name and power limit). Exits 1 without a CUDA device.
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
from genpercept_tpu_torch.ops import quant as tq  # noqa: E402
from genpercept_tpu_torch.ops.quant_conv import quantized_conv3x3  # noqa: E402

SHAPES = [  # (H, W, C, Co): scripts/profile_quant_conv.py's
    (768, 768, 128, 128),
    (384, 384, 256, 256),
    (192, 192, 512, 512),
    (96, 96, 512, 512),
    (96, 96, 320, 320),  # UNet level-0 resnet
]


def profile(batch: int = 16, reps: int = 10, seed: int = 0) -> list:
    """One record per shape; every K7 call here goes through the wrapper's
    launch counter."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    records = []
    for h, w, c, co in SHAPES:
        x = torch.randn(batch, c, h, w, device="cuda", generator=gen).to(torch.bfloat16)
        wf = torch.randn(co, c, 3, 3, device="cuda", generator=gen) * 0.05
        q = tq.quantize_conv(wf, torch.zeros(co, device="cuda"),
                             tq.absmax_per_channel(x.movedim(1, -1)), margin=1.0)
        wb = wf.to(torch.bfloat16)
        times = {
            "k7_ms": cuda_ms(lambda: quantized_conv3x3(x, q.w_int8, q.inv_a, q.o_scale,
                                                       q.bias), reps),
            "qconv_apply_ms": cuda_ms(lambda: tq.qconv_apply(q, x), reps),
            "cudnn_bf16_ms": cuda_ms(lambda: F.conv2d(x, wb, padding=1), reps),
        }
        ops = 2.0 * 9 * batch * h * w * c * co
        rec = {"shape": [batch, h, w, c, co], **times}
        rec.update({k.replace("_ms", "_tflops"): ops / (v * 1e-3) / 1e12
                    for k, v in times.items()})
        records.append(rec)
        del x, q, wf, wb
        torch.cuda.empty_cache()
    return records


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    phase_device()
    for rec in profile(args.batch, args.reps):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
