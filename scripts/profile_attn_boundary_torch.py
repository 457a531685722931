#!/usr/bin/env python3
"""The VAE mid attention (one head, d=512, 9216 tokens), the UNet's
spatial-transformer boundary, and the attention variants around them, on one
GPU.

    python3 scripts/profile_attn_boundary_torch.py [--batch 16] [--reps 10] [--part X]

The PyTorch port of scripts/profile_attn_boundary.py: the same parts, shapes,
op names and TFLOP/s formulas, bf16, the port's modules with seeded random
weights (the JAX init scheme). Parts:

  vae             vae_attention at 96^2 @ 512 (GroupNorm, projections, K1)
  flash512        K1 alone (flash_attention._flash_bhsd) at (b, 9216, 512)
  stransformer    spatial_transformer at 96@320 (5 heads), 48@640 (10)
  sweep512        S3 flash_attention.flash_d512_blocks at (b, 9216, 512) over
                  the CTA tiles D512_TILES of K1's d=512 wgmma body, the row
                  sum folded into PV or not
  gn              GroupNorm + SiLU at 768@128, 384@256, 192@512, 96@512, with
                  the effective GB/s (two reads and one write of x) and the
                  floor at the card's HBM rate
  nomax           S4 flash_attention.flash_nomax at (5b, 9216, 64) over
                  D64_TILES of K1's d=64 wgmma body
  resblock_chain  a VAE resnet_block with its output fed back as the next
                  input, at 768@128, 384@256, 192@512, with the conv floor
                  at the bf16 tensor peak and the GroupNorm floor at HBM rate
  xattn           cross-attention over 77 text tokens at (9216, 5 heads) and
                  (2304, 10): the plain softmax ("xla") and
                  dot_product_attention ("flash", which routes to the same
                  plain softmax: 77 keys take no flash kernel, as in JAX)
  dense           x @ w at (9216, 320), (2304, 640), (9216, 512)
  all             vae, flash512, stransformer, dense

Like the JAX script, the attention of sweep512 and nomax is that of
(x, x, x). The TPU script swept VMEM blocks of 256-1024 query rows; the port
sweeps its CUDA tiles, named by them (d512_64x64_foldTrue is 64 query rows
by 64 keys per step, the row sum folded). Timing: CUDA events around --reps
calls after one warm-up (chip_smoke's cuda_ms); the JAX script's loop-carry
tricks (marginal_time, marginal_time_chain) defeat XLA's loop-invariant
hoisting on the TPU, which eager CUDA does not do, except that
resblock_chain keeps feeding each output back, as the JAX part measures.
One JSON line per op after chip_smoke's device lines; a configuration a
kernel refuses prints {"op", "error"}. Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import HBM_BYTES_PER_S, PEAK, cuda_ms, phase_device  # noqa: E402
from genpercept_tpu_torch.models import layers as L  # noqa: E402
from genpercept_tpu_torch.ops import dot_product_attention, group_norm  # noqa: E402
from genpercept_tpu_torch.ops import flash_attention as fa  # noqa: E402
from genpercept_tpu_torch.ops.attention import _math_attention  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from profile_unet_torch import _Run  # noqa: E402


def _vae(r: _Run) -> None:
    x = r.randn(r.b, 512, 96, 96)
    p = r.module(L.VAEAttention(512))
    r.time("vae_attention_96@512", lambda: L.vae_attention(p, x),
           4 * r.b * 9216 * 9216 * 512 + 4 * 2 * r.b * 9216 * 512 * 512)


def _flash512(r: _Run) -> None:
    x = r.randn(r.b, 9216, 512)
    r.time("flash_bare_s9216_d512", lambda: fa._flash_bhsd(x, x, x, 512 ** -0.5)[0],
           4 * r.b * 9216 * 9216 * 512)


def _stransformer(r: _Run) -> None:
    for hw, c, heads in ((96, 320, 5), (48, 640, 10)):
        x = r.randn(r.b, c, hw, hw)
        ctx = r.randn(r.b, 77, 1024)
        p = r.module(L.SpatialTransformer(c, 1024))
        s = hw * hw
        fl = (4 * r.b * s * s * heads * 64 + 8 * r.b * s * c * c
              + 2 * r.b * s * c * (8 * c) + 2 * r.b * s * (4 * c) * c
              + 4 * r.b * 77 * c * 1024 + 4 * r.b * s * 77 * c
              + 2 * 2 * r.b * s * c * c)
        r.time(f"spatial_transformer_{hw}@{c}", lambda: L.spatial_transformer(p, x, ctx, heads),
               fl)


def _sweep512(r: _Run) -> None:
    x = r.randn(r.b, 9216, 512)
    for bq, bk in fa.D512_TILES:
        for fold in (True, False):
            r.time(f"d512_{bq}x{bk}_fold{fold}",
                   lambda: fa.flash_d512_blocks(x, x, x, 512 ** -0.5, bq, bk, fold),
                   4 * r.b * 9216 * 9216 * 512, guard=True)


def _gn(r: _Run) -> None:
    for hw, c in ((768, 128), (384, 256), (192, 512), (96, 512)):
        x = r.randn(r.b, c, hw, hw)
        w = torch.randn(c, device="cuda", generator=r.gen).abs()
        b = torch.randn(c, device="cuda", generator=r.gen)
        r.time(f"gn_silu_{hw}@{c}", lambda: F.silu(group_norm(x, w, b, 32, 1e-6)))
        nbytes = 3 * r.b * hw * hw * c * 2  # bf16: two reads (stats, apply), one write
        rec = r.records[-1]
        rec["gbps_eff"] = nbytes / 1e9 / (rec["ms"] * 1e-3)
        rec["floor_ms_hbm"] = nbytes / HBM_BYTES_PER_S * 1e3


def _nomax(r: _Run) -> None:
    s, heads, d = 9216, 5, 64
    x = r.randn(r.b * heads, s, d)
    for bq, bk in fa.D64_TILES:
        r.time(f"nomax_{bq}x{bk}", lambda: fa.flash_nomax(x, x, x, d ** -0.5, bq, bk),
               4 * r.b * heads * s * s * d, guard=True)


def _resblock_chain(r: _Run) -> None:
    for hw, c in ((768, 128), (384, 256), (192, 512)):
        state = [r.randn(r.b, c, hw, hw)]
        p = r.module(L.ResnetBlock(c, c, None))

        def step():
            state[0] = L.resnet_block(p, state[0], None, eps=1e-6)

        r.time(f"vae_resblock_chain_{hw}@{c}", step)
        fl = 2 * 2 * 9 * r.b * hw * hw * c * c
        r.records[-1].update({
            "conv_floor_ms": fl / PEAK["bf16"] * 1e3,
            "gn_floor_ms": 2 * 3 * r.b * hw * hw * c * 2 / HBM_BYTES_PER_S * 1e3})


def _xattn(r: _Run) -> None:
    for s, heads in ((9216, 5), (2304, 10)):
        q = r.randn(r.b, s, heads, 64)
        k, v = r.randn(r.b, 77, heads, 64), r.randn(r.b, 77, heads, 64)
        for name, fn in (("xla", lambda: _math_attention(q, k, v, 64 ** -0.5)),
                         ("flash", lambda: dot_product_attention(q, k, v))):
            r.time(f"xattn_{name}_s{s}", fn)


def _dense(r: _Run) -> None:
    for s, c in ((9216, 320), (2304, 640), (9216, 512)):
        x = r.randn(r.b, s, c)
        w = r.randn(c, c) * 0.03
        r.time(f"dense_s{s}_c{c}", lambda: torch.matmul(x, w), 2 * r.b * s * c * c)


PARTS = {"vae": _vae, "flash512": _flash512, "stransformer": _stransformer,
         "sweep512": _sweep512, "gn": _gn, "nomax": _nomax,
         "resblock_chain": _resblock_chain, "xattn": _xattn, "dense": _dense}
ALL = ("vae", "flash512", "stransformer", "dense")


def profile(part: str, batch: int = 16, reps: int = 10, seed: int = 0) -> list[dict]:
    """The records of one part ("all": the JAX script's set), each op timed
    on the card. Every kernel call goes through its wrapper's counter."""
    run = _Run(batch, reps, seed)
    with torch.no_grad():
        for name in (ALL if part == "all" else (part,)):
            PARTS[name](run)
            torch.cuda.empty_cache()
    return run.records


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--part", default="all", choices=("all", *PARTS))
    args = ap.parse_args()
    phase_device()
    for rec in profile(args.part, args.batch, args.reps):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
