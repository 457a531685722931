#!/usr/bin/env python3
"""Variants of K1's f32 body (split TF32), timed beside the shipped one and SDPA.

    python3 scripts/tune_k1_f32.py [--split cvt onepass] [--tile 64:4,1,64,4 ...]

Each variant is csrc/flash_attn_fwd.cu (with csrc/common.cuh) compiled by
nvcc into a library of its own, after one edit to a copy:

  --split cvt      hi and lo by cvt.rna.tf32.f32 (the PTX rounding
                   instruction, both rounded to nearest, ties away)
  --split onepass  hi only, one tf32 mma per product: not f32-accurate (its
                   error is printed); the time the split and the two extra
                   passes add to the shipped body
  --tile D:P,S,K,N the f32 instantiation at head dim D with P row parts, S
                   slices of d, K keys a tile and N ring buffers (the
                   template arguments of launch_f32)

At the main path's f32 K1 shapes and the training recipe's (chip_smoke.py
K1_SHAPES, K1_RECIPE), every library runs in turns (all variants in order,
then in reverse; CUDA events, mean of 10 calls after a warm-up), and one JSON
line per shape gives SDPA's ms and, per library, both times, the max abs
error of out and lse2 against the plain version, and the registers and spill
bytes ptxas reports for the f32 kernel of that head dim. Needs the card and
nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import cuda_ms  # noqa: E402
from genpercept_tpu_torch import _build  # noqa: E402
from genpercept_tpu_torch.ops import flash_attention as fa  # noqa: E402
from kernel_variants import build_variants, card  # noqa: E402

SHAPES = [(5, 9216, 64), (10, 2304, 64), (20, 576, 64), (1, 9216, 512),
          (40, 4800, 64), (8, 4800, 512)]
SHIPPED_SPLIT = """  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xFFFFE000u;"""
SPLITS = {
    "cvt": """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));""",
    "onepass": """  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = 0u;""",
}
# onepass also drops the two small-term passes of mma_3xtf32
SMALL_PASSES = ("  for (int n = 0; n < N; ++n) mma_tf32(c[n], al, bh[n][0], bh[n][1]);\n"
                "#pragma unroll\n"
                "  for (int n = 0; n < N; ++n) mma_tf32(c[n], ah, bl[n][0], bl[n][1]);\n"
                "#pragma unroll\n")
SHIPPED_TILE = re.compile(r"launch_f32<(\d+), (\d+), (\d+), (\d+), (\d+)>")
REPS = 10


def variants(args) -> dict[str, tuple[str, str]]:
    src = (_build.CSRC / "flash_attn_fwd.cu").read_text()
    hdr = (_build.CSRC / "common.cuh").read_text()
    assert SHIPPED_SPLIT in hdr and SMALL_PASSES in hdr, "split_tf32 or mma_3xtf32 changed"
    shipped = {int(m.group(1)): m.group(0) for m in SHIPPED_TILE.finditer(src)}
    out = {"shipped": (src, hdr)}
    for name in args.split:
        h = hdr.replace(SHIPPED_SPLIT, SPLITS[name])
        out[name] = (src, h.replace(SMALL_PASSES, "") if name == "onepass" else h)
    for tile in args.tile:
        d, cfg = tile.split(":")
        out[f"tile_{d}_{cfg.replace(',', '_')}"] = (
            src.replace(shipped[int(d)], f"launch_f32<{d}, {cfg.replace(',', ', ')}>"), hdr)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--split", nargs="*", default=list(SPLITS), choices=list(SPLITS))
    ap.add_argument("--tile", nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_k1_f32: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants("flash_attn_fwd.cu", variants(args), Path(tmp))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for lib, _ in libs.values():
            lib.flash_attn_fwd.argtypes = [p, p, p, p, p, i, i, i, i, f, i, p]
            lib.flash_attn_fwd.restype = i
        gen = torch.Generator(device="cuda").manual_seed(0)
        stream = torch.cuda.current_stream().cuda_stream
        for bh, s, d in SHAPES:
            q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen) for _ in range(3))
            scale = d ** -0.5
            ref, ref_lse = fa._flash_bhsd_ref(q, k, v, scale)
            rec = {"shape": [bh, s, d],
                   "sdpa_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                       q[None], k[None], v[None])[0], REPS)}
            for name in list(libs) + list(reversed(libs)):
                lib, regs = libs[name]
                out = torch.empty_like(q)
                lse = torch.empty(bh, s, 1, device="cuda")

                def call():
                    err = lib.flash_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                             out.data_ptr(), lse.data_ptr(), bh, s, s, d,
                                             ctypes.c_float(scale), 0, stream)
                    _build.check(err, name)

                ms = cuda_ms(call, REPS)
                mangled = f"flash_attn_fwd_f32_kernelILi{d}E"
                ptxas = [res for kern, res in regs.items() if mangled in kern]
                r = rec.setdefault(name, {"ms": [], "ptxas": ptxas})
                r["ms"].append(ms)
                r["err"] = [(out - ref).abs().max().item(), (lse - ref_lse).abs().max().item()]
            print(json.dumps(rec), flush=True)
            del q, k, v, ref, ref_lse
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
