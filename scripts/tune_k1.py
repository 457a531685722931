#!/usr/bin/env python3
"""Variants of K1's bodies, timed beside the shipped one, SDPA and the bound.

    python3 scripts/tune_k1.py [--dtype f32|bf16] [--split cvt onepass]
                               [--tile 64:4,1,64,4 ... | --tile 2,128,3 512:128,8 ...]
                               [--baseline NAME=OLD/flash_attn_fwd.cu ...]
                               [--shapes main|short] [--d 64|512] [--check]

Each variant is csrc/flash_attn_fwd.cu (with csrc/common.cuh) compiled by
nvcc into a library of its own (scripts/kernel_variants.py), after one edit
to a copy:

  --split cvt      f32: hi and lo by cvt.rna.tf32.f32 (the PTX rounding
                   instruction, both rounded to nearest, ties away)
  --split onepass  f32: hi only, one tf32 mma per product: not f32-accurate
                   (its error is printed); the time the split and the two
                   extra passes add to the shipped body
  --tile D:P,S,K,N f32: the instantiation at head dim D with P row parts, S
                   slices of d, K keys a tile and N ring buffers (the
                   template arguments of launch_f32)
  --tile W,K,N     bf16: the d=64 body (dispatch_bf16_d64) as one
                   instantiation for every length: W consumer warpgroups of
                   64 q rows, K keys a tile, N ring stages (the arguments of
                   launch_wgmma)
  --tile 512:K,N[,S]  bf16: the d=512 body (dispatch_bf16_d512) as one
                   instantiation for every length: K keys a tile (128, the
                   one tile the body takes), N ring
                   stages of one 64-column atom (the arguments of
                   launch_wgmma_d512); S splits of the key axis at every
                   length (no more than its 128-key tiles) in place of
                   d512_splits' rule
  --baseline NAME=FILE  another flash_attn_fwd.cu (an earlier commit's, with
                   its own common.cuh beside it) as the variant NAME

The f32 shapes are chip_smoke.py's K1 shapes and the training recipe's; the
bf16 ones are the five d=64 shapes of the main paths (768^2 levels 0-2, the
recipe's level 0, and 768^2 at batch 2's level 0) and the four d=512 ones
(the VAE mid block at 768^2 per image and at batch 2, at 576x768, and the
recipe's); --d keeps one head dim's shapes and checks, and --shapes short
the first three of those. Every library runs in turns (all variants in order,
then in reverse; CUDA events, mean of 10 calls after a warm-up), and one
JSON line per shape gives SDPA's ms, the bound at the card's peak for the
dtype (split TF32: a third of TF32's) and, per library, both times and the
max abs error of out and lse2 against the plain version and out's over
max|plain|; a line before them
gives the registers, spill bytes and ptxas advisories of each library's K1
kernels. --check first holds every library to the card tests' bar (1e-4 f32,
2e-2 bf16) at the card tests' ragged shapes of the dtype, errors printed,
and stops at the first library that misses it. Needs the card and nvcc.
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

from chip_smoke import PEAK, cuda_ms  # noqa: E402
from genpercept_tpu_torch import _build  # noqa: E402
from genpercept_tpu_torch.ops import flash_attention as fa  # noqa: E402
from kernel_variants import build_variants, card  # noqa: E402

SHAPES = {"f32": [(5, 9216, 64), (10, 2304, 64), (20, 576, 64), (1, 9216, 512),
                  (40, 4800, 64), (8, 4800, 512)],
          "bf16": [(5, 9216, 64), (10, 2304, 64), (20, 576, 64), (40, 4800, 64),
                   (10, 9216, 64), (1, 9216, 512), (2, 9216, 512), (1, 6912, 512),
                   (8, 4800, 512)]}
# (bh, sq, sk, d): tests/test_torch_cuda.py's shapes with a ragged edge
CHECK = {"f32": [(3, 200, 77, 64), (1, 130, 300, 64), (2, 100, 150, 512), (1, 300, 200, 512),
                 (6, 256, 77, 64), (2, 1000, 1000, 512)],
         "bf16": [(2, 256, 256, 64), (3, 200, 77, 64), (1, 130, 300, 64), (6, 256, 77, 64),
                  (4, 40, 300, 64), (2, 4800, 1000, 64), (2, 100, 150, 512),
                  (1, 300, 200, 512), (2, 1000, 1000, 512), (2, 40, 300, 512),
                  (1, 300, 77, 512), (1, 8500, 1200, 512)]}
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
# the body of a bf16 dispatch (d=64 or d=512), every launch it holds
BF16_DISPATCH = {d: re.compile(rf"(cudaError_t dispatch_bf16_d{d}\([^)]*\) \{{\n).*?(\n\}}\n)",
                               re.S) for d in (64, 512)}
BF16_LAUNCH = {64: "launch_wgmma", 512: "launch_wgmma_d512"}
BF16_ARGS = {64: "q, k, v, out, lse, bh, sq, sk, scale, stream",
             512: "q, k, v, out, lse, scratch, bh, sq, sk, scale, stream"}
D512_SPLITS = re.compile(r"(int d512_splits\(int bh, int sq, int sk\) \{\n).*?(\n\}\n)", re.S)
# K1's kernels by dtype; at bf16 also the mma.sync bodies K1 ran before its
# wgmma ones (d=64: the 4-warp, 64-key instantiation with l summed apart;
# d=512: flash_attn_fwd_split_kernel<512, 32, 64, false>)
KERNEL = {"f32": ("flash_attn_fwd_f32_kernel",),
          "bf16": ("flash_attn_fwd_wgmma_kernel", "flash_attn_fwd_wgmma_d512_kernel",
                   "flash_attn_fwd_mma_kernelILi64ELi4ELi64ELb0E",
                   "flash_attn_fwd_split_kernelILi512ELi32ELi64ELb0E")}
REPS = 10


def bf16_tile(src: str, tile: str) -> str:
    """src with dispatch_bf16_d64 launching launch_wgmma<tile> at every length,
    or, for a tile "512:...", dispatch_bf16_d512 launch_wgmma_d512<...>."""
    d, _, args = tile.rpartition(":")
    d = int(d) if d in ("64", "512") else 64 if d == "" else None
    pattern = {64: r"\d+,\d+,\d+(,(true|false))*", 512: r"128,\d+(,\d)?"}.get(d)
    if pattern is None or re.fullmatch(pattern, args) is None:
        raise SystemExit(f"--tile {tile}: want W,K,N[,...] (d=64, e.g. 2,128,3) "
                         "or 512:128,N[,S] (e.g. 512:128,8,2)")
    if d == 512 and args.count(",") == 2:
        args, splits = args.rsplit(",", 1)
        rule = f"  const int n = (sk + 127) / 128;\n  return n < {splits} ? n : {splits};"
        src, n = D512_SPLITS.subn(lambda mm: mm.group(1) + rule + mm.group(2), src)
        if n != 1:
            raise SystemExit("--tile: d512_splits not found in the shipped source")
    body = f"  return {BF16_LAUNCH[d]}<{args.replace(',', ', ')}>({BF16_ARGS[d]});"
    edited, n = BF16_DISPATCH[d].subn(lambda mm: mm.group(1) + body + mm.group(2), src)
    if n != 1:
        raise SystemExit(f"--tile: dispatch_bf16_d{d} not found in the shipped source")
    return edited


def variants(args) -> dict[str, tuple[str, str]]:
    src = (_build.CSRC / "flash_attn_fwd.cu").read_text()
    hdr = (_build.CSRC / "common.cuh").read_text()
    out = {"shipped": (src, hdr)}
    if args.dtype == "f32":
        assert SHIPPED_SPLIT in hdr and SMALL_PASSES in hdr, "split_tf32 or mma_3xtf32 changed"
        shipped = {int(m.group(1)): m.group(0) for m in SHIPPED_TILE.finditer(src)}
        for name in args.split:
            h = hdr.replace(SHIPPED_SPLIT, SPLITS[name])
            out[name] = (src, h.replace(SMALL_PASSES, "") if name == "onepass" else h)
        for tile in args.tile:
            d, cfg = tile.split(":")
            out[f"tile_{d}_{cfg.replace(',', '_')}"] = (
                src.replace(shipped[int(d)], f"launch_f32<{d}, {cfg.replace(',', ', ')}>"), hdr)
    else:
        if args.split:
            raise SystemExit("--split: f32 only")
        for tile in args.tile:
            out[f"tile_{tile.replace(',', '_').replace(':', '_')}"] = (bf16_tile(src, tile), hdr)
    for spec in args.baseline:
        name, _, path = spec.partition("=")
        base = Path(path)
        out[name] = (base.read_text(), (base.parent / "common.cuh").read_text())
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    ap.add_argument("--split", nargs="*", default=None, choices=list(SPLITS))
    ap.add_argument("--tile", nargs="*", default=[])
    ap.add_argument("--baseline", nargs="*", default=[])
    ap.add_argument("--shapes", choices=("main", "short"), default="main")
    ap.add_argument("--d", type=int, choices=(64, 512), default=None)
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    if args.split is None:  # f32 times both split forms unless told otherwise
        args.split = list(SPLITS) if args.dtype == "f32" else []
    if not torch.cuda.is_available():
        raise SystemExit("tune_k1: needs a CUDA device")
    dt, code = (torch.float32, 0) if args.dtype == "f32" else (torch.bfloat16, 1)
    peak, bar = (PEAK["tf32x3"], 1e-4) if args.dtype == "f32" else (PEAK["bf16"], 2e-2)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants("flash_attn_fwd.cu", variants(args), Path(tmp))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for lib, _ in libs.values():
            # sources before the d=512 key splits take no scratch argument
            scratch = [p] if hasattr(lib, "flash_attn_fwd_scratch_bytes") else []
            lib.flash_attn_fwd.argtypes = [p, p, p, p, p, *scratch, i, i, i, i, f, i, p]
            lib.flash_attn_fwd.restype = i
            if scratch:
                lib.flash_attn_fwd_scratch_bytes.argtypes = [i] * 5
                lib.flash_attn_fwd_scratch_bytes.restype = ctypes.c_longlong
        print(json.dumps({"ptxas": {n: {k: r for k, r in regs.items()
                                        if any(x in k for x in KERNEL[args.dtype])}
                                    for n, (_, regs) in libs.items()}}), flush=True)
        gen = torch.Generator(device="cuda").manual_seed(0)
        stream = torch.cuda.current_stream().cuda_stream

        def runner(lib, name, q, k, v, out, lse):
            bh, sq, d = q.shape
            sk = k.shape[1]
            scratch, buf = [], None
            if hasattr(lib, "flash_attn_fwd_scratch_bytes"):
                nbytes = lib.flash_attn_fwd_scratch_bytes(bh, sq, sk, d, code)
                buf = torch.empty(nbytes, dtype=torch.uint8, device="cuda") if nbytes else None
                scratch = [None if buf is None else buf.data_ptr()]

            def call():
                _build.check(lib.flash_attn_fwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                    *scratch, bh, sq, sk, d, ctypes.c_float(d ** -0.5), code, stream), name)
            call.scratch = buf  # kept alive with the call
            return call

        def errors(q, k, v, out, lse):
            ref, ref_lse = fa._flash_bhsd_ref(q, k, v, q.shape[2] ** -0.5)
            err = (out.float() - ref.float()).abs().max().item()
            return [err, (lse - ref_lse).abs().max().item(),
                    err / ref.float().abs().max().item()]

        if args.check:
            for bh, sq, sk, d in CHECK[args.dtype]:
                if args.d not in (None, d):
                    continue
                q = torch.randn(bh, sq, d, device="cuda", generator=gen).to(dt)
                k, v = (torch.randn(bh, sk, d, device="cuda", generator=gen).to(dt)
                        for _ in range(2))
                rec = {"check": [bh, sq, sk, d]}
                for name, (lib, _) in libs.items():
                    out, lse = torch.empty_like(q), torch.empty(bh, sq, 1, device="cuda")
                    runner(lib, name, q, k, v, out, lse)()
                    torch.cuda.synchronize()
                    rec[name] = errors(q, k, v, out, lse)
                print(json.dumps(rec), flush=True)
                bad = [n for n in libs if not max(rec[n][:2]) <= bar]
                if bad:
                    raise SystemExit(f"tune_k1: {bad} miss the bar {bar} at {(bh, sq, sk, d)}")
        shapes = [x for x in SHAPES[args.dtype] if args.d in (None, x[2])]
        for bh, s, d in shapes[:3 if args.shapes == "short" else None]:
            q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen).to(dt)
                       for _ in range(3))
            rec = {"shape": [bh, s, d],
                   "sdpa_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                       q[None], k[None], v[None])[0], REPS),
                   "bound_ms": 4.0 * bh * s * s * d / peak * 1e3}
            for name in list(libs) + list(reversed(libs)):
                lib, _ = libs[name]
                out, lse = torch.empty_like(q), torch.empty(bh, s, 1, device="cuda")
                ms = cuda_ms(runner(lib, name, q, k, v, out, lse), REPS)
                r = rec.setdefault(name, {"ms": []})
                r["ms"].append(ms)
                r["err"] = errors(q, k, v, out, lse)
            print(json.dumps(rec), flush=True)
            del q, k, v
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
