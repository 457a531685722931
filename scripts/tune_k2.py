#!/usr/bin/env python3
"""Variants of K2's f32 body, timed beside the shipped one, the f32
composition and the bound.

    python3 scripts/tune_k2.py [--tile MT,NBUF[,KT] ...] [--ctas blocks halves]
                               [--split onepass]
                               [--baseline NAME=OLD/fused_geglu_ff_fwd.cu ...]
                               [--rows N ...]

Each variant is csrc/fused_geglu_ff_fwd.cu (with csrc/common.cuh) compiled
by nvcc into a library of its own (scripts/kernel_variants.py), after one
edit to a copy:

  --tile MT,NBUF[,KT]  the f32 instantiation with 32 * MT rows a CTA and
                   NBUF slots in the weight ring (the template arguments of
                   launch_f32 after C), and KT columns of C a W1 tile
                   (kF32KT; a divisor of 320 and a multiple of 8)
  --ctas blocks    f32_ctas returning one CTA a row block (a grid of waves,
                   each CTA over the whole inner dimension)
  --ctas halves    f32_ctas returning two CTAs a row block, each over half
                   of the inner dimension (waves of half the work)
  --split onepass  hi only, one tf32 mma per product: not f32-accurate (its
                   error is printed); the time the split and the two extra
                   passes add to the shipped body
  --baseline NAME=FILE  another fused_geglu_ff_fwd.cu (an earlier commit's,
                   with its own common.cuh beside it) as the variant NAME

At C = 320, inner = 1280 and the rows given (default: the card tests'
ragged 96 and 1000, one 768^2 image's 9216, the pipeline's batch of 2,
18432, and the training recipe's 38400), with chip_smoke.py's K2 inputs,
every library runs in turns (all variants in order, then in reverse; CUDA
events, mean of 10 calls after a warm-up), and one JSON line per shape
gives the f32 composition's ms (ops.fused_ff._geglu_ff_composition, TF32
off), the bound at the split-TF32 rate and, per library, both times and the
max abs error over max|plain| (plain: the exact-f32 _fused_geglu_ff_ref); a
line before them gives the registers, spill bytes and ptxas advisories of
each library's f32 kernels. Needs the card and nvcc.
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
from genpercept_tpu_torch.ops import fused_ff as ff  # noqa: E402
from kernel_variants import build_variants, card  # noqa: E402
from tune_k1 import SHIPPED_SPLIT, SMALL_PASSES, SPLITS  # noqa: E402

C, INNER = 320, 1280
ROWS = [96, 1000, 9216, 18432, 38400]
SHIPPED_TILE = re.compile(r"launch_f32<320, (\d+), (\d+)>")
SHIPPED_KT = re.compile(r"constexpr int kF32KT = \d+;")
CTAS_BODY = re.compile(r"(int f32_ctas\(int blocks, int chunks\) \{\n).*?(\n\}\n)", re.S)
CTAS = {"blocks": "  return blocks;", "halves": "  return chunks % 2 == 0 ? 2 * blocks : blocks;"}
REPS = 10


def variants(args) -> dict[str, tuple[str, str]]:
    src = (_build.CSRC / "fused_geglu_ff_fwd.cu").read_text()
    hdr = (_build.CSRC / "common.cuh").read_text()
    out = {"shipped": (src, hdr)}
    (shipped,) = {m.group(0) for m in SHIPPED_TILE.finditer(src)}
    for tile in args.tile:
        m = re.fullmatch(r"(\d,\d)(?:,(\d+))?", tile)
        if m is None:
            raise SystemExit(f"--tile {tile}: want MT,NBUF[,KT] (e.g. 2,3,64)")
        edited = src.replace(shipped, f"launch_f32<320, {m.group(1).replace(',', ', ')}>")
        if m.group(2):
            edited = SHIPPED_KT.sub(f"constexpr int kF32KT = {m.group(2)};", edited)
        out[f"tile_{tile.replace(',', '_')}"] = (edited, hdr)
    for name in args.ctas:
        edited, n = CTAS_BODY.subn(lambda mm: mm.group(1) + CTAS[name] + mm.group(2), src)
        if n != 1:
            raise SystemExit("--ctas: f32_ctas not found in the shipped source")
        out[f"ctas_{name}"] = (edited, hdr)
    for name in args.split:
        assert SHIPPED_SPLIT in hdr and SMALL_PASSES in hdr, "split_tf32 or mma_3xtf32 changed"
        out[name] = (src, hdr.replace(SHIPPED_SPLIT, SPLITS[name]).replace(SMALL_PASSES, ""))
    for spec in args.baseline:
        name, _, path = spec.partition("=")
        base = Path(path)
        out[name] = (base.read_text(), (base.parent / "common.cuh").read_text())
    return out


def inputs(gen: torch.Generator, rows: int):
    """chip_smoke.phase_k2's draws: x ~ N(0, 1), weights uniform in +-1/sqrt(fan in),
    biases 0.1 N(0, 1)."""
    w1 = (torch.rand(2 * INNER, C, device="cuda", generator=gen) * 2 - 1) / C ** 0.5
    b1 = torch.randn(2 * INNER, device="cuda", generator=gen) * 0.1
    w2 = (torch.rand(C, INNER, device="cuda", generator=gen) * 2 - 1) / INNER ** 0.5
    b2 = torch.randn(C, device="cuda", generator=gen) * 0.1
    x = torch.randn(rows, C, device="cuda", generator=gen)
    return x, w1, b1, w2, b2


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tile", nargs="*", default=[])
    ap.add_argument("--ctas", nargs="*", default=[], choices=list(CTAS))
    ap.add_argument("--split", nargs="*", default=[], choices=["onepass"])
    ap.add_argument("--baseline", nargs="*", default=[])
    ap.add_argument("--rows", nargs="*", type=int, default=ROWS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_k2: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants("fused_geglu_ff_fwd.cu", variants(args), Path(tmp))
        p, i = ctypes.c_void_p, ctypes.c_int
        for lib, _ in libs.values():
            lib.fused_geglu_ff_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
            lib.fused_geglu_ff_fwd.restype = i
        print(json.dumps({"ptxas": {n: {k: r for k, r in regs.items()
                                        if "fused_geglu_ff" in k and "mma" not in k
                                        and "wide" not in k}
                                    for n, (_, regs) in libs.items()}}), flush=True)
        gen = torch.Generator(device="cuda").manual_seed(0)
        stream = torch.cuda.current_stream().cuda_stream
        for rows in args.rows:
            x, w1, b1, w2, b2 = inputs(gen, rows)
            ref = ff._fused_geglu_ff_ref(x, w1, b1, w2, b2)
            top = ref.abs().max().item()
            rec = {"rows": rows,
                   "composition_ms": cuda_ms(
                       lambda: ff._geglu_ff_composition(x, w1, b1, w2, b2), REPS),
                   "bound_ms": 6.0 * rows * C * INNER / PEAK["tf32x3"] * 1e3}
            for name in list(libs) + list(reversed(libs)):
                lib, _ = libs[name]
                y = torch.empty_like(x)

                def call():
                    _build.check(lib.fused_geglu_ff_fwd(
                        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                        b2.data_ptr(), y.data_ptr(), rows, C, INNER, 0, stream), name)

                ms = cuda_ms(call, REPS)
                r = rec.setdefault(name, {"ms": []})
                r["ms"].append(ms)
                r["rel_err"] = (y - ref).abs().max().item() / top
            print(json.dumps(rec), flush=True)
            del x, ref
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
