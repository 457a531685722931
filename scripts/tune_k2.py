#!/usr/bin/env python3
"""Variants of K2's f32 or bf16 body, timed beside the shipped one, the
composition in the same dtype and the bound.

    python3 scripts/tune_k2.py [--dtype f32|bf16] [--shapes c320|wide] [--tile ...]
                               [--ctas ...] [--split onepass] [--share N]
                               [--variant onebuf regs40]
                               [--baseline NAME=OLD/fused_geglu_ff_fwd.cu ...]
                               [--rows N ...]

Each variant is csrc/fused_geglu_ff_fwd.cu (with csrc/common.cuh) compiled
by nvcc into a library of its own (scripts/kernel_variants.py), after one
edit to a copy:

  f32 (--dtype f32, the default):
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

  bf16 (--dtype bf16), the wgmma body:
  --tile NWG,NB1,NB2  the instantiation (GP_K2_BF16) with 64 * NWG rows a
                   CTA (NWG consumer warpgroups, 1 or 2), NB1 slots of W1
                   chunks and NB2 of W2 chunks in the TMA rings (x and the
                   rings within a CTA's 227 KB of shared memory)
  --ctas blocks    wg_grid returning one CTA a row block (waves, no split
                   block)
  --share N        the walk's least units a CTA (kWgMinShare)
  --variant onebuf one register buffer for a: each stage's down-product is
                   issued before its up-product and both retire before GEGLU,
                   which then overlaps only the other warpgroup's products
  --variant regs40 setmaxnreg leaves the producer warpgroup 40 registers and
                   gives the consumers 232 (24 and 240 shipped)
                   (names joined by + take both edits: onebuf+regs40)

  --baseline NAME=FILE  another fused_geglu_ff_fwd.cu (an earlier commit's,
                   with its own common.cuh beside it) as the variant NAME

  --shapes wide    the bf16 body at C = 640 and 1280 (the UNet's level-1 and
                   level-2 widths, inner = 4 C) instead of C = 320, at
                   chip_smoke.py's K2_WIDE shapes and the batch of 8 at level
                   1, (8, 2304, 640); --rows, --tile, --ctas and --share do
                   not apply; --variant takes rb1 (C = 640: one 64-row
                   block a cluster, no weight load shared by multicast), rb2
                   (C = 1280: two row blocks of two CTAs a cluster sharing
                   each weight load) and the wide body's probes: noexch (C = 1280: no partials exchanged, each CTA's a from
                   its half of the depth: wrong results), nogeglu (a = h,
                   no erf: wrong results) and noup (no up-product: wrong
                   results) and rings (the
                   rings and the stages' waits alone: wrong results), which
                   time what each part adds

At C = 320, inner = 1280 and the rows given (default: the card tests'
ragged 96 and 1000, one 768^2 image's 9216, the pipeline's batch of 2,
18432, and the training recipe's 38400), or at the wide shapes, with
chip_smoke.py's K2 inputs, every library runs in turns (all variants in
order, then in reverse; CUDA events, mean of 10 calls after a warm-up), and
one JSON line per shape gives the composition's ms in the dtype
(ops.fused_ff._geglu_ff_composition, TF32 off), the bound (split-TF32 rate
in f32, bf16 rate in bf16) and, per library, both times and the error
against the plain version (_fused_geglu_ff_ref): max abs error over
max|plain| (rel_err) and, in bf16, the max and mean abs errors
(max_abs_err, mean_rel_err: mean over max|plain|) and whether two calls
gave the same bits (repeats); a line before them gives the registers, spill
bytes and ptxas advisories of each library's kernels of the dtype and
widths. Needs the card and nvcc.
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
WIDE = [(2, 2304, 640), (8, 2304, 640), (2, 576, 1280), (8, 576, 1280)]  # (b, s, C)
SHIPPED_TILE = re.compile(r"launch_f32<320, (\d+), (\d+)>")
SHIPPED_KT = re.compile(r"constexpr int kF32KT = \d+;")
CTAS_BODY = re.compile(r"(int f32_ctas\(int blocks, int chunks\) \{\n).*?(\n\}\n)", re.S)
CTAS = {"blocks": "  return blocks;", "halves": "  return chunks % 2 == 0 ? 2 * blocks : blocks;"}
SHIPPED_BF16 = re.compile(r"#define GP_K2_BF16 320, (\d+), (\d+), (\d+)")
WG_GRID_BODY = re.compile(r"(int wg_grid\(int blocks, int units\) \{\n).*?(\n\}\n)", re.S)
WG_CTAS = {"blocks": "  return blocks;"}
SHIPPED_SHARE = re.compile(r"constexpr int kWgMinShare = \d+;")
# --variant onebuf: the stage's products and GEGLU in sequence, a in af[0] only
ONEBUF = [
    ("""    issue_up(s1);
    wgmma_commit();
    issue_down(s2, af[1 - P]);
    wgmma_commit();
    wgmma_wait<1>();  // the up-product retired; the down-product in flight
    reg_fence(hg);
    mbar_arrive(w1_empty + s1);
    geglu(c, af[P]);
    wgmma_wait<0>();
    fence_out();
    reg_fence(af[1 - P]);
    mbar_arrive(w2_empty + s2);
""", """    issue_down(s2, af[0]);
    issue_up(s1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(hg);
    fence_out();
    reg_fence(af[0]);
    mbar_arrive(w1_empty + s1);
    mbar_arrive(w2_empty + s2);
    geglu(c, af[0]);
"""),
    ("    reg_fence(af[1 - P]);\n    wgmma_fence();", "    reg_fence(af[0]);\n    wgmma_fence();"),
    ("issue_down(s2, af[1]);", "issue_down(s2, af[0]);"),
    ("      reg_fence(af[1]);", "      reg_fence(af[0]);"),
]
BF16_VARIANTS = {
    "onebuf": ONEBUF,
    # the producer warpgroup keeps 40 registers, the consumers take 232
    "regs40": [("static constexpr int PRODUCER_REGS = 24;", "static constexpr int PRODUCER_REGS = 40;")],
}
# the wide body's probes (wrong results): what the exchange, GEGLU and the
# up-product each add to its time
WIDE_VARIANTS = {
    "noexch": [("        hg[P][k][0] += v.x, hg[P][k][1] += v.y, hg[P][k][2] += v.z, hg[P][k][3] += v.w;\n",
                "        (void)v;\n"),
               ("      mbar_wait_or_trap(xch_full, qe & 1);\n"
                "      if (ctid == 0) mbar_expect_tx(xch_full, T::XCH);  // armed for the next chunk's\n",
                ""),
               ("        mbar_wait_or_trap(xch_empty, qe & 1);\n"
                "        send_partials(xch, hg[1 - P], xch_full, wide_rank<CL>() ^ 1, (int)opaque(threadIdx.x));\n",
                ""),
               ("      if (qe > 0) mbar_wait_or_trap(xch_empty, (qe - 1) & 1);\n"
                "      send_partials(xch, hg[0], xch_full, wide_rank<CL>() ^ 1, (int)opaque(threadIdx.x));\n",
                ""),
               ("      if (lane == 0) mbar_arrive_cluster(xch_empty, wide_rank<CL>() ^ 1);\n", "")],
    # C = 640: one row block a cluster, no weight load shared (right results)
    "rb1": [("#define GP_K2_WIDE_RB_640 2", "#define GP_K2_WIDE_RB_640 1")],
    # C = 1280: two row blocks of two CTAs a cluster (4 CTAs) sharing each
    # weight load by multicast (right results)
    "rb2": [("#define GP_K2_WIDE_RB_1280 1", "#define GP_K2_WIDE_RB_1280 2")],
    # the rings and the stages' waits alone: no product, no GEGLU
    "rings": [("    if constexpr (UP) {\n      issue_up(j_, hg[1 - P]);\n      wgmma_commit();\n    }\n", ""),
              ("    if constexpr (DOWN) {\n      issue_down((qe - 1) & 1);\n      wgmma_commit();\n"
               "    }\n    geglu(p_, j_, c);\n", "")],
    "nogeglu": [("        av[e] = hr * (0.5f * gr * (1.0f + erf_xla<true>(gr * 0.70710678118654752f)));",
                 "        av[e] = hr + gr;")],
    "noup": [("    if constexpr (UP) {\n      issue_up(j_, hg[1 - P]);\n      wgmma_commit();\n    }\n",
              "")],
}
REPS = 10


def _edit(src: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise SystemExit(f"variant: {old.splitlines()[0].strip()!r} not in the shipped source")
        src = src.replace(old, new)
    return src


def variants(args) -> dict[str, tuple[str, str]]:
    src = (_build.CSRC / "fused_geglu_ff_fwd.cu").read_text()
    hdr = (_build.CSRC / "common.cuh").read_text()
    out = {"shipped": (src, hdr)}
    if getattr(args, "shapes", "c320") == "wide":
        if args.tile or args.ctas or args.share or args.split:
            raise SystemExit("--shapes wide: --tile, --ctas, --share and --split are C = 320's")
        for name in args.variant:
            if name not in WIDE_VARIANTS:
                raise SystemExit(f"--variant {name}: --shapes wide takes {list(WIDE_VARIANTS)}")
            out[name] = (_edit(src, WIDE_VARIANTS[name]), hdr)
    elif args.dtype == "bf16":
        (shipped,) = {m.group(0) for m in SHIPPED_BF16.finditer(src)}
        for tile in args.tile:
            if re.fullmatch(r"[12],\d,\d", tile) is None:
                raise SystemExit(f"--tile {tile}: want NWG,NB1,NB2 (e.g. 2,2,3)")
            out[f"tile_{tile.replace(',', '_')}"] = (
                src.replace(shipped, f"#define GP_K2_BF16 320, {tile.replace(',', ', ')}"), hdr)
        for name in args.ctas:
            if name not in WG_CTAS:
                raise SystemExit(f"--ctas {name}: bf16 takes {list(WG_CTAS)}")
            edited, n = WG_GRID_BODY.subn(lambda mm: mm.group(1) + WG_CTAS[name] + mm.group(2),
                                          src)
            if n != 1:
                raise SystemExit("--ctas: wg_grid not found in the shipped source")
            out[f"ctas_{name}"] = (edited, hdr)
        for share in args.share:
            out[f"share_{share}"] = (
                SHIPPED_SHARE.sub(f"constexpr int kWgMinShare = {share};", src), hdr)
        for name in args.variant:  # "a+b": both edits
            parts = name.split("+")
            if any(v not in BF16_VARIANTS for v in parts):
                raise SystemExit(f"--variant {name}: want names of {list(BF16_VARIANTS)} joined by +")
            out[name] = (_edit(src, [e for v in parts for e in BF16_VARIANTS[v]]), hdr)
    else:
        f32_variants(args, src, hdr, out)
    for spec in args.baseline:
        name, _, path = spec.partition("=")
        base = Path(path)
        out[name] = (base.read_text(), (base.parent / "common.cuh").read_text())
    return out


def f32_variants(args, src: str, hdr: str, out: dict) -> None:
    """The f32 body's variants into out."""
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
        if name not in CTAS:
            raise SystemExit(f"--ctas {name}: f32 takes {list(CTAS)}")
        edited, n = CTAS_BODY.subn(lambda mm: mm.group(1) + CTAS[name] + mm.group(2), src)
        if n != 1:
            raise SystemExit("--ctas: f32_ctas not found in the shipped source")
        out[f"ctas_{name}"] = (edited, hdr)
    for name in args.split:
        assert SHIPPED_SPLIT in hdr and SMALL_PASSES in hdr, "split_tf32 or mma_3xtf32 changed"
        out[name] = (src, hdr.replace(SHIPPED_SPLIT, SPLITS[name]).replace(SMALL_PASSES, ""))


def inputs(gen: torch.Generator, rows: int, dt: torch.dtype, c: int = C):
    """chip_smoke.phase_k2's draws: x ~ N(0, 1), weights uniform in +-1/sqrt(fan in),
    biases 0.1 N(0, 1); x and the weights in dt; inner = 4 c."""
    inner = 4 * c
    w1 = (torch.rand(2 * inner, c, device="cuda", generator=gen) * 2 - 1) / c ** 0.5
    b1 = torch.randn(2 * inner, device="cuda", generator=gen) * 0.1
    w2 = (torch.rand(c, inner, device="cuda", generator=gen) * 2 - 1) / inner ** 0.5
    b2 = torch.randn(c, device="cuda", generator=gen) * 0.1
    x = torch.randn(rows, c, device="cuda", generator=gen)
    return x.to(dt), w1.to(dt), b1, w2.to(dt), b2


def bind(lib) -> bool:
    """Set fused_geglu_ff_fwd's argument types; True if it takes a scratch
    pointer (sources from the bf16 wgmma body on), False for older ones."""
    p, i = ctypes.c_void_p, ctypes.c_int
    scratch = hasattr(lib, "fused_geglu_ff_scratch_bytes")
    lib.fused_geglu_ff_fwd.argtypes = [p] * (7 if scratch else 6) + [i] * 4 + [p]
    lib.fused_geglu_ff_fwd.restype = i
    if scratch:
        lib.fused_geglu_ff_scratch_bytes.argtypes = [i] * 4
        lib.fused_geglu_ff_scratch_bytes.restype = ctypes.c_longlong
    return scratch


def kernels_of(dtype: str, name: str, wide: bool = False) -> bool:
    """Whether a kernel's mangled name is one of the dtype's C = 320 bodies,
    or (wide) the bf16 body at C = 640 and 1280."""
    if "fused_geglu_ff" not in name:
        return False
    if wide or "wide" in name:
        return wide and "wide" in name
    return "f32" in name if dtype == "f32" else "f32" not in name


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--shapes", default="c320", choices=["c320", "wide"])
    ap.add_argument("--tile", nargs="*", default=[])
    ap.add_argument("--ctas", nargs="*", default=[])
    ap.add_argument("--split", nargs="*", default=[], choices=["onepass"])
    ap.add_argument("--share", nargs="*", type=int, default=[])
    ap.add_argument("--variant", nargs="*", default=[])
    ap.add_argument("--baseline", nargs="*", default=[])
    ap.add_argument("--rows", nargs="*", type=int, default=ROWS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_k2: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    wide = args.shapes == "wide"
    if wide and args.dtype != "bf16":
        raise SystemExit("--shapes wide: the body at C = 640 and 1280 is bf16 only")
    bf16 = args.dtype == "bf16"
    dt, code = (torch.bfloat16, 1) if bf16 else (torch.float32, 0)
    print(card(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants("fused_geglu_ff_fwd.cu", variants(args), Path(tmp))
        takes_scratch = {n: bind(lib) for n, (lib, _) in libs.items()}
        print(json.dumps({"ptxas": {
            n: {k: r for k, r in regs.items() if kernels_of(args.dtype, k, wide)}
            for n, (_, regs) in libs.items()}}), flush=True)
        gen = torch.Generator(device="cuda").manual_seed(0)
        stream = torch.cuda.current_stream().cuda_stream
        shapes = [(b * s, c) for b, s, c in WIDE] if wide else [(rows, C) for rows in args.rows]
        for rows, c in shapes:
            inner = 4 * c
            x, w1, b1, w2, b2 = inputs(gen, rows, dt, c)
            ref = ff._fused_geglu_ff_ref(x, w1, b1, w2, b2).float()
            top = ref.abs().max().item()
            rec = {"rows": rows, "c": c,
                   "composition_ms": cuda_ms(
                       lambda: ff._geglu_ff_composition(x, w1, b1, w2, b2), REPS),
                   "bound_ms": 6.0 * rows * c * inner / PEAK["bf16" if bf16 else "tf32x3"] * 1e3}
            for name in list(libs) + list(reversed(libs)):
                lib, _ = libs[name]
                y = torch.empty_like(x)
                lead = [x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                        y.data_ptr()]
                if takes_scratch[name]:
                    nbytes = lib.fused_geglu_ff_scratch_bytes(rows, c, inner, code)
                    scratch = torch.empty(nbytes // 4, device="cuda") if nbytes else None
                    lead.append(None if scratch is None else scratch.data_ptr())

                def call():
                    _build.check(lib.fused_geglu_ff_fwd(*lead, rows, c, inner, code, stream), name)

                call()
                first = y.clone()
                ms = cuda_ms(call, REPS)
                r = rec.setdefault(name, {"ms": []})
                r["ms"].append(ms)
                err = (y.float() - ref).abs()
                r["rel_err"] = err.max().item() / top
                r["repeats"] = torch.equal(first, y)
                if bf16:
                    r["max_abs_err"] = err.max().item()
                    r["mean_rel_err"] = err.mean().item() / top
            print(json.dumps(rec), flush=True)
            del x, ref
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
