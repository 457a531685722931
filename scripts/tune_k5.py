#!/usr/bin/env python3
"""Variants of K5's body (the W8A8 GEGLU feed-forward on int8 wgmma), timed
beside the shipped one, an older source, K2's bf16 body at the C=320 shape,
the bf16 composition and the bounds, at the pipeline's two shapes.

    python3 scripts/tune_k5.py [--tile 320:KS,NB1,NB2,CL 640:KS,NB1,NB2,CL ...]
                               [--variant noerf nodown noup noepi noxq noslab noy noout loads ring]
                               [--baseline NAME=OLD/fused_geglu_ff_int8.cu ...]
                               [--dtype bf16 f32]

Each variant is csrc/fused_geglu_ff_int8.cu (with csrc/common.cuh) compiled
by nvcc into a library of its own (scripts/kernel_variants.py), after one
edit to a copy:

  --tile C:KS,NB1,NB2,CL  the instantiation at width C (GP_K5_320 /
                   GP_K5_640): chunks of 32 KS inner columns, NB1 stages of
                   W1 chunks and NB2 of W2 stages (64 inner columns) in the
                   TMA rings, CL CTAs a cluster sharing each weight load by
                   multicast (1: each CTA loads its own)
  --variant noerf nodown noup noepi noxq noslab noy noout loads ring
                   timing probes (wrong results): GEGLU without erf (g times
                   the constant); no down-product; no up-product; no epilogue
                   (aq never written); no quantization of x (the A tile as it
                   stands); no split blocks' slabs and counters; no stores of
                   y; no output (no slab, no y); loads: the rings, the x
                   quantization and the output alone (noup+nodown+noepi);
                   ring: the rings alone (loads+noxq+noout); names joined by
                   + take every edit
  --baseline NAME=FILE  another fused_geglu_ff_int8.cu (an earlier commit's,
                   with its own common.cuh beside it) as the variant NAME; a
                   source without fused_geglu_ff_int8_body (the int8
                   mma.sync body) takes no scratch argument

At chip_smoke.py's K5_SHAPES with chip_smoke.phase_k5's inputs (x + 0.3,
asymmetric calibration), every library runs in turns (all in order, then in
reverse; CUDA events, mean of REPS calls after a warm-up, each call through
the wrapper's steps: the scratch and the launch), and one JSON line per
shape and dtype gives the bound (the function's 6 rows C inner int8
operations at 1,979 TOPS, or its bytes), the epilogue floor (EPILOGUE_OPS
FP32-pipe operations a hidden element at 67 TFLOP/s), K2's bf16 time and
the bf16 composition's at the shape (the bf16 path's feed-forward), and per
library both times, the max abs error against the plain version
(fused_ff._fused_geglu_ff_int8_ref) and whether it is bit for bit equal. A
line before the shapes gives each library's registers, spills and ptxas
advisories of its K5 kernels. Needs the card and nvcc.
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

from chip_smoke import (  # noqa: E402
    HBM_BYTES_PER_S, K5_SHAPES, PEAK, cuda_ms, elt, ff_int8_trees, int8_generator)
from genpercept_tpu_torch import _build  # noqa: E402
from genpercept_tpu_torch.ops import fused_ff as ff  # noqa: E402
from kernel_variants import build_variants, card  # noqa: E402

# FP32-pipe operations of one hidden element's epilogue, reckoned from the
# source (tests/test_torch_fused_ff_int8_wgmma.py counts them): two
# dequantizations (2 each), erf (clamp 2, x^2 1, Horner 8 + 12, x p 1, the
# division 7), GEGLU (4), the scale of g (1), the quantization (sub, mul,
# round, clamp 2: 5)
EPILOGUE_OPS = 47
FP32_OPS_PER_S = 67e12 / 2  # 67 TFLOP/s counts an FMA as two operations

VARIANTS = {
    # timing probes, wrong results
    "noerf": [("  const float e = erf_ops(__fmul_rn(g, 0.70710678118654752f));\n",
               "  const float e = __fmul_rn(g, 0.70710678118654752f);\n")],
    "nodown": [("        wgmma_s8(out[h], da + step + 2 * kk, db + step + h * 160 * 64 / 16 + 2 * kk, "
                "1);\n", "        (void)da, (void)db, (void)step;\n")],
    "noup": [("#pragma unroll\n    for (int kk = 0; kk < C / 32; ++kk)\n"
              "      wgmma_s8(acc, da + step + ((kk / 2) * K::XATOM + 32 * (kk % 2)) / 16,\n"
              "               db + step + ((kk / 2) * 512 + 32 * (kk % 2)) / 16, kk);\n",
              "    (void)da, (void)db, (void)step, (void)acc;\n")],
    "noepi": [("    epilogue(p_);\n", "")],
    "noxq": [("#pragma unroll 1\n      for (int b = 0; b < ITEMS; b += XB) {",
              "#pragma unroll 1\n      for (int b = 0; b < 0; b += XB) {")],
    "noslab": [("    if (parts > 1) {\n      int* arrived", "    if (parts > 1 && rows < 0) {\n      int* arrived")],
    "noy": [("          store2(y + (size_t)row * C + col, dequant(out[h][n][2 * r], sc.x, bb.x),\n"
             "                 dequant(out[h][n][2 * r + 1], sc.y, bb.y));\n",
             "          (void)sc, (void)bb;\n")],
    "noout": [("    // A block in parts: each counts its arrival on the block's first\n",
               "    if (rows > 0) continue;\n"
               "    // A block in parts: each counts its arrival on the block's first\n")],
}
VARIANTS["loads"] = VARIANTS["noup"] + VARIANTS["nodown"] + VARIANTS["noepi"]
VARIANTS["ring"] = VARIANTS["loads"] + VARIANTS["noxq"] + VARIANTS["noout"]
REPS = 10


def _edit(src: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise SystemExit(f"variant: {old.splitlines()[0].strip()!r} not in the shipped source")
        src = src.replace(old, new)
    return src


def _tile(src: str, spec: str) -> str:
    m = re.fullmatch(r"(320|640):(\d+),(\d+),(\d+),(\d+)", spec)
    if m is None:
        raise SystemExit(f"--tile {spec}: want C:KS,NB1,NB2,CL with C 320 or 640")
    c, *rest = m.groups()
    pat = rf"#define GP_K5_{c} {c}, \d+, \d+, \d+, \d+"
    if re.search(pat, src) is None:
        raise SystemExit(f"--tile: no GP_K5_{c} in the shipped source")
    return re.sub(pat, f"#define GP_K5_{c} {c}, " + ", ".join(rest), src)


def variants(args) -> dict[str, tuple[str, str]]:
    src = (_build.CSRC / "fused_geglu_ff_int8.cu").read_text()
    hdr = (_build.CSRC / "common.cuh").read_text()
    out = {"shipped": (src, hdr)}
    for spec in args.tile:
        out[spec] = (_tile(src, spec), hdr)
    for name in args.variant:  # "a+b": both edits
        parts = name.split("+")
        if any(v not in VARIANTS for v in parts):
            raise SystemExit(f"--variant {name}: want names of {list(VARIANTS)} joined by +")
        out[name] = (_edit(src, [e for v in parts for e in VARIANTS[v]]), hdr)
    for spec in args.baseline:
        name, _, path = spec.partition("=")
        base = Path(path)
        out[name] = (base.read_text(), (base.parent / "common.cuh").read_text())
    return out


def bind(lib) -> bool:
    """Set fused_geglu_ff_int8's argument types; True if the library has the
    wgmma body, whose entry takes a scratch pointer (PR 3's does not)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    current = hasattr(lib, "fused_geglu_ff_int8_body")
    lib.fused_geglu_ff_int8.argtypes = [p] * (16 if current else 15) + [i] * 4 + [p]
    lib.fused_geglu_ff_int8.restype = i
    if current:
        lib.fused_geglu_ff_int8_scratch_bytes.argtypes = [i] * 3
        lib.fused_geglu_ff_int8_scratch_bytes.restype = ctypes.c_longlong
    return current


def operands(x: torch.Tensor, qh, qg, q2):
    """The wrapper's operands (fused_ff.fused_geglu_ff_int8): x as (rows, C),
    the three weights, the ten vectors."""
    rows, c = x.shape[0] * x.shape[1], x.shape[2]
    inner, dev = qh.w_int8.shape[0], x.device
    vecs = [ff._vec(qh.inv_a, c, dev), ff._vec(qh.zp, c, dev),
            ff._vec(qh.o_scale, inner, dev), ff._vec(qh.bias, inner, dev),
            ff._vec(qg.o_scale, inner, dev), ff._vec(qg.bias, inner, dev),
            ff._vec(q2.inv_a, inner, dev), ff._vec(q2.zp, inner, dev),
            ff._vec(q2.o_scale, c, dev), ff._vec(q2.bias, c, dev)]
    return (x.reshape(rows, c).contiguous(), [q.w_int8.contiguous() for q in (qh, qg, q2)],
            vecs)


def call(lib, current: bool, ops, name: str) -> torch.Tensor:
    x2, ws, vecs = ops
    rows, c = x2.shape
    inner = ws[0].shape[0]
    code = 0 if x2.dtype == torch.float32 else 1
    y = torch.empty_like(x2)
    ptrs = [x2.data_ptr(), *(w.data_ptr() for w in ws), *(v.data_ptr() for v in vecs),
            y.data_ptr()]
    if current:
        n = lib.fused_geglu_ff_int8_scratch_bytes(rows, c, inner)
        scratch = torch.empty(n, dtype=torch.uint8, device="cuda") if n else None
        ptrs.append(None if scratch is None else scratch.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    _build.check(lib.fused_geglu_ff_int8(*ptrs, rows, c, inner, code, stream), name)
    return y


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tile", nargs="*", default=[])
    ap.add_argument("--variant", nargs="*", default=[])
    ap.add_argument("--baseline", nargs="*", default=[])
    ap.add_argument("--dtype", nargs="*", choices=("bf16", "f32"), default=["bf16", "f32"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_k5: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants("fused_geglu_ff_int8.cu", variants(args), Path(tmp))
        current = {n: bind(lib) for n, (lib, _) in libs.items()}
        print(json.dumps({"ptxas": {n: {k: r for k, r in regs.items() if "ff_int8" in k}
                                    for n, (_, regs) in libs.items()}}), flush=True)
        gen = int8_generator()
        dts = {"bf16": torch.bfloat16, "f32": torch.float32}
        for name in args.dtype:
            dt = dts[name]
            for (b, s, c), n in K5_SHAPES:
                x = (torch.randn(b, s, c, device="cuda", generator=gen) + 0.3).to(dt)
                trees = ff_int8_trees(gen, c, x)
                rows, inner = b * s, 4 * c
                ops = operands(x, *trees)
                ref = ff._fused_geglu_ff_int8_ref(ops[0], *trees)
                nbytes = 2 * rows * c * elt(dt) + 3 * c * inner + 4 * (4 * c + 6 * inner)
                ops_n = 6.0 * rows * c * inner
                rec = {"shape": [b, s, c], "dtype": name, "launches_per_forward": n,
                       "bound_ms": max(ops_n / PEAK["int8"], nbytes / HBM_BYTES_PER_S) * 1e3,
                       "epilogue_floor_ms": rows * inner * EPILOGUE_OPS / FP32_OPS_PER_S * 1e3}
                xb = x.to(torch.bfloat16)
                w1 = ((torch.rand(2 * inner, c, device="cuda", generator=gen) * 2 - 1)
                      / c ** 0.5).to(torch.bfloat16)
                w2 = ((torch.rand(c, inner, device="cuda", generator=gen) * 2 - 1)
                      / inner ** 0.5).to(torch.bfloat16)
                rec["composition_bf16_ms"] = cuda_ms(
                    lambda: ff._geglu_ff_composition(xb, w1, None, w2, None), REPS)
                if c == 320:
                    rec["k2_bf16_ms"] = cuda_ms(lambda: ff.fused_geglu_ff(xb, w1, None, w2, None),
                                                REPS)
                for lname in list(libs) + list(reversed(libs)):
                    lib, _ = libs[lname]
                    cur = current[lname]
                    ms = cuda_ms(lambda: call(lib, cur, ops, lname), REPS)
                    got = rec.setdefault(lname, {"ms": []})
                    got["ms"].append(ms)
                    out = call(lib, cur, ops, lname)
                    again = call(lib, cur, ops, lname)
                    torch.cuda.synchronize()
                    got["max_abs_err"] = (out.float() - ref.float()).abs().max().item()
                    got["bit_identical"] = bool(torch.equal(out, ref))
                    got["repeat_bit_identical"] = bool(torch.equal(out, again))
                print(json.dumps(rec), flush=True)
                del x, xb, w1, w2, trees, ops, ref
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
