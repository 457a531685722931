#!/usr/bin/env python3
"""Variants of K8's f32 body (split TF32 on wgmma), timed beside the shipped
one, the f32 unfused composition and the bound, at every resblock
convolution of a 768^2 forward.

    python3 scripts/tune_k8.py [--tile NB,KG ...] [--variant onepass oneacc ...]
                               [--baseline NAME=OLD/fused_gn_silu_conv3x3.cu ...]

Each variant is csrc/fused_gn_silu_conv3x3.cu (with csrc/common.cuh)
compiled by nvcc into a library of its own (scripts/kernel_variants.py),
after one edit to a copy:

  --tile NB,KG      the f32 instantiation (GP_K8_F32): NB slots in the TMA
                    ring of weight taps (32 KB each) and KG k steps of 8
                    channels a wgmma group (1, 2 or 4)
  --variant onepass hi.hi only, one tf32 wgmma a product: not f32-accurate
                    (its error is printed); what the two small passes cost
  --variant oneacc  one accumulator over every chunk of C (the tensor cores
                    truncate each sum into it) instead of a chunk's sums
                    added to the tile's by f32 adds: the error the design
                    keeps away, read on the card
  --variant nosilu  timing probe: the staging splits raw x, without
                    silu_affine (wrong results)
  --variant hionly  timing probe: the weight ring loads only the hi half of
                    each tap (half the L2 reads; wrong results)
  --variant regs80  setmaxnreg leaves the producer warpgroup 80 registers and
                    gives the consumers 208 (96 and 200 shipped)
  --variant raw1    one slot of raw halo boxes (the next chunk's box asked for
                    once this one is staged) and three of weights (two and
                    two shipped)
  --variant kunroll2 the stagers' loop over the chunk's four k steps
                    unrolled by two (not unrolled shipped)
  --variant rcp     the stagers' reciprocal by rcp.rn in place of
                    silu_affine's div.rn(1, .) (the same bits)
                    (names joined by + take both edits: onepass+oneacc)
  --baseline NAME=FILE  another fused_gn_silu_conv3x3.cu (an earlier
                    commit's, with its own common.cuh beside it) as the
                    variant NAME; a source without the split-TF32 body (no
                    fused_gn_silu_conv3x3_f32_body) takes its f32 weights as
                    (3, 3, C, Co), the FFMA body's layout

At chip_smoke.py's K8_SHAPES with chip_smoke.phase_k8's inputs in f32 (TF32
off), every library runs in turns (all in order, then in reverse; CUDA
events, mean of REPS calls after a warm-up; each call prepares its weights
as the wrapper does), and one JSON line per shape gives the unfused
composition's ms (chip_smoke.unfused_conv: GroupNorm, SiLU, cuDNN conv, +
residual), the bound at the split-TF32 rate and at the FFMA rate, and, per
library, both
times and the errors against the plain version
(fused_conv._fused_gn_silu_conv3x3_ref) over max|plain|, whole output and
border pixels. A last line sums each over a forward's 48 launches; a line
before the shapes gives each library's registers, spills and ptxas
advisories of the f32 body. Needs the card and nvcc.
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

from chip_smoke import K8_SHAPES, PEAK, border, cuda_ms, unfused_conv  # noqa: E402
from genpercept_tpu_torch import _build  # noqa: E402
from genpercept_tpu_torch.ops import fused_conv as fc  # noqa: E402
from kernel_variants import build_variants, card  # noqa: E402

SHIPPED_TILE = re.compile(r"#define GP_K8_F32 \d+, \d+")
# the two small passes of each k step
SMALL_PASSES = [
    "          wgmma_rs_tf32(part, af[gi % 2][2 * k + 1], dh + step, gi > 0 || k > 0);\n"
    "          wgmma_rs_tf32(part, af[gi % 2][2 * k], dl + step, 1);\n",
    "          wgmma_rs_tf32(part, af[gi % 2][2 * k], dh + step, 1);\n",
]
VARIANTS = {
    # hi.hi alone, which then opens the chunk's sums
    "onepass": [(SMALL_PASSES[0] + SMALL_PASSES[1],
                 SMALL_PASSES[1].replace("dh + step, 1)", "dh + step, gi > 0 || k > 0)"))],
    # part runs on over the tile's chunks and is the tile's sums
    "oneacc": [
        ("for (int n = 0; n < 16; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;",
         "for (int n = 0; n < 16; ++n)\n"
         "      part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;"),
        ("dh + step, gi > 0 || k > 0);", "dh + step, 1);"),
        ("acc[n][j] = __fadd_rn(acc[n][j], part[n][j]);", "acc[n][j] = part[n][j];"),
    ],
    # timing probes, wrong results: the staging without silu_affine (raw x
    # split), and the weight ring without the lo half (16 KB a tap)
    "nosilu": [("inside ? silu_affine(v0, a0, b0) : 0.f;", "v0;"),
               ("inside ? silu_affine(v1, a1, b1) : 0.f;", "v1;")],
    # the stagers' reciprocal by rcp.rn in place of silu_affine's div.rn(1, .)
    # (the same bits)
    "rcp": [("inside ? silu_affine(v0, a0, b0) : 0.f;",
             "inside ? __fmul_rn(y0, __frcp_rn(__fadd_rn(1.0f, expf(-y0)))) : 0.f;"),
            ("inside ? silu_affine(v1, a1, b1) : 0.f;",
             "inside ? __fmul_rn(y1, __frcp_rn(__fadd_rn(1.0f, expf(-y1)))) : 0.f;"),
            ("            const bool inside = (in >> m) & 1u;\n",
             "            const bool inside = (in >> m) & 1u;\n"
             "            const float y0 = __fadd_rn(__fmul_rn(v0, a0), b0);\n"
             "            const float y1 = __fadd_rn(__fmul_rn(v1, a1), b1);\n")],
    "hionly": [("mbar_expect_tx(b_full + s, kFBBytes);", "mbar_expect_tx(b_full + s, kFBHalf);"),
               ("tma_load_3d(dst + kFBHalf, &tw, b_full + s, ch * kFKC, tile.co0, 9 + tap);",
                "")],
    # one raw halo slot: the next chunk's box asked for only once this one
    # is staged (three weight slots, the room of the second), two and two shipped
    "raw1": [("constexpr int kFRawSlots = 2;", "constexpr int kFRawSlots = 1;"),
             ("#define GP_K8_F32 2, 2", "#define GP_K8_F32 3, 2")],
    # the stagers' k loop unrolled by two
    "kunroll2": [("#pragma unroll 1\n        for (int k = 0; k < 4; ++k) {",
                  "#pragma unroll 2\n        for (int k = 0; k < 4; ++k) {")],
    # the producer warpgroup keeps 80 registers (consumers 208), 96 shipped
    "regs80": [("static constexpr int PRODUCER_REGS = 96;",
                "static constexpr int PRODUCER_REGS = 80;")],
}
REPS = 10


def _edit(src: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise SystemExit(f"variant: {old.splitlines()[0].strip()!r} not in the shipped source")
        src = src.replace(old, new)
    return src


def variants(args) -> dict[str, tuple[str, str]]:
    src = (_build.CSRC / "fused_gn_silu_conv3x3.cu").read_text()
    hdr = (_build.CSRC / "common.cuh").read_text()
    out = {"shipped": (src, hdr)}
    (shipped,) = set(SHIPPED_TILE.findall(src))
    for tile in args.tile:
        m = re.fullmatch(r"(\d+),([124])", tile)
        if m is None:
            raise SystemExit(f"--tile {tile}: want NB,KG (e.g. 4,2; KG one of 1, 2, 4)")
        out[f"tile_{m.group(1)}_{m.group(2)}"] = (
            src.replace(shipped, f"#define GP_K8_F32 {m.group(1)}, {m.group(2)}"), hdr)
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
    """Set fused_gn_silu_conv3x3's argument types; True if the library's f32
    body is the split-TF32 one (weights (2, 9, Co, C)), False for the FFMA
    body before it (weights (3, 3, C, Co))."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_gn_silu_conv3x3.argtypes = [p] * 7 + [i] * 6 + [p]
    lib.fused_gn_silu_conv3x3.restype = i
    return hasattr(lib, "fused_gn_silu_conv3x3_f32_body")


def inputs(gen: torch.Generator, hw: int, c: int, co: int, res: bool):
    """chip_smoke.phase_k8's draws, f32."""
    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    x = randn(2, c, hw, hw) * 2 + 0.5
    gs, gb = 1.0 + 0.1 * randn(c), 0.1 * randn(c)
    w = (torch.rand(co, c, 3, 3, device="cuda", generator=gen) * 2 - 1) / (9 * c) ** 0.5
    b = 0.1 * randn(co)
    r = randn(2, co, hw, hw) if res else None
    return x, gs, gb, w, b, r


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tile", nargs="*", default=[])
    ap.add_argument("--variant", nargs="*", default=[])
    ap.add_argument("--baseline", nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_k8: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants("fused_gn_silu_conv3x3.cu", variants(args), Path(tmp))
        split = {n: bind(lib) for n, (lib, _) in libs.items()}
        print(json.dumps({"ptxas": {n: {k: r for k, r in regs.items() if "f32" in k or "tf32" in k}
                                    for n, (_, regs) in libs.items()}}), flush=True)
        gen = torch.Generator(device="cuda").manual_seed(0)
        stream = torch.cuda.current_stream().cuda_stream
        total = {"launches": 0, "unfused_ms": 0.0, "bound_ms": 0.0, "bound_ffma_ms": 0.0}
        for (hw, c, co, res), n in K8_SHAPES:
            x, gs, gb, w, b, r = inputs(gen, hw, c, co, res)
            a, bb = fc.gn_affine(x, gs, gb)
            ref = fc._fused_gn_silu_conv3x3_ref(x, a, bb, w, b, r)
            top = ref.abs().max().item()
            ops = 2.0 * 9 * 2 * hw * hw * c * co
            rec = {"shape": [2, c, hw, hw], "co": co, "residual": res, "launches_per_forward": n,
                   "unfused_ms": cuda_ms(lambda: unfused_conv(x, gs, gb, w, b, r), REPS),
                   "bound_ms": ops / PEAK["tf32x3"] * 1e3, "bound_ffma_ms": ops / PEAK["f32"] * 1e3}
            for name in list(libs) + list(reversed(libs)):
                lib, _ = libs[name]
                y = torch.empty((2, co, hw, hw), device="cuda")

                def call():
                    wt = (fc._split_tf32_weights(w) if split[name]
                          else w.permute(2, 3, 1, 0).contiguous())
                    _build.check(lib.fused_gn_silu_conv3x3(
                        x.data_ptr(), a.data_ptr(), bb.data_ptr(), wt.data_ptr(), b.data_ptr(),
                        None if r is None else r.data_ptr(), y.data_ptr(), 2, c, co, hw, hw, 0,
                        stream), name)

                ms = cuda_ms(call, REPS)
                got = rec.setdefault(name, {"ms": []})
                got["ms"].append(ms)
                got["rel_err"] = (y - ref).abs().max().item() / top
                got["rel_err_border"] = (border(y) - border(ref)).abs().max().item() / top
            print(json.dumps(rec), flush=True)
            total["launches"] += n
            for k in ("unfused_ms", "bound_ms", "bound_ffma_ms"):
                total[k] += n * rec[k]
            for name in libs:
                total[name] = total.get(name, 0.0) + n * sum(rec[name]["ms"]) / 2
            del x, r, a, bb, ref
            torch.cuda.empty_cache()
        print(json.dumps({"per_forward": total}), flush=True)


if __name__ == "__main__":
    main()
