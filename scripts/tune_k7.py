#!/usr/bin/env python3
"""Variants of K7's body (the W8A8 conv3x3 on int8 wgmma), timed beside the
shipped one, an older source, cuDNN's bf16 convolution and the bound, at the
profiling script's shapes.

    python3 scripts/tune_k7.py [--variant cluster1 ring4 noquant ...]
                               [--baseline NAME=OLD/quantized_conv3x3.cu ...]
                               [--batch 2 16] [--dtype bf16|f32]

Each variant is csrc/quantized_conv3x3.cu (with csrc/common.cuh) compiled by
nvcc into a library of its own (scripts/kernel_variants.py), after one edit
to a copy:

  --variant cluster1 cluster4  each CTA loads its own weight ring (twice the
                    weight bytes from L2), or 4 CTAs of a cluster share it
                    (half; 2 shipped)
  --variant ring3 ring4 ring8 ring10 ring12  at most that many weight slots
                    (6 shipped; shared memory may hold fewer)
  --variant raw2 raw3 raw4 raw6  at most that many raw x boxes (half
                    chunks) in flight, as long as 4 weight slots fit (2
                    shipped)
  --variant regs40 regs56 regs72  setmaxnreg leaves the producer warpgroup
                    that many registers (88 shipped) and gives the consumers
                    what it frees (232, 224, 216; 208 shipped)
  --variant unroll1 unroll4  the stagers' loop over their 16-byte units
                    unrolled by 1 or 4 (2 shipped)
  --variant sendnow  bf16: each warp sends its tile rows right after staging
                    them (shipped: after the next tile's first chunk)
  --variant waitplain  the consumers' waits for a weight slot spin without
                    the trap that ends a wait of seconds
  --variant noquant nostage noldsm noproducts noepi  timing probes (wrong
                    results): the staging stores the low bytes of raw x's
                    bits as codes (no multiply, clamp or rounding); the
                    stagers stage nothing (the rings' protocol alone); the
                    consumers load no A fragments; issue no wgmma; store no
                    output; rings = nostage+noldsm+noproducts+noepi: the
                    rings and waits alone (names joined by + take every
                    edit)
  --baseline NAME=FILE  another quantized_conv3x3.cu (an earlier commit's,
                    with its own common.cuh beside it) as the variant NAME;
                    a source without quantized_conv3x3_body (the first body,
                    on mma.sync) takes its weights as (Co, 3, 3, C)

At scripts/profile_quant_conv_torch.py's SHAPES and each --batch (2 and 16
by default) with that script's inputs in --dtype (a random OIHW weight
quantized on x's absmax statistics, here with a random bias), every library
runs in turns (all in order, then in reverse; CUDA events, mean of REPS
calls after a warm-up, each call laying out the weights as the wrapper
does), and one JSON line per shape gives cuDNN's bf16 convolution's time on
the same x, the bound (2*9*N*H*W*C*Co int8 operations at 1,979 TOPS, or x,
the output and the weights at 3.35 TB/s), the weight bytes a call reads from
L2 reckoned from the tiles (the shipped body's, quant_conv.weight_l2_bytes,
and the first body's: every 8 x 16-pixel tile all 9 C Co weights), and per
library both times and whether its output equals the shipped one's; at the
smallest batch also the shipped body's max abs error against the plain
version (quant_conv._quantized_conv3x3_ref). A line before the shapes gives
each library's registers, spills and ptxas advisories of its kernels. Needs
the card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import bound, cuda_ms, elt  # noqa: E402
from genpercept_tpu_torch import _build  # noqa: E402
from genpercept_tpu_torch.ops import quant as tq  # noqa: E402
from genpercept_tpu_torch.ops import quant_conv as qc  # noqa: E402
from kernel_variants import build_variants, card  # noqa: E402
from profile_quant_conv_torch import SHAPES  # noqa: E402

VARIANTS = {
    **{f"cluster{n}": [("constexpr int kCL = 2;", f"constexpr int kCL = {n};")] for n in (1, 4)},
    **{f"ring{n}": [("constexpr int kMaxNB = 6;", f"constexpr int kMaxNB = {n};")]
       for n in (3, 4, 8, 10, 12)},
    **{f"raw{n}": [("constexpr int kMaxRaw = 2;", f"constexpr int kMaxRaw = {n};")]
       for n in (2, 3, 4, 6)},

    # the producer warpgroup keeps R registers (the consumers what it frees,
    # rounded down to 8), 88 shipped
    **{f"regs{r}": [("static constexpr int PRODUCER_REGS = 88;",
                     f"static constexpr int PRODUCER_REGS = {r};")] for r in (40, 56, 72)},
    # the stagers' loop over their units unrolled by U (2 shipped)
    **{f"unroll{u}": [("#pragma unroll 2\n          for (int m = 0; m < Q::STAGE_ITEMS; ++m) {",
                       f"#pragma unroll {u}\n          for (int m = 0; m < Q::STAGE_ITEMS; ++m) {{")]
       for u in (1, 4)},
    # bf16: each warp sends its rows right after staging them, not after the
    # next tile's first chunk
    "sendnow": [("      __syncwarp();\n      sent = false;\n    }\n",
                 "      __syncwarp();\n      send();\n    }\n")],
    "waitplain": [("      mbar_wait_or_trap(b_full + s, ((qb + tap) / NB) & 1);",
                   "      mbar_wait(b_full + s, ((qb + tap) / NB) & 1);")],
    # timing probes, wrong results
    "noquant": [("b[i] = code_bits(to_f32(src[(4 * j4 + i) * Q::HR * Q::RAW_W]), iav[i]);",
                 "b[i] = __float_as_uint(to_f32(src[(4 * j4 + i) * Q::HR * Q::RAW_W]));")],
    "nostage": [("if (item >= Q::PIECE_ITEMS) break;", "if (item >= 0) break;")],
    "noldsm": [("ldsm_x4(As + p * KC + ((unit ^ ((p >> 1) & 3)) << 4), f[ks][mb]);",
                "f[ks][mb][0] = f[ks][mb][1] = f[ks][mb][2] = f[ks][mb][3] = unit;")],
    "noproducts": [("wgmma_s8_rs(acc[mb], af[tap % 2][ks][mb], db + 2 * ks, 1);", "")],
    "noepi": [("    if (!tile.store) {\n    } else if constexpr", "    if (true) {\n    } else if constexpr")],
}
VARIANTS["rings"] = [e for v in ("nostage", "noldsm", "noproducts", "noepi")
                     for e in VARIANTS[v]]
REPS = 10


def _edit(src: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise SystemExit(f"variant: {old.splitlines()[0].strip()!r} not in the shipped source")
        src = src.replace(old, new)
    return src


def variants(args) -> dict[str, tuple[str, str]]:
    src = (_build.CSRC / "quantized_conv3x3.cu").read_text()
    hdr = (_build.CSRC / "common.cuh").read_text()
    out = {"shipped": (src, hdr)}
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
    """Set quantized_conv3x3's argument types; True if the library's body
    takes the weights as (9, Co, C), False for the first body's (Co, 3, 3,
    C)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.quantized_conv3x3.argtypes = [p] * 6 + [i] * 6 + [p]
    lib.quantized_conv3x3.restype = i
    return hasattr(lib, "quantized_conv3x3_body")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", nargs="*", default=[])
    ap.add_argument("--baseline", nargs="*", default=[])
    ap.add_argument("--batch", nargs="*", type=int, default=[2, 16])
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_k7: needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    dt, code = (torch.bfloat16, 1) if args.dtype == "bf16" else (torch.float32, 0)
    print(card(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants("quantized_conv3x3.cu", variants(args), Path(tmp))
        current = {n: bind(lib) for n, (lib, _) in libs.items()}
        print(json.dumps({"ptxas": {n: {k: r for k, r in regs.items() if "conv" in k}
                                    for n, (_, regs) in libs.items()}}), flush=True)
        gen = torch.Generator(device="cuda").manual_seed(0)
        stream = torch.cuda.current_stream().cuda_stream
        for batch in args.batch:
            for h, w, c, co in SHAPES:
                x = torch.randn(batch, c, h, w, device="cuda", generator=gen).to(dt)
                wf = torch.randn(co, c, 3, 3, device="cuda", generator=gen) * 0.05
                b = torch.randn(co, device="cuda", generator=gen) * 0.1
                q = tq.quantize_conv(wf, b, tq.absmax_per_channel(x.movedim(1, -1)), margin=1.0)
                ia, osc, bias = q.inv_a.contiguous(), q.o_scale.contiguous(), q.bias.contiguous()
                wb = wf.to(torch.bfloat16)
                xb = x.to(torch.bfloat16)
                bd = bound(2.0 * 9 * batch * h * w * c * co, "int8",
                           batch * h * w * (c + co) * elt(dt) + 9 * c * co + 4 * (c + 2 * co))
                tiles_first = batch * -(-h // 8) * -(-w // 16)
                rec = {"batch": batch, "shape": [batch, c, h, w], "co": co, "dtype": args.dtype,
                       "bound_ms": bd.ms, "bound_by": bd.by,
                       "cudnn_bf16_ms": cuda_ms(lambda: F.conv2d(xb, wb, padding=1), REPS),
                       "weight_l2_bytes": qc.weight_l2_bytes(batch, c, co, h, w),
                       "weight_l2_bytes_first_body": tiles_first * 9 * c * co}
                outs = {}
                for name in list(libs) + list(reversed(libs)):
                    lib, _ = libs[name]
                    # NaN until written: a probe that stores nothing is not equal
                    y = torch.full((batch, co, h, w), float("nan"), device="cuda", dtype=dt)

                    def call():
                        wt = (qc._tap_major_weights(q.w_int8) if current[name]
                              else q.w_int8.permute(0, 2, 3, 1).contiguous())
                        _build.check(lib.quantized_conv3x3(
                            x.data_ptr(), ia.data_ptr(), wt.data_ptr(), osc.data_ptr(),
                            bias.data_ptr(), y.data_ptr(), batch, c, co, h, w, code, stream),
                            name)

                    ms = cuda_ms(call, REPS)
                    rec.setdefault(name, {"ms": []})["ms"].append(ms)
                    outs[name] = y
                for name in libs:
                    rec[name]["equal_to_shipped"] = bool(torch.equal(outs[name], outs["shipped"]))
                if batch == min(args.batch):
                    ref = qc._quantized_conv3x3_ref(x, q.w_int8, q.inv_a, q.o_scale, q.bias)
                    rec["shipped"]["max_abs_err"] = (
                        outs["shipped"].float() - ref.float()).abs().max().item()
                    rec["shipped"]["bit_identical"] = bool(torch.equal(outs["shipped"], ref))
                    del ref
                print(json.dumps(rec), flush=True)
                del x, xb, wf, wb, q, outs, y
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
