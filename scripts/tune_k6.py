#!/usr/bin/env python3
"""Variants of K6's bodies (int8 wgmma, a max pass per k block), timed beside
the shipped ones, an older source, K1's bf16 body at the same shape and the
bounds: the d=512 body at the pipeline's shapes, the d=64 body at the
profiling script's.

    python3 scripts/tune_k6.py [--shapes d512|d64]
                               [--variant ring10 atomwait nopark ...]
                               [--baseline NAME=OLD/flash_attn_int8.cu ...]
                               [--dtype bf16 f32]

Each variant is csrc/flash_attn_int8.cu (with csrc/common.cuh) compiled by
nvcc into a library of its own (scripts/kernel_variants.py), after one edit
to a copy. The d=512 body's (--shapes d512, the default):

  --variant ring10  10 stages of 16 KB in the K / V^T ring, the most that
                    shared memory holds (8 shipped, the fewest that do not
                    deadlock)
  --variant cluster1 cluster4  each CTA loads its own K / V^T ring (1), or 4
                    CTAs of a cluster share each load by multicast (2 shipped)
  --variant parkload  the parked output read back by the threads from
                    device memory at each fold, not through the ring
  --variant atomwait  S's chain of 16 wgmma waits for each K atom in turn
                    inside it (the first form; ptxas serialized every wgmma)
  --variant nopark nomaxpass nosoftmax nopv noqk noexp  timing probes (wrong
                    results): the folds without their stores of the parked
                    output, the max pass without its products, the second
                    pass without its softmax (pq from the logit's low bits),
                    without P V, both passes without Q K^T, pq without exp2f;
                    noqk+nopv+nosoftmax+nopark: the ring's loads alone
                    (names joined by + take every edit: ring10+nopv)

The d=64 body's (--shapes d64):

  --variant d64nwg2 d64nwg3 d64cta3 d64bk64 d64ring4 d64ring8 d64ring12
                    other tiles: two consumer warpgroups a CTA sharing one
                    ring (one CTA a SM), three with 64-key tiles (128-key
                    tiles do not fit their registers), three CTAs a SM with
                    64-key tiles, 64-key tiles, 4, 8 or 12 ring stages
                    (shipped: one warpgroup a CTA, two CTAs a SM, 128-key
                    tiles, 6 stages)
  --variant d64nomax d64nosoftmax d64noexp d64nopv d64noqk  timing probes
                    (wrong results): the max pass without its arithmetic
                    (its products kept), the second pass's codes without the
                    softmax (pq from the logit's low bits), pq without exp2f,
                    without P V, both passes without Q K^T;
                    d64noqk+d64nopv+d64nosoftmax+d64nomax: the ring's loads
                    and the stages' waits alone

  --baseline NAME=FILE  another flash_attn_int8.cu (an earlier commit's,
                    with its own common.cuh beside it) as the variant NAME;
                    a source without flash_attn_int8_d512_body (the first
                    d=512 body, on mma.sync) takes no scratch argument, and
                    one without flash_attn_int8_d64_body (the d=64 mma.sync
                    body) takes V^T with its keys in order

At chip_smoke.py's K6_SHAPES (d512) or K6_D64 (d64) with chip_smoke's
inputs, every library runs in turns (all in order, then in reverse; CUDA
events, mean of REPS calls after a warm-up, each call through the wrapper's
steps: V^T, the scratch, the launch), and one JSON line per shape and
output dtype gives the bound (the function's 4 bh s^2 d int8 operations at
1,979 TOPS, or its bytes), the design's floor (1.5x the operations: the max
pass), at d=64 the exponent floor (one exp2f a logit on the 16-a-clock MUFU
of each SM at the card's highest clock), K1's bf16 time at the shape, the
operands' quantization, and per library both times, the max abs error
against the plain version (flash_attention._flash_int8_ref) and whether it
is bit for bit equal. A line before the shapes gives each library's
registers, spills and ptxas advisories of its flash_int8 kernels. Needs the
card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import (HBM_BYTES_PER_S, K6_D64, K6_SHAPES, MUFU_PER_CLK_SM, PEAK,  # noqa: E402
                        cuda_ms, elt, int8_generator, sm_clock_hz)
from genpercept_tpu_torch import _build  # noqa: E402
from genpercept_tpu_torch.ops import flash_attention as fa  # noqa: E402
from kernel_variants import build_variants, card  # noqa: E402

VARIANTS = {
    # 10 stages of 16 KB in the ring, the most that shared memory holds (8
    # shipped, the fewest that do not deadlock)
    "ring10": [("constexpr int NBUF = 8;", "constexpr int NBUF = 10;")],
    # CTAs a cluster sharing each K / V^T load by multicast (2 shipped; 1:
    # every CTA loads its own)
    **{f"cluster{n}": [("constexpr int CLUSTER = 2;", f"constexpr int CLUSTER = {n};")]
       for n in (1, 4)},
    # the parked output read back by the threads from device memory at each
    # fold, not brought back through the ring as TMA boxes
    "parkload": [
        ("        if (b >= 2)\n          for (int g = 0; g < NGROUP; ++g) put_park(g);\n", ""),
        ("      if (nblk >= 2)  // the output's fold, onto the parked output of the block before\n"
         "        for (int g = 0; g < NGROUP; ++g) put_park(g);\n", ""),
        ("if (parked) ring.wait(pos);", ""),
        ("const float2 a = parked_value(box, row0 + 8 * r, n, t);",
         "const float2 a = ok[r] ? *reinterpret_cast<const float2*>(park + at[r] + 8 * tn)\n"
         "                                   : make_float2(0.f, 0.f);"),
        ("        if (parked) {\n          ring.release(pos);\n          ++pos;\n        }\n", ""),
        ("      if (parked) {\n        ring.release(pos);\n        ++pos;\n      }\n", "")],
    # the chain of S's 16 wgmma waits for each K atom in turn, inside it
    # (ptxas then serialized every wgmma of the kernel: advisory C7520)
    "atomwait": [
        ("#pragma unroll\n  for (int a = 0; a < 4; ++a) ring.wait(pos + a);\n", ""),
        ("    const uint64_t dk = sw128_desc(ring.stage(pos + a) + koff);\n",
         "    ring.wait(pos + a);\n    const uint64_t dk = sw128_desc(ring.stage(pos + a) + koff);\n")],
    # timing probes, wrong results: the folds without their stores of the
    # parked output; the max pass without its products (its atoms waited
    # on and released); the second pass without its softmax (pq from the
    # int32 logit's low bits); without P V; both passes without Q K^T;
    # pq from the logit without exp2f
    "nopark": [("if (ok[r]) store2(park + at[r] + 8 * tn, o.x, o.y);", "")],
    "nomaxpass": [
        ("    qk_tile<NS, false>(sn, Qs, ring, pos, wg * 8 * NS * 128, 0);\n",
         "    for (int a = 0; a < 4; ++a) ring.wait(pos + a);\n"
         "    for (int a = 0; a < 3; ++a) ring.release(pos + a);\n")],
    "nosoftmax": [("          const float sv = logit(sn[n][2 * r + j], qsr[r], j ? kv[n].y : kv[n].x);\n"
                   "          const float p = exp2f(__fsub_rn(__fmul_rn(sv, c), mc[r]));\n"
                   "          pq[j] = __float2int_rn(__fmul_rn(p, 127.f));\n",
                   "          pq[j] = sn[n][2 * r + j] & 127;\n")],
    "nopv": [("    for (int kk = 0; kk < NS / 2; ++kk) wgmma_s8(pv, dp + 2 * kk, dv + 2 * kk, 1);\n",
              "")],
    "noqk": [("      wgmma_s8(s, dq + (a * QATOM + 32 * kk) / 16, dk + 2 * kk, a > 0 || kk > 0);\n",
              "")],
    "noexp": [("const float p = exp2f(__fsub_rn(__fmul_rn(sv, c), mc[r]));",
               "const float p = __fsub_rn(__fmul_rn(sv, c), mc[r]);")],
    # the d=64 body's tiles: two consumer warpgroups a CTA sharing its ring
    # (one CTA a SM), three with 64-key tiles (128-key tiles do not fit their
    # registers), three CTAs a SM with 64-key tiles, 64-key tiles, ring
    # stages (1 warpgroup, 2 CTAs a SM, BK 128, 6 stages shipped)
    "d64nwg2": [("constexpr int D64_NWG = 1;", "constexpr int D64_NWG = 2;"),
                ("constexpr int D64_CTAS = 2;", "constexpr int D64_CTAS = 1;")],
    "d64nwg3": [("constexpr int D64_NWG = 1;", "constexpr int D64_NWG = 3;"),
                ("constexpr int D64_BK = 128;", "constexpr int D64_BK = 64;"),
                ("constexpr int D64_CTAS = 2;", "constexpr int D64_CTAS = 1;")],
    "d64cta3": [("constexpr int D64_BK = 128;", "constexpr int D64_BK = 64;"),
                ("constexpr int D64_CTAS = 2;", "constexpr int D64_CTAS = 3;")],
    "d64bk64": [("constexpr int D64_BK = 128;", "constexpr int D64_BK = 64;")],
    **{f"d64ring{n}": [("constexpr int D64_NBUF = 6;", f"constexpr int D64_NBUF = {n};")]
       for n in (4, 8, 12)},
    # timing probes of the d=64 body, wrong results: the max pass without its
    # arithmetic (its products kept); the codes
    # without the softmax (pq from the int32 logit's low bits); pq without
    # exp2f; without P V; both passes without Q K^T
    "d64nomax": [("row_max64(bm, ", "(void)(bm, ")],
    "d64nosoftmax": [("      const float sv = logit64(s[n][j], qsr[j / 2], (j & 1) ? kv.y : kv.x);\n"
                      "      const float p = exp2f(__fsub_rn(__fmul_rn(sv, c), mc[j / 2]));\n"
                      "      s[n][j] = __float_as_int(__fadd_rn(__fmul_rn(p, 127.f), 12582912.f));\n",
                      "      s[n][j] &= 127;\n")],
    "d64noexp": [("const float p = exp2f(__fsub_rn(__fmul_rn(sv, c), mc[j / 2]));",
                  "const float p = __fsub_rn(__fmul_rn(sv, c), mc[j / 2]);")],
    "d64nopv": [("    for (int kk = 0; kk < KP; ++kk) wgmma_s8_rs(pv, pf[kk], dv + 2 * kk, "
                 "kk > 0 || accumulate);\n", "")],
    "d64noqk": [("    wgmma_s8(sx, dq, dk, 0);\n    wgmma_s8(sx, dq + 2, dk + 2, 1);\n", "")],
}
REPS = 10


def _edit(src: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise SystemExit(f"variant: {old.splitlines()[0].strip()!r} not in the shipped source")
        src = src.replace(old, new)
    return src


def variants(args) -> dict[str, tuple[str, str]]:
    src = (_build.CSRC / "flash_attn_int8.cu").read_text()
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


def bind(lib) -> dict:
    """Set flash_attn_int8's argument types; what the library's entry takes:
    a scratch pointer (the d=512 wgmma body's; the first entry has none), V^T
    with each 32 keys in the d=64 wgmma body's order (not the mma.sync one's)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    scratch = hasattr(lib, "flash_attn_int8_d512_body")
    lib.flash_attn_int8.argtypes = [p] * (8 if scratch else 7) + [i] * 5 + [f, i, p]
    lib.flash_attn_int8.restype = i
    if scratch:
        lib.flash_attn_int8_scratch_bytes.argtypes = [i] * 6
        lib.flash_attn_int8_scratch_bytes.restype = ctypes.c_longlong
    return {"scratch": scratch, "vt_order": hasattr(lib, "flash_attn_int8_d64_body")}


def call(lib, takes: dict, ops, scale: float, k_blk: int, dt, name: str) -> torch.Tensor:
    """The wrapper's steps (flash_attention._flash_int8_codes) on one library."""
    q8, k8, v8, qs, ks, vs = ops
    bh, sq, d = q8.shape
    sk = k8.shape[1]
    code = 0 if dt == torch.float32 else 1
    vt = fa._int8_vt(v8) if takes["vt_order"] else v8.transpose(1, 2).contiguous()
    out = torch.empty((bh, sq, d), dtype=dt, device="cuda")
    c = ctypes.c_float(scale * fa._LOG2E)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (q8, k8, vt, qs, ks, vs, out)]
    if takes["scratch"]:
        n = lib.flash_attn_int8_scratch_bytes(bh, sq, sk, d, k_blk, code)
        scratch = torch.empty(n, dtype=torch.uint8, device="cuda") if n else None
        ptrs.append(None if scratch is None else scratch.data_ptr())
    _build.check(lib.flash_attn_int8(*ptrs, bh, sq, sk, d, k_blk, c, code, stream), name)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", nargs="*", default=[])
    ap.add_argument("--baseline", nargs="*", default=[])
    ap.add_argument("--dtype", nargs="*", choices=("bf16", "f32"), default=["bf16", "f32"])
    ap.add_argument("--shapes", choices=("d512", "d64"), default="d512")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_k6: needs a CUDA device")
    print(card(), flush=True)
    shapes = ([((bh, s, d), n, None) for (bh, s, d), n in K6_SHAPES] if args.shapes == "d512"
              else [(shape, 0, k_blk) for shape, k_blk in K6_D64])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = sm_clock_hz()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants("flash_attn_int8.cu", variants(args), Path(tmp))
        takes = {n: bind(lib) for n, (lib, _) in libs.items()}
        print(json.dumps({"ptxas": {n: {k: r for k, r in regs.items() if "flash_int8" in k}
                                    for n, (_, regs) in libs.items()}}), flush=True)
        gen = int8_generator()
        dts = {"bf16": torch.bfloat16, "f32": torch.float32}
        for name in args.dtype:
            dt = dts[name]
            for (bh, s, d), n, k_blk in shapes:
                q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen).to(dt)
                           for _ in range(3))
                scale = d ** -0.5
                k_blk = k_blk or fa._int8_k_block(s, s, d)
                ops = fa.int8_operands(q, k, v)
                ref = fa._flash_int8_ref(*ops, scale, k_blk, dt)
                ops_n = 4.0 * bh * s * s * d
                nbytes = bh * s * (3 * d + d * elt(dt) + 8) + 4 * bh * d
                qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
                rec = {"shape": [bh, s, d], "dtype": name, "k_block": k_blk,
                       "launches_per_forward": n,
                       "bound_ms": max(ops_n / PEAK["int8"], nbytes / HBM_BYTES_PER_S) * 1e3,
                       "design_floor_ms": 1.5 * ops_n / PEAK["int8"] * 1e3,
                       "k1_bf16_ms": cuda_ms(lambda: fa._flash_bhsd(qb, kb, vb, scale), REPS),
                       "quantize_ms": cuda_ms(lambda: fa.int8_operands(q, k, v), REPS)}
                if d == 64:
                    rec["exponent_floor_ms"] = bh * s * s / (MUFU_PER_CLK_SM * sms * clock) * 1e3
                for lname in list(libs) + list(reversed(libs)):
                    lib, _ = libs[lname]
                    tk = takes[lname]
                    ms = cuda_ms(lambda: call(lib, tk, ops, scale, k_blk, dt, lname), REPS)
                    got = rec.setdefault(lname, {"ms": []})
                    got["ms"].append(ms)
                    out = call(lib, tk, ops, scale, k_blk, dt, lname)
                    torch.cuda.synchronize()
                    got["max_abs_err"] = (out.float() - ref.float()).abs().max().item()
                    got["bit_identical"] = bool(torch.equal(out, ref))
                print(json.dumps(rec), flush=True)
                del q, k, v, qb, kb, vb, ops, ref
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
