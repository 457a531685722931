#!/usr/bin/env python3
"""Variants of K6's d=512 body (int8 wgmma, a max pass per k block), timed
beside the shipped one, an older source, K1's bf16 body at the same shape
and both bounds, at the pipeline's d=512 shapes.

    python3 scripts/tune_k6.py [--variant ring10 atomwait nopark ...]
                               [--baseline NAME=OLD/flash_attn_int8.cu ...]
                               [--dtype bf16 f32]

Each variant is csrc/flash_attn_int8.cu (with csrc/common.cuh) compiled by
nvcc into a library of its own (scripts/kernel_variants.py), after one edit
to a copy:

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
  --baseline NAME=FILE  another flash_attn_int8.cu (an earlier commit's,
                    with its own common.cuh beside it) as the variant NAME;
                    a source without flash_attn_int8_d512_body (PR 3's
                    mma.sync body) takes no scratch argument

At chip_smoke.py's K6_SHAPES with chip_smoke.phase_k6's inputs, every
library runs in turns (all in order, then in reverse; CUDA events, mean of
REPS calls after a warm-up, each call through the wrapper's steps: the
transpose of v, the scratch, the launch), and one JSON line per shape and
output dtype gives the bound (the function's 4 bh s^2 d int8 operations at
1,979 TOPS, or its bytes), the design's floor (1.5x the operations: the max
pass), K1's bf16 time at the shape (the pipeline's bf16 attention), the
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

from chip_smoke import HBM_BYTES_PER_S, K6_SHAPES, PEAK, cuda_ms, elt, int8_generator  # noqa: E402
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


def bind(lib) -> bool:
    """Set flash_attn_int8's argument types; True if the library has the
    wgmma body, whose entry takes a scratch pointer (PR 3's does not)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    current = hasattr(lib, "flash_attn_int8_d512_body")
    lib.flash_attn_int8.argtypes = [p] * (8 if current else 7) + [i] * 5 + [f, i, p]
    lib.flash_attn_int8.restype = i
    if current:
        lib.flash_attn_int8_scratch_bytes.argtypes = [i] * 6
        lib.flash_attn_int8_scratch_bytes.restype = ctypes.c_longlong
    return current


def call(lib, current: bool, ops, scale: float, k_blk: int, dt, name: str) -> torch.Tensor:
    """The wrapper's steps (flash_attention._flash_int8_codes) on one library."""
    q8, k8, v8, qs, ks, vs = ops
    bh, sq, d = q8.shape
    sk = k8.shape[1]
    code = 0 if dt == torch.float32 else 1
    vt = v8.transpose(1, 2).contiguous()
    out = torch.empty((bh, sq, d), dtype=dt, device="cuda")
    c = ctypes.c_float(scale * fa._LOG2E)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (q8, k8, vt, qs, ks, vs, out)]
    if current:
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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_k6: needs a CUDA device")
    print(card(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants("flash_attn_int8.cu", variants(args), Path(tmp))
        current = {n: bind(lib) for n, (lib, _) in libs.items()}
        print(json.dumps({"ptxas": {n: {k: r for k, r in regs.items() if "flash_int8" in k}
                                    for n, (_, regs) in libs.items()}}), flush=True)
        gen = int8_generator()
        dts = {"bf16": torch.bfloat16, "f32": torch.float32}
        for name in args.dtype:
            dt = dts[name]
            for (bh, s, d), n in K6_SHAPES:
                q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen).to(dt)
                           for _ in range(3))
                scale, k_blk = d ** -0.5, fa._int8_k_block(s, s, d)
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
                for lname in list(libs) + list(reversed(libs)):
                    lib, _ = libs[lname]
                    cur = current[lname]
                    ms = cuda_ms(lambda: call(lib, cur, ops, scale, k_blk, dt, lname), REPS)
                    got = rec.setdefault(lname, {"ms": []})
                    got["ms"].append(ms)
                    out = call(lib, cur, ops, scale, k_blk, dt, lname)
                    torch.cuda.synchronize()
                    got["max_abs_err"] = (out.float() - ref.float()).abs().max().item()
                    got["bit_identical"] = bool(torch.equal(out, ref))
                print(json.dumps(rec), flush=True)
                del q, k, v, qb, kb, vb, ops, ref
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
