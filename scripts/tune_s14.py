#!/usr/bin/env python3
"""S1-S4, the attention profiling scripts' kernels, on K1's wgmma bodies,
timed beside an older source's bodies, SDPA, the bound and the d=64 floors.

    python3 scripts/tune_s14.py [--baseline NAME=OLD/flash_attn_fwd.cu ...]

csrc/flash_attn_fwd.cu (with csrc/common.cuh) and each older source are
compiled by nvcc into a library of their own (scripts/kernel_variants.py):

  --baseline NAME=FILE  another flash_attn_fwd.cu (an earlier commit's, with
                      its own common.cuh beside it) as the library NAME;
                      its tile sets are read from its source (before the
                      S bodies moved onto K1's wgmma bodies: the mma.sync
                      bodies, whose flash_attn_fwd_tiled takes no scratch)

At chip_smoke.py's S shapes (S1_SHAPES, S3_SHAPE, S24_SHAPE) and inputs
made as chip_smoke.phase_s14 makes them, every library runs each S kernel
at each of its own tiles in turns (all libraries in order, then in reverse;
CUDA events, mean of REPS calls after a warm-up, each a launch of the
library's entry with the scratch it asks for). One JSON line per shape and
kernel gives SDPA's ms (scaled_dot_product_attention on the same inputs),
the bound (4 bh s^2 d flop at 989 TFLOP/s, or the bytes), at d=64 the
exponent floor (one ex2 a logit at 16 a clock an SM) and the conversion
floor (chip_smoke.S_CVT_PER_LOGIT), and per library and tile both times, the
max abs error against the plain version over max|plain| and, for S2, the
mean's; "best" names each library's fastest tile. A line before them gives
each library's registers, spills and ptxas advisories of its S kernels
(scripts/kernel_resources.py gives the SASS counts). Needs the card and nvcc.
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

from chip_smoke import (HBM_BYTES_PER_S, MUFU_PER_CLK_SM, PEAK, S1_SHAPES,  # noqa: E402
                        S24_SHAPE, S3_SHAPE, S_CVT_PER_LOGIT, SEED, cuda_ms, sm_clock_hz)
from genpercept_tpu_torch import _build  # noqa: E402
from genpercept_tpu_torch.ops import flash_attention as fa  # noqa: E402
from kernel_variants import build_variants, card  # noqa: E402

# the kernels of the S bodies in ptxas's mangled names: every instantiation
# of the wgmma bodies (the older mma.sync ones by their own names)
S_KERNELS = ("flash_attn_fwd_wgmma_kernel", "flash_attn_fwd_wgmma_d512_kernel",
             "flash_attn_fwd_mma_kernel", "flash_attn_fwd_split_kernel")
REPS = 10


def sources(args) -> dict[str, tuple[str, str]]:
    """{library name: (flash_attn_fwd.cu text, common.cuh text)}"""
    out = {"shipped": ((_build.CSRC / "flash_attn_fwd.cu").read_text(),
                       (_build.CSRC / "common.cuh").read_text())}
    for spec in args.baseline:
        name, _, path = spec.partition("=")
        base = Path(path)
        out[name] = (base.read_text(), (base.parent / "common.cuh").read_text())
    return out


def tiles_of(src: str) -> dict[int, list[tuple[int, int]]]:
    """The (query rows, keys) tiles a source's tiled entries instantiate, by
    head dim: its GP_D64_TILES / GP_D512_TILES macros, or, in a source
    before GP_D512_TILES, its GP_D512(BQ, BK) uses."""
    pair = r"\((\d+), (\d+)(?:, \d+)?\)"
    d64 = re.search(r"#define GP_D64_TILES\(X\) (.*)", src).group(1)
    m512 = re.search(r"#define GP_D512_TILES\(X\) (.*)", src)
    d512 = (re.findall("X" + pair, m512.group(1)) if m512 else
            re.findall(r"(?<!define )GP_D512" + pair, src))
    return {64: [tuple(map(int, t)) for t in re.findall("X" + pair, d64)],
            512: [tuple(map(int, t)) for t in d512]}


def bind(lib, src: str) -> bool:
    """Set the S entries' argument types; True if flash_attn_fwd_tiled takes
    a scratch pointer (K1's key splits at d=512)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sig = re.search(r'extern "C" int flash_attn_fwd_tiled\(([^)]*)\)', src).group(1)
    scratch = "scratch" in sig
    lib.flash_attn_fwd_tiled.argtypes = [p] * (6 if scratch else 5) + [i] * 4 + [f, i, i, i, p]
    lib.flash_attn_fwd_tiled.restype = i
    for name in ("flash_bf16_softmax", "flash_nomax"):
        getattr(lib, name).argtypes = [p, p, p, p, i, i, i, i, f, i, i, p]
        getattr(lib, name).restype = i
    lib.flash_attn_fwd_scratch_bytes.argtypes = [i] * 5
    lib.flash_attn_fwd_scratch_bytes.restype = ctypes.c_longlong
    return scratch


def caller(lib, takes_scratch: bool, kernel: str, q, k, v, bq: int, bk: int, fold: bool, name):
    """A call of one library's S entry at tile (bq, bk) -> (call, out)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    scale = ctypes.c_float(d ** -0.5)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    buffers = []  # lse2 and scratch, alive with the call
    if kernel in ("S1", "S3"):
        buffers.append(torch.empty((bh, sq), dtype=torch.float32, device="cuda"))
        ptrs.append(buffers[-1].data_ptr())
        if takes_scratch:
            nbytes = lib.flash_attn_fwd_scratch_bytes(bh, sq, sk, d, 1)
            buffers.append(torch.empty(nbytes, dtype=torch.uint8, device="cuda")
                           if nbytes else None)
            ptrs.append(None if buffers[-1] is None else buffers[-1].data_ptr())
        entry, tail = lib.flash_attn_fwd_tiled, (bq, bk, int(fold))
    else:
        entry = lib.flash_bf16_softmax if kernel == "S2" else lib.flash_nomax
        tail = (bq, bk)

    def call():
        _build.check(entry(*ptrs, bh, sq, sk, d, scale, *tail, stream), f"{name} {kernel}")
    call.buffers = buffers
    return call, out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_s14: needs a CUDA device")
    print(card(), flush=True)
    srcs = sources(args)
    unit_ms = 1e3 / (MUFU_PER_CLK_SM * torch.cuda.get_device_properties(0).multi_processor_count
                     * sm_clock_hz())
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants("flash_attn_fwd.cu", srcs, Path(tmp))
        scratch = {n: bind(lib, srcs[n][0]) for n, (lib, _) in libs.items()}
        tiles = {n: tiles_of(srcs[n][0]) for n in libs}
        print(json.dumps({"tiles": tiles, "ptxas": {
            n: {k: r for k, r in regs.items() if any(x in k for x in S_KERNELS)}
            for n, (_, regs) in libs.items()}}), flush=True)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
        dt = torch.bfloat16
        runs = [("S1", x) for x in S1_SHAPES] + [("S3", S3_SHAPE), ("S2", S24_SHAPE),
                                                 ("S4", S24_SHAPE)]
        inputs = {}
        for kernel, (bh, s, d) in runs:
            if (bh, s, d) not in inputs:
                inputs.clear()
                torch.cuda.empty_cache()
                inputs[(bh, s, d)] = tuple(torch.randn(bh, s, d, device="cuda", generator=gen)
                                           .to(dt) for _ in range(3))
            q, k, v = inputs[(bh, s, d)]
            logits = bh * s * s
            rec = {"kernel": kernel, "shape": [bh, s, d],
                   "sdpa_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                       q[None], k[None], v[None])[0], REPS),
                   "bound_ms": max(4.0 * logits * d / PEAK["bf16"],
                                   4 * bh * s * d * 2 / HBM_BYTES_PER_S) * 1e3}
            if d == 64:
                rec["exp_floor_ms"] = logits * unit_ms
                rec["cvt_floor_ms"] = S_CVT_PER_LOGIT[kernel] * logits * unit_ms
            folds = (True, False) if kernel == "S3" else (d <= 128,)
            refs = {}
            for name in list(libs) + list(reversed(libs)):
                lib, _ = libs[name]
                got = rec.setdefault(name, {})
                for bq, bk in tiles[name][d]:
                    for fold in folds:
                        key = f"{bq}x{bk}" + (f"_fold{fold}" if kernel == "S3" else "")
                        call, out = caller(lib, scratch[name], kernel, q, k, v, bq, bk, fold,
                                           name)
                        ms = cuda_ms(call, REPS)
                        r = got.setdefault(key, {"ms": []})
                        r["ms"].append(ms)
                        if "rel_err" in r:
                            continue
                        ref_key = bk if kernel == "S2" else None
                        if ref_key not in refs:
                            refs[ref_key] = (fa._flash_bf16_softmax_ref(q, k, v, d ** -0.5, bk)
                                             if kernel == "S2" else
                                             fa._flash_nomax_ref(q, k, v, d ** -0.5)
                                             if kernel == "S4" else
                                             fa._flash_bhsd_ref(q, k, v, d ** -0.5)[0]).float()
                        ref = refs[ref_key]
                        diff = (out.float() - ref).abs()
                        top = ref.abs().max().item()
                        r["rel_err"] = diff.max().item() / top
                        if kernel == "S2":
                            r["mean_rel_err"] = diff.mean().item() / top
                        del diff
            for name in libs:
                got = rec[name]
                got["best"] = min(got, key=lambda t: min(got[t]["ms"]))
            print(json.dumps(rec), flush=True)
            del refs
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
