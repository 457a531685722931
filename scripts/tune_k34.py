#!/usr/bin/env python3
"""Tilings of K3/K4's bodies, timed beside the shipped ones and SDPA's backward.

    python3 scripts/tune_k34.py [--dtype f32|bf16] [--tile dq64:4,1,32,3,true ...]
                                [--variant oneacc] [--baseline OLD/flash_attn_bwd.cu]
                                [--shapes all|recipe|long]

Each variant is csrc/flash_attn_bwd.cu (with csrc/common.cuh) compiled by
nvcc into a library of its own (scripts/kernel_variants.py), after one edit
to a copy:

  --tile KD:ARGS   the instantiation of K (dq = K3, dkv = K4) at head dim
                   D with other template arguments (several joined by + make
                   one variant). f32 (launch_f32), e.g. dkv512:1,8,16,2,false:
                   P row parts of 16 rows, S slices of d, C columns a tile, N
                   ring buffers, A (true: A1 and A2 split once into hi and lo
                   in shared memory; false: split at each k step). bf16
                   (launch_mma), e.g. dq64:4,2: RG row groups of 16 rows, N
                   ring buffers (1: loaded by every thread, no ring)
  --variant oneacc f32 only: each column tile's output products summed into
                   dq (dk, dv) in one accumulator over the whole column loop,
                   not into accumulators of their own: the tensor cores
                   truncate every sum into an accumulator, so its error grows
                   with the length (printed; the shipped body's does not)
  --baseline FILE  another flash_attn_bwd.cu (an earlier commit's, with its
                   own common.cuh beside it), as the variant "baseline"

At chip_smoke.py's K3/K4 shapes (K34_RECIPE and K34_768; --shapes recipe for
the first two, long for the two of 9216 tokens), in --dtype (default f32),
every library runs in turns (all variants in order, then in reverse; CUDA
events, mean of 5 calls after a warm-up), and one JSON line per shape gives
SDPA's backward ms and, per library, K3's and K4's times and their errors
(max abs of dq, dk, dv over max|plain|); a line before them gives the
registers and spill bytes ptxas reports for each kernel. K1 (the package's)
makes the forward's out and lse2. Needs the card and nvcc.
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

from chip_smoke import K34_768, K34_RECIPE, cuda_ms  # noqa: E402
from genpercept_tpu_torch import _build  # noqa: E402
from genpercept_tpu_torch.ops import flash_attention as fa  # noqa: E402
from kernel_variants import build_variants, card  # noqa: E402

SHAPES = {"all": [s for s, _ in K34_RECIPE] + K34_768,
          "recipe": [s for s, _ in K34_RECIPE],
          "long": [s for s in K34_768 if s[1] == 9216]}
REPS = 5
# --variant oneacc: the tile's output products go straight into acc1/acc2
SHIPPED_PART = """        float part[kOutTiles][4];
#pragma unroll
        for (int n = 0; n < kOutTiles; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
"""
SHIPPED_ADD = """        float(*acc)[4] = (m ? acc2 : acc1) + n0;
#pragma unroll
        for (int n = 0; n < kOutTiles; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
"""
ONE_ACC = "        float(*part)[4] = (m ? acc2 : acc1) + n0;\n"


def variants(args) -> dict[str, tuple[str, str]]:
    launcher = "launch_f32" if args.dtype == "f32" else "launch_mma"
    src = (_build.CSRC / "flash_attn_bwd.cu").read_text()
    hdr = (_build.CSRC / "common.cuh").read_text()
    out = {"shipped": (src, hdr)}
    for spec in args.tile:
        edited = src
        for part in spec.split("+"):
            m = re.fullmatch(r"(dq|dkv)(\d+):([a-z0-9,]+)", part)
            if m is None:
                raise SystemExit(f"--tile {part}: want dq64:ARGS or dkv512:ARGS")
            dkv = "true" if m.group(1) == "dkv" else "false"
            args_ = m.group(3).replace(",", ", ")
            edited, n = re.subn(rf"{launcher}<{m.group(2)}, [^<>]*, {dkv}>",
                                f"{launcher}<{m.group(2)}, {args_}, {dkv}>", edited)
            if n != 1:
                raise SystemExit(f"--tile {part}: no single shipped instantiation to replace")
        out[re.sub(r"[^a-z0-9]+", "_", spec)] = (edited, hdr)
    for name in args.variant:
        if args.dtype != "f32" or SHIPPED_PART not in src or SHIPPED_ADD not in src:
            raise SystemExit(f"--variant {name}: needs --dtype f32 and the shipped output products")
        out[name] = (src.replace(SHIPPED_PART, ONE_ACC).replace(SHIPPED_ADD, ""), hdr)
    if args.baseline:
        base = Path(args.baseline)
        out["baseline"] = (base.read_text(), (base.parent / "common.cuh").read_text())
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    ap.add_argument("--tile", nargs="*", default=[])
    ap.add_argument("--variant", nargs="*", default=[], choices=["oneacc"])
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--shapes", choices=list(SHAPES), default="all")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_k34: needs a CUDA device")
    dt, code = (torch.float32, 0) if args.dtype == "f32" else (torch.bfloat16, 1)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants("flash_attn_bwd.cu", variants(args), Path(tmp))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for lib, _ in libs.values():
            lib.flash_attn_bwd_dq.argtypes = [p, p, p, p, p, p, p, i, i, i, i, f, i, p]
            lib.flash_attn_bwd_dq.restype = i
            lib.flash_attn_bwd_dkv.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, f, i, p]
            lib.flash_attn_bwd_dkv.restype = i
        print(json.dumps({"ptxas": {n: {k: r for k, r in regs.items() if "flash_attn_bwd_" in k}
                                    for n, (_, regs) in libs.items()}}), flush=True)
        gen = torch.Generator(device="cuda").manual_seed(0)
        stream = torch.cuda.current_stream().cuda_stream
        for bh, s, d in SHAPES[args.shapes]:
            q, k, v, do = (torch.randn(bh, s, d, device="cuda", generator=gen).to(dt)
                           for _ in range(4))
            scale = d ** -0.5
            out, lse = fa._flash_bhsd(q, k, v, scale)
            dsum = (do.float() * out.float()).sum(dim=-1, keepdim=True)
            ref = fa._flash_bwd_bhsd_ref(q, k, v, do, lse, dsum, scale)
            qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
            o_lib = torch.nn.functional.scaled_dot_product_attention(qg[None], kg[None],
                                                                     vg[None])[0]
            rec = {"shape": [bh, s, d], "sdpa_bwd_ms": cuda_ms(
                lambda: torch.autograd.grad(o_lib, (qg, kg, vg), do, retain_graph=True), REPS)}
            del qg, kg, vg, o_lib
            dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
            for name in list(libs) + list(reversed(libs)):
                lib, _ = libs[name]

                def call_dq():
                    _build.check(lib.flash_attn_bwd_dq(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                        dsum.data_ptr(), dq.data_ptr(), bh, s, s, d, ctypes.c_float(scale), code,
                        stream), name)

                def call_dkv():
                    _build.check(lib.flash_attn_bwd_dkv(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                        dsum.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, s, s, d,
                        ctypes.c_float(scale), code, stream), name)

                r = rec.setdefault(name, {"ms_dq": [], "ms_dkv": []})
                r["ms_dq"].append(cuda_ms(call_dq, REPS))
                r["ms_dkv"].append(cuda_ms(call_dkv, REPS))
                r["rel_err"] = [(a.float() - b.float()).abs().max().item()
                                / b.float().abs().max().item()
                                for a, b in zip((dq, dk, dv), ref)]
            print(json.dumps(rec), flush=True)
            del q, k, v, do, out, lse, dsum, ref, dq, dk, dv
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
