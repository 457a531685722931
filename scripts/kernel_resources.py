#!/usr/bin/env python3
"""What nvcc made of a kernel source: registers, spills and instruction mix.

    python3 scripts/kernel_resources.py [SOURCE.cu ...] [--match SUBSTRING]

Compiles each source of genpercept_tpu_torch/csrc (default: flash_attn_fwd.cu)
with the package's flags (_build.NVCC_FLAGS) plus ``-Xptxas -v`` into a
temporary directory, disassembles the object with cuobjdump, and prints one
JSON line per kernel whose demangled name contains --match (default: every
kernel):

  kernel          demangled name (template arguments included)
  registers       registers a thread (ptxas)
  spill_stores    bytes of spill stores, and spill_loads, stack_bytes (ptxas)
  static_smem     bytes of static shared memory (ptxas; the dynamic shared
                  memory a launch asks for is not part of the object)
  advisories      ptxas's lines about the kernel's wgmma (e.g. that it
                  serialized them, which loses their pipelining), if any
  sass            counts of SASS instructions in the kernel's code (each
                  instruction once, however often it runs): HMMA (mma.sync)
                  and HGMMA (wgmma) by shape and types (e.g.
                  HMMA.1688.F32.TF32, HGMMA.64x128x16.F32.BF16, K8's f32
                  body's HGMMA.64x128x8.F32.TF32 and its bf16 body's
                  HGMMA.64x256x16.F32.BF16; --match wgmma_kernel keeps the
                  latter; K2's bf16 body at C=640/1280, fused_geglu_ff_fwd.cu
                  --match wide: HGMMA.64x32x16 and 64x160x16), IMMA and
                  IGMMA (their int8 forms, e.g. K6's
                  d=512 body's IGMMA.64x256x32, its d=64 body's
                  IGMMA.64x64x32 and 64x32x32: flash_attn_int8.cu --match
                  d64, K5's IGMMA.64x64x32,
                  64x32x32 and 64x160x32: fused_geglu_ff_int8.cu --match
                  ff_int8_wgmma, K7's IGMMA.64x256x32, 64x128x32, 64x160x32
                  and 64x64x32: quantized_conv3x3.cu --match qconv)
                  likewise, the others
                  by mnemonic without modifiers (FFMA, LDS, LDGSTS = cp.async,
                  UTMALDG = TMA, SYNCS = mbarrier, ...), and the total

Needs nvcc and cuobjdump (the CUDA toolkit), so it runs on the card's
machine, not where only the CPU build of PyTorch is installed.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from genpercept_tpu_torch import _build  # noqa: E402

def _tool(name: str) -> str:
    path = Path(_build._nvcc()).parent / name
    if path.exists():
        return str(path)
    found = shutil.which(name)
    if found is None:
        raise SystemExit(f"kernel_resources: {name} not found")
    return found


def _demangle(names: list[str]) -> dict[str, str]:
    local = Path(_build._nvcc()).parent / "cu++filt"
    tool = str(local) if local.exists() else shutil.which("c++filt")
    if tool is None:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                         check=True).stdout.split("\n")
    return dict(zip(names, out))


def ptxas_info(text: str) -> dict[str, dict]:
    """ptxas -v output -> {mangled name: resources}."""
    info, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            info.setdefault(name, {})  # advisories about it may come first
            continue
        if re.search(r"serializ|wgmma\.|warpgroup\.|Performance Loss", line, re.I):
            m = re.search(r"function '(\S+)'", line)  # the function it names, or the current
            info.setdefault(m.group(1) if m else name, {}).setdefault(
                "advisories", []).append(line.strip())
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            info[name].update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            info[name]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            info[name]["static_smem"] = int(s.group(1)) if s else 0
    return info


def sass_counts(text: str) -> dict[str, collections.Counter]:
    """cuobjdump -sass output -> {mangled name: opcode counts}."""
    counts, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Za-z0-9_.]*)", line)
        if name is None or m is None:
            continue
        op = m.group(1)
        c = counts[name]
        c["total"] += 1
        c[op if op.startswith(("HMMA", "HGMMA", "IMMA", "IGMMA")) else op.split(".")[0]] += 1
    return counts


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*", default=["flash_attn_fwd.cu"])
    ap.add_argument("--match", default="")
    args = ap.parse_args(argv)
    nvcc, cuobjdump = _build._nvcc(), _tool("cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        for src in args.sources:
            obj = Path(tmp) / (Path(src).stem + ".o")
            res = subprocess.run(
                [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj),
                 str(_build.CSRC / src)], capture_output=True, text=True)
            if res.returncode != 0:
                raise SystemExit(f"nvcc failed on {src}:\n{res.stdout}\n{res.stderr}")
            info = ptxas_info(res.stdout + res.stderr)
            sass = sass_counts(subprocess.run([cuobjdump, "-sass", str(obj)], capture_output=True,
                                              text=True, check=True).stdout)
            names = _demangle(sorted(set(info) | set(sass)))
            for mangled, name in sorted(names.items(), key=lambda kv: kv[1]):
                if args.match not in name:
                    continue
                print(json.dumps({"source": src, "kernel": name, **info.get(mangled, {}),
                                  "sass": dict(sorted(sass.get(mangled, {}).items()))}),
                      flush=True)


if __name__ == "__main__":
    main()
