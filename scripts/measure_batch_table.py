#!/usr/bin/env python3
"""The largest batch GenPerceptPipeline.batch runs on one GPU, per
processing resolution and dtype: the rows of utils/batchsize.py's table.

    python3 scripts/measure_batch_table.py [--res 512 768 1024 1536]
        [--dtype bf16 f32] [--out FILE.json]

Per dtype, builds the SD2.1 modules at full width with seeded random weights
(chip_smoke.build_models: UNet, VAE and the CLIP text tower, all resident,
as a published checkpoint loads them) and a GenPerceptPipeline; per
resolution, runs .batch over n square images of that side with batch_size n.
It guesses n from the peak device memory at n = 1 and 2
(torch.cuda.max_memory_allocated), steps from the guess by a sixteenth of it
until a batch fails, then bisects to the largest n that runs. A batch fails
on torch.cuda.OutOfMemoryError; any other error is recorded and counts as a
failure too. One JSON line per (dtype, resolution): the largest n, its peak
memory, the seconds of its .batch, and every n tried. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import SEED, build_models, phase_device  # noqa: E402
from genpercept_tpu_torch.pipeline import (  # noqa: E402
    GenPerceptModels, GenPerceptPipeline, PipelineConfig)

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def try_batch(pipe, image, n: int) -> dict:
    """One .batch of n copies of image at batch_size n: ok, peak GB, seconds."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        pipe.batch([image] * n, batch_size=n)
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError:
        return {"n": n, "ok": False, "error": "OutOfMemoryError"}
    except RuntimeError as e:  # recorded: a limit other than memory
        return {"n": n, "ok": False, "error": f"{type(e).__name__}: {str(e)[:200]}"}
    finally:
        torch.cuda.empty_cache()
    return {"n": n, "ok": True, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "seconds": time.perf_counter() - t0}


def largest_batch(pipe, res: int) -> dict:
    image = (np.random.default_rng(SEED).uniform(size=(res, res, 3)) * 255).astype(np.uint8)
    tried = [try_batch(pipe, image, 1), try_batch(pipe, image, 2)]
    if not tried[0]["ok"]:
        return {"largest": 0, "tried": tried}
    total = torch.cuda.mem_get_info()[1] / 1e9
    per = max(tried[1].get("peak_gb", total) - tried[0]["peak_gb"], 1e-3)
    guess = max(int((total - tried[0]["peak_gb"]) / per) + 1, 1)
    ok = {t["n"]: t for t in tried if t["ok"]}
    lo = max(ok)
    hi = min((t["n"] for t in tried if not t["ok"]), default=None)
    step = max(guess // 16, 1)
    n = max(guess, lo + 1) if hi is None else None
    while n is not None:  # step up from the guess until a batch fails
        t = try_batch(pipe, image, n)
        tried.append(t)
        if t["ok"]:
            lo, ok[n] = n, t
            n += step
        else:
            hi, n = n, None
    while hi - lo > 1:
        t = try_batch(pipe, image, (lo + hi) // 2)
        tried.append(t)
        if t["ok"]:
            lo, ok[t["n"]] = t["n"], t
        else:
            hi = t["n"]
    return {"largest": lo, "peak_gb": ok[lo]["peak_gb"], "seconds": ok[lo]["seconds"],
            "guess": guess, "tried": tried}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, nargs="+", default=[512, 768, 1024, 1536])
    ap.add_argument("--dtype", nargs="+", choices=sorted(DTYPES), default=["bf16", "f32"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    name = phase_device()
    # the pipeline's defaults, not chip_smoke's TF32 switch (memory is the same)
    torch.backends.cudnn.allow_tf32 = True
    records = []
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    unet, vae, clip = build_models(gen)
    for key in args.dtype:
        dt = DTYPES[key]
        models = GenPerceptModels(unet=unet.to(dt), vae=vae.to(dt), clip=clip.to(dt))
        for res in args.res:
            pipe = GenPerceptPipeline(models, PipelineConfig(dtype=dt, processing_res=res))
            rec = {"dtype": key, "res": res, "device": name, **largest_batch(pipe, res)}
            print(json.dumps(rec), flush=True)
            records.append(rec)
            del pipe
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(records, indent=1))
    table = {}
    for r in records:
        table.setdefault(r["dtype"], {})[r["res"]] = r["largest"]
    print(json.dumps({"table": table, "device": name}), flush=True)


if __name__ == "__main__":
    main()
