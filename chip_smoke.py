#!/usr/bin/env python3
"""Drive the PyTorch port's one-step depth path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as a JSON line:
  (a) device: the card's name and power limit (nvidia-smi), torch and CUDA
      versions; TF32 is switched off for the f32 phases;
  (b) build: compiles the CUDA kernels from genpercept_tpu_torch/csrc;
  (c) K1 flash attention and (d) K2 fused GEGLU feed-forward against their
      plain PyTorch versions on the card, at the main path's 768^2 shapes,
      in f32 and bf16: max abs error and CUDA-event times;
  (e) the slice at full SD2.1 width (seeded random weights, JAX init scheme):
      a GenPerceptPipeline answers .batch over four 768x768 images
      (batch_size 2) and one __call__ on a 480x640 image, in f32 and bf16,
      with the kernels and under reference_kernels(); launch counts, depth
      deviation kernels-vs-plain, img/s (median and spread of back-to-back
      .batch passes over a few seconds).
Then one JSON line with a record per kernel, and as the last line
{"ok": true, "device": {...}}. Any failed check raises, so the exit code is
not 0. Without a CUDA device it exits 1 before printing anything; without
the repository around it the import fails.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

from genpercept_tpu_torch import _build
from genpercept_tpu_torch.models import (
    AutoencoderKL, CLIPTextModel, UNet2DConditionModel, init_params_)
from genpercept_tpu_torch.ops import flash_attention as fa
from genpercept_tpu_torch.ops import fused_ff as ff
from genpercept_tpu_torch.ops import reference_kernels
from genpercept_tpu_torch.pipeline import (
    GenPerceptModels, GenPerceptPipeline, PipelineConfig)

SEED = 0
# main-path K1 shapes per 768^2 image: (bh per image, s, d) -> launches per forward
K1_SHAPES = [((5, 9216, 64), 5), ((10, 2304, 64), 5), ((20, 576, 64), 5),
             ((1, 9216, 512), 2)]
K2_SHAPE, K2_PER_FORWARD = (1, 9216, 320), 5
K1_PER_FORWARD = sum(n for _, n in K1_SHAPES)  # 17
TOL = {  # kernel vs plain version on the card
    "K1": {torch.float32: 1e-4, torch.bfloat16: 2e-2},  # max abs, out and lse2
    "K2": {torch.float32: 1e-4, torch.bfloat16: 6e-2},  # f32: relative to max|ref|
}
DTYPES = (torch.float32, torch.bfloat16)
# img/s: back-to-back .batch passes over at least this window and count
WINDOW_S, MIN_PASSES = 3.0, 5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean time of fn on the card over reps calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})
    return name


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_seconds,
          "library": str(_build.library_path().relative_to(_build.CSRC.parent.parent))})


def phase_k1(gen: torch.Generator) -> dict:
    worst = {dt: 0.0 for dt in DTYPES}
    per_image = {dt: [0.0, 0.0] for dt in DTYPES}
    for dt in DTYPES:
        for (bh, s, d), n in K1_SHAPES:
            q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen).to(dt)
                       for _ in range(3))
            scale = d ** -0.5
            out, lse = fa._flash_bhsd(q, k, v, scale)
            ref, ref_lse = fa._flash_bhsd_ref(q, k, v, scale)
            torch.cuda.synchronize()
            err_o = (out.float() - ref.float()).abs().max().item()
            err_l = (lse - ref_lse).abs().max().item()
            ms = cuda_ms(lambda: fa._flash_bhsd(q, k, v, scale), 10)
            plain_ms = cuda_ms(lambda: fa._flash_bhsd_ref(q, k, v, scale), 3)
            emit({"phase": "K1", "dtype": str(dt), "shape": [bh, s, d],
                  "max_abs_err_out": err_o, "max_abs_err_lse2": err_l,
                  "ms": ms, "plain_ms": plain_ms})
            check(err_o <= TOL["K1"][dt] and err_l <= TOL["K1"][dt],
                  f"K1 {dt} {(bh, s, d)}: errors {err_o}, {err_l}")
            worst[dt] = max(worst[dt], err_o, err_l)
            per_image[dt][0] += n * ms
            per_image[dt][1] += n * plain_ms
            del q, k, v, out, lse, ref, ref_lse
    return {"worst": worst, "per_image": per_image}


def phase_k2(gen: torch.Generator) -> dict:
    b, s, c = K2_SHAPE
    inner = 4 * c
    w1 = (torch.rand(2 * inner, c, device="cuda", generator=gen) * 2 - 1) / c ** 0.5
    b1 = torch.randn(2 * inner, device="cuda", generator=gen) * 0.1
    w2 = (torch.rand(c, inner, device="cuda", generator=gen) * 2 - 1) / inner ** 0.5
    b2 = torch.randn(c, device="cuda", generator=gen) * 0.1
    worst, per_image = {}, {}
    for dt in DTYPES:
        x = torch.randn(b, s, c, device="cuda", generator=gen).to(dt)
        args = (x, w1.to(dt), b1, w2.to(dt), b2)
        y = ff.fused_geglu_ff(*args)
        ref = ff._fused_geglu_ff_ref(*args)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        ms = cuda_ms(lambda: ff.fused_geglu_ff(*args), 10)
        plain_ms = cuda_ms(lambda: ff._fused_geglu_ff_ref(*args), 10)
        emit({"phase": "K2", "dtype": str(dt), "shape": [b, s, c],
              "max_abs_err": err, "output_max_abs": scale, "ms": ms,
              "plain_ms": plain_ms})
        bound = TOL["K2"][dt] * (scale if dt == torch.float32 else 1.0)
        check(err <= bound, f"K2 {dt}: error {err} > {bound}")
        worst[dt] = err
        per_image[dt] = [K2_PER_FORWARD * ms, K2_PER_FORWARD * plain_ms]
    return {"worst": worst, "per_image": per_image}


def build_models(gen: torch.Generator):
    with torch.device("cuda"):
        unet, vae, clip = UNet2DConditionModel(), AutoencoderKL(), CLIPTextModel()
    for m in (unet, vae, clip):
        init_params_(m, gen)
    return unet, vae, clip


def launch_counts():
    return {"K1": fa._flash_bhsd.launches, "K2": ff.fused_geglu_ff.launches}


def reset_counts() -> None:
    fa._flash_bhsd.launches = 0
    ff.fused_geglu_ff.launches = 0


def drive(pipe, batch_images, call_image):
    """One .batch and one __call__; returns depth maps and launch counts."""
    reset_counts()
    outs = pipe.batch(batch_images, batch_size=2)
    torch.cuda.synchronize()
    batch_counts = launch_counts()
    reset_counts()
    call_out = pipe(call_image)
    torch.cuda.synchronize()
    return outs, call_out, batch_counts, launch_counts()


def throughput(pipe, images) -> dict:
    """img/s of back-to-back .batch passes, each timed with CUDA events, over
    at least WINDOW_S seconds and MIN_PASSES passes: median and spread."""
    rates = []
    stop = time.perf_counter() + WINDOW_S
    while len(rates) < MIN_PASSES or time.perf_counter() < stop:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        pipe.batch(images, batch_size=2)
        end.record()
        end.synchronize()
        rates.append(len(images) / (start.elapsed_time(end) / 1000.0))
    return {"median": float(np.median(rates)), "min": min(rates), "max": max(rates),
            "passes": len(rates)}


def phase_slice(gen: torch.Generator) -> dict:
    rng = np.random.default_rng(SEED)
    batch_images = [(rng.uniform(size=(768, 768, 3)) * 255).astype(np.uint8)
                    for _ in range(4)]
    call_image = (rng.uniform(size=(480, 640, 3)) * 255).astype(np.uint8)
    forwards = len(batch_images) // 2
    # 480x640 -> 576x768 -> 72x96 latent: 6912 tokens at level 0 (flash, 5)
    # and in the VAE (flash, 2); 1728 and 432 at levels 1-2 (plain); 6912
    # rows is no multiple of 512, so the FF stays plain
    call_expect = {"K1": 7, "K2": 0}

    unet, vae, clip = build_models(gen)
    results = {}
    for dt in DTYPES:
        models = GenPerceptModels(
            unet=copy.deepcopy(unet).to(dt), vae=copy.deepcopy(vae).to(dt),
            clip=copy.deepcopy(clip).to(dt))
        pipe = GenPerceptPipeline(models, PipelineConfig(dtype=dt), device="cuda")
        pipe.batch(batch_images[:2], batch_size=2)  # warm-up
        outs, call_out, counts, call_counts = drive(pipe, batch_images, call_image)
        rate = throughput(pipe, batch_images)
        with reference_kernels():
            r_outs, r_call, r_counts, r_call_counts = drive(pipe, batch_images, call_image)
            r_rate = throughput(pipe, batch_images)
        check(counts == {"K1": K1_PER_FORWARD * forwards, "K2": K2_PER_FORWARD * forwards},
              f"{dt} .batch launch counts {counts}")
        check(call_counts == call_expect, f"{dt} __call__ launch counts {call_counts}")
        check(r_counts == {"K1": 0, "K2": 0} and r_call_counts == {"K1": 0, "K2": 0},
              f"{dt} kernels launched under reference_kernels()")
        preds = [o.pred_np for o in outs] + [call_out.pred_np]
        refs = [o.pred_np for o in r_outs] + [r_call.pred_np]
        check(all(p.shape == (768, 768) for p in preds[:4])
              and preds[4].shape == (480, 640), "depth shapes")
        check(all(o.pred_colored.shape == o.pred_np.shape + (3,)
                  for o in outs + [call_out]), "colorized shapes")
        for p in preds + refs:
            check(bool(np.isfinite(p).all()) and p.min() >= 0.0 and p.max() <= 1.0,
                  f"{dt} depth not finite or outside [0, 1]")
        dev = np.concatenate([np.abs(p - r).ravel() for p, r in zip(preds, refs)])
        mean_dev, max_dev = float(dev.mean()), float(dev.max())
        emit({"phase": "slice", "dtype": str(dt), "batch_size": 2,
              "images": len(batch_images), "launches_batch": counts,
              "launches_call_480x640": call_counts,
              "launches_reference": {"batch": r_counts, "call": r_call_counts},
              "mean_abs_dev": mean_dev, "max_abs_dev": max_dev,
              "img_per_s": rate, "img_per_s_reference": r_rate,
              "depth_mean": float(np.mean(preds[0])), "depth_std": float(np.std(preds[0]))})
        bar = 1e-4 if dt == torch.float32 else 1e-2
        check(mean_dev <= bar, f"{dt} slice mean deviation {mean_dev} > {bar}")
        results[dt] = {"counts": counts}
        del models, pipe
        torch.cuda.empty_cache()
    return results


def main() -> None:
    name = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k1 = phase_k1(gen)
    k2 = phase_k2(gen)
    sl = phase_slice(gen)
    f32 = torch.float32
    emit({"kernels": [
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": "genpercept_tpu_torch/csrc/flash_attn_fwd.cu",
         "replaces": "genpercept_tpu/ops/flash_attention.py:39",
         "launches": sl[f32]["counts"]["K1"], "max_abs_err": k1["worst"][f32],
         "ms": k1["per_image"][f32][0], "plain_ms": k1["per_image"][f32][1]},
        {"name": "fused_geglu_ff_fwd", "route": "cuda",
         "source": "genpercept_tpu_torch/csrc/fused_geglu_ff_fwd.cu",
         "replaces": "genpercept_tpu/ops/fused_ff.py:57",
         "launches": sl[f32]["counts"]["K2"], "max_abs_err": k2["worst"][f32],
         "ms": k2["per_image"][f32][0], "plain_ms": k2["per_image"][f32][1]},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
