#!/usr/bin/env python3
"""Drive the PyTorch port's one-step depth inference and its training step
once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as a JSON line:
  (a) device: the card's name and power limit (nvidia-smi), torch and CUDA
      versions; TF32 is switched off for the f32 phases;
  (b) build: compiles the CUDA kernels from genpercept_tpu_torch/csrc;
  (c) K1 flash attention and (d) K2 fused GEGLU feed-forward against their
      plain PyTorch versions on the card, at the inference path's 768^2
      shapes and the training recipe's, in f32 and bf16: max abs error and
      CUDA-event times;
  (e) the slice at full SD2.1 width (seeded random weights, JAX init scheme):
      a GenPerceptPipeline answers .batch over four 768x768 images
      (batch_size 2) and one __call__ on a 480x640 image, in f32 and bf16,
      with the kernels and under reference_kernels(); launch counts, depth
      deviation kernels-vs-plain, img/s (median and spread of back-to-back
      .batch passes over a few seconds);
  (f) K3 and K4, the flash-attention backward, against their plain version
      at the training recipe's shapes (480x640, micro-batch 8) and at 768^2
      micro-batch 2, in f32 and bf16: errors relative to max|plain|, times;
  (g) training at full width, the main-paper depth recipe (TRAIN_CFG) on
      synthetic 480x640 batches made from SEED: one micro-batch's loss and
      gradients with the kernels and under reference_kernels(), for the mse
      loss alone and for the recipe's losses, in f32 and bf16 (bf16 also
      against the f32 gradients of the same losses), with launch counts and
      the SSI loss's least-square scale per image; the fault check (finite
      gradients, non-zero ones on the flash-routed level-0 attention and
      feed-forward); then Trainer.train for 3 optimizer steps of 4
      micro-batches, with the kernels and again from the same start under
      reference_kernels(): loss per step, ms per step, img/s, peak device
      memory.
Then one JSON line with a record per kernel, and as the last line
{"ok": true, "device": {...}}. Any failed check raises, so the exit code is
not 0. Without a CUDA device it exits 1 before printing anything; without
the repository around it the import fails.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from genpercept_tpu_torch import _build
from genpercept_tpu_torch.data.sampler import DataLoader, MixedBatchSampler
from genpercept_tpu_torch.diffusion import GENPERCEPT_SCHEDULER
from genpercept_tpu_torch.models import (
    AutoencoderKL, CLIPTextModel, UNet2DConditionModel, init_params_)
from genpercept_tpu_torch.ops import flash_attention as fa
from genpercept_tpu_torch.ops import fused_ff as ff
from genpercept_tpu_torch.ops import reference_kernels
from genpercept_tpu_torch.pipeline import (
    GenPerceptModels, GenPerceptPipeline, PipelineConfig)
from genpercept_tpu_torch.train import TrainConfig, build_loss_fn, init_train_state
from genpercept_tpu_torch.train import losses as train_losses
from genpercept_tpu_torch.train.trainer import Trainer

SEED = 0
# main-path K1 shapes per 768^2 image: (bh per image, s, d) -> launches per forward
K1_SHAPES = [((5, 9216, 64), 5), ((10, 2304, 64), 5), ((20, 576, 64), 5),
             ((1, 9216, 512), 2)]
K2_SHAPE, K2_PER_FORWARD = (1, 9216, 320), 5
K1_PER_FORWARD = sum(n for _, n in K1_SHAPES)  # 17
# the training recipe's shapes (480x640, micro-batch 8): K1 at level 0 of the
# UNet and in the VAE's mid blocks, K2 over 8 * 4800 rows; checked against
# plain, not counted in the per-image times; their inputs come from a
# generator of their own, so the 768^2 shapes and the models get the same
# draws as without them
K1_RECIPE = [(40, 4800, 64), (8, 4800, 512)]
K2_RECIPE = (8, 4800, 320)
TOL = {  # kernel vs plain version on the card
    "K1": {torch.float32: 1e-4, torch.bfloat16: 2e-2},  # max abs, out and lse2
    "K2": {torch.float32: 1e-4, torch.bfloat16: 6e-2},  # f32: relative to max|ref|
}
DTYPES = (torch.float32, torch.bfloat16)
# img/s: back-to-back .batch passes over at least this window and count
WINDOW_S, MIN_PASSES = 3.0, 5

# K3/K4 shapes (bh, s, d): the recipe's (480x640, micro-batch 8: level-0 UNet
# self-attention, 5 per micro-step, and the decoder's mid-block attention, 1)
# and 768^2 micro-batch 2's
K34_RECIPE = [((40, 4800, 64), 5), ((8, 4800, 512), 1)]
K34_768 = [(10, 9216, 64), (20, 2304, 64), (40, 576, 64), (2, 9216, 512)]
K34_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # relative to max|plain|

# configs/train/main_paper/depth.yaml through resolve_train_config, written
# out because the card's machine has no PyYAML (a CPU test holds the two equal)
TRAIN_CFG = TrainConfig(
    mode="depth", arch="genpercept", loss_names=("mse", "ssi", "grad"), lr=3e-5,
    lr_total_iter_length=25000, lr_final_ratio=0.01, lr_warmup_steps=100,
    adam_mu_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, remat_unet=True,
    remat_granularity="unet", scheduler=GENPERCEPT_SCHEDULER)
TRAIN_HW, MICRO, ACCUM, STEPS = (480, 640), 8, 4, 3  # the recipe on one card
# launches per micro-step with remat (tests/test_torch_train.py pins them)
STEP_LAUNCHES = {"K1": 14, "K2": 10, "K3": 6, "K4": 6}
# kernels vs reference_kernels(), one micro-batch: the loss's relative
# difference (every check), and the gradients' global relative L2 distance.
# The gradient bounds are on the smooth mse loss; the recipe's gradients are
# reported, not bounded: with random weights the prediction does not
# correlate with the target, so the least-square SSI scale s of some images
# is <= 0 and the SSI loss takes its median-ratio branch, whose gradient
# reaches the prediction through the one pixel that is the median. Which
# pixel that is changes with any change of summation order, and that
# pixel's gradient is a few hundred times the others' (the record counts
# those images). "grads" bounds the distance to the plain path's gradients;
# in bf16, "to_f32" also bounds the distance to the f32 plain path's
# gradients of the same loss, as a multiple of the bf16 plain path's own.
# The bf16 bounds were set from the card's readings (NVIDIA H100 80GB HBM3,
# 700.00 W): grads 1.36e-2, to_f32 0.945 (0.0200 against 0.0212).
GRAD_TOL = {torch.float32: {"loss": 1e-5, "grads": 1e-4},
            torch.bfloat16: {"loss": 1e-2, "grads": 2.5e-2, "to_f32": 1.2}}


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


def recipe_generator() -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(SEED + 1)


def phase_k1(gen: torch.Generator) -> dict:
    worst = {dt: 0.0 for dt in DTYPES}
    per_image = {dt: [0.0, 0.0] for dt in DTYPES}
    rgen = recipe_generator()
    for dt in DTYPES:
        for (bh, s, d), n in K1_SHAPES + [(x, 0) for x in K1_RECIPE]:
            q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen if n else rgen).to(dt)
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
            per_image[dt][0] += n * ms  # 0 for the recipe's shapes
            per_image[dt][1] += n * plain_ms
            del q, k, v, out, lse, ref, ref_lse
    return {"worst": worst, "per_image": per_image}


def phase_k2(gen: torch.Generator) -> dict:
    c = K2_SHAPE[2]
    inner = 4 * c
    w1 = (torch.rand(2 * inner, c, device="cuda", generator=gen) * 2 - 1) / c ** 0.5
    b1 = torch.randn(2 * inner, device="cuda", generator=gen) * 0.1
    w2 = (torch.rand(c, inner, device="cuda", generator=gen) * 2 - 1) / inner ** 0.5
    b2 = torch.randn(c, device="cuda", generator=gen) * 0.1
    worst, per_image = {dt: 0.0 for dt in DTYPES}, {}
    rgen = recipe_generator()
    for dt in DTYPES:
        for (b, s, _), n in ((K2_SHAPE, K2_PER_FORWARD), (K2_RECIPE, 0)):
            x = torch.randn(b, s, c, device="cuda", generator=gen if n else rgen).to(dt)
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
            check(err <= bound, f"K2 {dt} {(b, s, c)}: error {err} > {bound}")
            worst[dt] = max(worst[dt], err)
            if n:
                per_image[dt] = [n * ms, n * plain_ms]
            del x, args, y, ref
    return {"worst": worst, "per_image": per_image}


def build_models(gen: torch.Generator):
    with torch.device("cuda"):
        unet, vae, clip = UNet2DConditionModel(), AutoencoderKL(), CLIPTextModel()
    for m in (unet, vae, clip):
        init_params_(m, gen)
    return unet, vae, clip


def launch_counts():
    return {"K1": fa._flash_bhsd.launches, "K2": ff._fused_geglu_ff_fwd.launches,
            "K3": fa._flash_bwd_dq.launches, "K4": fa._flash_bwd_dkv.launches}


def reset_counts() -> None:
    fa._flash_bhsd.launches = 0
    ff._fused_geglu_ff_fwd.launches = 0
    fa._flash_bwd_dq.launches = 0
    fa._flash_bwd_dkv.launches = 0


def fwd_counts(counts):
    return {k: counts[k] for k in ("K1", "K2")}


def drive(pipe, batch_images, call_image):
    """One .batch and one __call__; returns depth maps and launch counts."""
    reset_counts()
    outs = pipe.batch(batch_images, batch_size=2)
    torch.cuda.synchronize()
    batch_counts = fwd_counts(launch_counts())
    reset_counts()
    call_out = pipe(call_image)
    torch.cuda.synchronize()
    return outs, call_out, batch_counts, fwd_counts(launch_counts())


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


def phase_slice(unet, vae, clip) -> dict:
    rng = np.random.default_rng(SEED)
    batch_images = [(rng.uniform(size=(768, 768, 3)) * 255).astype(np.uint8)
                    for _ in range(4)]
    call_image = (rng.uniform(size=(480, 640, 3)) * 255).astype(np.uint8)
    forwards = len(batch_images) // 2
    # 480x640 -> 576x768 -> 72x96 latent: 6912 tokens at level 0 (flash, 5)
    # and in the VAE (flash, 2); 1728 and 432 at levels 1-2 (plain); 6912
    # rows is no multiple of 512, so the FF stays plain
    call_expect = {"K1": 7, "K2": 0}

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


def phase_k34(gen: torch.Generator) -> dict:
    """K3 and K4 against their plain version on the same inputs and the
    kernel forward's saved output and lse2."""
    # per dtype, over the recipe's shapes: worst max abs error of dq (K3) and
    # of dk, dv (K4); their ms per recipe micro-step, and the plain
    # version's, which computes all three in one pass
    worst = {dt: {"K3": 0.0, "K4": 0.0} for dt in DTYPES}
    per_step = {dt: {"K3": 0.0, "K4": 0.0, "plain": 0.0} for dt in DTYPES}
    for dt in DTYPES:
        for (bh, s, d), n in K34_RECIPE + [(x, 0) for x in K34_768]:
            q, k, v, do = (torch.randn(bh, s, d, device="cuda", generator=gen).to(dt)
                           for _ in range(4))
            scale = d ** -0.5
            out, lse = fa._flash_bhsd(q, k, v, scale)
            dsum = (do.float() * out.float()).sum(dim=-1, keepdim=True)
            ref = fa._flash_bwd_bhsd_ref(q, k, v, do, lse, dsum, scale)
            got = (fa._flash_bwd_dq(q, k, v, do, lse, dsum, scale),
                   *fa._flash_bwd_dkv(q, k, v, do, lse, dsum, scale))
            torch.cuda.synchronize()
            abs_err = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, ref)]
            rel_err = [e / b.float().abs().max().item() for e, b in zip(abs_err, ref)]
            del got, ref
            ms_dq = cuda_ms(lambda: fa._flash_bwd_dq(q, k, v, do, lse, dsum, scale), 5)
            ms_dkv = cuda_ms(lambda: fa._flash_bwd_dkv(q, k, v, do, lse, dsum, scale), 5)
            plain_ms = cuda_ms(lambda: fa._flash_bwd_bhsd_ref(q, k, v, do, lse, dsum, scale), 2)
            emit({"phase": "K3K4", "dtype": str(dt), "shape": [bh, s, d],
                  "rel_err_dq_dk_dv": rel_err, "max_abs_err_dq_dk_dv": abs_err,
                  "ms_dq": ms_dq, "ms_dkv": ms_dkv, "plain_ms": plain_ms})
            check(max(rel_err) <= K34_TOL[dt], f"K3/K4 {dt} {(bh, s, d)}: errors {rel_err}")
            if n:
                worst[dt]["K3"] = max(worst[dt]["K3"], abs_err[0])
                worst[dt]["K4"] = max(worst[dt]["K4"], *abs_err[1:])
                per_step[dt]["K3"] += n * ms_dq
                per_step[dt]["K4"] += n * ms_dkv
                per_step[dt]["plain"] += n * plain_ms
            del q, k, v, do, out, lse, dsum
            torch.cuda.empty_cache()
    return {"worst": worst, "per_step": per_step}


def synthetic_samples(n: int, seed: int) -> list:
    """Training samples in the dataset readers' layout: rgb_norm in [-1, 1],
    a smooth depth_raw_norm in [-1, 1] (low-frequency sinusoids) and a valid
    mask with one contiguous invalid block."""
    h, w = TRAIN_HW
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    out = []
    for _ in range(n):
        f = rng.uniform(0.5, 2.0, 4)
        ph = rng.uniform(0.0, 2 * np.pi, 3)
        depth = (np.sin(2 * np.pi * f[0] * xx + ph[0]) + np.sin(2 * np.pi * f[1] * yy + ph[1])
                 + 0.5 * np.sin(2 * np.pi * (f[2] * xx + f[3] * yy) + ph[2]))
        depth = 2.0 * (depth - depth.min()) / (depth.max() - depth.min()) - 1.0
        mask = np.ones((h, w), bool)
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        mask[y0:y0 + h // 4, x0:x0 + w // 4] = False
        out.append({"rgb_norm": rng.uniform(-1, 1, (h, w, 3)).astype(np.float32),
                    "depth_raw_norm": depth.astype(np.float32), "valid_mask_raw": mask})
    return out


def train_models(unet, vae, embed, frozen_dtype) -> GenPerceptModels:
    """Copies in the Trainer's storage: trainable UNet f32, frozen VAE and
    text embedding in the compute dtype."""
    return GenPerceptModels(unet=copy.deepcopy(unet), vae=copy.deepcopy(vae).to(frozen_dtype),
                            text_embed=embed.to(frozen_dtype))


def loss_and_grads(models, cfg, batch):
    """One micro-batch through build_loss_fn and backward; timesteps from a
    generator seeded with SEED, so both runs draw the same. Also returns the
    least-square SSI scale s of each image (empty without the SSI loss)."""
    trainable, _, _ = init_train_state(models, cfg)
    scales = []
    solve = train_losses.compute_scale_and_shift

    def recording(*args):
        s, t = solve(*args)
        scales.extend(s.detach().float().tolist())
        return s, t

    train_losses.compute_scale_and_shift = recording
    try:
        loss, _ = build_loss_fn(cfg, models)(batch, torch.Generator().manual_seed(SEED))
    finally:
        train_losses.compute_scale_and_shift = solve
    grads = torch.autograd.grad(loss, list(trainable.values()))
    torch.cuda.synchronize()
    return loss.item(), dict(zip(trainable, grads)), scales


def rel_l2(a: dict, b: dict) -> float:
    """Relative L2 distance over all parameters of two {name: gradient} dicts."""
    num = sum(float((a[k].float() - b[k].float()).square().sum()) for k in b)
    return math.sqrt(num / sum(float(b[k].float().square().sum()) for k in b))


def grad_check(unet, vae, embed, batch, dt, losses, bounded: bool, f32_grads=None):
    """One micro-batch's loss and gradients with the kernels and under
    reference_kernels(), launch counts, and the fault check; the gradients
    are held to GRAD_TOL[dt] if bounded, else only reported (the loss always
    is). f32_grads: the f32 plain path's gradients of the same loss, for
    the distances to f32. Returns (record, reference gradients)."""
    cfg = dataclasses.replace(TRAIN_CFG, compute_dtype=dt, loss_names=losses)
    reset_counts()
    loss, grads, ssi_scales = loss_and_grads(train_models(unet, vae, embed, dt), cfg, batch)
    counts = launch_counts()
    # the fault check: finite gradients everywhere, and non-zero ones where
    # the flash attention and the fused feed-forward sit (level 0)
    check(all(bool(torch.isfinite(g).all()) for g in grads.values()),
          f"{dt}: a non-finite gradient")
    level0 = [k for k in grads if (k.startswith(("unet.down_blocks.0.attentions.",
                                                  "unet.up_blocks.3.attentions."))
                                   and k.endswith(("attn1.to_q.weight", "attn1.to_k.weight",
                                                   "attn1.to_v.weight", "ff.net.0.proj.weight")))]
    check(len(level0) == 20 and all(bool(grads[k].abs().max() > 0) for k in level0),
          f"{dt}: zero gradients on the flash-routed level-0 attention / feed-forward")
    reset_counts()
    with reference_kernels():
        r_loss, r_grads, _ = loss_and_grads(train_models(unet, vae, embed, dt), cfg, batch)
    r_counts = launch_counts()
    norms = {k: float(g.float().norm()) for k, g in r_grads.items()}
    top = max(norms.values())
    worst_k, worst = max(((k, float((grads[k].float() - r_grads[k].float()).norm()) / norms[k])
                          for k in grads if norms[k] > 1e-6 * top), key=lambda kv: kv[1])
    rec = {"phase": "train_grad_check", "dtype": str(dt), "losses": losses, "bounded": bounded,
           "images": batch["rgb_norm"].shape[0],
           "loss": loss, "loss_reference": r_loss,
           "loss_rel_diff": abs(loss - r_loss) / abs(r_loss),
           "grad_rel_l2_global": rel_l2(grads, r_grads), "grad_rel_l2_worst": worst,
           "grad_rel_l2_worst_param": worst_k, "ssi_scales": ssi_scales,
           "ssi_median_branch_images": sum(x <= 0 for x in ssi_scales), "launches": counts,
           "launches_reference": r_counts, "level0_grads_nonzero": len(level0)}
    if f32_grads is not None:
        rec["grad_rel_l2_to_f32"] = rel_l2(grads, f32_grads)
        rec["grad_rel_l2_to_f32_reference"] = rel_l2(r_grads, f32_grads)
    emit(rec)
    del grads
    torch.cuda.empty_cache()
    check(counts == STEP_LAUNCHES, f"{dt}: launches per micro-step {counts}")
    check(all(v == 0 for v in r_counts.values()), f"{dt}: kernels under reference_kernels()")
    tol = GRAD_TOL[dt]
    check(rec["loss_rel_diff"] <= tol["loss"], f"{dt}: loss {rec['loss_rel_diff']}")
    if bounded:
        check(rec["grad_rel_l2_global"] <= tol["grads"],
              f"{dt}: gradients {rec['grad_rel_l2_global']}")
    if bounded and "to_f32" in tol:
        check(rec["grad_rel_l2_to_f32"] <= tol["to_f32"] * rec["grad_rel_l2_to_f32_reference"],
              f"{dt}: gradients {rec['grad_rel_l2_to_f32']} from f32, the plain path's "
              f"{rec['grad_rel_l2_to_f32_reference']}")
    return rec, r_grads


def run_trainer(unet, vae, embed, samples) -> dict:
    """Trainer.train for STEPS optimizer steps of ACCUM micro-batches, bf16:
    losses, CUDA-event time of each step, peak memory, launches."""
    cfg = dataclasses.replace(TRAIN_CFG, grad_accum_steps=ACCUM)
    loader = DataLoader(samples, MixedBatchSampler([samples], batch_size=ACCUM * MICRO,
                                                   generator=np.random.default_rng(SEED)))
    models = GenPerceptModels(unet=copy.deepcopy(unet), vae=copy.deepcopy(vae),
                              text_embed=embed.clone())
    with tempfile.TemporaryDirectory() as out_dir:
        trainer = Trainer(cfg, models, loader, out_dir, max_iter=STEPS, save_period=0,
                          main_seed=SEED)
        losses, step_ms = [], []
        step = trainer.step_fn

        def timed(batch, gen):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            metrics = step(batch, gen)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            losses.append(metrics["loss"].item())
            return metrics

        trainer.step_fn = timed
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
    del trainer, models
    torch.cuda.empty_cache()
    ms = float(np.median(step_ms[1:]))
    return {"losses": losses, "step_ms": step_ms, "ms_per_step": ms,
            "img_per_s": ACCUM * MICRO / (ms / 1000.0), "peak_bytes": peak,
            "wall_s_incl_final_checkpoint": wall, "launches": counts}


def phase_train(unet, vae, clip) -> dict:
    samples = synthetic_samples(ACCUM * MICRO, SEED)
    with torch.no_grad():
        embed = GenPerceptModels(unet=unet, vae=vae, clip=clip).get_text_embed()
    batch = {"rgb_norm": np.stack([x["rgb_norm"] for x in samples[:MICRO]]),
             "gt_norm": np.stack([np.repeat(x["depth_raw_norm"][..., None], 3, -1)
                                  for x in samples[:MICRO]]),
             "valid_mask": np.stack([x["valid_mask_raw"] for x in samples[:MICRO]])}
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    checks = {}
    for name, losses, bounded in (("mse", ("mse",), True),
                                  ("recipe", TRAIN_CFG.loss_names, False)):
        checks[f"f32_{name}"], f32_grads = grad_check(unet, vae, embed, batch, torch.float32,
                                                      losses, bounded)
        checks[f"bf16_{name}"], _ = grad_check(unet, vae, embed, batch, torch.bfloat16,
                                               losses, bounded, f32_grads)
        del f32_grads
        torch.cuda.empty_cache()
    run = run_trainer(unet, vae, embed, samples)
    with reference_kernels():
        ref = run_trainer(unet, vae, embed, samples)
    expect = {k: n * ACCUM * STEPS for k, n in STEP_LAUNCHES.items()}
    rec = {"phase": "train_run", "dtype": str(torch.bfloat16), "steps": STEPS,
           "micro_batch": MICRO, "accum": ACCUM, "image_hw": list(TRAIN_HW), **run,
           "reference": ref,
           "loss_abs_diff": [abs(a - b) for a, b in zip(run["losses"], ref["losses"])]}
    emit(rec)
    check(len(run["losses"]) == STEPS and all(math.isfinite(x) for x in run["losses"]),
          f"trainer losses {run['losses']}")
    check(run["launches"] == expect, f"trainer launches {run['launches']} != {expect}")
    check(all(v == 0 for v in ref["launches"].values()), "kernels under reference_kernels()")
    return {"checks": checks, "run": run}


def main() -> None:
    name = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k1 = phase_k1(gen)
    k2 = phase_k2(gen)
    unet, vae, clip = build_models(gen)
    sl = phase_slice(unet, vae, clip)
    k34 = phase_k34(gen)
    tr = phase_train(unet, vae, clip)
    f32, bf16 = torch.float32, torch.bfloat16
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
        {"name": "flash_attn_bwd_dq", "route": "cuda",
         "source": "genpercept_tpu_torch/csrc/flash_attn_bwd.cu",
         "replaces": "genpercept_tpu/ops/flash_attention.py:310",
         "launches": tr["run"]["launches"]["K3"], "max_abs_err": k34["worst"][bf16]["K3"],
         "ms": k34["per_step"][bf16]["K3"], "plain_ms": k34["per_step"][bf16]["plain"]},
        {"name": "flash_attn_bwd_dkv", "route": "cuda",
         "source": "genpercept_tpu_torch/csrc/flash_attn_bwd.cu",
         "replaces": "genpercept_tpu/ops/flash_attention.py:355",
         "launches": tr["run"]["launches"]["K4"], "max_abs_err": k34["worst"][bf16]["K4"],
         "ms": k34["per_step"][bf16]["K4"], "plain_ms": k34["per_step"][bf16]["plain"]},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
