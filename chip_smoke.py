#!/usr/bin/env python3
"""Drive the PyTorch port's one-step depth inference, its training step, its
W8A8 int8 inference and its fused-VAE inference once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as a JSON line:
  (a) device: the card's name and power limit (nvidia-smi), torch and CUDA
      versions; TF32 is switched off for the f32 phases;
  (b) build: compiles the CUDA kernels from genpercept_tpu_torch/csrc;
  (c) K1 flash attention and (d) K2 fused GEGLU feed-forward against their
      plain PyTorch versions on the card, at the inference path's 768^2
      shapes, the training recipe's and the VAE mid block's at the
      pipeline's batch of 2 and at 576x768 (K1_D512_MORE), in f32 and bf16:
      max abs error and CUDA-event times (K1's bf16 output also relative to
      max|plain|, and its f32 output at 9216 keys); K1 also at two ragged shapes
      (K1_RAGGED); K2 also at the pipeline's batch of 2 (K2_BATCH) and at
      the card tests' ragged rows (K2_RAGGED), relative to max|plain| in f32
      and, in bf16, also within 2^-6 of max|plain| and with a mean abs error
      within K2_BF16_MEAN_REL_TOL of it, two calls bit for bit equal, beside
      the unfused composition in the same dtype (composition_ms) and with
      the names of its f32 body (split TF32) and its bf16 body (wgmma);
      K1 with the names of the f32 body the library holds (split TF32) and
      of the bf16 bodies at d=64 and d=512 (wgmma); K1 and K2 with the f32
      bound at the split-TF32 rate beside the FFMA rate of the body it
      replaced; K1 at bf16 with
      parent_ms: the mma.sync body K1 ran before its wgmma one, at its tile
      (K1_TILES) through S1's entry at d=64 (which sums l in the PV product
      where K1 summed it apart) and S3's at d=512 (l summed apart, as K1);
  (e) the slice at full SD2.1 width (seeded random weights, JAX init scheme):
      a GenPerceptPipeline answers .batch over four 768x768 images
      (batch_size 2) and one __call__ on a 480x640 image, in f32 and bf16,
      with the kernels and under reference_kernels(); launch counts, depth
      deviation kernels-vs-plain, img/s (median and spread of back-to-back
      .batch passes over a few seconds);
  (f) K3 and K4, the flash-attention backward, against their plain version
      at the training recipe's shapes (480x640, micro-batch 8) and at 768^2
      micro-batch 2, in f32 and bf16, and checked at the card tests' ragged
      lengths (K34_RAGGED): errors relative to max|plain| (bf16: max within
      2e-2 and 2^-6 of it, mean within K34_BF16_MEAN_REL_TOL), times, the
      names of the f32 body (split TF32) and the bf16 d=64 body (wgmma), the
      f32 bound at the split-TF32 rate beside the FFMA rate of the body it
      replaced; per recipe micro-step, K3+K4 ms against SDPA's autograd
      backward;
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
      memory;
  (h) K5 int8 fused GEGLU FF and (i) K6 int8 flash attention against their
      plain versions at the 768^2 path's shapes (and K6 at 480x640's), f32
      and bf16, both bit for bit (error 0.0, and a second call equal to the
      first), with the names of their bodies (int8 wgmma); K5 beside the
      bf16 composition at both shapes and K2 bf16 at C=320, its epilogue
      floor (FP32-pipe operations) beside the bound; K6 beside K1, the
      design's floor (1.5x the function's operations: a max pass per k
      block) beside the bound, and the wrapper's quantization and transpose
      of v;
  (j) W8A8 int8 inference at full width in bf16 (int8_vae, int8_unet,
      int8_unet_ff, int8_vae_attn; asymmetric refined stats, the default
      placement): the first .batch of two natural-like 768x768 images
      calibrates (seconds, launches, the int8 self-check int8_mean_dev <=
      1e-2); then .batch over four and one 480x640 __call__ with the kernels
      and under reference_kernels() on the same calibration (launches, depth
      deviation, int8 img/s beside (e)'s bf16 img/s); a save_calibration ->
      load_calibration round trip into a fresh pipeline gives identical depth;
  (k) K8 fused GroupNorm -> SiLU -> conv3x3 (+ residual) against its plain
      version at every resblock convolution shape of a 768^2 forward (batch
      2), f32 and bf16: max and mean error relative to max|plain| (border
      pixels too; f32 within 2e-5 of it, bf16 within 2e-2 and 2^-6, mean
      within 1e-5), ms of the kernel, of its plain version, of the GroupNorm
      statistics the wrapper computes around it and of the unfused
      composition (GN, SiLU, cuDNN conv, + residual: the yardstick; no
      single PyTorch call computes K8), with the names of the f32 body
      (split TF32 on wgmma) and the bf16 body (wgmma), and the f32 bound at
      the split-TF32 rate beside the FFMA rate of the body it replaced;
  (l) K7 W8A8 conv3x3 against its plain version (quant.qconv_apply) at
      scripts/profile_quant_conv_torch.py's shapes, batch 2, f32 and bf16
      (error 0.0); then K7's path, that script's profile() at batch 2 in
      bf16: K7, qconv_apply and cuDNN bf16 conv ms, launches;
  (m) the fused-VAE slice, PipelineConfig(fused_vae=True), as (e): launches
      (K8 48 per forward), depth deviation kernels-vs-plain and against
      (e)'s unfused output on the same weights, img/s beside (e)'s;
  (n) K2's bf16 body at C=640 and 1280 against its plain version at the
      profiling script's shapes, beside the unfused composition;
  (o) K6 at d=64 (the UNet's heads) against its plain version, f32 and
      bf16 (error 0.0), beside K1's bf16 time at the same shape;
  (p) S1-S4, the attention profiling scripts' kernels, against their plain
      versions at batch 2, bf16: S1 (K1's function at every CTA tile of
      D64_TILES / D512_TILES) at the four UNet/VAE shapes, S3 (d=512, both
      row-sum folds), S2 (the bf16 softmax chain, plain version over the
      tile's key blocks) and S4 (no running max) at (10, 9216, 64); errors,
      kernel, plain and SDPA ms (SDPA computes S1's and S3's function, and
      S2's and S4's up to their rounding and clamp), K1 beside them;
  (q) the two profiling scripts' paths: scripts/profile_unet_torch.py and
      scripts/profile_attn_boundary_torch.py, profile() once per part that
      reaches a kernel (batch 2, fusedff 8), exact launch counts per part
      and no refused configuration.
Every phase's launch counts include K7, K8 and S1-S4 (0 outside their
paths).
K1 and K3+K4 are also timed against one PyTorch call computing the same
function (scaled_dot_product_attention and its autograd backward), which the
port never calls; every kernel's bound is computed from its shapes (PEAK).
Then one JSON line with a record per kernel, and as the last line
{"ok": true, "device": {...}}. Any failed check raises, so the exit code is
not 0. Without a CUDA device it exits 1 before printing anything; without
the repository around it the import fails.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from genpercept_tpu_torch import _build
from genpercept_tpu_torch.data.sampler import DataLoader, MixedBatchSampler
from genpercept_tpu_torch.diffusion import GENPERCEPT_SCHEDULER
from genpercept_tpu_torch.models import (
    AutoencoderKL, CLIPTextModel, UNet2DConditionModel, init_params_)
from genpercept_tpu_torch.ops import conv2d, group_norm
from genpercept_tpu_torch.ops import flash_attention as fa
from genpercept_tpu_torch.ops import fused_conv as fc
from genpercept_tpu_torch.ops import fused_ff as ff
from genpercept_tpu_torch.ops import quant as tq
from genpercept_tpu_torch.ops import quant_conv as qc
from genpercept_tpu_torch.ops import reference_kernels
from genpercept_tpu_torch.pipeline import (
    GenPerceptModels, GenPerceptPipeline, PipelineConfig)
from genpercept_tpu_torch.utils.synthetic import natural_like_images
from genpercept_tpu_torch.train import TrainConfig, build_loss_fn, init_train_state
from genpercept_tpu_torch.train import losses as train_losses
from genpercept_tpu_torch.train.trainer import Trainer

SEED = 0
# main-path K1 shapes per 768^2 image: (bh per image, s, d) -> launches per forward
K1_SHAPES = [((5, 9216, 64), 5), ((10, 2304, 64), 5), ((20, 576, 64), 5),
             ((1, 9216, 512), 2)]
K2_SHAPE, K2_PER_FORWARD = (1, 9216, 320), 5
# the shape the pipeline launches K2 at: a .batch of 2 images, 5 per forward;
# checked and timed, not counted in the per-image times
K2_BATCH = (2, 9216, 320)
K1_PER_FORWARD = sum(n for _, n in K1_SHAPES)  # 17
# the training recipe's shapes (480x640, micro-batch 8): K1 at level 0 of the
# UNet and in the VAE's mid blocks, K2 over 8 * 4800 rows; checked against
# plain, not counted in the per-image times; their inputs come from a
# generator of their own, so the 768^2 shapes and the models get the same
# draws as without them
K1_RECIPE = [(40, 4800, 64), (8, 4800, 512)]
# the VAE mid block's K1 at the pipeline's batch of 2 and at the 480x640
# call's 576x768 (6912 tokens): checked and timed beside SDPA, not counted
K1_D512_MORE = [(2, 9216, 512), (1, 6912, 512)]
# (bh, sq, sk, d) where a key tile is partial and a q tile has rows past Sq:
# JAX's padded-KV test (2 x 3 heads, 256 queries, 77 keys) and a d=512 length
# that is no multiple of 32; checked once each, inputs from the recipe's
# generator after the recipe's shapes
K1_RAGGED = [(6, 256, 77, 64), (2, 1000, 1000, 512)]
K2_RECIPE = (8, 4800, 320)
TOL = {  # kernel vs plain version on the card
    "K1": {torch.float32: 1e-4, torch.bfloat16: 2e-2},  # max abs, out and lse2
    "K2": {torch.float32: 2e-5, torch.bfloat16: 6e-2},  # f32: relative to max|ref|
}
# K1's f32 out at 9216 keys, also relative to max|plain|: |out| is only
# ~0.1 there, so 1e-4 absolute would pass an error that grows with the key
# count (one tensor-core accumulator over every key tile read 7.8e-5)
K1_F32_LONG_REL_TOL = 2e-5
# K1's bf16 out, also relative to max|plain|: a few bf16 ulps of the largest
# output. With randn inputs over thousands of keys |out| is ~0.02, so 2e-2
# alone would pass an error as large as the output itself
K1_BF16_REL_TOL = 2.0 ** -6
# K2's bf16 output, also relative to max|plain| (|out| is ~0.9 at the K2
# inputs): the max within a few bf16 ulps, as K1's; and the mean abs error,
# which a body whose running sum passes through bf16 after each 64-column
# unit of the inner dimension exceeds ~37-fold (CPU model,
# tests/test_torch_fused_ff_bf16.py) while its max stays under both max bars.
# The parent mma.sync body and the wgmma one read 0.8e-6 to 1.4e-6 mean.
K2_BF16_REL_TOL = 2.0 ** -6
K2_BF16_MEAN_REL_TOL = 1e-5
# ragged row counts (the card tests'): checked and timed, not counted
K2_RAGGED = [(1, 96, 320), (1, 1000, 320)]
DTYPES = (torch.float32, torch.bfloat16)
# img/s: back-to-back .batch passes over at least this window and count
WINDOW_S, MIN_PASSES = 3.0, 5

# K3/K4 shapes (bh, s, d): the recipe's (480x640, micro-batch 8: level-0 UNet
# self-attention, 5 per micro-step, and the decoder's mid-block attention, 1)
# and 768^2 micro-batch 2's
K34_RECIPE = [((40, 4800, 64), 5), ((8, 4800, 512), 1)]
K34_768 = [(10, 9216, 64), (20, 2304, 64), (40, 576, 64), (2, 9216, 512)]
K34_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # relative to max|plain|
# bf16 also: the max abs error within 2^-6 of max|plain| (a few bf16 ulps of
# the largest gradient), and the mean abs error within K34_BF16_MEAN_REL_TOL
# of it. CPU model (tests/test_torch_flash_bwd_bf16.py): the body reads
# <= 5e-8 mean; dS left unrounded 1.9e-4-2.1e-4 and dK/dV summed through
# bf16 per tile 3.7e-4-7.2e-4 (both within the max bars at 576 tokens), a
# dropped column tile or K4's lse2/dsum taken by row fail every bar. On the
# card the d=64 wgmma body reads 1e-7 to 7e-7 mean; the d=512 one, one f32
# accumulator over the column loop (tests/test_torch_flash_bwd_d512.py),
# 1.7e-6 to 4.6e-6.
K34_BF16_REL_TOL = 2.0 ** -6
K34_BF16_MEAN_REL_TOL = 2e-5
# ragged lengths (the card tests'): checked, not timed. (bh, sq, sk, d): at
# d=512, fewer rows than a CTA's 64 (sq 40 in K3, sk 77 in K4) and Sq = 77,
# which puts K4's lse2/dsum boxes off 16 bytes
K34_RAGGED = [(3, 200, 77, 64), (1, 130, 300, 64), (2, 256, 256, 64), (3, 77, 200, 64),
              (2, 40, 300, 512), (1, 300, 77, 512), (1, 77, 200, 512)]

# configs/train/main_paper/depth.yaml through resolve_train_config, written
# out because the card's machine has no PyYAML (a CPU test holds the two equal)
TRAIN_CFG = TrainConfig(
    mode="depth", arch="genpercept", loss_names=("mse", "ssi", "grad"), lr=3e-5,
    lr_total_iter_length=25000, lr_final_ratio=0.01, lr_warmup_steps=100,
    adam_mu_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, remat_unet=True,
    remat_granularity="unet", scheduler=GENPERCEPT_SCHEDULER)
TRAIN_HW, MICRO, ACCUM, STEPS = (480, 640), 8, 4, 3  # the recipe on one card
# launches per micro-step with remat (tests/test_torch_train.py pins them)
NO_S = {"S1": 0, "S2": 0, "S3": 0, "S4": 0}  # the profiling scripts' kernels
STEP_LAUNCHES = {"K1": 14, "K2": 10, "K3": 6, "K4": 6, "K5": 0, "K6": 0, "K7": 0, "K8": 0,
                 **NO_S}
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


# W8A8 int8: K5 at the level-0 and level-1 feed-forwards of a 768^2 forward
# at batch 2 ((b, s, c), launches per forward), K6 at the VAE mid blocks
# ((bh, s, d), launches per forward; 6912 tokens: the 480x640 call's)
K5_SHAPES = [((2, 9216, 320), 5), ((2, 2304, 640), 5)]
K6_SHAPES = [((2, 9216, 512), 2), ((1, 6912, 512), 0)]
INT8_TOL = {"K5": {torch.float32: 1e-4, torch.bfloat16: 6e-2},  # f32: of max|plain|
            "K6": {torch.float32: 1e-4, torch.bfloat16: 2e-2}}  # of max|plain|
INT8_CFG = dict(int8_vae=True, int8_unet=True, int8_unet_ff=True, int8_vae_attn=True)
# launches per 768^2 forward on the int8 path, as the JAX package routes
# (tests/test_torch_models.py pins them): the VAE mid blocks take K6 from
# K1, the C=320 and C=640 feed-forwards K5; the calibration pass runs the
# full-precision routing with every FF through the hooks (no K2)
INT8_PER_FORWARD = {"K1": 15, "K2": 0, "K5": 10, "K6": 2, "K7": 0, "K8": 0, **NO_S}
CALIB_PER_FORWARD = {"K1": 17, "K2": 0, "K5": 0, "K6": 0, "K7": 0, "K8": 0, **NO_S}
INT8_CALL_480x640 = {"K1": 5, "K2": 0, "K5": 0, "K6": 2, "K7": 0, "K8": 0, **NO_S}

# K8 (fused GN -> SiLU -> conv3x3) at the resblock convolutions of a 768^2
# forward, batch 2: ((H = W, C, Co, residual), launches per forward); 20 in
# the encoder, 28 in the decoder (tests/test_torch_fused_conv.py pins 48)
K8_SHAPES = [((768, 128, 128, False), 4), ((768, 128, 128, True), 5),
             ((768, 256, 128, False), 1), ((384, 128, 256, False), 1),
             ((384, 256, 256, True), 5), ((384, 256, 256, False), 3),
             ((384, 512, 256, False), 1), ((192, 256, 512, False), 1),
             ((192, 512, 512, True), 5), ((192, 512, 512, False), 4),
             ((96, 512, 512, False), 9), ((96, 512, 512, True), 9)]
K8_PER_FORWARD = sum(n for _, n in K8_SHAPES)  # 48
# of max|plain|, whole output and border pixels. f32: the body runs split
# TF32 on wgmma; 3xTF32 reads 1e-6-5e-6 here, a single TF32 pass ~3e-4 and one
# accumulator over every chunk of C up to 3.7e-5 at C = 512, both past the bar
# (tests/test_torch_fused_conv_f32.py models the two)
K8_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# K8's bf16 output, also of max|plain|, whole output and border pixels: the
# max within a few bf16 ulps, as K1's and K2's; and the mean abs error, which
# a body whose running sum passes through bf16 after each 32-channel chunk
# exceeds ~20-fold while its max stays under both max bars, and which the
# wgmma body's truncating accumulator over all of K = 9 C keeps ~6x under
# (CPU model, tests/test_torch_fused_conv_bf16.py)
K8_BF16_REL_TOL = 2.0 ** -6
K8_BF16_MEAN_REL_TOL = 1e-5
# the fused-VAE slice: launches per 768^2 forward; the 480x640 call (576x768
# processing) passes the predicate at every level
FUSED_PER_FORWARD = {"K1": K1_PER_FORWARD, "K2": K2_PER_FORWARD, "K5": 0, "K6": 0, "K7": 0,
                     "K8": K8_PER_FORWARD, **NO_S}
FUSED_CALL_480x640 = {"K1": 7, "K2": 0, "K5": 0, "K6": 0, "K7": 0, "K8": K8_PER_FORWARD,
                      **NO_S}
K7_BATCH, K7_REPS = 2, 5  # K7's path: profile_quant_conv_torch.profile at batch 2

# the attention profiling scripts' kernels (S1-S4), K6 at d=64 and K2 at the
# wide widths, at the scripts' shapes at batch 2 ((bh, s, d); (b, s, c))
S1_SHAPES = [(10, 9216, 64), (20, 2304, 64), (40, 576, 64), (2, 9216, 512)]
S3_SHAPE = (2, 9216, 512)
S24_SHAPE = (10, 9216, 64)
# of max|plain|: max abs error of S1, S3, S4 2e-2, of S2 2^-7, and S2's mean
# abs error 1e-4 (tests/test_torch_cuda.py states why)
S_TOL = {"S1": 2e-2, "S3": 2e-2, "S4": 2e-2, "S2": 2.0 ** -7}
S2_MEAN_TOL = 1e-4
K6_D64 = [((10, 9216, 64), 1536), ((20, 2304, 64), 2304)]  # the TPU's k blocks
K2_WIDE = [(2, 2304, 640), (8, 576, 1280)]  # 8 x 576: rows a multiple of 512
K2_WIDE_TOL = 6e-2  # absolute, as K2 in bf16
SCRIPT_REPS = 2

# the least time the card could take: NVIDIA H100 SXM data sheet, dense
# rates (bf16 tensor cores, int8 tensor cores, f32 FFMA outside them, and
# TF32 tensor cores at a third of their 495 TFLOP/s for split TF32, whose
# every product is three tf32 products: K1's and K3/K4's f32 bodies) and
# HBM3 bandwidth
PEAK = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "tf32x3": 495e12 / 3}
HBM_BYTES_PER_S = 3.35e12


class Bound:
    """The least time the card could take for some work: the larger of its
    operations over the peak rate and its bytes (each input read once, each
    output written once) over HBM. Work adds up: ``a + b``, ``n * a``."""

    def __init__(self, ops_ms: float = 0.0, bytes_ms: float = 0.0):
        self.ops_ms, self.bytes_ms = ops_ms, bytes_ms

    def __add__(self, other):
        return Bound(self.ops_ms + other.ops_ms, self.bytes_ms + other.bytes_ms)

    def __rmul__(self, n):
        return Bound(n * self.ops_ms, n * self.bytes_ms)

    @property
    def ms(self) -> float:
        return max(self.ops_ms, self.bytes_ms)

    @property
    def by(self) -> str:
        return "operations" if self.ops_ms >= self.bytes_ms else "bytes"


def bound(ops: float, rate: str, nbytes: float) -> Bound:
    return Bound(ops / PEAK[rate] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3)


def elt(dt) -> int:
    return torch.tensor([], dtype=dt).element_size()


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


def sdpa(q, k, v):
    """The one PyTorch call computing K1's function, for library_ms (the
    port never calls it): (BH, S, D) as one batch of BH heads."""
    return torch.nn.functional.scaled_dot_product_attention(q[None], k[None], v[None])[0]


def attn_bytes(bh, s, d, dt, n_in, n_out, n_rows=0) -> int:
    """Bytes of an attention call: n_in + n_out (BH, S, D) tensors of dt
    and n_rows (BH, S) f32 rows (lse2, dsum)."""
    return bh * s * (d * elt(dt) * (n_in + n_out) + 4 * n_rows)


def k1_errors(q, k, v) -> tuple[float, float, float]:
    """K1 against its plain version on the same inputs: max abs error of the
    output and of lse2, and max|plain output|."""
    scale = q.shape[-1] ** -0.5
    out, lse = fa._flash_bhsd(q, k, v, scale)
    ref, ref_lse = fa._flash_bhsd_ref(q, k, v, scale)
    torch.cuda.synchronize()
    return ((out.float() - ref.float()).abs().max().item(), (lse - ref_lse).abs().max().item(),
            ref.float().abs().max().item())


def k1_within(dt, err_o: float, err_l: float, top: float, sk: int = 0) -> bool:
    """K1's errors within its bars: TOL["K1"] absolute, and the output within
    K1_BF16_REL_TOL of max|plain| in bf16, K1_F32_LONG_REL_TOL in f32 at
    9216 keys."""
    rel = K1_BF16_REL_TOL if dt == torch.bfloat16 else K1_F32_LONG_REL_TOL if sk >= 9216 else 1.0
    return err_o <= TOL["K1"][dt] and err_l <= TOL["K1"][dt] and err_o <= rel * top


def phase_k1(gen: torch.Generator) -> dict:
    lib = _build.load()
    body = lib.flash_attn_fwd_f32_body().decode()
    emit({"phase": "K1_f32_body", "body": body})
    check(body.startswith("split TF32"), f"K1's f32 body is {body!r}")
    body = lib.flash_attn_fwd_bf16_body().decode()
    emit({"phase": "K1_bf16_body", "body": body})
    check(body.startswith("wgmma"), f"K1's bf16 body at d=64 is {body!r}")
    body = lib.flash_attn_fwd_bf16_d512_body().decode()
    emit({"phase": "K1_bf16_d512_body", "body": body})
    check(body.startswith("wgmma"), f"K1's bf16 body at d=512 is {body!r}")
    worst = {dt: 0.0 for dt in DTYPES}
    # per 768^2 image and dtype: kernel, plain, bound and library ms
    per_image = {dt: [0.0, 0.0, Bound(), 0.0] for dt in DTYPES}
    rgen = recipe_generator()
    for dt in DTYPES:
        for (bh, s, d), n in K1_SHAPES + [(x, 0) for x in K1_RECIPE + K1_D512_MORE]:
            q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen if n else rgen).to(dt)
                       for _ in range(3))
            scale = d ** -0.5
            err_o, err_l, top = k1_errors(q, k, v)
            ms = cuda_ms(lambda: fa._flash_bhsd(q, k, v, scale), 10)
            plain_ms = cuda_ms(lambda: fa._flash_bhsd_ref(q, k, v, scale), 3)
            library_ms = cuda_ms(lambda: sdpa(q, k, v), 10)
            f32 = dt == torch.float32
            parent_ms = None if f32 else cuda_ms(
                (lambda: fa.flash_with_blocks(q, k, v, scale, *fa.K1_TILES[64])) if d == 64 else
                (lambda: fa.flash_d512_blocks(q, k, v, scale, *fa.K1_TILES[512], False)), 10)
            nbytes = attn_bytes(bh, s, d, dt, 3, 1, 1)
            bd = bound(4.0 * bh * s * s * d, "tf32x3" if f32 else "bf16", nbytes)
            emit({"phase": "K1", "dtype": str(dt), "shape": [bh, s, d],
                  "max_abs_err_out": err_o, "max_abs_err_lse2": err_l,
                  "output_max_abs": top, "rel_err_out": err_o / top,
                  "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                  "bound_ms": bd.ms, "bound_by": bd.by, "parent_ms": parent_ms,
                  # f32: the bound at the FFMA rate of the f32 body this one replaced
                  "bound_ffma_ms": bound(4.0 * bh * s * s * d, "f32", nbytes).ms if f32 else None})
            check(k1_within(dt, err_o, err_l, top, s),
                  f"K1 {dt} {(bh, s, d)}: errors {err_o}, {err_l}, max|plain| {top}")
            worst[dt] = max(worst[dt], err_o, err_l)
            for i, t in enumerate((ms, plain_ms, bd, library_ms)):
                per_image[dt][i] += n * t  # 0 for the recipe's shapes
            del q, k, v
        for bh, sq, sk, d in K1_RAGGED:
            q = torch.randn(bh, sq, d, device="cuda", generator=rgen).to(dt)
            k, v = (torch.randn(bh, sk, d, device="cuda", generator=rgen).to(dt) for _ in range(2))
            err_o, err_l, top = k1_errors(q, k, v)
            emit({"phase": "K1_ragged", "dtype": str(dt), "shape": [bh, sq, sk, d],
                  "max_abs_err_out": err_o, "max_abs_err_lse2": err_l,
                  "output_max_abs": top, "rel_err_out": err_o / top})
            check(k1_within(dt, err_o, err_l, top, sk),
                  f"K1 {dt} ragged {(bh, sq, sk, d)}: errors {err_o}, {err_l}, max|plain| {top}")
            worst[dt] = max(worst[dt], err_o, err_l)
    return {"worst": worst, "per_image": per_image}


def k2_within(dt, err: float, mean: float, top: float) -> bool:
    """K2's errors within its bars: in f32 max abs within TOL["K2"] of
    max|plain|; in bf16 TOL["K2"] absolute, K2_BF16_REL_TOL of max|plain| and
    a mean abs error within K2_BF16_MEAN_REL_TOL of max|plain|."""
    if dt == torch.float32:
        return err <= TOL["K2"][dt] * top
    return (err <= TOL["K2"][dt] and err <= K2_BF16_REL_TOL * top
            and mean <= K2_BF16_MEAN_REL_TOL * top)


def phase_k2(gen: torch.Generator) -> dict:
    lib = _build.load()
    body = lib.fused_geglu_ff_f32_body().decode()
    emit({"phase": "K2_f32_body", "body": body})
    check(body.startswith("split TF32"), f"K2's f32 body is {body!r}")
    body = lib.fused_geglu_ff_bf16_body().decode()
    emit({"phase": "K2_bf16_body", "body": body})
    check(body.startswith("wgmma"), f"K2's bf16 body is {body!r}")
    c = K2_SHAPE[2]
    inner = 4 * c
    w1 = (torch.rand(2 * inner, c, device="cuda", generator=gen) * 2 - 1) / c ** 0.5
    b1 = torch.randn(2 * inner, device="cuda", generator=gen) * 0.1
    w2 = (torch.rand(c, inner, device="cuda", generator=gen) * 2 - 1) / inner ** 0.5
    b2 = torch.randn(c, device="cuda", generator=gen) * 0.1
    worst, per_image = {dt: 0.0 for dt in DTYPES}, {}
    rgen = recipe_generator()
    shapes = [(K2_SHAPE, K2_PER_FORWARD), (K2_BATCH, 0), (K2_RECIPE, 0)] + [
        (shape, 0) for shape in K2_RAGGED]
    for dt in DTYPES:
        for (b, s, _), n in shapes:
            x = torch.randn(b, s, c, device="cuda", generator=gen if n else rgen).to(dt)
            args = (x, w1.to(dt), b1, w2.to(dt), b2)
            y = ff.fused_geglu_ff(*args)
            again = ff.fused_geglu_ff(*args)
            ref = ff._fused_geglu_ff_ref(*args)
            torch.cuda.synchronize()
            diff = (y.float() - ref.float()).abs()
            err, mean = diff.max().item(), diff.mean().item()
            scale = ref.float().abs().max().item()
            ms = cuda_ms(lambda: ff.fused_geglu_ff(*args), 10)
            plain_ms = cuda_ms(lambda: ff._fused_geglu_ff_ref(*args), 10)
            # the unfused feed-forward in x's dtype (TF32 off in f32): the
            # yardstick, as no single PyTorch call computes K2's function
            composition_ms = cuda_ms(lambda: ff._geglu_ff_composition(*args), 10)
            rows = b * s
            f32 = dt == torch.float32
            bd = bound(6.0 * rows * c * inner, "tf32x3" if f32 else "bf16",
                       (2 * rows * c + 3 * c * inner) * elt(dt) + 4 * (2 * inner + c))
            emit({"phase": "K2", "dtype": str(dt), "shape": [b, s, c],
                  "max_abs_err": err, "mean_abs_err": mean, "output_max_abs": scale,
                  "rel_err": err / scale, "mean_rel_err": mean / scale,
                  "repeats": torch.equal(y, again),
                  "ms": ms, "plain_ms": plain_ms, "composition_ms": composition_ms,
                  "bound_ms": bd.ms, "bound_by": bd.by,
                  # f32: the bound at the FFMA rate of the f32 body this one replaced
                  "bound_ffma_ms": bound(6.0 * rows * c * inner, "f32", 0).ms if f32 else None})
            check(k2_within(dt, err, mean, scale),
                  f"K2 {dt} {(b, s, c)}: error {err}, mean {mean}, max|plain| {scale}")
            check(torch.equal(y, again), f"K2 {dt} {(b, s, c)}: two calls differ")
            worst[dt] = max(worst[dt], err)
            if n:
                per_image[dt] = [n * ms, n * plain_ms, n * bd]
            del x, args, y, again, ref, diff
    return {"worst": worst, "per_image": per_image}


def build_models(gen: torch.Generator):
    with torch.device("cuda"):
        unet, vae, clip = UNet2DConditionModel(), AutoencoderKL(), CLIPTextModel()
    for m in (unet, vae, clip):
        init_params_(m, gen)
    return unet, vae, clip


COUNTERS = {"K1": fa._flash_bhsd, "K2": ff._fused_geglu_ff_fwd, "K3": fa._flash_bwd_dq,
            "K4": fa._flash_bwd_dkv, "K5": ff.fused_geglu_ff_int8, "K6": fa._flash_int8_codes,
            "K7": qc.quantized_conv3x3, "K8": fc.fused_gn_silu_conv3x3,
            "S1": fa.flash_with_blocks, "S2": fa.flash_bf16_softmax,
            "S3": fa.flash_d512_blocks, "S4": fa.flash_nomax}


def launch_counts():
    return {k: f.launches for k, f in COUNTERS.items()}


def reset_counts() -> None:
    for f in COUNTERS.values():
        f.launches = 0


def fwd_counts(counts):
    """The counts of the kernels a forward can launch (all but K3, K4)."""
    return {k: n for k, n in counts.items() if k not in ("K3", "K4")}


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


def slice_images():
    """Four 768x768 uniform-noise images and one 480x640, from SEED."""
    rng = np.random.default_rng(SEED)
    batch_images = [(rng.uniform(size=(768, 768, 3)) * 255).astype(np.uint8)
                    for _ in range(4)]
    return batch_images, (rng.uniform(size=(480, 640, 3)) * 255).astype(np.uint8)


def phase_slice(unet, vae, clip) -> dict:
    batch_images, call_image = slice_images()
    forwards = len(batch_images) // 2
    # 480x640 -> 576x768 -> 72x96 latent: 6912 tokens at level 0 (flash, 5)
    # and in the VAE (flash, 2); 1728 and 432 at levels 1-2 (plain); 6912
    # rows is no multiple of 512, so the FF stays plain
    call_expect = {"K1": 7, "K2": 0, "K5": 0, "K6": 0, "K7": 0, "K8": 0, **NO_S}

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
        check(counts == {"K1": K1_PER_FORWARD * forwards, "K2": K2_PER_FORWARD * forwards,
                         "K5": 0, "K6": 0, "K7": 0, "K8": 0, **NO_S},
              f"{dt} .batch launch counts {counts}")
        check(call_counts == call_expect, f"{dt} __call__ launch counts {call_counts}")
        check(not any(r_counts.values()) and not any(r_call_counts.values()),
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
        results[dt] = {"counts": counts, "img_per_s": rate, "preds": preds}
        del models, pipe
        torch.cuda.empty_cache()
    return results


def k34_errors(q, k, v, do, scale):
    """K3 and K4 against their plain version on the same inputs and the
    kernel forward's saved output and lse2: per output (dq, dk, dv) the max
    abs error, and the max and mean abs errors over max|plain|."""
    out, lse = fa._flash_bhsd(q, k, v, scale)
    dsum = (do.float() * out.float()).sum(dim=-1, keepdim=True)
    ref = fa._flash_bwd_bhsd_ref(q, k, v, do, lse, dsum, scale)
    got = (fa._flash_bwd_dq(q, k, v, do, lse, dsum, scale),
           *fa._flash_bwd_dkv(q, k, v, do, lse, dsum, scale))
    torch.cuda.synchronize()
    diffs = [((a.float() - b.float()).abs(), b.float().abs().max().item())
             for a, b in zip(got, ref)]
    return ([d.max().item() for d, _ in diffs], [d.max().item() / top for d, top in diffs],
            [d.mean().item() / top for d, top in diffs], lse, dsum)


def k34_within(dt, rel_err, mean_rel) -> bool:
    """K3/K4's errors within their bars: K34_TOL of max|plain|, and in bf16
    also K34_BF16_REL_TOL of it and a mean within K34_BF16_MEAN_REL_TOL."""
    if dt == torch.float32:
        return max(rel_err) <= K34_TOL[dt]
    return (max(rel_err) <= min(K34_TOL[dt], K34_BF16_REL_TOL)
            and max(mean_rel) <= K34_BF16_MEAN_REL_TOL)


def phase_k34(gen: torch.Generator) -> dict:
    """K3 and K4 against their plain version on the same inputs and the
    kernel forward's saved output and lse2."""
    # per dtype, over the recipe's shapes: worst max abs error of dq (K3) and
    # of dk, dv (K4); their ms per recipe micro-step, and the plain
    # version's, which computes all three in one pass
    lib = _build.load()
    body = lib.flash_attn_bwd_f32_body().decode()
    emit({"phase": "K3K4_f32_body", "body": body})
    check(body.startswith("split TF32"), f"K3/K4's f32 body is {body!r}")
    body = lib.flash_attn_bwd_bf16_body().decode()
    emit({"phase": "K3K4_bf16_body", "body": body})
    check(body.startswith("wgmma"), f"K3/K4's bf16 body at d=64 is {body!r}")
    body = lib.flash_attn_bwd_bf16_d512_body().decode()
    emit({"phase": "K3K4_bf16_d512_body", "body": body})
    check(body.startswith("wgmma"), f"K3/K4's bf16 body at d=512 is {body!r}")
    worst = {dt: {"K3": 0.0, "K4": 0.0} for dt in DTYPES}
    per_step = {dt: {"K3": 0.0, "K4": 0.0, "plain": 0.0, "K3_bound": Bound(), "K4_bound": Bound(),
                     "library": 0.0} for dt in DTYPES}
    for dt in DTYPES:
        for (bh, s, d), n in K34_RECIPE + [(x, 0) for x in K34_768]:
            q, k, v, do = (torch.randn(bh, s, d, device="cuda", generator=gen).to(dt)
                           for _ in range(4))
            scale = d ** -0.5
            abs_err, rel_err, mean_rel, lse, dsum = k34_errors(q, k, v, do, scale)
            ms_dq = cuda_ms(lambda: fa._flash_bwd_dq(q, k, v, do, lse, dsum, scale), 5)
            ms_dkv = cuda_ms(lambda: fa._flash_bwd_dkv(q, k, v, do, lse, dsum, scale), 5)
            plain_ms = cuda_ms(lambda: fa._flash_bwd_bhsd_ref(q, k, v, do, lse, dsum, scale), 2)
            # SDPA's autograd backward (dq, dk, dv from its saved forward)
            qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
            o_lib = sdpa(qg, kg, vg)
            library_ms = cuda_ms(lambda: torch.autograd.grad(o_lib, (qg, kg, vg), do,
                                                             retain_graph=True), 3)
            del qg, kg, vg, o_lib
            # K3: S, dP and dS.K; K4: S, dP, P^T.dO and dS^T.Q (2*S*S*D each);
            # f32 at the split-TF32 rate, the FFMA rate of the body it
            # replaced beside it
            f32 = dt == torch.float32
            ops3, ops4 = 6.0 * bh * s * s * d, 8.0 * bh * s * s * d
            bytes3, bytes4 = attn_bytes(bh, s, d, dt, 4, 1, 2), attn_bytes(bh, s, d, dt, 4, 2, 2)
            rate = "tf32x3" if f32 else "bf16"
            b3, b4 = bound(ops3, rate, bytes3), bound(ops4, rate, bytes4)
            emit({"phase": "K3K4", "dtype": str(dt), "shape": [bh, s, d],
                  "rel_err_dq_dk_dv": rel_err, "max_abs_err_dq_dk_dv": abs_err,
                  "mean_rel_err_dq_dk_dv": mean_rel,
                  "ms_dq": ms_dq, "ms_dkv": ms_dkv, "plain_ms": plain_ms,
                  "library_ms": library_ms, "bound_ms_dq": b3.ms, "bound_ms_dkv": b4.ms,
                  "bound_by": [b3.by, b4.by],
                  "bound_ffma_ms_dq": bound(ops3, "f32", bytes3).ms if f32 else None,
                  "bound_ffma_ms_dkv": bound(ops4, "f32", bytes4).ms if f32 else None})
            check(k34_within(dt, rel_err, mean_rel),
                  f"K3/K4 {dt} {(bh, s, d)}: errors {rel_err}, mean {mean_rel}")
            if n:
                worst[dt]["K3"] = max(worst[dt]["K3"], abs_err[0])
                worst[dt]["K4"] = max(worst[dt]["K4"], *abs_err[1:])
                per_step[dt]["K3"] += n * ms_dq
                per_step[dt]["K4"] += n * ms_dkv
                per_step[dt]["plain"] += n * plain_ms
                per_step[dt]["K3_bound"] += n * b3
                per_step[dt]["K4_bound"] += n * b4
                per_step[dt]["library"] += n * library_ms
            del q, k, v, do, lse, dsum
            torch.cuda.empty_cache()
        rgen = torch.Generator(device="cuda").manual_seed(SEED + 8)  # gen draws as before
        for bh, sq, sk, d in K34_RAGGED:
            q, do = (torch.randn(bh, sq, d, device="cuda", generator=rgen).to(dt) for _ in range(2))
            k, v = (torch.randn(bh, sk, d, device="cuda", generator=rgen).to(dt) for _ in range(2))
            abs_err, rel_err, mean_rel, _, _ = k34_errors(q, k, v, do, d ** -0.5)
            emit({"phase": "K3K4_ragged", "dtype": str(dt), "shape": [bh, sq, sk, d],
                  "rel_err_dq_dk_dv": rel_err, "max_abs_err_dq_dk_dv": abs_err,
                  "mean_rel_err_dq_dk_dv": mean_rel})
            check(k34_within(dt, rel_err, mean_rel),
                  f"K3/K4 {dt} ragged {(bh, sq, sk, d)}: errors {rel_err}, mean {mean_rel}")
        st = per_step[dt]
        emit({"phase": "K3K4_per_step", "dtype": str(dt), "ms_K3": st["K3"], "ms_K4": st["K4"],
              "ms_K3_K4": st["K3"] + st["K4"], "library_ms": st["library"],
              "per_library": (st["K3"] + st["K4"]) / st["library"]})
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


def int8_generator() -> torch.Generator:
    """The int8 phases' inputs, from a generator of their own, so that the
    earlier phases and the models draw what they drew before."""
    return torch.Generator(device="cuda").manual_seed(SEED + 2)


def ff_int8_trees(gen, c: int, x: torch.Tensor):
    """QDense trees of one GEGLU feed-forward (JAX init scheme weights)
    calibrated on its own activations, as make_calib_dense_fn does."""
    inner, dt = 4 * c, x.dtype
    w1 = ((torch.rand(2 * inner, c, device="cuda", generator=gen) * 2 - 1) / c ** 0.5).to(dt)
    b1 = torch.randn(2 * inner, device="cuda", generator=gen) * 0.1
    w2 = ((torch.rand(c, inner, device="cuda", generator=gen) * 2 - 1) / inner ** 0.5).to(dt)
    b2 = torch.randn(c, device="cuda", generator=gen) * 0.1
    stat = tq.mse_optimal_clip_asym(x)
    qh = tq.quantize_dense(w1[:inner], b1[:inner], stat)
    qg = tq.quantize_dense(w1[inner:], b1[inner:], stat)
    a = tq.qdense_apply(qh, x) * torch.nn.functional.gelu(tq.qdense_apply(qg, x))
    return qh, qg, tq.quantize_dense(w2, b2, tq.mse_optimal_clip_asym(a))


# FP32-pipe operations of one hidden element of K5's epilogue, counted from
# its source (scripts/tune_k5.py): its floor at 67 TFLOP/s FFMA (33.5 T
# operations a second) beside the tensor-core bound
K5_EPILOGUE_OPS = 47


def phase_k5() -> dict:
    """K5 against its plain version at the 768^2 forward's two FF shapes
    (batch 2), f32 and bf16: bit for bit (0.0), and again on a second call;
    with the name of its body (int8 wgmma), the epilogue floor beside the
    bound, and as yardsticks K2's bf16 time at the C=320 shape and the bf16
    composition's (the bf16 path's feed-forward) at both."""
    body = _build.load().fused_geglu_ff_int8_body().decode()
    emit({"phase": "K5_body", "body": body})
    check(body.startswith("wgmma"), f"K5 body {body!r}")
    gen = int8_generator()
    worst = {dt: 0.0 for dt in DTYPES}
    per_forward = {dt: [0.0, 0.0, Bound()] for dt in DTYPES}  # kernel, plain ms, bound
    for dt in DTYPES:
        for (b, s, c), n in K5_SHAPES:
            x = (torch.randn(b, s, c, device="cuda", generator=gen) + 0.3).to(dt)
            trees = ff_int8_trees(gen, c, x)
            rows, inner = b * s, 4 * c
            y = ff.fused_geglu_ff_int8(x, *trees)
            again = ff.fused_geglu_ff_int8(x, *trees)
            ref = ff._fused_geglu_ff_int8_ref(x.reshape(rows, c), *trees).reshape(x.shape)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            ms = cuda_ms(lambda: ff.fused_geglu_ff_int8(x, *trees), 10)
            plain_ms = cuda_ms(lambda: ff._fused_geglu_ff_int8_ref(x.reshape(rows, c), *trees), 5)
            bd = bound(6.0 * rows * c * inner, "int8",
                       2 * rows * c * elt(dt) + 3 * c * inner + 4 * (4 * c + 6 * inner))
            # yardsticks in bf16 on the same x: the bf16 composition, and K2
            # (the non-int8 fused kernel) where it has a body (C=320)
            xb = x.to(torch.bfloat16)
            w1 = ((torch.rand(2 * inner, c, device="cuda", generator=gen) * 2 - 1)
                  / c ** 0.5).to(torch.bfloat16)
            w2 = ((torch.rand(c, inner, device="cuda", generator=gen) * 2 - 1)
                  / inner ** 0.5).to(torch.bfloat16)
            rec = {"phase": "K5", "dtype": str(dt), "shape": [b, s, c], "max_abs_err": err,
                   "output_max_abs": scale, "bit_identical": bool(torch.equal(y, ref)),
                   "repeat_bit_identical": bool(torch.equal(y, again)), "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bd.ms, "bound_by": bd.by,
                   "epilogue_floor_ms": rows * inner * K5_EPILOGUE_OPS / (PEAK["f32"] / 2) * 1e3,
                   "composition_bf16_ms": cuda_ms(
                       lambda: ff._geglu_ff_composition(xb, w1, None, w2, None), 10),
                   "library_ms": None}
            if c == 320:
                rec["k2_bf16_ms_same_shape"] = cuda_ms(
                    lambda: ff.fused_geglu_ff(xb, w1, None, w2, None), 10)
            emit(rec)
            bar = INT8_TOL["K5"][dt] * (scale if dt == torch.float32 else 1.0)
            check(err <= bar, f"K5 {dt} {(b, s, c)}: error {err} > {bar}")
            check(err == 0.0, f"K5 {dt} {(b, s, c)}: error {err}, not 0.0")
            check(torch.equal(y, again), f"K5 {dt} {(b, s, c)}: a second call differs")
            worst[dt] = max(worst[dt], err)
            for i, t in enumerate((ms, plain_ms, bd)):
                per_forward[dt][i] += n * t
            del x, xb, w1, w2, trees, y, again, ref
            torch.cuda.empty_cache()
    return {"worst": worst, "per_forward": per_forward}


def phase_k6() -> dict:
    """K6 against its plain version on the same int8 operands at the VAE mid
    blocks' shapes, f32 and bf16 outputs: bit for bit (0.0), and again on a
    second call; with the name of its d=512 body (int8 wgmma), the design's
    floor (its max pass runs Q K^T twice: 1.5x the function's operations)
    beside the function's bound, K1's bf16 time at the same shape and the
    wrapper's operand work in torch (quantization and the transpose of v)."""
    body = _build.load().flash_attn_int8_d512_body().decode()
    emit({"phase": "K6_d512_body", "body": body})
    check(body.startswith("wgmma"), f"K6 d=512 body {body!r}")
    gen = int8_generator()
    worst = {dt: 0.0 for dt in DTYPES}
    per_forward = {dt: [0.0, 0.0, Bound()] for dt in DTYPES}
    for dt in DTYPES:
        for (bh, s, d), n in K6_SHAPES:
            q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen).to(dt)
                       for _ in range(3))
            scale, k_blk = d ** -0.5, fa._int8_k_block(s, s, d)
            ops = fa.int8_operands(q, k, v)
            out = fa._flash_int8_codes(*ops, scale, k_blk, dt)
            ref = fa._flash_int8_ref(*ops, scale, k_blk, dt)
            again = fa._flash_int8_codes(*ops, scale, k_blk, dt)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            rel = err / ref.float().abs().max().item()
            ms = cuda_ms(lambda: fa._flash_int8_codes(*ops, scale, k_blk, dt), 5)
            plain_ms = cuda_ms(lambda: fa._flash_int8_ref(*ops, scale, k_blk, dt), 2)
            quantize_ms = cuda_ms(lambda: fa.int8_operands(q, k, v)[2].transpose(1, 2)
                                  .contiguous(), 5)
            k1_ms = cuda_ms(lambda: fa._flash_bhsd(q, k, v, scale), 5)
            qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
            k1_bf16_ms = cuda_ms(lambda: fa._flash_bhsd(qb, kb, vb, scale), 5)
            bd = bound(4.0 * bh * s * s * d, "int8",
                       bh * s * (3 * d + d * elt(dt) + 8) + 4 * bh * d)
            emit({"phase": "K6", "dtype": str(dt), "shape": [bh, s, d], "k_block": k_blk,
                  "max_abs_err": err, "rel_err": rel, "bit_identical": bool(torch.equal(out, ref)),
                  "repeat_bit_identical": bool(torch.equal(out, again)), "ms": ms,
                  "plain_ms": plain_ms, "quantize_transpose_ms": quantize_ms,
                  "k1_ms_same_shape": k1_ms, "k1_bf16_ms_same_shape": k1_bf16_ms,
                  "bound_ms": bd.ms, "bound_by": bd.by,
                  "design_floor_ms": 1.5 * bd.ops_ms, "library_ms": None})
            check(rel <= INT8_TOL["K6"][dt], f"K6 {dt} {(bh, s, d)}: error {rel}")
            check(err == 0.0, f"K6 {dt} {(bh, s, d)}: error {err}, not 0.0")
            check(torch.equal(out, again), f"K6 {dt} {(bh, s, d)}: a second call differs")
            worst[dt] = max(worst[dt], err)
            for i, t in enumerate((ms, plain_ms, bd)):
                per_forward[dt][i] += n * t
            del q, k, v, qb, kb, vb, ops, out, ref, again
            torch.cuda.empty_cache()
    return {"worst": worst, "per_forward": per_forward}


def phase_int8_slice(unet, vae, clip, fp_img_per_s: dict) -> dict:
    """W8A8 inference in bf16 through GenPerceptPipeline (section (j))."""
    dt = torch.bfloat16
    images = list(natural_like_images(SEED, 4, 768))
    call_image = natural_like_images(SEED + 1, 1, 768)[0][:480, :640]
    forwards = len(images) // 2

    def models():
        return GenPerceptModels(unet=copy.deepcopy(unet).to(dt), vae=copy.deepcopy(vae).to(dt),
                                clip=copy.deepcopy(clip).to(dt))

    cfg = PipelineConfig(dtype=dt, **INT8_CFG)
    pipe = GenPerceptPipeline(models(), cfg, device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    pipe.batch(images[:2], batch_size=2)  # calibration + self-check forward
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    calib_counts = fwd_counts(launch_counts())
    outs, call_out, counts, call_counts = drive(pipe, images, call_image)
    rate = throughput(pipe, images)
    with reference_kernels():
        r_outs, r_call, r_counts, r_call_counts = drive(pipe, images, call_image)
    preds = [o.pred_np for o in outs] + [call_out.pred_np]
    refs = [o.pred_np for o in r_outs] + [r_call.pred_np]
    dev = np.concatenate([np.abs(p - r).ravel() for p, r in zip(preds, refs)])
    n_layers = {g: len(t) for g, t in pipe.vae_quant.items()}
    with tempfile.TemporaryDirectory() as tmp:
        pipe.save_calibration(f"{tmp}/calibration.npz")
        fresh = GenPerceptPipeline(models(), cfg, device="cuda")
        fresh.load_calibration(f"{tmp}/calibration.npz")
    round_trip = [o.pred_np for o in fresh.batch(images, batch_size=2)]
    round_trip_max = max(float(np.abs(a - b).max()) for a, b in zip(round_trip, preds[:4]))
    expect_calib = {k: CALIB_PER_FORWARD[k] + INT8_PER_FORWARD[k] for k in INT8_PER_FORWARD}
    rec = {"phase": "int8_slice", "dtype": str(dt), "config": INT8_CFG,
           "int8_exclude": list(cfg.int8_exclude), "quantized_layers": n_layers,
           "calibration_batch_s": calib_s, "int8_mean_dev": pipe.int8_mean_dev,
           "launches_calibration_batch": calib_counts, "launches_batch": counts,
           "launches_call_480x640": call_counts,
           "launches_reference": {"batch": r_counts, "call": r_call_counts},
           "mean_abs_dev_vs_reference": float(dev.mean()), "max_abs_dev_vs_reference":
           float(dev.max()), "img_per_s": rate, "img_per_s_bf16_no_int8": fp_img_per_s,
           "round_trip_max_abs_diff": round_trip_max,
           "depth_mean": float(np.mean(preds[0])), "depth_std": float(np.std(preds[0]))}
    emit(rec)
    check(calib_counts == expect_calib, f"int8 calibration batch launches {calib_counts}")
    check(counts == {k: n * forwards for k, n in INT8_PER_FORWARD.items()},
          f"int8 .batch launches {counts}")
    check(call_counts == INT8_CALL_480x640, f"int8 __call__ launches {call_counts}")
    check(not any(r_counts.values()) and not any(r_call_counts.values()),
          "kernels launched under reference_kernels()")
    check(all(p.shape == (768, 768) for p in preds[:4]) and preds[4].shape == (480, 640),
          "int8 depth shapes")
    for p in preds + refs:
        check(bool(np.isfinite(p).all()) and p.min() >= 0.0 and p.max() <= 1.0,
              "int8 depth not finite or outside [0, 1]")
    check(pipe.int8_mean_dev is not None and pipe.int8_mean_dev <= 1e-2,
          f"int8_mean_dev {pipe.int8_mean_dev} > 1e-2")
    check(rec["mean_abs_dev_vs_reference"] <= 1e-2,
          f"int8 kernels vs reference_kernels(): {rec['mean_abs_dev_vs_reference']}")
    check(round_trip_max == 0.0, f"calibration round trip changed depth: {round_trip_max}")
    del pipe, fresh
    torch.cuda.empty_cache()
    return {"counts": counts}


def border(t: torch.Tensor) -> torch.Tensor:
    """The outermost rows and columns of an NCHW tensor."""
    return torch.cat([t[..., 0, :], t[..., -1, :], t[..., :, 0], t[..., :, -1]], dim=-1)


def unfused_conv(x, gs, gb, w, b, r):
    """One K8 call's function as the port's unfused resblock runs it: GroupNorm,
    SiLU, cuDNN conv and + residual, each in x's dtype (the yardstick)."""
    y = conv2d(F.silu(group_norm(x, gs, gb, 32, 1e-6)), w, b)
    return y if r is None else y + r


def k8_within(dt, err: float, mean: float, top: float) -> bool:
    """K8's errors (max and mean abs, of the whole output or its border)
    within its bars: K8_TOL of max|plain|, and in bf16 also K8_BF16_REL_TOL
    and a mean within K8_BF16_MEAN_REL_TOL of max|plain|."""
    if dt == torch.float32:
        return err <= K8_TOL[dt] * top
    return (err <= K8_TOL[dt] * top and err <= K8_BF16_REL_TOL * top
            and mean <= K8_BF16_MEAN_REL_TOL * top)


def phase_k8() -> dict:
    """K8 against its plain version on the same inputs and folded statistics
    at every resblock convolution shape of a 768^2 forward (batch 2)."""
    lib = _build.load()
    body = lib.fused_gn_silu_conv3x3_f32_body().decode()
    emit({"phase": "K8_f32_body", "body": body})
    check(body.startswith("split TF32") and "wgmma" in body, f"K8's f32 body is {body!r}")
    body = lib.fused_gn_silu_conv3x3_bf16_body().decode()
    emit({"phase": "K8_bf16_body", "body": body})
    check(body.startswith("wgmma"), f"K8's bf16 body is {body!r}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    worst = {dt: 0.0 for dt in DTYPES}
    # per 768^2 forward and dtype: kernel, plain, bound, statistics, unfused ms,
    # and in f32 the bound at the FFMA rate of the body the split-TF32 one replaced
    per_forward = {dt: [0.0, 0.0, Bound(), 0.0, 0.0, Bound()] for dt in DTYPES}
    for dt in DTYPES:
        for (hw, c, co, res), n in K8_SHAPES:
            def randn(*shape):
                return torch.randn(*shape, device="cuda", generator=gen)

            x = (randn(2, c, hw, hw) * 2 + 0.5).to(dt)
            gs, gb = 1.0 + 0.1 * randn(c), 0.1 * randn(c)
            w = ((torch.rand(co, c, 3, 3, device="cuda", generator=gen) * 2 - 1)
                 / (9 * c) ** 0.5).to(dt)
            b = 0.1 * randn(co)
            r = randn(2, co, hw, hw).to(dt) if res else None
            a, bb = fc.gn_affine(x, gs, gb)
            out = fc.fused_conv_apply(x, a, bb, w, b, r)
            ref = fc._fused_gn_silu_conv3x3_ref(x, a, bb, w, b, r)
            torch.cuda.synchronize()
            d = (out.float() - ref.float()).abs()
            d_border = (border(out).float() - border(ref).float()).abs()
            err, err_border = d.max().item(), d_border.max().item()
            mean, mean_border = d.mean().item(), d_border.mean().item()
            scale = ref.float().abs().max().item()
            del out, ref, d, d_border
            ms = cuda_ms(lambda: fc.fused_conv_apply(x, a, bb, w, b, r), 5)
            plain_ms = cuda_ms(lambda: fc._fused_gn_silu_conv3x3_ref(x, a, bb, w, b, r), 3)
            stats_ms = cuda_ms(lambda: fc.gn_affine(x, gs, gb), 5)
            unfused_ms = cuda_ms(lambda: unfused_conv(x, gs, gb, w, b, r), 5)
            # x, residual and output once, the weight, a, b and the bias
            nbytes = ((c + co * (2 if res else 1)) * 2 * hw * hw + 9 * c * co) * elt(dt) \
                + 4 * (4 * c + co)
            f32 = dt == torch.float32
            ops = 2.0 * 9 * 2 * hw * hw * c * co
            bd = bound(ops, "tf32x3" if f32 else "bf16", nbytes)
            bd_ffma = bound(ops, "f32", nbytes) if f32 else Bound()
            emit({"phase": "K8", "dtype": str(dt), "shape": [2, c, hw, hw], "co": co,
                  "residual": res, "launches_per_forward": n, "max_abs_err": err,
                  "max_abs_err_border": err_border, "output_max_abs": scale,
                  "rel_err": err / scale, "rel_err_border": err_border / scale,
                  "mean_rel_err": mean / scale, "mean_rel_err_border": mean_border / scale,
                  "ms": ms,
                  "plain_ms": plain_ms, "stats_ms": stats_ms, "unfused_ms": unfused_ms,
                  "bound_ms": bd.ms, "bound_by": bd.by,
                  "bound_ffma_ms": bd_ffma.ms if f32 else None, "library_ms": None})
            check(k8_within(dt, err, mean, scale) and k8_within(dt, err_border, mean_border, scale),
                  f"K8 {dt} {(hw, c, co, res)}: errors {err}, {err_border}, means {mean}, "
                  f"{mean_border}, max|plain| {scale}")
            worst[dt] = max(worst[dt], err)
            for i, t in enumerate((ms, plain_ms, bd, stats_ms, unfused_ms, bd_ffma)):
                per_forward[dt][i] += n * t
            del x, r, a, bb
            torch.cuda.empty_cache()
        k, p, bd, st, un, bd_ffma = per_forward[dt]
        emit({"phase": "K8_per_forward", "dtype": str(dt), "launches": K8_PER_FORWARD,
              "ms": k, "plain_ms": p, "stats_ms": st, "unfused_ms": un, "bound_ms": bd.ms,
              "bound_by": bd.by,
              "bound_ffma_ms": bd_ffma.ms if dt == torch.float32 else None})
    return {"worst": worst, "per_forward": per_forward}


def load_script(name: str):
    """A module of scripts/ by file name (the directory is no package)."""
    path = Path(__file__).resolve().parent / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_k7() -> dict:
    """K7 against its plain version at the profiling script's shapes (batch
    2), f32 and bf16; then K7's path, the script's profile() at batch 2."""
    pq = load_script("profile_quant_conv_torch")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    worst = {dt: 0.0 for dt in DTYPES}
    for dt in DTYPES:
        for h, w, c, co in pq.SHAPES:
            x = torch.randn(K7_BATCH, c, h, w, device="cuda", generator=gen).to(dt)
            wf = torch.randn(co, c, 3, 3, device="cuda", generator=gen) * 0.05
            b = torch.randn(co, device="cuda", generator=gen) * 0.1
            q = tq.quantize_conv(wf, b, tq.absmax_per_channel(x.movedim(1, -1)), margin=1.0)
            out = qc.quantized_conv3x3(x, q.w_int8, q.inv_a, q.o_scale, q.bias)
            ref = qc._quantized_conv3x3_ref(x, q.w_int8, q.inv_a, q.o_scale, q.bias)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            emit({"phase": "K7", "dtype": str(dt), "shape": [K7_BATCH, c, h, w], "co": co,
                  "max_abs_err": err, "bit_identical": bool(torch.equal(out, ref))})
            check(err == 0.0, f"K7 {dt} {(h, w, c, co)}: error {err}")
            worst[dt] = max(worst[dt], err)
            del x, wf, q, out, ref
            torch.cuda.empty_cache()
    reset_counts()
    records = pq.profile(batch=K7_BATCH, reps=K7_REPS, seed=SEED)
    torch.cuda.synchronize()
    counts = launch_counts()
    total = {"ms": 0.0, "plain_ms": 0.0, "cudnn_bf16_ms": 0.0, "bound": Bound()}
    for rec in records:
        nb, h, w, c, co = rec["shape"]
        bd = bound(2.0 * 9 * nb * h * w * c * co, "int8",
                   nb * h * w * (c + co) * 2 + 9 * c * co + 4 * (c + 2 * co))
        emit({"phase": "K7_path", **rec, "bound_ms": bd.ms, "bound_by": bd.by,
              "library_ms": None})
        total["ms"] += rec["k7_ms"]
        total["plain_ms"] += rec["qconv_apply_ms"]
        total["cudnn_bf16_ms"] += rec["cudnn_bf16_ms"]
        total["bound"] += bd
    expect = {k: 0 for k in COUNTERS}
    expect["K7"] = len(records) * (1 + K7_REPS)
    emit({"phase": "K7_path_launches", "launches": counts,
          **{k: v for k, v in total.items() if k != "bound"}, "bound_ms": total["bound"].ms})
    check(counts == expect, f"K7 path launches {counts} != {expect}")
    return {"worst": worst, "counts": counts, **total}


def phase_fused_slice(unet, vae, clip, unfused: dict) -> dict:
    """PipelineConfig(fused_vae=True) at full width, as phase_slice, beside
    phase_slice's unfused output on the same weights and images."""
    batch_images, call_image = slice_images()
    forwards = len(batch_images) // 2
    results = {}
    for dt in DTYPES:
        models = GenPerceptModels(
            unet=copy.deepcopy(unet).to(dt), vae=copy.deepcopy(vae).to(dt),
            clip=copy.deepcopy(clip).to(dt))
        pipe = GenPerceptPipeline(models, PipelineConfig(dtype=dt, fused_vae=True), device="cuda")
        pipe.batch(batch_images[:2], batch_size=2)  # warm-up
        outs, call_out, counts, call_counts = drive(pipe, batch_images, call_image)
        rate = throughput(pipe, batch_images)
        with reference_kernels():
            r_outs, r_call, r_counts, r_call_counts = drive(pipe, batch_images, call_image)
        preds = [o.pred_np for o in outs] + [call_out.pred_np]
        refs = [o.pred_np for o in r_outs] + [r_call.pred_np]
        check(all(p.shape == (768, 768) for p in preds[:4])
              and preds[4].shape == (480, 640), "fused depth shapes")
        for p in preds + refs:
            check(bool(np.isfinite(p).all()) and p.min() >= 0.0 and p.max() <= 1.0,
                  f"{dt} fused depth not finite or outside [0, 1]")
        dev = np.concatenate([np.abs(p - r).ravel() for p, r in zip(preds, refs)])
        dev_unf = np.concatenate([np.abs(p - u).ravel()
                                  for p, u in zip(preds, unfused[dt]["preds"])])
        rec = {"phase": "fused_slice", "dtype": str(dt), "batch_size": 2,
               "images": len(batch_images), "launches_batch": counts,
               "launches_call_480x640": call_counts,
               "launches_reference": {"batch": r_counts, "call": r_call_counts},
               "mean_abs_dev": float(dev.mean()), "max_abs_dev": float(dev.max()),
               "mean_abs_dev_vs_unfused": float(dev_unf.mean()),
               "max_abs_dev_vs_unfused": float(dev_unf.max()),
               "img_per_s": rate, "img_per_s_unfused": unfused[dt]["img_per_s"],
               "depth_mean": float(np.mean(preds[0])), "depth_std": float(np.std(preds[0]))}
        emit(rec)
        check(counts == {k: n * forwards for k, n in FUSED_PER_FORWARD.items()},
              f"{dt} fused .batch launch counts {counts}")
        check(call_counts == FUSED_CALL_480x640, f"{dt} fused __call__ launch counts {call_counts}")
        check(not any(r_counts.values()) and not any(r_call_counts.values()),
              f"{dt} kernels launched under reference_kernels()")
        bar = 1e-4 if dt == torch.float32 else 1e-2
        check(rec["mean_abs_dev"] <= bar, f"{dt} fused slice mean deviation {dev.mean()} > {bar}")
        results[dt] = {"counts": counts, "img_per_s": rate}
        del models, pipe
        torch.cuda.empty_cache()
    return results


def phase_k2_wide() -> None:
    """K2's bf16 body at C=640 and 1280 against its plain version, beside
    the unfused composition (no single PyTorch call computes K2)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    dt = torch.bfloat16
    for b, s, c in K2_WIDE:
        inner, rows = 4 * c, b * s
        x = torch.randn(b, s, c, device="cuda", generator=gen).to(dt)
        w1 = ((torch.rand(2 * inner, c, device="cuda", generator=gen) * 2 - 1) / c ** 0.5).to(dt)
        b1 = torch.randn(2 * inner, device="cuda", generator=gen) * 0.1
        w2 = ((torch.rand(c, inner, device="cuda", generator=gen) * 2 - 1) / inner ** 0.5).to(dt)
        b2 = torch.randn(c, device="cuda", generator=gen) * 0.1
        args = (x, w1, b1, w2, b2)
        y = ff.fused_geglu_ff(*args)
        ref = ff._fused_geglu_ff_ref(*args)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        ms = cuda_ms(lambda: ff.fused_geglu_ff(*args), 10)
        plain_ms = cuda_ms(lambda: ff._fused_geglu_ff_ref(*args), 5)
        composition_ms = cuda_ms(lambda: ff._geglu_ff_composition(*args), 10)
        bd = bound(6.0 * rows * c * inner, "bf16",
                   (2 * rows * c + 3 * c * inner) * elt(dt) + 4 * (2 * inner + c))
        emit({"phase": "K2_wide", "dtype": str(dt), "shape": [b, s, c], "max_abs_err": err,
              "output_max_abs": ref.float().abs().max().item(), "ms": ms, "plain_ms": plain_ms,
              "composition_ms": composition_ms, "bound_ms": bd.ms, "bound_by": bd.by,
              "library_ms": None})
        check(err <= K2_WIDE_TOL, f"K2 {(b, s, c)}: error {err} > {K2_WIDE_TOL}")
        del x, w1, w2, args, y, ref


def phase_k6_d64() -> None:
    """K6 at the UNet's head dim against its plain version on the same int8
    operands, f32 and bf16 outputs: bit-identical, as at d=512."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    for dt in DTYPES:
        for (bh, s, d), k_blk in K6_D64:
            q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen).to(dt)
                       for _ in range(3))
            scale = d ** -0.5
            check(fa._int8_k_block(s, s, d) == k_blk, f"K6 d=64 k block at {s}")
            ops = fa.int8_operands(q, k, v)
            out = fa._flash_int8_codes(*ops, scale, k_blk, dt)
            ref = fa._flash_int8_ref(*ops, scale, k_blk, dt)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ms = cuda_ms(lambda: fa._flash_int8_codes(*ops, scale, k_blk, dt), 5)
            plain_ms = cuda_ms(lambda: fa._flash_int8_ref(*ops, scale, k_blk, dt), 2)
            qb = q.to(torch.bfloat16)
            k1_ms = cuda_ms(lambda: fa._flash_bhsd(qb, qb, qb, scale), 5)
            bd = bound(4.0 * bh * s * s * d, "int8",
                       bh * s * (3 * d + d * elt(dt) + 8) + 4 * bh * d)
            emit({"phase": "K6_d64", "dtype": str(dt), "shape": [bh, s, d], "k_block": k_blk,
                  "max_abs_err": err, "bit_identical": bool(torch.equal(out, ref)), "ms": ms,
                  "plain_ms": plain_ms, "k1_bf16_ms_same_shape": k1_ms, "bound_ms": bd.ms,
                  "bound_by": bd.by, "library_ms": None})
            check(err == 0.0, f"K6 d=64 {dt} {(bh, s, d)}: error {err}")
            del q, k, v, ops, out, ref, qb
            torch.cuda.empty_cache()


def phase_s14() -> dict:
    """S1-S4 against their plain versions at the scripts' shapes, batch 2,
    bf16; per kernel the sums over its configurations of the kernel, plain
    and SDPA ms and of the bounds."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    dt = torch.bfloat16
    total = {n: {"worst": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound": Bound()}
             for n in ("S1", "S2", "S3", "S4")}

    def run(name, shape, tile, fn, ref, plain_ms, library_ms, bd, extra=None):
        out = fn()
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        err, mean = diff.max().item(), diff.mean().item()
        top = ref.float().abs().max().item()
        bar = S_TOL[name] * top
        ms = cuda_ms(fn, 5)
        emit({"phase": name, "dtype": str(dt), "shape": list(shape), "tile": list(tile),
              **(extra or {}), "max_abs_err": err, "rel_err": err / top,
              "mean_rel_err": mean / top, "bar": bar, "ms": ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "bound_ms": bd.ms, "bound_by": bd.by})
        check(err <= bar, f"{name} {shape} {tile} {extra}: error {err} > {bar}")
        if name == "S2":
            check(mean <= S2_MEAN_TOL * top, f"S2 {tile}: mean error {mean / top} of max")
        t = total[name]
        t["worst"] = max(t["worst"], err)
        t["ms"] += ms
        t["plain_ms"] += plain_ms
        t["library_ms"] += library_ms
        t["bound"] += bd

    for bh, s, d in S1_SHAPES:
        q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen).to(dt) for _ in range(3))
        scale = d ** -0.5
        ref = fa._flash_bhsd_ref(q, k, v, scale)[0]
        plain_ms = cuda_ms(lambda: fa._flash_bhsd_ref(q, k, v, scale), 2)
        library_ms = cuda_ms(lambda: sdpa(q, k, v), 5)
        k1_ms = cuda_ms(lambda: fa._flash_bhsd(q, k, v, scale), 5)
        # K1_TILES: the mma.sync tile K1 ran before its wgmma bodies
        emit({"phase": "S_K1_baseline", "shape": [bh, s, d],
              "mma_sync_tile": list(fa.K1_TILES[d]),
              "k1_ms": k1_ms, "plain_ms": plain_ms, "library_ms": library_ms})
        bd = bound(4.0 * bh * s * s * d, "bf16", attn_bytes(bh, s, d, dt, 3, 1, 1))
        for bq, bk in (fa.D64_TILES if d == 64 else fa.D512_TILES):
            run("S1", (bh, s, d), (bq, bk),
                lambda: fa.flash_with_blocks(q, k, v, scale, bq, bk), ref, plain_ms,
                library_ms, bd)
        if (bh, s, d) == S3_SHAPE:
            for bq, bk in fa.D512_TILES:
                for fold in (True, False):
                    run("S3", (bh, s, d), (bq, bk),
                        lambda: fa.flash_d512_blocks(q, k, v, scale, bq, bk, fold), ref,
                        plain_ms, library_ms, bd, {"fold": fold})
        del q, k, v, ref
        torch.cuda.empty_cache()

    bh, s, d = S24_SHAPE
    q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen).to(dt) for _ in range(3))
    scale = d ** -0.5
    library_ms = cuda_ms(lambda: sdpa(q, k, v), 5)
    bd = bound(4.0 * bh * s * s * d, "bf16", attn_bytes(bh, s, d, dt, 3, 1))
    for bq, bk in fa.D64_TILES:
        ref = fa._flash_bf16_softmax_ref(q, k, v, scale, bk)
        plain_ms = cuda_ms(lambda: fa._flash_bf16_softmax_ref(q, k, v, scale, bk), 2)
        run("S2", (bh, s, d), (bq, bk), lambda: fa.flash_bf16_softmax(q, k, v, scale, bq, bk),
            ref, plain_ms, library_ms, bd)
    ref = fa._flash_nomax_ref(q, k, v, scale)
    plain_ms = cuda_ms(lambda: fa._flash_nomax_ref(q, k, v, scale), 2)
    for bq, bk in fa.D64_TILES:
        run("S4", (bh, s, d), (bq, bk), lambda: fa.flash_nomax(q, k, v, scale, bq, bk),
            ref, plain_ms, library_ms, bd)
    del q, k, v, ref
    torch.cuda.empty_cache()
    return total


def script_runs():
    """(script, part, batch, launches expected of one profile() call): each
    op is called once to warm up and SCRIPT_REPS times timed."""
    n = 1 + SCRIPT_REPS
    t64, t512 = len(fa.D64_TILES), len(fa.D512_TILES)
    unet, attn = "profile_unet_torch", "profile_attn_boundary_torch"
    return [
        (unet, "flash", 2, {"K1": 3 * n}),
        (unet, "blocks", 2, {"S1": t64 * n}),
        (unet, "blocks2304", 2, {"S1": t64 * n}),
        (unet, "blocks576", 2, {"S1": t64 * n}),
        (unet, "blocks512", 2, {"S1": t512 * n}),
        (unet, "bf16softmax", 2, {"S2": t64 * n}),
        # feed_forward ("xla") takes K2 at C=320 only; fused_geglu_ff at all three
        (unet, "fusedff", 8, {"K2": 4 * n}),
        (unet, "int8ff", 2, {"K5": 2 * n, "K2": 3 * n}),
        (unet, "int8flash", 2, {"K6": 2 * n, "K1": 2 * n}),
        (attn, "flash512", 2, {"K1": n}),
        (attn, "sweep512", 2, {"S3": 2 * t512 * n}),
        (attn, "nomax", 2, {"S4": t64 * n}),
    ]


def phase_scripts() -> dict:
    """The two profiling scripts' paths: profile() once per part that reaches
    a kernel, with exact launch counts; returns the launches of S1-S4."""
    mods = {}
    launched = {k: 0 for k in COUNTERS}
    for script, part, batch, want in script_runs():
        mod = mods.setdefault(script, load_script(script))
        reset_counts()
        t0 = time.perf_counter()
        records = mod.profile(part, batch=batch, reps=SCRIPT_REPS, seed=SEED)
        torch.cuda.synchronize()
        counts = launch_counts()
        expect = {k: want.get(k, 0) for k in COUNTERS}
        errors = [r for r in records if "error" in r]
        emit({"phase": "script_path", "script": f"scripts/{script}.py", "part": part,
              "batch": batch, "reps": SCRIPT_REPS, "seconds": time.perf_counter() - t0,
              "launches": counts, "records": records})
        check(not errors, f"{script} {part}: refused configurations {errors}")
        check(counts == expect, f"{script} {part}: launches {counts} != {expect}")
        for k, v in counts.items():
            launched[k] += v
        torch.cuda.empty_cache()
    return launched


def kernel_record(name, source, replaces, launches, max_abs_err, ms, plain_ms, bd: Bound,
                  library_ms):
    return {"name": name, "route": "cuda", "source": f"genpercept_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": max_abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bd.ms, "bound_by": bd.by,
            "library_ms": library_ms}


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
    k5 = phase_k5()
    k6 = phase_k6()
    i8 = phase_int8_slice(unet, vae, clip, sl[bf16]["img_per_s"])
    k8 = phase_k8()
    k7 = phase_k7()
    fv = phase_fused_slice(unet, vae, clip, sl)
    phase_k2_wide()
    phase_k6_d64()
    s14 = phase_s14()
    paths = phase_scripts()
    # per 768^2 image (K1, K2: f32), per recipe micro-step (K3, K4: bf16),
    # per 768^2 forward of batch 2 (K5, K6, K8: bf16), per pass of K7's path
    # over its five shapes at batch 2 (bf16)
    k1_img, k2_img, k34_step = k1["per_image"][f32], k2["per_image"][f32], k34["per_step"][bf16]
    emit({"kernels": [
        kernel_record("flash_attn_fwd", "flash_attn_fwd.cu",
                      "genpercept_tpu/ops/flash_attention.py:39", sl[f32]["counts"]["K1"],
                      k1["worst"][f32], k1_img[0], k1_img[1], k1_img[2], k1_img[3]),
        kernel_record("fused_geglu_ff_fwd", "fused_geglu_ff_fwd.cu",
                      "genpercept_tpu/ops/fused_ff.py:57", sl[f32]["counts"]["K2"],
                      k2["worst"][f32], k2_img[0], k2_img[1], k2_img[2], None),
        kernel_record("flash_attn_bwd_dq", "flash_attn_bwd.cu",
                      "genpercept_tpu/ops/flash_attention.py:310", tr["run"]["launches"]["K3"],
                      k34["worst"][bf16]["K3"], k34_step["K3"], k34_step["plain"],
                      k34_step["K3_bound"], k34_step["library"]),
        kernel_record("flash_attn_bwd_dkv", "flash_attn_bwd.cu",
                      "genpercept_tpu/ops/flash_attention.py:355", tr["run"]["launches"]["K4"],
                      k34["worst"][bf16]["K4"], k34_step["K4"], k34_step["plain"],
                      k34_step["K4_bound"], k34_step["library"]),
        kernel_record("fused_geglu_ff_int8", "fused_geglu_ff_int8.cu",
                      "genpercept_tpu/ops/fused_ff.py:134", i8["counts"]["K5"],
                      k5["worst"][bf16], *k5["per_forward"][bf16], None),
        kernel_record("flash_attn_int8", "flash_attn_int8.cu",
                      "genpercept_tpu/ops/flash_attention.py:179", i8["counts"]["K6"],
                      k6["worst"][bf16], *k6["per_forward"][bf16], None),
        kernel_record("quantized_conv3x3", "quantized_conv3x3.cu",
                      "genpercept_tpu/ops/quant_conv.py:41", k7["counts"]["K7"],
                      k7["worst"][bf16], k7["ms"], k7["plain_ms"], k7["bound"], None),
        kernel_record("fused_gn_silu_conv3x3", "fused_gn_silu_conv3x3.cu",
                      "genpercept_tpu/ops/fused_conv.py:43", fv[bf16]["counts"]["K8"],
                      k8["worst"][bf16], *k8["per_forward"][bf16][:3], None),
        # S1-S4: launches on the scripts' paths (phase (q)); times summed over
        # every configuration of phase (p)
        *(kernel_record(name, source, replaces, paths[s], s14[s]["worst"], s14[s]["ms"],
                        s14[s]["plain_ms"], s14[s]["bound"], s14[s]["library_ms"])
          for s, name, source, replaces in (
              ("S1", "flash_attn_fwd_tiled", "flash_attn_fwd.cu", "scripts/profile_unet.py:71"),
              ("S2", "flash_bf16_softmax", "flash_attn_fwd.cu",
               "scripts/profile_unet.py:285"),
              ("S3", "flash_attn_fwd_tiled", "flash_attn_fwd.cu",
               "scripts/profile_attn_boundary.py:151"),
              ("S4", "flash_nomax", "flash_attn_fwd.cu",
               "scripts/profile_attn_boundary.py:262"))),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
