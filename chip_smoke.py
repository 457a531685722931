#!/usr/bin/env python3
"""Drive the PyTorch port's one-step depth inference, its training step, its
W8A8 int8 inference (round-to-nearest and GPTQ, the fake-quant attribution
modes, a DPT head), its fused-VAE inference, its checkpoint loader and
folder CLI (depth and the DPT head), its marigold arch (multi-step DDIM,
the 8-channel UNet input, test-time ensembling), its serving path (the
HTTP server, the hub predictor, the dataset inference CLI) and its
train -> export -> infer -> eval loop (the training, export and eval CLIs,
the batched eval harness) and every other training recipe family (the
non-depth modes, a DPT head, LoRA, marigold and rgb_blending, the metric3d
losses) and data-parallel training across processes once on one NVIDIA
GPU.

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
      replaced;
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
      feed-forward); then Trainer.train for 2 optimizer steps of 4
      micro-batches with the kernels: loss per step, ms per step, img/s,
      peak device memory;
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
  (l) K7 W8A8 conv3x3 (the body's name starts with "int8 wgmma") against
      its plain version (quant.qconv_apply) at
      scripts/profile_quant_conv_torch.py's shapes, batch 2, and at the
      tiles' ragged edges (K7_RAGGED), f32 and bf16 (error 0.0, bit for bit,
      a second call equal); then K7's path, that script's profile() at
      batch 2 in bf16: K7, qconv_apply and cuDNN bf16 conv ms, the weight
      bytes a call reads from L2 (reckoned from the tiles), launches;
  (m) the fused-VAE slice, PipelineConfig(fused_vae=True), as (e): launches
      (K8 48 per forward), depth deviation kernels-vs-plain and against
      (e)'s unfused output on the same weights, img/s beside (e)'s;
  (n) K2's bf16 body at C=640 and 1280 (the body's name starts with
      "wgmma") against its plain version at the profiling script's shapes
      and the UNet's level-2 launch at batch 2, held to K2's three bf16
      bars, a second call equal, beside the unfused composition;
  (o) K6 at d=64 (the UNet's heads) against its plain version, f32 and
      bf16 (error 0.0, a second call equal; the body's name starts with
      "wgmma"), beside the bound, the design and exponent floors and K1's
      bf16 time at the same shape;
  (p) S1-S4, the attention profiling scripts' kernels, on K1's wgmma
      bodies, against their plain versions at batch 2, bf16: S1 (K1's
      function at every CTA tile of D64_TILES / D512_TILES) at the four
      UNet/VAE shapes, S3 (d=512, both row-sum folds), S2 (the bf16 softmax
      chain, plain version over the tile's key blocks) and S4 (no running
      max) at (10, 9216, 64); errors, kernel, plain and SDPA ms (SDPA
      computes S1's and S3's function, and S2's and S4's up to their
      rounding and clamp), K1 beside them; at d=64 the exponent floor (one
      MUFU ex2 a logit) beside the bound, and for S2 also its conversion
      floor (S_CVT_PER_LOGIT);
  (q) the two profiling scripts' paths: scripts/profile_unet_torch.py and
      scripts/profile_attn_boundary_torch.py, profile() once per part that
      reaches a kernel (batch 2, fusedff 8), exact launch counts per part
      and no refused configuration;
  (r) checkpoint_cli: the golden's weights (the torch oracles of
      tests/test_{unet,vae}_oracle.py at SD2.1 width, seeds 0 and 1, as
      scripts/make_torch_golden.py builds them; their fingerprint checked
      first), written as a published-layout checkpoint with the port's
      safetensors writer and loaded with load_genpercept_checkpoint: z, v
      and pred against golden/torch_golden_768.npz (mean, p99, max) in f32
      with the backend's defaults (cuDNN TF32 on), f32 with TF32 off and
      bf16, pred's mean within 1e-2, 1e-4 and 1e-2; then a DPT-identity
      checkpoint beside it (the same unet/ files, conv_out dropped by the
      loader; a seeded head) and the folder CLI in-process over two 768x768
      PNGs and one 480x640: depth f32 one image at a time, depth bf16 with
      --batch_size -1 (the H100 table) and disparity_dpt_head bf16, each
      with exact K1/K2 launch counts, every file written, each npy equal to
      the pipeline's own output on the decoded image; the DPT path also
      under reference_kernels() (mean deviation within 1e-2);
  (s) marigold: the same weights with the UNet's conv_in widened to 8
      channels by scripts/make_torch_golden.py's own _conv_in_8ch (taken from
      its syntax tree), written with in_channels 8 and loaded; 10 DDIM steps
      of the marigold arch (build_single_infer) on the golden's rgb and noise
      against golden/torch_golden_768_marigold.npz: z and pred (mean, p99,
      max) in f32 with TF32 off, f32 with the backend's defaults and bf16,
      pred's mean within 1e-3, 1e-2 and 1e-2; exact launches per call
      derived from the routing predicates (K1 152, K2 50) and none under
      reference_kernels() (bf16 mean deviation within 1e-2); __call__ with
      an ensemble of 3 in bf16 (pred in [0, 1], a finite uncertainty map of
      the image's shape, equal seeds equal bit for bit, K1 152 and K2 50);
      the folder CLI with --archs marigold --denoise_steps 10
      --ensemble_size 3 --seed 0 --bf16 over checkpoint_cli's three images
      (every file, _uncert.npy too, each npy equal to __call__ with a
      generator seeded 0; K1 356, K2 100); seconds per 768^2 image for 10
      steps in f32 and bf16 and for the ensemble in bf16 (CUDA events,
      median of 3 calls after a warm-up);
  (t) serve: the same one-step weights as (r), loaded by the port's server
      through its own start-up (make_server on the parsed flags, port 0,
      one worker thread), in f32 with the backend's defaults and in bf16:
      /healthz; a 768x768 and a 480x640 PNG through ?format=npy against a
      direct __call__ on a pipeline loaded from the same checkpoint (f32
      max within 1e-6, bf16 mean within 1e-2) with exact K1/K2 launches
      per request from the routing predicates (17/5 and 7/0); png16, png
      and colored against the npy; a bad payload's 500 and the request
      after it; single-image latency: SERVE_REQUESTS sequential 768x768
      /v1/infer_json requests after SERVE_WARMUPS and SERVE_480_REQUESTS
      480x640 ones, the client's wall, the server's latency_ms and the
      pipeline call alone (CUDA events), median, min, max; a burst of
      SERVE_BURST identical 768x768 requests with --max_batch 8, queued
      while the worker holds a lone request (HeldPipeline), in f32 with
      TF32 off, in bf16 and once with --data_parallel (one worker on one
      card): one fused .batch, each response against the lone one's (f32
      max 1e-4, bf16 mean 1e-2), requests per second from the release to
      the last response, launches; the hub's GenPercept_Depth (bf16,
      resolution 512) on a 480x640 PIL image: shape, equal to the
      pipeline on its resize resized back (1e-6), launches, seconds per
      image; the dataset inference CLI on NYU's layout (the split's first
      three paths as a tar of synthetic 480x640 PNGs, a copy of
      configs/dataset/eval/nyu.yaml) in f32, bf16 and bf16 with --prompt
      (a seeded SD2.1 text encoder and a toy tokenizer beside the
      checkpoint): the file tree against get_pred_name, each npy equal to
      the pipeline's output on the dataset's decoded rgb, K1 21 / K2 0,
      seconds per image (checkpoint load included), the prompt's
      prediction unlike the empty prompt's;
  (u) train_eval: the train -> export -> infer -> eval loop through the
      port's CLIs on the same weights as the base checkpoint. The recipe
      configs/train/main_paper/depth.yaml, merged and written with only
      its datasets' dir and filenames, max_iter and the trainer's periods
      changed (its 8 x 4 batch, mixture, bf16, losses and bf16 moments
      kept), over synthetic files in the readers' layouts: 32 Hypersim
      samples as a jsonl-metadata directory (rgb and depth-in-mm PNGs at
      480x640), 32 vKITTI in a split file (depth in cm, 375x1242 for the
      benchmark crop), 4 Hypersim val and 2 vis. Run A: cli/train.py, 2
      steps, validation and visualization at step 2 (the eval readers keep
      480x640): its files, finite losses, val metrics, 2 PNGs, exact
      K1-K4 launches from the routing predicates per step's source
      (replayed from the sampler) and per val/vis forward. Run R: A's
      recipe resumed from final with nothing left to train: parameters,
      Adam state (bf16 mu), count and counters equal to A's trainer (0.0).
      cli/export.py on A's final: each UNet tensor equal to A's trained
      one (0.0), and the depth of the export (loaded over the base) on the
      golden's rgb equal to the base pipeline with that UNet swapped in
      (f32, 0.0). cli/infer.py on the export over (t)'s NYU layout, then
      cli/eval.py with least_square and least_square_disparity: files,
      launches, each metric against a float64 numpy recomputation
      (TE_EVAL_TOL), the CSV's samples; evaluate_dataset on the same
      dataset, batch 2, in bf16 and f32 against reference_kernels()
      (TE_HARNESS_TOL), exact launches. Run B: A resumed to step 3; run C:
      3 steps straight, validation off (exact launches; A's and C's
      steps 1-2 losses; B's step-3 loss beside C's, reported: the resumed
      run restarts the sample stream). Reported: the CLI's ms per step
      (host wall between steps, loader included, median of C's steps 2-3)
      beside (g)'s train_run, peak memory, validation s per image, export
      s, cli/eval.py and evaluate_dataset s per image;
  (v) train_extras: the other recipe families through cli/train.py from
      (u)'s base checkpoint and files (the Hypersim split also with normal
      and DIS maps, and a DIS5K listing), each recipe merged with only its
      datasets' paths, max_iter and the periods set (TE_CHANGED), at the
      recipe's own micro-batch, 2 optimizer steps of its accumulation (TX_RUNS): main_paper/normal.yaml
      (angular, 768^2), others/dis_mse_with_latent_loss.yaml (DIS5K,
      768^2), ablation/components/dpt_head_identity_mse_loss.yaml (a fresh
      DPT-identity head, disparity_dpt_head, 768^2), depth_lora.yaml (rank
      128), depth_marigold.yaml (f32, the 8-channel conv_in, multi-res
      noise) and ablation/beta_values/rgb_blending_0p00085_0p012.yaml. Each:
      the step's host wall (step 2), peak memory, K1-K4 launches exactly as
      train_step_launches derives them from the routing predicates, and one
      micro-batch's loss and gradients with the kernels against
      reference_kernels() (tx_fidelity_checks: in the run's dtype and in
      f32, GRAD_TOL's bars, TX_SMOOTH, the bf16 gradients also against the
      f32 plain path's; with mse alone too where the recipe's loss is not
      smooth, but TX_MSE_MADE). The DPT head's and
      LoRA's runs are exported (cli/export.py) and served by cli/run.py on
      three images, each npy equal to the trained weights' pipeline in
      memory (0.0; LoRA merged on the host as the export merges); LoRA's
      base UNet stored in bf16 as JAX's Trainer stores it and bit for bit
      after the steps, its adapters moved. Then the
      main-paper recipe with losses (mse, vnl, hdnr, hdsnr) in
      build_train_step from Hypersim's reader (its K scaled to 480x640): 2
      steps (CUDA events), launches, each metric3d loss's forward and
      backward ms, the fidelity as the runs' above;
  (w) int8_extras, on (u)'s base checkpoint (the golden's weights) in bf16
      with INT8_CFG and the int8 slice's four natural-like 768^2 images
      (the first batch of two calibrates): round-to-nearest and GPTQ
      (int8_gptq) on the same images, each with its calibration seconds,
      peak device memory over the weights, int8_mean_dev (<= 1e-2), exact
      launches on the calibrating and the quantized batches, and GPTQ's
      gptq_round seconds summed over the layers; GPTQ moves the VAE's
      codes only; its tree through save/load gives equal depth (0.0); the
      fake:w, fake:a and fake:wa modes on that tree against full precision
      and the int8 path, in bf16 and f32 with TF32 off (fake:wa's deviation
      within FAKE_WA_REL of the int8 path's, fake:w's and fake:a's below
      it), launches K1 17 / K2 5; a
      DPT-identity checkpoint in int8: the decoder's group empty,
      int8_mean_dev <= 1e-2, launches K1 15 / K5 10 / K6 1 a forward, and
      cli/run.py --int8_vae --int8_unet --batch_size 2 --data_parallel on
      it (one device) with each npy equal to the pipeline's (0.0);
  (x) data_parallel: first the batch split's own rounding in this
      process (dp_split_witness: two images' f32 gradient image by image
      against batched); then cli/train.py as two gloo ranks on the one
      card under torchrun (--multihost, each rank's gloo group started
      before the CLI, which uses it; NCCL refuses two ranks on one GPU),
      one image a rank, against one process on the same global
      micro-batch of 2, one optimizer step of the main-paper recipe
      (DP_CHANGED keys set; its flips kept): in f32 with TF32 off the loss
      within DP_LOSS_TOL, the gradient (Adam's first moment) within
      DP_GRAD_TOL and DP_GRAD_WITNESS_X times the witness's, the update
      within DP_UPDATE_WITNESS_X times the witness's (its gradients
      through Adam's first step); in the recipe's bf16 reported; rank 0's run directory,
      logging and validation; --zero1 the same step (moments within
      DP_ZERO1_MU_REL, the update within DP_ZERO1_UPDATE_REL of plain's,
      the ranks' parameters equal) with the whole Adam state gathered into
      its checkpoint; both ranks resumed from its `final` (one save fewer
      than `latest` would take: tests/test_torch_parallel.py resumes from
      `latest`); exact launches per rank.
      (u)'s run C runs as one NCCL rank (--coordinator_address), its steps
      1-2 within DP_LOSS_TOL of run A's.
Every phase's launch counts include K7, K8 and S1-S4 (0 outside their
paths). Each phase's wall seconds print on a line of their own, and all of
them before the kernels' line.
K1 and K3+K4 are also timed against one PyTorch call computing the same
function (scaled_dot_product_attention and its autograd backward), which the
port never calls; every kernel's bound is computed from its shapes (PEAK).
Then one JSON line with a record per kernel, and as the last line
{"ok": true, "device": {...}}. Any failed check raises, so the exit code is
not 0. Without a CUDA device it exits 1 before printing anything; without
the repository around it the import fails.
"""

from __future__ import annotations

import ast
import contextlib
import copy
import dataclasses
import importlib.util
import json
import math
import shutil
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
from genpercept_tpu_torch.io.checkpoints import load_genpercept_checkpoint
from genpercept_tpu_torch.io.weights import save_safetensors
from genpercept_tpu_torch.models import (
    DPT_IDENTITY, AutoencoderKL, CLIPTextModel, DPTHead, UNet2DConditionModel, init_params_,
    unet_apply, vae_encode)
from genpercept_tpu_torch.ops import conv2d, group_norm
from genpercept_tpu_torch.ops import flash_attention as fa
from genpercept_tpu_torch.ops import fused_conv as fc
from genpercept_tpu_torch.ops import fused_ff as ff
from genpercept_tpu_torch.ops import quant as tq
from genpercept_tpu_torch.ops import quant_conv as qc
from genpercept_tpu_torch.ops import reference_kernels
from genpercept_tpu_torch.parallel import tensor as TP
from genpercept_tpu_torch.pipeline import (
    GenPerceptModels, GenPerceptPipeline, PipelineConfig, build_single_infer)
from genpercept_tpu_torch.utils.synthetic import natural_like_images
from genpercept_tpu_torch.train import TrainConfig, build_loss_fn, init_train_state
from genpercept_tpu_torch.train import losses as train_losses
from genpercept_tpu_torch.train.trainer import Trainer

SEED = 0
# main-path K1 shapes per 768^2 image: (bh per image, s, d) -> launches per forward
K1_SHAPES = [((5, 9216, 64), 5), ((10, 2304, 64), 5), ((20, 576, 64), 5),
             ((1, 9216, 512), 2)]
K2_SHAPE, K2_PER_FORWARD = (1, 9216, 320), 5
# the tensor-parallel jobs' model group (phase (x)) and K2 on a rank's share
# there: two 768^2 images, 18432 level-0 rows
TP_M, K2_TP_SHAPE = 2, (2, 9216, 320)
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
WINDOW_S, MIN_PASSES = 1.5, 3

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
RUN_STEPS = 2  # phase (g)'s Trainer runs: a warm-up step and a timed one
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
# K7 at its tiles' edges, (n, c, h, w, co): Co 64 and 192 (16 x 16 x 64 tiles),
# heights and widths no multiple of the tile, odd pixel-tile counts (the last
# 2-CTA cluster half-full: 1 tile at 16 x 16, 3 at 24 x 16, 9 at 24 x 40)
K7_RAGGED = [(1, 64, 16, 16, 64), (2, 64, 24, 40, 192), (3, 128, 40, 24, 128),
             (1, 256, 24, 16, 256), (1, 320, 24, 40, 320), (1, 256, 20, 24, 128)]

# the attention profiling scripts' kernels (S1-S4), K6 at d=64 and K2 at the
# wide widths, at the scripts' shapes at batch 2 ((bh, s, d); (b, s, c))
S1_SHAPES = [(10, 9216, 64), (20, 2304, 64), (40, 576, 64), (2, 9216, 512)]
S3_SHAPE = (2, 9216, 512)
S24_SHAPE = (10, 9216, 64)
# of max|plain|: max abs error of S1, S3, S4 2e-2, of S2 2^-7, and S2's mean
# abs error 1e-4 (tests/test_torch_cuda.py states why)
S_TOL = {"S1": 2e-2, "S3": 2e-2, "S4": 2e-2, "S2": 2.0 ** -7}
S2_MEAN_TOL = 1e-4
# the d=64 bodies' floors beside the bound: the MUFU unit takes 16 ex2 a
# clock an SM, one a logit, and conversions (cvt) run at 16 a clock an SM
# too (the CUDA C++ Programming Guide's throughput table, compute
# capability 9.0). Conversion instructions a logit: S1/S4 pack p in pairs
# (0.5); S2 packs the logits and p in pairs (1.0)
MUFU_PER_CLK_SM = 16
S_CVT_PER_LOGIT = {"S1": 0.5, "S2": 1.0, "S4": 0.5}
K6_D64 = [((10, 9216, 64), 1536), ((20, 2304, 64), 2304)]  # the TPU's k blocks
# 8 x 576: rows a multiple of 512; 2 x 576: the UNet's level-2 launch at batch 2
K2_WIDE = [(2, 2304, 640), (8, 576, 1280), (2, 576, 1280)]
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
            nbytes = attn_bytes(bh, s, d, dt, 3, 1, 1)
            bd = bound(4.0 * bh * s * s * d, "tf32x3" if f32 else "bf16", nbytes)
            emit({"phase": "K1", "dtype": str(dt), "shape": [bh, s, d],
                  "max_abs_err_out": err_o, "max_abs_err_lse2": err_l,
                  "output_max_abs": top, "rel_err_out": err_o / top,
                  "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                  "bound_ms": bd.ms, "bound_by": bd.by,
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


def k2_reading(args: tuple, what: str) -> dict:
    """K2 on ``args`` (x, w1, b1, w2, b2) against its plain version, timed
    beside it and the unfused composition, emitted and held to K2's bars
    (two calls equal)."""
    x, w1 = args[0], args[1]
    (b, s, c), inner, dt = x.shape, w1.shape[0] // 2, x.dtype
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
    repeats = torch.equal(y, again)
    emit({"phase": what, "dtype": str(dt), "shape": [b, s, c], "inner": inner,
          "max_abs_err": err, "mean_abs_err": mean, "output_max_abs": scale,
          "rel_err": err / scale, "mean_rel_err": mean / scale, "repeats": repeats,
          "ms": ms, "plain_ms": plain_ms, "composition_ms": composition_ms,
          "bound_ms": bd.ms, "bound_by": bd.by,
          # f32: the bound at the FFMA rate of the f32 body this one replaced
          "bound_ffma_ms": bound(6.0 * rows * c * inner, "f32", 0).ms if f32 else None})
    check(k2_within(dt, err, mean, scale),
          f"{what} {dt} {(b, s, c)} inner {inner}: error {err}, mean {mean}, max|plain| {scale}")
    check(repeats, f"{what} {dt} {(b, s, c)} inner {inner}: two calls differ")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound": bd}


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
    # a tensor-parallel rank's share (parallel/tensor.py): inner 4C / TP_M,
    # its hidden rows stacked on its gate rows, b2 withheld (the model
    # group adds it once after its sum), at the rows of two 768^2 images
    pairs = TP.Split(0, True)
    share = (TP.share(w1, pairs, TP_M, 0).contiguous(), TP.share(b1, pairs, TP_M, 0).contiguous(),
             w2.chunk(TP_M, dim=1)[0].contiguous())
    for dt in DTYPES:
        for (b, s, _), n in shapes:
            x = torch.randn(b, s, c, device="cuda", generator=gen if n else rgen).to(dt)
            rec = k2_reading((x, w1.to(dt), b1, w2.to(dt), b2), "K2")
            worst[dt] = max(worst[dt], rec["err"])
            if n:
                per_image[dt] = [n * rec["ms"], n * rec["plain_ms"], n * rec["bound"]]
            del x
        x = torch.randn(K2_TP_SHAPE, device="cuda", generator=rgen).to(dt)
        rec = k2_reading((x, share[0].to(dt), share[1], share[2].to(dt), None), "K2_tp_share")
        worst[dt] = max(worst[dt], rec["err"])
        del x
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
    """Trainer.train for RUN_STEPS optimizer steps of ACCUM micro-batches, bf16:
    losses, CUDA-event time of each step, peak memory, launches."""
    cfg = dataclasses.replace(TRAIN_CFG, grad_accum_steps=ACCUM)
    loader = DataLoader(samples, MixedBatchSampler([samples], batch_size=ACCUM * MICRO,
                                                   generator=np.random.default_rng(SEED)))
    models = GenPerceptModels(unet=copy.deepcopy(unet), vae=copy.deepcopy(vae),
                              text_embed=embed.clone())
    with tempfile.TemporaryDirectory() as out_dir:
        trainer = Trainer(cfg, models, loader, out_dir, max_iter=RUN_STEPS, save_period=0,
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
    # the Trainer with the kernels only: their plain versions are held
    # against them per micro-batch above (the plain Trainer's ms per step,
    # ~6140, is in PERF.md)
    run = run_trainer(unet, vae, embed, samples)
    expect = {k: n * ACCUM * RUN_STEPS for k, n in STEP_LAUNCHES.items()}
    rec = {"phase": "train_run", "dtype": str(torch.bfloat16), "steps": RUN_STEPS,
           "micro_batch": MICRO, "accum": ACCUM, "image_hw": list(TRAIN_HW), **run}
    emit(rec)
    check(len(run["losses"]) == RUN_STEPS and all(math.isfinite(x) for x in run["losses"]),
          f"trainer losses {run['losses']}")
    check(run["launches"] == expect, f"trainer launches {run['launches']} != {expect}")
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
    2) and at K7_RAGGED, f32 and bf16, bit for bit and a second call equal;
    then K7's path, the script's profile() at batch 2."""
    pq = load_script("profile_quant_conv_torch")
    body = _build.load().quantized_conv3x3_body().decode()
    emit({"phase": "K7_body", "body": body})
    check(body.startswith("int8 wgmma"), f"K7 body: {body}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    worst = {dt: 0.0 for dt in DTYPES}
    cases = [(K7_BATCH, c, h, w, co) for h, w, c, co in pq.SHAPES] + K7_RAGGED
    for dt in DTYPES:
        for n, c, h, w, co in cases:
            x = torch.randn(n, c, h, w, device="cuda", generator=gen).to(dt)
            wf = torch.randn(co, c, 3, 3, device="cuda", generator=gen) * 0.05
            b = torch.randn(co, device="cuda", generator=gen) * 0.1
            q = tq.quantize_conv(wf, b, tq.absmax_per_channel(x.movedim(1, -1)), margin=1.0)
            out = qc.quantized_conv3x3(x, q.w_int8, q.inv_a, q.o_scale, q.bias)
            again = qc.quantized_conv3x3(x, q.w_int8, q.inv_a, q.o_scale, q.bias)
            ref = qc._quantized_conv3x3_ref(x, q.w_int8, q.inv_a, q.o_scale, q.bias)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            same, repeats = bool(torch.equal(out, ref)), bool(torch.equal(out, again))
            emit({"phase": "K7", "dtype": str(dt), "shape": [n, c, h, w], "co": co,
                  "max_abs_err": err, "bit_identical": same, "repeats": repeats})
            check(err == 0.0 and same and repeats,
                  f"K7 {dt} {(n, c, h, w, co)}: error {err}, equal {same}, repeats {repeats}")
            worst[dt] = max(worst[dt], err)
            del x, wf, q, out, again, ref
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
              "weight_l2_bytes": qc.weight_l2_bytes(nb, c, co, h, w), "library_ms": None})
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
    """K2's bf16 body at C=640 and 1280 against its plain version, held to
    K2's three bf16 bars (k2_within) and two calls bit for bit equal, beside
    the unfused composition (no single PyTorch call computes K2); with the
    name of the body (wgmma)."""
    body = _build.load().fused_geglu_ff_bf16_wide_body().decode()
    emit({"phase": "K2_wide_body", "body": body})
    check(body.startswith("wgmma"), f"K2's wide bf16 body is {body!r}")
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
        again = ff.fused_geglu_ff(*args)
        ref = ff._fused_geglu_ff_ref(*args)
        torch.cuda.synchronize()
        diff = (y.float() - ref.float()).abs()
        err, mean = diff.max().item(), diff.mean().item()
        scale = ref.float().abs().max().item()
        ms = cuda_ms(lambda: ff.fused_geglu_ff(*args), 10)
        plain_ms = cuda_ms(lambda: ff._fused_geglu_ff_ref(*args), 5)
        composition_ms = cuda_ms(lambda: ff._geglu_ff_composition(*args), 10)
        bd = bound(6.0 * rows * c * inner, "bf16",
                   (2 * rows * c + 3 * c * inner) * elt(dt) + 4 * (2 * inner + c))
        emit({"phase": "K2_wide", "dtype": str(dt), "shape": [b, s, c], "max_abs_err": err,
              "mean_abs_err": mean, "output_max_abs": scale, "rel_err": err / scale,
              "mean_rel_err": mean / scale, "repeats": torch.equal(y, again), "ms": ms,
              "plain_ms": plain_ms, "composition_ms": composition_ms, "bound_ms": bd.ms,
              "bound_by": bd.by, "library_ms": None})
        check(k2_within(dt, err, mean, scale),
              f"K2 {(b, s, c)}: error {err}, mean {mean}, max|plain| {scale}")
        check(torch.equal(y, again), f"K2 {(b, s, c)}: two calls differ")
        del x, w1, w2, args, y, again, ref, diff


def phase_k6_d64() -> None:
    """K6 at the UNet's head dim against its plain version on the same int8
    operands, f32 and bf16 outputs: bit for bit (0.0), and again on a second
    call; with the name of its d=64 body (int8 wgmma), the design's floor
    (its max pass runs Q K^T twice: 1.5x the function's operations) and the
    exponent floor (one exp2f a logit on the MUFU of every SM) beside the
    bound, and K1's bf16 time at the same shape."""
    body = _build.load().flash_attn_int8_d64_body().decode()
    emit({"phase": "K6_d64_body", "body": body})
    check(body.startswith("wgmma"), f"K6 d=64 body {body!r}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    sms, clock = torch.cuda.get_device_properties(0).multi_processor_count, sm_clock_hz()
    for dt in DTYPES:
        for (bh, s, d), k_blk in K6_D64:
            q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen).to(dt)
                       for _ in range(3))
            scale = d ** -0.5
            check(fa._int8_k_block(s, s, d) == k_blk, f"K6 d=64 k block at {s}")
            ops = fa.int8_operands(q, k, v)
            out = fa._flash_int8_codes(*ops, scale, k_blk, dt)
            ref = fa._flash_int8_ref(*ops, scale, k_blk, dt)
            again = fa._flash_int8_codes(*ops, scale, k_blk, dt)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ms = cuda_ms(lambda: fa._flash_int8_codes(*ops, scale, k_blk, dt), 5)
            plain_ms = cuda_ms(lambda: fa._flash_int8_ref(*ops, scale, k_blk, dt), 2)
            qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
            k1_ms = cuda_ms(lambda: fa._flash_bhsd(qb, kb, vb, scale), 5)
            bd = bound(4.0 * bh * s * s * d, "int8",
                       bh * s * (3 * d + d * elt(dt) + 8) + 4 * bh * d)
            emit({"phase": "K6_d64", "dtype": str(dt), "shape": [bh, s, d], "k_block": k_blk,
                  "max_abs_err": err, "bit_identical": bool(torch.equal(out, ref)),
                  "repeat_bit_identical": bool(torch.equal(out, again)), "ms": ms,
                  "plain_ms": plain_ms, "k1_bf16_ms_same_shape": k1_ms, "bound_ms": bd.ms,
                  "bound_by": bd.by, "design_floor_ms": 1.5 * bd.ops_ms,
                  "exponent_floor_ms": bh * s * s / (MUFU_PER_CLK_SM * sms * clock) * 1e3,
                  "library_ms": None})
            check(err == 0.0, f"K6 d=64 {dt} {(bh, s, d)}: error {err}")
            check(torch.equal(out, again), f"K6 d=64 {dt} {(bh, s, d)}: a second call differs")
            del q, k, v, ops, out, ref, again, qb, kb, vb
            torch.cuda.empty_cache()


def sm_clock_hz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm), in Hz."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0]
    return float(mhz) * 1e6


def phase_s14() -> dict:
    """S1-S4 against their plain versions at the scripts' shapes, batch 2,
    bf16; per kernel the sums over its configurations of the kernel, plain
    and SDPA ms and of the bounds."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    dt = torch.bfloat16
    total = {n: {"worst": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound": Bound()}
             for n in ("S1", "S2", "S3", "S4")}
    # ms a logit takes at 16 a clock on every SM: the exponent floor per logit
    unit_ms = 1e3 / (MUFU_PER_CLK_SM * torch.cuda.get_device_properties(0).multi_processor_count
                     * sm_clock_hz())

    def run(name, shape, tile, fn, ref, plain_ms, library_ms, bd, extra=None):
        out = fn()
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        err, mean = diff.max().item(), diff.mean().item()
        top = ref.float().abs().max().item()
        bar = S_TOL[name] * top
        ms = cuda_ms(fn, 5)
        bh, s, d = shape
        floors = {} if d != 64 else {
            "exp_floor_ms": bh * s * s * unit_ms,
            "cvt_floor_ms": S_CVT_PER_LOGIT[name] * bh * s * s * unit_ms}
        emit({"phase": name, "dtype": str(dt), "shape": list(shape), "tile": list(tile),
              **(extra or {}), "max_abs_err": err, "rel_err": err / top,
              "mean_rel_err": mean / top, "bar": bar, "ms": ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "bound_ms": bd.ms, "bound_by": bd.by, **floors})
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
        # K1_TILES: the tile K1 launches, one of the S1 tiles below
        emit({"phase": "S_K1_baseline", "shape": [bh, s, d], "k1_tile": list(fa.K1_TILES[d]),
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


# ------------------------------------------------------------ checkpoint_cli
# The torch oracles of the golden (tests/test_{unet,vae}_oracle.py) import jax
# at their top, so their classes are taken from the files' syntax trees and
# run in a namespace of torch alone; the width constants are the files' own
# unless given, as scripts/make_torch_golden.py:59-78 patches them to SD2.1.
ORACLE_FILES = {"unet": "tests/test_unet_oracle.py", "vae": "tests/test_vae_oracle.py"}
ORACLE_CONSTANTS = ("C", "HEADS", "CTX", "TEMB")
SD21_ORACLE = {"unet": dict(C=(320, 640, 1280, 1280), HEADS=(5, 10, 20, 20), CTX=1024,
                            TEMB=1280),
               "vae": dict(C=(128, 256, 512, 512))}
GOLDEN_SEEDS = {"unet": 0, "vae": 1}
GOLDEN = Path(__file__).resolve().parent / "golden" / "torch_golden_768.npz"
# fingerprint() of the golden's modules, built with torch 2.13.0+cpu (the
# torch that wrote the golden) and equal on the card's torch 2.11.0+cu128:
# a difference in default init would read as "weights differ" here, before
# any comparison could blame the port
GOLDEN_FINGERPRINT = {
    "unet": {"conv_in": [3.582708143781929, -2.1165475963600606],
             "time_embedding": [21.934820322989037, 18.956832992612572],
             "down_blocks": [31095.0938000275, 135.1767829191433],
             "mid_block": [10189.795578992405, -14.339363130926218],
             "up_blocks": [58191.31878901554, 145.78934737254065],
             "conv_norm_out": [320.0, -0.3437191830318703],
             "conv_out": [-2.4797791274342558, -0.4478952767852077]},
    "vae": {"encoder": [8324.914027864152, 23.23833826416533],
            "quant_conv": [-0.15034631034359336, -0.11382218203540084],
            "post_quant_conv": [-0.5147169232368469, 0.8599414394990137],
            "decoder": [11518.47925779799, 87.57393368364605]},
}
# pred's mean abs error against the golden: f32 with TF32 off is the same
# math as the golden's CPU f32; the CLI's f32 (cuDNN TF32 on, the backend
# default) and bf16 are held to the north star's per-pixel bar
GOLDEN_BARS = {"f32_defaults": 1e-2, "f32_tf32_off": 1e-4, "bf16": 1e-2}
# the backend's switches as a caller of the pipeline or the CLI finds them,
# read before phase_device turns TF32 off
DEFAULT_TF32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
DPT_SEED = 2
# K1 per forward on the DPT path: the VAE encoder's mid block and the UNet
# (the decoder does not run); 480x640 -> 72x96 latent: level 0 and the encoder
DPT_K1 = {768: K1_PER_FORWARD - 1, 480: 6}


def oracle_namespace(which: str, widths: dict | None = None) -> dict:
    """The classes and functions of an oracle file (its tests left out) and
    its width constants, executed without its imports; ``widths`` replace
    the constants."""
    path = Path(__file__).resolve().parent / ORACLE_FILES[which]
    keep = [n for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.ClassDef, ast.FunctionDef)) and not n.name.startswith("test_")
            or isinstance(n, ast.Assign)
            and all(isinstance(t, ast.Name) and t.id in ORACLE_CONSTANTS for t in n.targets)]
    ns = {"torch": torch, "nn": torch.nn, "F": F, "np": np}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(path), "exec"), ns)
    ns.update(widths or {})
    return ns


def oracle_modules(widths: dict | None = None):
    """The golden's UNet and VAE oracles, seeded as make_torch_golden.py seeds
    them (the global CPU generator, forked so nothing else sees the draws);
    ``widths`` {"unet": {...}, "vae": {...}} or the files' own small ones."""
    widths = widths or {}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(GOLDEN_SEEDS["unet"])
        unet = oracle_namespace("unet", widths.get("unet"))["TUNet"]().eval()
        torch.manual_seed(GOLDEN_SEEDS["vae"])
        vae = oracle_namespace("vae", widths.get("vae"))["TVAE"]().eval()
    return unet, vae


_GOLDEN_ORACLES: dict = {}


def golden_oracles() -> tuple:
    """(unet, vae, fingerprint) of oracle_modules(SD21_ORACLE), built once
    and shared by every phase that writes the golden's weights (read only:
    a phase that changes them works on a copy)."""
    if not _GOLDEN_ORACLES:
        unet, vae = oracle_modules(SD21_ORACLE)
        _GOLDEN_ORACLES.update(unet=unet, vae=vae,
                               fp={"unet": fingerprint(unet), "vae": fingerprint(vae)})
    return _GOLDEN_ORACLES["unet"], _GOLDEN_ORACLES["vae"], _GOLDEN_ORACLES["fp"]


def fingerprint(module: torch.nn.Module) -> dict:
    """Per child: the sum of its parameters, and their sum weighted by the
    cosine of each element's index (which tells seeds apart where the
    first is all norm weights), in float64."""
    out = {}
    for name, child in module.named_children():
        total = weighted = 0.0
        for p in child.parameters():
            flat = p.detach().double().flatten()
            total += float(flat.sum())
            weighted += float((flat * torch.cos(torch.arange(flat.numel(),
                                                             dtype=torch.float64))).sum())
        out[name] = [total, weighted]
    return out


def write_oracle_checkpoint(root: Path, unet, vae, ns_unet: dict, ns_vae: dict,
                            text_embed: np.ndarray, in_channels: int = 4) -> Path:
    """The oracles' state dicts in the published layout, with the port's
    writer: unet/ and vae/ with their config.json, empty_text_embed.npy."""
    for sub, module, cfg in (
            ("unet", unet, {"in_channels": in_channels,
                            "block_out_channels": list(ns_unet["C"]),
                            "attention_head_dim": list(ns_unet["HEADS"]),
                            "cross_attention_dim": ns_unet["CTX"],
                            "down_block_types": ["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"],
                            "layers_per_block": 2, "norm_eps": 1e-5}),
            ("vae", vae, {"block_out_channels": list(ns_vae["C"]), "latent_channels": 4,
                          "scaling_factor": 0.18215})):
        (root / sub).mkdir(parents=True)
        save_safetensors(module.state_dict(), str(root / sub / "diffusion_pytorch_model.safetensors"))
        (root / sub / "config.json").write_text(json.dumps(cfg))
    np.save(root / "empty_text_embed.npy", text_embed)
    return root


def err_stats(ours, ref) -> dict:
    d = np.abs(np.asarray(ours, np.float64) - np.asarray(ref, np.float64))
    return {"mean": float(d.mean()), "p99": float(np.percentile(d, 99)), "max": float(d.max())}


@contextlib.contextmanager
def tf32(matmul: bool, cudnn: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def golden_reading(models, golden: dict, dtype) -> dict:
    """pred (build_single_infer) on the golden's rgb and the pipeline's first
    steps, z and, where the golden holds it, v (NHWC), each against the
    golden: mean, p99 and max abs error."""
    rgb = torch.from_numpy(golden["rgb"]).to(models.device)
    pred = build_single_infer(models, PipelineConfig(dtype=dtype))(rgb)
    with torch.no_grad():
        z = vae_encode(models.vae, rgb.to(dtype).permute(0, 3, 1, 2) * 2.0 - 1.0)
        got = {"z": z.permute(0, 2, 3, 1), "pred": pred}
        if "v" in golden:
            v = unet_apply(models.unet, z, torch.tensor(1, device=models.device),
                           models.get_text_embed().to(dtype))
            got["v"] = v.permute(0, 2, 3, 1)
    return {k: err_stats(t.float().cpu().numpy(), golden[k]) for k, t in got.items()}


def write_dpt_checkpoint(root: Path, ckpt: Path, head_state: dict, cfg) -> Path:
    """A DPT-identity checkpoint beside ``ckpt``: its unet/ (conv_out and all,
    which the loader drops), vae/ and embedding linked, and
    dpt_head_identity/ with ``head_state`` and ``cfg``'s widths."""
    root.mkdir()
    for sub in ("unet", "vae", "empty_text_embed.npy"):
        (root / sub).symlink_to(ckpt / sub)
    (root / "dpt_head_identity").mkdir()
    save_safetensors(head_state, str(root / "dpt_head_identity" / "model.safetensors"))
    (root / "dpt_head_identity" / "config.json").write_text(json.dumps(
        {"neck_hidden_sizes": list(cfg.neck_hidden_sizes),
         "fusion_hidden_size": cfg.fusion_hidden_size,
         "add_projection": cfg.add_projection, "head_in_index": cfg.head_in_index}))
    return root


def write_cli_images(root: Path) -> list:
    """Two 768x768 PNGs and one 480x640, natural-like from SEED."""
    from PIL import Image

    root.mkdir()
    images = [*natural_like_images(SEED + 5, 2, 768),
              natural_like_images(SEED + 6, 1, 768)[0][:480, :640]]
    paths = []
    for i, im in enumerate(images):
        paths.append(root / f"img{i}.png")
        Image.fromarray((im * 255).astype(np.uint8)).save(paths[-1])
    return paths


def check_cli_outputs(paths, out_dir: Path, mode: str, direct) -> float:
    """Every file the CLI writes per image exists, each npy equals the
    pipeline's own output on the decoded image (the ensemble's uncertainty
    map too, written exactly when there is one), each png its truncation;
    returns the largest npy difference (0.0)."""
    from PIL import Image

    worst = 0.0
    for path, out in zip(paths, direct):
        base = out_dir / (path.stem + "_pred")
        for suffix in (".npy", ".png", "_colored.png"):
            check(Path(f"{base}{suffix}").is_file(), f"CLI wrote no {base}{suffix}")
        npy = np.load(f"{base}.npy")
        check(npy.shape == out.pred_np.shape, f"{base}.npy shape {npy.shape}")
        worst = max(worst, float(np.abs(npy - out.pred_np).max()))
        uncert = Path(f"{base}_uncert.npy")
        check(uncert.is_file() == (out.uncertainty is not None),
              f"CLI wrote {'no ' * (out.uncertainty is not None)}{uncert}")
        if out.uncertainty is not None:
            u = np.load(uncert)
            check(u.shape == out.uncertainty.shape, f"{uncert} shape {u.shape}")
            worst = max(worst, float(np.abs(u - out.uncertainty).max()))
        scale, dt = (65535.0, np.uint16) if mode == "depth" else (255.0, np.uint8)
        with Image.open(f"{base}.png") as im:
            check(np.array_equal(np.asarray(im).astype(dt), (npy * scale).astype(dt)),
                  f"{base}.png is not the npy's truncation")
        with Image.open(f"{base}_colored.png") as im:
            check(np.array_equal(np.asarray(im), out.pred_colored),
                  f"{base}_colored.png differs from the pipeline's")
    return worst


def fingerprint_matches(fp: dict) -> bool:
    return all(fp[m].keys() == want.keys()
               and all(math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-9)
                       for k in want for a, b in zip(want[k], fp[m][k]))
               for m, want in GOLDEN_FINGERPRINT.items())


def golden_readings(ckpt: Path, golden: dict) -> dict:
    """The golden checkpoint loaded in f32 and in bf16, each held to the
    golden: f32 with the backend's defaults and with TF32 off, bf16 with
    the defaults."""
    readings = {}
    for name, dt, switches in (("f32_defaults", torch.float32, DEFAULT_TF32),
                               ("f32_tf32_off", torch.float32, (False, False)),
                               ("bf16", torch.bfloat16, DEFAULT_TF32)):
        t0 = time.perf_counter()
        models = load_genpercept_checkpoint(str(ckpt), dtype=dt, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        check(models.dpt_head is None and models.unet.cfg.with_conv_out,
              "the plain checkpoint loaded a head")
        with tf32(*switches):
            readings[name] = {**golden_reading(models, golden, dt), "load_s": load_s}
        del models
        torch.cuda.empty_cache()
    return readings


def cli_run(name, ckpt: Path, mode: str, dt, batch_size: int, paths, decoded,
            out_dir: Path) -> dict:
    """One in-process run of the folder CLI with the backend's defaults, its
    launches, and its files held to the pipeline's own outputs on the
    decoded images (a fresh load of the same checkpoint); on the DPT path
    also the plain kernels' run of the same images."""
    import PIL

    from genpercept_tpu_torch.cli import run as cli

    argv = ["--checkpoint", str(ckpt), "--input_rgb_dir", str(paths[0].parent),
            "--output_dir", str(out_dir), "--mode", mode, "--batch_size", str(batch_size)]
    argv += ["--bf16"] if dt == torch.bfloat16 else []
    with tf32(*DEFAULT_TF32):
        reset_counts()
        t0 = time.perf_counter()
        cli.main(argv)
        torch.cuda.synchronize()
        rec = {"run": name, "mode": mode, "dtype": str(dt), "batch_size": batch_size,
               "seconds": time.perf_counter() - t0, "launches": launch_counts(),
               "image_io": f"PIL {PIL.__version__}"}
        pipe = GenPerceptPipeline(load_genpercept_checkpoint(str(ckpt), dtype=dt),
                                  PipelineConfig(mode=mode, dtype=dt))
        direct = ([pipe(im) for im in decoded] if batch_size == 0
                  else pipe.batch(decoded, batch_size=0))
        rec["npy_max_abs_diff_vs_pipeline"] = check_cli_outputs(paths, out_dir, mode, direct)
        rec["files"] = sorted(p.name for p in out_dir.iterdir())
        preds = [o.pred_np for o in direct]
        rec["pred_std"] = [float(np.std(p)) for p in preds]
        rec["pred_range"] = [float(min(p.min() for p in preds)), float(max(p.max() for p in preds))]
        if mode == "disparity_dpt_head":
            reset_counts()
            with reference_kernels():
                plain = [pipe(im).pred_np for im in decoded]
            rec["launches_reference"] = launch_counts()
            rec["mean_abs_dev_vs_reference"] = float(np.mean(np.concatenate(
                [np.abs(a - b).ravel() for a, b in zip(preds, plain)])))
    emit({"phase": "checkpoint_cli", "step": "cli", **rec})
    # .batch clamps to [0, 1] before resizing an image back to its size, as
    # the JAX package does: the bilinear weights' f32 sums may step past 1 by
    # an ulp or so
    for p in preds:
        check(bool(np.isfinite(p).all()) and p.min() >= -1e-6 and p.max() <= 1.0 + 1e-6,
              f"CLI {name}: prediction not finite or outside [0, 1]")
    check(min(rec["pred_std"]) > 1e-4, f"CLI {name}: a constant prediction")
    check(rec["npy_max_abs_diff_vs_pipeline"] == 0.0,
          f"CLI {name}: an npy differs from the pipeline's output")
    if "launches_reference" in rec:
        check(not any(rec["launches_reference"].values()),
              "kernels launched under reference_kernels()")
        check(rec["mean_abs_dev_vs_reference"] <= 1e-2,
              f"DPT kernels vs reference_kernels(): {rec['mean_abs_dev_vs_reference']}")
    del pipe, direct
    torch.cuda.empty_cache()
    return rec


def phase_checkpoint_cli() -> None:
    """A published-layout checkpoint of the golden's weights and a DPT one,
    written with the port's writer and loaded with load_genpercept_checkpoint:
    held to golden/torch_golden_768.npz three ways, then driven through the
    folder CLI three ways (section (r))."""
    from PIL import Image

    t0 = time.perf_counter()
    unet_o, vae_o, fp = golden_oracles()
    emit({"phase": "checkpoint_cli", "step": "golden_weights",
          "fingerprint_matched": fingerprint_matches(fp),
          "seconds": time.perf_counter() - t0, "fingerprint": fp})
    check(fingerprint_matches(fp),
          "the golden's weights differ: this torch's default init is not the golden's")
    with np.load(GOLDEN) as zf:
        golden = {k: zf[k] for k in zf.files}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        ckpt = write_oracle_checkpoint(root / "ckpt", unet_o, vae_o, SD21_ORACLE["unet"],
                                       SD21_ORACLE["vae"], golden["ctx"])
        del unet_o, vae_o
        head = init_params_(DPTHead(DPT_IDENTITY),
                            torch.Generator().manual_seed(SEED + DPT_SEED))
        dpt = write_dpt_checkpoint(root / "ckpt_dpt", ckpt, head.state_dict(), DPT_IDENTITY)
        write_s = time.perf_counter() - t0
        readings = golden_readings(ckpt, golden)
        emit({"phase": "checkpoint_cli", "step": "golden_768", "write_s": write_s,
              "backend_defaults": {
                  "matmul.allow_tf32": DEFAULT_TF32[0], "cudnn.allow_tf32": DEFAULT_TF32[1],
                  "matmul.allow_bf16_reduced_precision_reduction":
                  torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction},
              "bars_pred_mean": GOLDEN_BARS, **readings})
        for key, bar in GOLDEN_BARS.items():
            got = readings[key]["pred"]["mean"]
            check(got <= bar, f"golden 768 {key}: pred mean abs error {got} > {bar}")

        paths = write_cli_images(root / "images")
        decoded = []
        for p in paths:
            with Image.open(p) as im:
                decoded.append(np.asarray(im.convert("RGB")))
        zero = {k: 0 for k in COUNTERS}
        for name, ck, mode, dt, bs, expect in (
                ("depth_f32_loop", ckpt, "depth", torch.float32, 0,
                 {"K1": 2 * K1_PER_FORWARD + 7, "K2": 2 * K2_PER_FORWARD}),
                ("depth_bf16_batch_auto", ckpt, "depth", torch.bfloat16, -1,
                 {"K1": K1_PER_FORWARD + 7, "K2": K2_PER_FORWARD}),
                ("disparity_dpt_head_bf16_loop", dpt, "disparity_dpt_head", torch.bfloat16, 0,
                 {"K1": 2 * DPT_K1[768] + DPT_K1[480], "K2": 2 * K2_PER_FORWARD})):
            rec = cli_run(name, ck, mode, dt, bs, paths, decoded, root / f"out_{name}")
            check(rec["launches"] == {**zero, **expect},
                  f"CLI {name}: launches {rec['launches']} != {expect}")


# ------------------------------------------------------------------ marigold
# The marigold golden (scripts/make_torch_golden.py run_torch_marigold): the
# one-step golden's weights with conv_in widened to 8 channels, 10 DDIM steps
# over the SD2.1 betas from the stored noise. pred's mean abs error: f32 with
# TF32 off compounds ten UNet passes of the one-step golden's v error
# (3.5e-5 mean) into 1e-3; f32 with the backend's defaults and bf16 are
# held to the golden's own bar.
GOLDEN_MARIGOLD = GOLDEN.parent / "torch_golden_768_marigold.npz"
GOLDEN_SCRIPT = "scripts/make_torch_golden.py"
MARIGOLD_STEPS, MARIGOLD_E = 10, 3
MARIGOLD_BARS = {"f32_tf32_off": 1e-3, "f32_defaults": 1e-2, "bf16": 1e-2}
MARIGOLD_REF_BAR = 1e-2  # bf16 pred, kernels against reference_kernels()
MARIGOLD_REPS = 3
# self-attention transformers per UNet level at head dim 64 (levels 0-2: two
# down, three up; the mid block's at level 3) and the VAE's two mid blocks
UNET_TRANSFORMERS = {0: 5, 1: 5, 2: 5, 3: 1}
UNET_WIDTHS = SD21_ORACLE["unet"]["C"]


def golden_script_function(name: str):
    """A function of scripts/make_torch_golden.py, taken from its syntax tree
    and run without the script's imports."""
    path = Path(__file__).resolve().parent / GOLDEN_SCRIPT
    node = next(n for n in ast.parse(path.read_text()).body
                if isinstance(n, ast.FunctionDef) and n.name == name)
    ns: dict = {}
    exec(compile(ast.Module(body=[node], type_ignores=[]), str(path), "exec"), ns)
    return ns[name]


def ddim_launches(lh: int, lw: int, batch: int, steps: int) -> dict:
    """K1 and K2 launches of one DDIM call at latent lh x lw, derived from
    the routing predicates: K1 where a self-attention routes to flash (the
    UNet's per level, each pass; the VAE encoder's and decoder's mid block),
    K2 where a level's GEGLU feed-forward does; one launch each per call of
    the batch."""
    from genpercept_tpu_torch.ops.attention import routes_to_flash

    k1 = k2 = 0
    h, w = lh, lw
    for level, n in UNET_TRANSFORMERS.items():
        s = h * w
        k1 += n * routes_to_flash(s, s, 64)
        k2 += n * ff.supported(batch, s, UNET_WIDTHS[level])
        h, w = (h + 1) // 2, (w + 1) // 2
    vae = 2 * routes_to_flash(lh * lw, lh * lw, 512)
    return {"K1": steps * k1 + vae, "K2": steps * k2}


def spread(values) -> dict:
    return {"median": float(np.median(values)), "min": float(min(values)),
            "max": float(max(values)), "n": len(values)}


def device_ms(fn, device: str, reps: int) -> dict:
    """ms of each of reps calls of fn after a warm-up: CUDA events on the
    card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        if device == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return spread(times)


def call_seconds(fn) -> dict:
    """Seconds of fn on the card, CUDA events around each of MARIGOLD_REPS
    calls after a warm-up: median, min, max."""
    ms = device_ms(fn, "cuda", MARIGOLD_REPS)
    return {"median_s": ms["median"] / 1e3, "min_s": ms["min"] / 1e3, "max_s": ms["max"] / 1e3,
            "calls": ms["n"]}


def marigold_reading(models, golden: dict, dtype, steps: int = MARIGOLD_STEPS) -> tuple:
    """One marigold build_single_infer call of ``steps`` DDIM steps on the
    golden's rgb and noise: z and pred against the golden (mean, p99, max
    abs error) and the call's launches; pred; and the call again."""
    rgb = torch.from_numpy(golden["rgb"]).to(models.device)
    noise = torch.from_numpy(golden["noise"]).to(models.device)
    infer = build_single_infer(models, PipelineConfig(arch="marigold", denoising_steps=steps,
                                                      dtype=dtype))
    reset_counts()
    pred = infer(rgb, noise=noise)
    launches = launch_counts()
    with torch.no_grad():
        z = vae_encode(models.vae, rgb.to(dtype).permute(0, 3, 1, 2) * 2.0 - 1.0)
    got = {"z": z.permute(0, 2, 3, 1), "pred": pred}
    reading = {k: err_stats(t.float().cpu().numpy(), golden[k]) for k, t in got.items()}
    return {**reading, "launches": launches}, pred, lambda: infer(rgb, noise=noise)


def phase_marigold() -> dict:
    """The marigold arch at full width (section (s)): the golden's weights
    with conv_in widened as the golden's script widens it, written as a
    checkpoint and loaded; 10 DDIM steps held to
    golden/torch_golden_768_marigold.npz three ways with exact launches and
    against reference_kernels(); an ensemble of 3 through __call__; the
    folder CLI with --archs marigold; seconds per image."""
    from PIL import Image

    from genpercept_tpu_torch.cli import run as cli
    from genpercept_tpu_torch.diffusion import SchedulerConfig, leading_timesteps

    t0 = time.perf_counter()
    unet_o, vae_o, fp = golden_oracles()
    check(fingerprint_matches(fp),
          "the golden's weights differ: this torch's default init is not the golden's")
    unet_o = golden_script_function("_conv_in_8ch")(copy.deepcopy(unet_o))
    with np.load(GOLDEN_MARIGOLD) as zf:
        golden = {k: zf[k] for k in zf.files}
    meta = json.loads(str(golden["meta"]))
    check(meta["steps"] == MARIGOLD_STEPS and meta["timesteps"]
          == leading_timesteps(SchedulerConfig(), MARIGOLD_STEPS).tolist(),
          f"the marigold golden's schedule: {meta}")
    # one call of 1 image (the golden) or of an ensemble's MARIGOLD_E members
    zero = {k: 0 for k in COUNTERS}
    per_call = {b: {**zero, **ddim_launches(96, 96, b, MARIGOLD_STEPS)} for b in (1, MARIGOLD_E)}
    per_call_576 = {**zero, **ddim_launches(72, 96, MARIGOLD_E, MARIGOLD_STEPS)}
    check(per_call[1] == per_call[MARIGOLD_E] == {**zero, "K1": 152, "K2": 50}
          and per_call_576 == {**zero, "K1": 52, "K2": 0},
          f"routing predicates: {per_call}, {per_call_576}")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        ckpt = write_oracle_checkpoint(root / "ckpt", unet_o, vae_o, SD21_ORACLE["unet"],
                                       SD21_ORACLE["vae"], golden["ctx"], in_channels=8)
        del unet_o, vae_o
        emit({"phase": "marigold", "step": "golden_weights", "fingerprint_matched": True,
              "conv_in": "8 channels (make_torch_golden._conv_in_8ch)",
              "seconds": time.perf_counter() - t0, "golden_meta": meta})

        readings, times = {}, {}
        for dt in (torch.float32, torch.bfloat16):
            models = load_genpercept_checkpoint(str(ckpt), dtype=dt, device="cuda")
            check(models.unet.cfg.in_channels == 8 and models.unet.conv_in.weight.shape[1] == 8,
                  "the checkpoint's conv_in is not 8 channels wide")
            runs = ((("f32_defaults", DEFAULT_TF32), ("f32_tf32_off", (False, False)))
                    if dt == torch.float32 else (("bf16", DEFAULT_TF32),))
            for name, switches in runs:
                with tf32(*switches):
                    readings[name], pred, again = marigold_reading(models, golden, dt)
                    check(readings[name]["launches"] == per_call[1],
                          f"marigold {name}: launches {readings[name]['launches']}")
                    if name != "f32_tf32_off":
                        times[name] = call_seconds(again)
                if name == "bf16":
                    reset_counts()
                    with reference_kernels(), tf32(*switches):
                        plain = again()
                    torch.cuda.synchronize()
                    readings[name]["launches_reference"] = launch_counts()
                    readings[name]["mean_abs_dev_vs_reference"] = float(
                        (pred - plain).abs().mean())
            if dt == torch.bfloat16:
                ensemble = marigold_ensemble(models, golden, per_call[MARIGOLD_E])
                times["bf16_e3"] = ensemble.pop("seconds")
            del models
            torch.cuda.empty_cache()
        emit({"phase": "marigold", "step": "golden_768", "bars_pred_mean": MARIGOLD_BARS,
              **readings})
        for key, bar in MARIGOLD_BARS.items():
            got = readings[key]["pred"]["mean"]
            check(got <= bar, f"marigold golden {key}: pred mean abs error {got} > {bar}")
        check(not any(readings["bf16"]["launches_reference"].values()),
              "kernels launched under reference_kernels()")
        check(readings["bf16"]["mean_abs_dev_vs_reference"] <= MARIGOLD_REF_BAR,
              f"marigold bf16 kernels vs reference_kernels(): "
              f"{readings['bf16']['mean_abs_dev_vs_reference']}")
        emit({"phase": "marigold", "step": "ensemble", **ensemble})

        paths = write_cli_images(root / "images")
        decoded = []
        for p in paths:
            with Image.open(p) as im:
                decoded.append(np.asarray(im.convert("RGB")))
        out_dir = root / "out_marigold"
        expect = {k: 2 * per_call[MARIGOLD_E][k] + per_call_576[k] for k in zero}
        with tf32(*DEFAULT_TF32):
            reset_counts()
            t1 = time.perf_counter()
            cli.main(["--checkpoint", str(ckpt), "--input_rgb_dir", str(paths[0].parent),
                      "--output_dir", str(out_dir), "--mode", "depth", "--archs", "marigold",
                      "--denoise_steps", str(MARIGOLD_STEPS),
                      "--ensemble_size", str(MARIGOLD_E), "--seed", "0", "--bf16"])
            torch.cuda.synchronize()
            rec = {"seconds": time.perf_counter() - t1, "launches": launch_counts(),
                   "expect": expect}
            pipe = GenPerceptPipeline(
                load_genpercept_checkpoint(str(ckpt), dtype=torch.bfloat16),
                PipelineConfig(arch="marigold", denoising_steps=MARIGOLD_STEPS,
                               ensemble_size=MARIGOLD_E, dtype=torch.bfloat16))
            direct = [pipe(im, generator=torch.Generator("cuda").manual_seed(0))
                      for im in decoded]
            rec["npy_max_abs_diff_vs_pipeline"] = check_cli_outputs(paths, out_dir, "depth",
                                                                    direct)
        rec["files"] = sorted(p.name for p in out_dir.iterdir())
        emit({"phase": "marigold", "step": "cli", **rec})
        check(rec["launches"] == expect, f"marigold CLI: launches {rec['launches']} != {expect}")
        check(rec["npy_max_abs_diff_vs_pipeline"] == 0.0,
              "marigold CLI: an npy differs from the pipeline's output")
        del pipe, direct
        torch.cuda.empty_cache()
    per_image = {k: v["median_s"] / (MARIGOLD_E if k == "bf16_e3" else 1)
                 for k, v in times.items()}
    emit({"phase": "marigold", "step": "seconds_per_768_image", "steps": MARIGOLD_STEPS,
          "per_call": times, "per_image_median_s": per_image,
          "seconds": time.perf_counter() - t0})
    return {"readings": readings, "times": times}


def marigold_ensemble(models, golden: dict, per_call: dict) -> dict:
    """__call__ with E = MARIGOLD_E in bf16 on the golden's rgb: pred in
    [0, 1], a finite uncertainty map of the image's shape, equal seeds equal
    bit for bit, one call's launches those of one 10-step call; its time."""
    with tf32(*DEFAULT_TF32):
        pipe = GenPerceptPipeline(models, PipelineConfig(
            arch="marigold", denoising_steps=MARIGOLD_STEPS, ensemble_size=MARIGOLD_E,
            dtype=torch.bfloat16))
        image = golden["rgb"][0]

        def call():
            return pipe(image, generator=torch.Generator("cuda").manual_seed(SEED))

        reset_counts()
        out = call()
        launches = launch_counts()
        again = call()
        seconds = call_seconds(call)
    rec = {"ensemble_size": MARIGOLD_E, "launches": launches,
           "pred_range": [float(out.pred_np.min()), float(out.pred_np.max())],
           "pred_std": float(out.pred_np.std()),
           "uncertainty_shape": list(out.uncertainty.shape),
           "uncertainty_mean": float(out.uncertainty.mean()),
           "uncertainty_max": float(out.uncertainty.max()),
           "equal_seeds_equal": bool(np.array_equal(out.pred_np, again.pred_np)
                                     and np.array_equal(out.uncertainty, again.uncertainty)),
           "seconds": seconds}
    check(launches == per_call, f"marigold ensemble: launches {launches} != {per_call}")
    check(bool(np.isfinite(out.pred_np).all()) and out.pred_np.min() >= 0.0
          and out.pred_np.max() <= 1.0, "marigold ensemble: pred not finite or outside [0, 1]")
    check(out.pred_np.std() > 1e-4, "marigold ensemble: a constant prediction")
    check(out.uncertainty.shape == image.shape[:2] and bool(np.isfinite(out.uncertainty).all()),
          "marigold ensemble: the uncertainty is not finite or not of the image's shape")
    check(rec["equal_seeds_equal"], "marigold ensemble: equal seeds gave different outputs")
    return rec


def profile_marigold() -> list:
    """Where the device time of one 10-step marigold __call__ on a 768x768
    image goes (not part of main): seeded random weights at full width, the
    UNet's conv_in widened as the golden's; one warm-up call, then one call
    traced with torch.profiler and summarized by
    scripts/profile_torch_slice.py's summarize() (wall, device busy, idle
    share, kernel families): f32 (TF32 off), bf16, bf16 with an ensemble of
    MARIGOLD_E.

        python3 -c "import chip_smoke as c; c.phase_device(); c.phase_build(); c.profile_marigold()"
    """
    from torch.profiler import ProfilerActivity, profile

    summarize = load_script("profile_torch_slice").summarize
    unet, vae, clip = build_models(torch.Generator(device="cuda").manual_seed(SEED))
    unet = golden_script_function("_conv_in_8ch")(unet)
    image = (np.random.default_rng(SEED).uniform(size=(768, 768, 3)) * 255).astype(np.uint8)
    records = []
    for dt, e in ((torch.float32, 1), (torch.bfloat16, 1), (torch.bfloat16, MARIGOLD_E)):
        models = GenPerceptModels(unet=copy.deepcopy(unet).to(dt), vae=copy.deepcopy(vae).to(dt),
                                  clip=copy.deepcopy(clip).to(dt))
        pipe = GenPerceptPipeline(models, PipelineConfig(
            arch="marigold", denoising_steps=MARIGOLD_STEPS, ensemble_size=e, dtype=dt))

        def call():
            return pipe(image, generator=torch.Generator("cuda").manual_seed(SEED))

        call()  # warm-up: cuDNN plans
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1000.0
        rec = {"phase": "marigold_profile", "dtype": str(dt), "ensemble_size": e,
               "steps": MARIGOLD_STEPS, **summarize(prof, wall_ms)}
        rec.pop("all")
        emit(rec)
        records.append(rec)
        del models, pipe, prof
        torch.cuda.empty_cache()
    return records


# --------------------------------------------------------------------- serve
# The serving path (section (t)): the golden's weights as a checkpoint, loaded
# by the server's own start-up, by the hub and by the dataset inference CLI.
SERVE_WARMUPS, SERVE_REQUESTS, SERVE_480_REQUESTS = 2, 10, 3
SERVE_BURST = 8
# the served npy against a direct __call__ on the decoded image, on a
# pipeline loaded from the same checkpoint in the same dtype (backend
# defaults): (statistic, bar)
SERVE_BARS = {torch.float32: ("max", 1e-6), torch.bfloat16: ("mean", 1e-2)}
# each burst response against a lone request's: f32 with TF32 off, bf16
BURST_BARS = {torch.float32: ("max", 1e-4), torch.bfloat16: ("mean", 1e-2)}
HUB_BAR = 1e-6  # the hub's output against the pipeline on its resize, resized back
HUB_CALLS = 3
NYU_YAML = "configs/dataset/eval/nyu.yaml"
NYU_SPLIT = "data_split/nyu/labeled/filename_list_test.txt"
NYU_IMAGES = 3
SERVE_PROMPT = "the depth of an indoor scene, and the hands"
CLIP_SEED = 8


def png_bytes(image: np.ndarray) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="PNG")
    return buf.getvalue()


def decode_png(data: bytes) -> np.ndarray:
    import io

    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im)


def http(url: str, data: bytes | None = None, timeout: float = 600.0) -> bytes:
    import urllib.request

    with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=timeout) as r:
        return r.read()


def npy_of(data: bytes) -> np.ndarray:
    import io

    return np.load(io.BytesIO(data))


def start_server(flags: list):
    """make_server on the flags, with its own start-up (no pipeline
    injected), served on a thread; returns the server and its URL."""
    import threading

    from genpercept_tpu_torch.cli import serve

    server = serve.make_server(serve.build_parser().parse_args(flags))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def stop_server(server) -> None:
    server.shutdown()
    server.server_close()
    server.worker.close()


def served_launches(hw: tuple, batch: int = 1) -> dict:
    """K1 and K2 launches of one genpercept forward of ``batch`` images at
    processing size hw, from the routing predicates; every other kernel 0."""
    return {**{k: 0 for k in COUNTERS}, **ddim_launches(hw[0] // 8, hw[1] // 8, batch, 1)}


def within(stat: tuple, reading: dict) -> bool:
    return reading[stat[0]] <= stat[1]


def serve_reading(ckpt: Path, dt, images: list, device: str = "cuda",
                  processing_res: int = 768) -> dict:
    """The server through make_server(args) in ``dt``: healthz; a 768x768
    PNG through ?format=npy against a direct __call__ on a pipeline loaded
    from the same checkpoint; png16, png and colored against the npy; a bad
    payload's 500 and the request after it; then the latency of
    SERVE_REQUESTS sequential 768x768 /v1/infer_json requests after
    SERVE_WARMUPS (client wall, the server's latency_ms) and of a 480x640,
    beside the direct pipeline call alone; launches per request."""
    from genpercept_tpu_torch.ops.colorize import colorize_depth

    flags = ["--checkpoint", str(ckpt), "--port", "0", "--device", device,
             "--processing_res", str(processing_res)]
    flags += ["--bf16"] if dt == torch.bfloat16 else []
    t0 = time.perf_counter()
    server, url = start_server(flags)
    rec = {"dtype": str(dt), "start_s": time.perf_counter() - t0}
    try:
        rec["healthz"] = json.loads(http(url + "/healthz"))
        direct = GenPerceptPipeline(load_genpercept_checkpoint(str(ckpt), dtype=dt, device=device),
                                    PipelineConfig(processing_res=processing_res, dtype=dt),
                                    device=device)
        pngs = [png_bytes(im) for im in images]
        decoded = [decode_png(p) for p in pngs]
        for _ in range(SERVE_WARMUPS):
            http(url + "/v1/infer?format=npy", pngs[0])
        for i, size in enumerate(("768", "480x640")):
            reset_counts()
            npy = npy_of(http(url + "/v1/infer?format=npy", pngs[i]))
            rec[f"launches_{size}"] = launch_counts()
            ref = direct(decoded[i])
            rec[f"vs_direct_{size}"] = err_stats(npy, ref.pred_np)
            rec[f"shape_{size}"] = list(npy.shape)
            if i == 0:
                pred = npy
        p16 = decode_png(http(url + "/v1/infer?format=png16", pngs[0]))
        p8 = decode_png(http(url + "/v1/infer?format=png", pngs[0]))
        col = decode_png(http(url + "/v1/infer?format=colored", pngs[0]))
        colored = (colorize_depth(torch.from_numpy(pred).to(device)) * 255).to(torch.uint8).cpu()
        rec["formats_consistent"] = {
            "png16": bool(np.array_equal(p16.astype(np.uint16),
                                         (np.clip(pred, 0, 1) * 65535.0).astype(np.uint16))),
            "png": bool(np.array_equal(p8, (np.clip(pred, 0, 1) * 255.0).astype(np.uint8))),
            "colored": bool(np.array_equal(col, colored.numpy()))}
        import urllib.error

        try:
            http(url + "/v1/infer", b"not an image")
            rec["bad_payload"] = {"code": 200}
        except urllib.error.HTTPError as e:
            rec["bad_payload"] = {"code": e.code, "error": json.loads(e.read()).get("error")}
        rec["after_error_equal"] = bool(np.array_equal(
            npy_of(http(url + "/v1/infer?format=npy", pngs[0])), pred))
        import base64

        for i, (size, n) in enumerate((("768", SERVE_REQUESTS), ("480x640", SERVE_480_REQUESTS))):
            body = json.dumps({"image_b64": base64.b64encode(pngs[i]).decode()}).encode()
            client, server_ms = [], []
            for _ in range(n):
                t0 = time.perf_counter()
                out = json.loads(http(url + "/v1/infer_json", body))
                client.append((time.perf_counter() - t0) * 1e3)
                server_ms.append(out["latency_ms"])
            rec[f"latency_{size}"] = {
                "client_ms": spread(client), "server_latency_ms": spread(server_ms),
                "pipeline_call_ms": device_ms(lambda im=decoded[i]: direct(im), device, n)}
        del direct
    finally:
        stop_server(server)
    return rec


class HeldPipeline(GenPerceptPipeline):
    """A served pipeline whose single-image calls, once computed, wait for
    ``release`` (keeping its worker busy while a burst queues), and whose
    .batch calls are recorded: images and seconds."""

    def __call__(self, *args, **kw):
        out = super().__call__(*args, **kw)
        self.holding.set()
        self.release.wait()
        return out

    def batch(self, images, *args, **kw):
        t0 = time.perf_counter()
        outs = super().batch(images, *args, **kw)
        self.batches.append({"images": len(images), "seconds": time.perf_counter() - t0})
        return outs


def burst_reading(ckpt: Path, dt, image: np.ndarray, data_parallel: bool = False,
                  device: str = "cuda", burst: int = SERVE_BURST,
                  processing_res: int = 768) -> dict:
    """``burst`` concurrent identical requests with --max_batch burst, queued
    while the worker holds a lone request: the batches the worker ran, each
    response against the lone request's, requests per second from the
    release to the last response, and the burst's launches."""
    import threading

    flags = ["--checkpoint", str(ckpt), "--port", "0", "--device", device,
             "--max_batch", str(burst), "--processing_res", str(processing_res)]
    flags += ["--bf16"] if dt == torch.bfloat16 else []
    flags += ["--data_parallel"] if data_parallel else []
    server, url = start_server(flags)
    try:
        worker = server.worker
        for pipe in worker.pipes:
            pipe.__class__ = HeldPipeline
            pipe.holding, pipe.release, pipe.batches = threading.Event(), threading.Event(), []
        pipe = worker.pipes[0]
        png = png_bytes(image)
        results: dict = {}

        def send(key):
            results[key] = npy_of(http(url + "/v1/infer?format=npy", png))

        lone = threading.Thread(target=send, args=("lone",))
        lone.start()
        check(pipe.holding.wait(600), "the lone request never reached the pipeline")
        senders = [threading.Thread(target=send, args=(i,)) for i in range(burst)]
        for t in senders:
            t.start()
        deadline = time.perf_counter() + 120
        while worker.q.qsize() < burst:
            check(time.perf_counter() < deadline, f"only {worker.q.qsize()} requests queued")
            time.sleep(0.005)
        reset_counts()
        t0 = time.perf_counter()
        pipe.release.set()
        for t in senders + [lone]:
            t.join()
        wall = time.perf_counter() - t0
        launches = launch_counts()
    finally:
        stop_server(server)
    errs = [err_stats(results[i], results["lone"]) for i in range(burst)]
    return {"dtype": str(dt), "data_parallel": data_parallel, "workers": len(worker.threads),
            "requests": burst, "batches": pipe.batches, "release_to_last_s": wall,
            "requests_per_s": burst / wall, "launches": launches,
            "vs_lone": {"max": max(e["max"] for e in errs),
                        "mean": float(np.mean([e["mean"] for e in errs]))}}


def hub_reading(ckpt: Path, image: np.ndarray, device: str = "cuda", **kw) -> dict:
    """GenPercept_Depth with its defaults (bf16, resolution 512) on a PIL
    image: the output's shape, against the pipeline on the hub's resize
    resized back, launches per image, seconds per image."""
    from PIL import Image

    from genpercept_tpu_torch import hub
    from genpercept_tpu_torch.ops.resize import resize_linear_halfpixel

    t0 = time.perf_counter()
    predictor = hub.GenPercept_Depth(str(ckpt), device=device, **kw)
    load_s = time.perf_counter() - t0
    pil = Image.fromarray(image)
    predictor.infer_pil(pil)  # warm-up
    reset_counts()
    pred = predictor.infer_pil(pil)
    launches = launch_counts()
    x = hub._resize_multiple_of_64(image, predictor.resolution)
    direct = predictor.pipe(x, color_map=None).pred_np
    back = resize_linear_halfpixel(torch.from_numpy(direct)[None, ..., None], image.shape[:2])
    seconds = []
    for _ in range(HUB_CALLS):
        t0 = time.perf_counter()
        predictor.infer_pil(pil)
        seconds.append(time.perf_counter() - t0)
    return {"dtype": str(predictor.pipe.cfg.dtype), "resolution": predictor.resolution,
            "load_s": load_s, "shape": list(pred.shape), "processing_hw": list(x.shape[:2]),
            "vs_pipeline_max": float(np.abs(pred - back[0, ..., 0].numpy()).max()),
            "pred_std": float(pred.std()), "launches": launches,
            "seconds_per_image": spread(seconds)}


def write_nyu_layout(root: Path, hw=(480, 640)) -> tuple:
    """NYU's test layout: the split's first NYU_IMAGES lines as natural-like
    rgb and synthetic depth PNGs in a tar at the yaml's ``dir``, and a copy
    of configs/dataset/eval/nyu.yaml pointed at them (dataset cfg, yaml)."""
    import io
    import re
    import tarfile

    repo = Path(__file__).resolve().parent
    lines = (repo / NYU_SPLIT).read_text().splitlines()[:NYU_IMAGES]
    text = (repo / NYU_YAML).read_text()
    rel = re.search(r"^\s*dir:\s*(\S+)", text, re.M).group(1)
    (root / rel).parent.mkdir(parents=True)
    rgbs = natural_like_images(SEED + 7, NYU_IMAGES, max(hw))
    rng = np.random.default_rng(SEED + 7)
    with tarfile.open(root / rel, "w") as tf:
        for line, im in zip(lines, rgbs):
            for k, path in enumerate(line.split()):
                arr = ((im[:hw[0], :hw[1]] * 255).astype(np.uint8) if k == 0
                       else rng.integers(500, 9000, hw).astype(np.uint16))
                data = png_bytes(arr)
                info = tarfile.TarInfo("./" + path)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    split = root / "split.txt"
    split.write_text("\n".join(lines) + "\n")
    text = re.sub(r"^(\s*filenames:\s*)\S+", lambda m: m.group(1) + str(split), text, flags=re.M)
    (root / "nyu.yaml").write_text(text)
    cfg = {"name": "nyu_v2", "dir": rel, "filenames": str(split), "eigen_valid_mask": True}
    return cfg, root / "nyu.yaml"


def write_prompt_checkpoint(root: Path, ckpt: Path, clip: torch.nn.Module) -> Path:
    """``ckpt``'s unet/, vae/ and embedding linked beside a text_encoder/
    (``clip``'s weights under the published ``text_model.`` keys) and a
    tokenizer/ of a toy vocabulary: every byte's symbol, alone and
    word-final, and a few merges."""
    from genpercept_tpu_torch.utils import tokenizer as tok

    root.mkdir()
    for sub in ("unet", "vae", "empty_text_embed.npy"):
        (root / sub).symlink_to(ckpt / sub)
    (root / "text_encoder").mkdir()
    save_safetensors({f"text_model.{k}": v for k, v in clip.state_dict().items()},
                     str(root / "text_encoder" / "model.safetensors"))
    syms = sorted(set(tok._byte_encoder().values()))
    vocab = {s: i for i, s in enumerate(syms)}
    vocab.update({s + "</w>": len(syms) + i for i, s in enumerate(syms)})
    merges = [("t", "h"), ("th", "e</w>"), ("a", "n"), ("an", "d</w>"), ("e", "r")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab.update({"<|startoftext|>": tok.BOS, "<|endoftext|>": tok.EOS})
    (root / "tokenizer").mkdir()
    (root / "tokenizer" / "vocab.json").write_text(json.dumps(vocab))
    (root / "tokenizer" / "merges.txt").write_text(
        "#version\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return root


def infer_reading(name: str, ckpt: Path, dt, root: Path, data: tuple, prompt: str = "",
                  device: str = "cuda", processing_res: int = 768) -> dict:
    """One in-process run of the dataset inference CLI over the NYU layout:
    its launches and seconds, its file tree against get_pred_name, and each
    npy against the pipeline's output on the dataset's decoded rgb (a fresh
    load of the same checkpoint; the prompt encoded as the CLI encodes it)."""
    from genpercept_tpu_torch.cli import infer as infer_cli
    from genpercept_tpu_torch.data import DatasetMode, get_dataset, get_pred_name

    cfg, yaml_path = data
    out = root / f"infer_{name}"
    argv = ["--checkpoint", str(ckpt), "--dataset_config", str(yaml_path), "--base_data_dir",
            str(root), "--output_dir", str(out), "--device", device,
            "--processing_res", str(processing_res)]
    argv += ["--half_precision"] if dt == torch.bfloat16 else []
    argv += ["--prompt", prompt] if prompt else []
    reset_counts()
    t0 = time.perf_counter()
    infer_cli.main(argv)
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    models = load_genpercept_checkpoint(str(ckpt), dtype=dt, device=device)
    if prompt:
        models.text_embed = models.encode_prompt(prompt)
    pipe = GenPerceptPipeline(models, PipelineConfig(processing_res=processing_res, dtype=dt),
                              device=device)
    ds = get_dataset(cfg, str(root), DatasetMode.RGB_ONLY)
    want, worst = [], 0.0
    for i in range(len(ds)):
        item = ds[i]
        rel = item["rgb_relative_path"]
        want.append(str(Path(rel).parent / get_pred_name(Path(rel).name, ds.name_mode, ".npy")))
        rgb = ((item["rgb_norm"] + 1.0) / 2.0 * 255).astype(np.uint8)
        npy = np.load(out / want[-1])
        worst = max(worst, float(np.abs(npy - pipe(rgb, color_map=None).pred_np).max()))
    files = sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file())
    return {"run": name, "dtype": str(dt), "prompt": prompt, "seconds": seconds,
            "seconds_per_image": seconds / len(ds), "images": len(ds), "launches": launches,
            "files": files, "files_expected": sorted(want), "npy_max_abs_diff_vs_pipeline": worst,
            "npy": {f: np.load(out / f) for f in files}}


def check_served(rec: dict, dt, expect: dict, platform: str, shapes: list) -> None:
    """serve_reading's record within SERVE_BARS, with the launches ``expect``
    {"768": ..., "480x640": ...} and the served shapes."""
    stat = SERVE_BARS[dt]
    for size, shape in zip(("768", "480x640"), shapes):
        check(within(stat, rec[f"vs_direct_{size}"]),
              f"serve {dt} {size}: {stat[0]} {rec[f'vs_direct_{size}'][stat[0]]}")
        check(rec[f"launches_{size}"] == expect[size],
              f"serve {dt} {size}: launches {rec[f'launches_{size}']} != {expect[size]}")
        check(rec[f"shape_{size}"] == list(shape), f"serve {dt} {size}: shape")
    check(rec["healthz"] == {"status": "ok", "mode": "depth", "platform": platform},
          f"healthz: {rec['healthz']}")
    check(all(rec["formats_consistent"].values()), f"formats: {rec['formats_consistent']}")
    check(rec["bad_payload"]["code"] == 500 and bool(rec["bad_payload"].get("error")),
          f"bad payload: {rec['bad_payload']}")
    check(rec["after_error_equal"], "the request after the error differs")


def check_burst(rec: dict, dt, expect: dict, burst: int) -> None:
    """One fused batch of the whole burst, each response within BURST_BARS of
    the lone request's, one worker, the launches ``expect``."""
    check([b["images"] for b in rec["batches"]] == [burst], f"burst {dt}: {rec['batches']}")
    stat = BURST_BARS[dt]
    check(within(stat, rec["vs_lone"]), f"burst {dt}: {rec['vs_lone']}")
    check(rec["launches"] == expect, f"burst {dt}: launches {rec['launches']} != {expect}")
    check(rec["workers"] == 1, f"burst: {rec['workers']} workers on one device")


def check_hub(rec: dict, expect: dict, shape: list) -> None:
    check(rec["shape"] == shape, f"hub shape {rec['shape']}")
    check(rec["vs_pipeline_max"] <= HUB_BAR, f"hub vs pipeline {rec['vs_pipeline_max']}")
    check(rec["launches"] == expect, f"hub launches {rec['launches']} != {expect}")
    check(rec["pred_std"] > 1e-4, "hub: a constant prediction")


def check_infer(rec: dict, expect: dict, images: int) -> None:
    check(rec["files"] == rec["files_expected"] and len(rec["files"]) == images,
          f"infer CLI {rec['run']}: files {rec['files']}")
    check(rec["npy_max_abs_diff_vs_pipeline"] == 0.0,
          f"infer CLI {rec['run']}: an npy differs from the pipeline's output")
    check(rec["launches"] == expect, f"infer CLI {rec['run']}: launches {rec['launches']}")


def phase_serve() -> dict:
    """The serving path at full width (section (t)): the server through its
    own start-up in f32 and bf16 (bars, formats, the error reply, latency,
    launches), a burst of SERVE_BURST in f32 with TF32 off and bf16 and once
    with --data_parallel, the hub's GenPercept_Depth, and the dataset
    inference CLI on NYU's layout in f32, bf16 and with a prompt."""
    t_phase = time.perf_counter()
    unet_o, vae_o, fp = golden_oracles()
    check(fingerprint_matches(fp),
          "the golden's weights differ: this torch's default init is not the golden's")
    with np.load(GOLDEN) as zf:
        ctx = zf["ctx"]
    zero = {k: 0 for k in COUNTERS}
    images = [(natural_like_images(SEED + 9, 1, 768)[0] * 255).astype(np.uint8),
              (natural_like_images(SEED + 10, 1, 768)[0][:480, :640] * 255).astype(np.uint8)]
    summary: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        ckpt = write_oracle_checkpoint(root / "ckpt", unet_o, vae_o, SD21_ORACLE["unet"],
                                       SD21_ORACLE["vae"], ctx)
        del unet_o, vae_o
        expect = {"768": served_launches((768, 768)), "480x640": served_launches((576, 768))}
        check(expect["768"] == {**zero, "K1": 17, "K2": 5}
              and expect["480x640"] == {**zero, "K1": 7, "K2": 0},
              f"routing predicates: {expect}")
        for dt in DTYPES:
            with tf32(*DEFAULT_TF32):
                rec = serve_reading(ckpt, dt, images)
            emit({"phase": "serve", "step": "server", **rec})
            check_served(rec, dt, expect, "cuda", [(768, 768), (480, 640)])
            summary[str(dt)] = {k: rec[k] for k in ("latency_768", "latency_480x640")}

        burst_expect = {**zero, **ddim_launches(96, 96, SERVE_BURST, 1)}
        for dt, dp in ((torch.float32, False), (torch.bfloat16, False), (torch.bfloat16, True)):
            with tf32(*((False, False) if dt == torch.float32 else DEFAULT_TF32)):
                rec = burst_reading(ckpt, dt, images[0], data_parallel=dp)
            emit({"phase": "serve", "step": "burst", **rec})
            check_burst(rec, dt, burst_expect, SERVE_BURST)
            summary[f"burst_{dt}{'_data_parallel' if dp else ''}"] = rec["requests_per_s"]

        with tf32(*DEFAULT_TF32):
            rec = hub_reading(ckpt, images[1])
        emit({"phase": "serve", "step": "hub", **rec})
        check_hub(rec, served_launches(tuple(rec["processing_hw"])), [480, 640])
        summary["hub_seconds_per_image"] = rec["seconds_per_image"]

        data = write_nyu_layout(root / "nyu")
        clip = CLIPTextModel()
        init_params_(clip, torch.Generator().manual_seed(SEED + CLIP_SEED))
        ckpt_prompt = write_prompt_checkpoint(root / "ckpt_prompt", ckpt, clip)
        del clip
        infer_expect = {k: NYU_IMAGES * n for k, n in served_launches((576, 768)).items()}
        npys = {}
        for name, ck, dt, prompt in (("f32", ckpt, torch.float32, ""),
                                     ("bf16", ckpt, torch.bfloat16, ""),
                                     ("bf16_prompt", ckpt_prompt, torch.bfloat16, SERVE_PROMPT)):
            with tf32(*DEFAULT_TF32):
                rec = infer_reading(name, ck, dt, root / "nyu", data, prompt)
            npys[name] = rec.pop("npy")
            emit({"phase": "serve", "step": "infer_cli", **rec})
            check_infer(rec, infer_expect, NYU_IMAGES)
            summary[f"infer_{name}_seconds_per_image"] = rec["seconds_per_image"]
        moved = max(float(np.abs(npys["bf16_prompt"][f] - npys["bf16"][f]).max())
                    for f in npys["bf16"])
        check(moved > 1e-3, f"the prompt did not reach the UNet ({moved})")
    torch.cuda.empty_cache()
    emit({"phase": "serve", "step": "summary", "prompt_vs_empty_max": moved,
          "seconds": time.perf_counter() - t_phase, **summary})
    return summary


# ---------------------------------------------------------------- train_eval
# The train -> export -> infer -> eval loop (section (u)) through the port's
# CLIs, with the golden's weights (section (r)) as the base checkpoint and
# the main-paper recipe read from files in the real readers' layouts.
TE_RECIPE = "configs/train/main_paper/depth.yaml"
TE_VKITTI_HW = (375, 1242)  # vKITTI's raster; kitti_bm_crop takes 352x1216
TE_SAMPLES = {"hypersim": 32, "vkitti": 32, "val": 4, "vis": 2}
# the keys of the recipe the phase may change (everything else is the file's)
TE_CHANGED = ("dir", "filenames", "max_iter", "trainer.save_period",
              "trainer.validation_period", "trainer.visualization_period")
# cli/eval.py's metrics against a float64 numpy recomputation, relative; the
# delta fractions absolute (a prediction clipped to the range's end can sit
# exactly on a threshold in float64 and either side of it in f32) and silog
# relative 1e-4 (its mean(d^2) - mean(d)^2 cancels in f32), as
# tests/test_torch_eval_cli.py reads them on the CPU
TE_EVAL_TOL = {"rel": 1e-5, "delta_abs": 5e-4, "silog_rel": 1e-4}
# evaluate_dataset's abs_relative_difference and delta1_acc, kernels against
# reference_kernels(), absolute
TE_HARNESS_TOL = {torch.bfloat16: 1e-3, torch.float32: 1e-5}


def te_depth(rng, hw, lo: float, hi: float, scale: float) -> np.ndarray:
    """A smooth depth map in [lo, hi] metres as integer PNG units (``scale``
    per metre), with one invalid (0) block."""
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    f, ph = rng.uniform(0.5, 2.0, 3), rng.uniform(0, 2 * np.pi, 3)
    d = np.sin(2 * np.pi * f[0] * xx + ph[0]) + np.sin(2 * np.pi * f[1] * yy + ph[1]) \
        + 0.5 * np.sin(2 * np.pi * f[2] * (xx + yy) + ph[2])
    d = lo + (hi - lo) * (d - d.min()) / (d.max() - d.min())
    out = np.round(d * scale).astype(np.uint16)
    y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
    out[y0:y0 + h // 8, x0:x0 + w // 8] = 0
    return out


def write_train_data(root: Path) -> dict:
    """The recipe's datasets in their readers' layouts under ``root``:
    Hypersim as a jsonl-metadata directory per split (train, val, vis; rgb
    PNG and depth PNG in mm at 480x640) and vKITTI as a split file (rgb and
    depth PNG in cm at 375x1242; uniform-noise rgb: the first steps do not
    draw from it). The train split also has a smooth normal map (RGB PNG,
    channels in [30, 225], one invalid 0 block) and a DIS map (grey PNG)
    per sample, listed
    by a second metadata directory with all four (train_gt, train_extras'
    normal recipe) and a third with rgb and DIS only (dis5k, its DIS
    recipe). Returns {split: (dir, filenames)}. The arrays are drawn in
    order and the PNGs encoded by a pool of threads (the encoder releases
    the GIL)."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    pngs: list = []  # (array, path)

    def save(array, path):
        pngs.append((array, path))

    meta = root / "meta"
    meta.mkdir(parents=True)
    out = {}
    for k, split in enumerate(("train", "val", "vis")):
        rows = []
        n = TE_SAMPLES["hypersim" if split == "train" else split]
        (root / "hypersim" / split).mkdir(parents=True)
        rng = np.random.default_rng(SEED + 20 + k)
        rgbs = natural_like_images(SEED + 20 + k, n, max(TRAIN_HW))[:, :TRAIN_HW[0]]
        gt_rows, dis_rows = [], []
        rng_gt = np.random.default_rng(SEED + 24)  # apart: the depth maps stay as they were
        for i in range(n):
            rgb, depth = f"{split}/rgb_{i:03d}.png", f"{split}/depth_{i:03d}.png"
            save((rgbs[i] * 255).astype(np.uint8), root / "hypersim" / rgb)
            save(te_depth(rng, TRAIN_HW, 1.0, 20.0, 1000.0), root / "hypersim" / depth)
            rows.append(json.dumps({"image": rgb, "depth_conditioning_image": depth}))
            if split != "train":
                continue
            normal, dis = f"{split}/normal_{i:03d}.png", f"{split}/dis_{i:03d}.png"
            nmap = np.stack([te_depth(rng_gt, TRAIN_HW, 30.0, 225.0, 1.0) for _ in range(3)], -1)
            save(nmap.astype(np.uint8), root / "hypersim" / normal)
            save(te_depth(rng_gt, TRAIN_HW, 0.0, 255.0, 1.0).astype(np.uint8),
                 root / "hypersim" / dis)
            gt_rows.append(json.dumps({"image": rgb, "depth_conditioning_image": depth,
                                       "normal_conditioning_image": normal,
                                       "dis_conditioning_image": dis}))
            dis_rows.append(json.dumps({"image": rgb, "dis_conditioning_image": dis}))
        for name, lines_ in ((f"hypersim_{split}", rows), ("hypersim_train_gt", gt_rows),
                             ("dis5k_train", dis_rows)):
            if lines_:
                (meta / name).mkdir()
                (meta / name / "metadata.jsonl").write_text("\n".join(lines_) + "\n")
        out[split] = ("hypersim", str(meta / f"hypersim_{split}"))
        if split == "train":
            out["train_gt"] = ("hypersim", str(meta / "hypersim_train_gt"))
            out["dis5k"] = ("hypersim", str(meta / "dis5k_train"))
    lines = []
    (root / "vkitti" / "rgb").mkdir(parents=True)
    (root / "vkitti" / "depth").mkdir()
    rng = np.random.default_rng(SEED + 23)
    for i in range(TE_SAMPLES["vkitti"]):
        rgb = rng.integers(0, 256, TE_VKITTI_HW + (3,), dtype=np.uint8)
        save(rgb, root / "vkitti" / f"rgb/{i:03d}.png")
        save(te_depth(rng, TE_VKITTI_HW, 2.0, 70.0, 100.0), root / "vkitti" / f"depth/{i:03d}.png")
        lines.append(f"rgb/{i:03d}.png depth/{i:03d}.png")
    (meta / "vkitti_train.txt").write_text("\n".join(lines) + "\n")
    out["vkitti"] = ("vkitti", str(meta / "vkitti_train.txt"))
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        list(pool.map(lambda job: Image.fromarray(job[0]).save(job[1]), pngs))
    return out


def flat_config(tree, prefix: str = "") -> dict:
    """{dotted key: leaf}, list items keyed by their index."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            out.update(flat_config(v, key + "."))
        else:
            out[key] = v
    return out


def write_recipe(path: Path, data: dict, max_iter: int, val_vis_period: int) -> dict:
    """TE_RECIPE merged as the CLI merges it, with only TE_CHANGED keys set:
    the datasets' dir and filenames pointed at ``data``, max_iter, no
    periodic checkpoint, validation and visualization every
    ``val_vis_period`` steps (0: off). Returns the merged config."""
    import yaml

    from genpercept_tpu_torch.utils.config import recursive_load_config

    with contextlib.chdir(Path(__file__).resolve().parent):
        original = json.loads(json.dumps(recursive_load_config(TE_RECIPE)))
    cfg = copy.deepcopy(original)
    hs, vk = cfg["dataset"]["train"]["dataset_list"]
    for entry, key in ((hs, "train"), (vk, "vkitti"), (cfg["dataset"]["val"][0], "val"),
                       (cfg["dataset"]["vis"][0], "vis")):
        entry["dir"], entry["filenames"] = data[key]
    cfg["max_iter"] = max_iter
    cfg["trainer"].update(save_period=0, validation_period=val_vis_period,
                          visualization_period=val_vis_period)
    a, b = flat_config(original), flat_config(cfg)
    changed = sorted(k for k in a.keys() | b.keys() if a.get(k) != b.get(k))
    check(a.keys() == b.keys() and all(k.endswith(TE_CHANGED) for k in changed),
          f"the recipe changed beyond {TE_CHANGED}: {changed}")
    path.write_text(yaml.safe_dump(cfg))
    return cfg


def te_sources(cfg: dict, steps: int) -> list:
    """The dataset each of a fresh run's first ``steps`` optimizer steps
    draws from: the trainer's sampler replayed on indices alone. The phase
    expects Hypersim's 480x640 micro-steps (STEP_LAUNCHES) throughout."""
    train = cfg["dataset"]["train"]
    sizes = [TE_SAMPLES["hypersim"], TE_SAMPLES["vkitti"]]
    batch = cfg["dataloader"]["max_train_batch_size"] * ACCUM
    sampler = MixedBatchSampler([range(n) for n in sizes], batch_size=batch,
                                prob=train["prob_ls"],
                                generator=np.random.default_rng(cfg["trainer"]["init_seed"]))
    out = []
    while len(out) < steps:
        for b in sampler:
            out.append(train["dataset_list"][int(b[0] >= sizes[0])]["name"])
            if len(out) == steps:
                break
    return out


def metrics_log(run_dir: Path) -> dict:
    """{tag: [(step, value, host time), ...]} from the run's metrics.jsonl."""
    out: dict = {}
    for line in (run_dir / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        for k, v in rec.items():
            if k not in ("t", "step"):
                out.setdefault(k, []).append((rec["step"], v, rec["t"]))
    return out


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def train_cli_run(recipe: Path, ckpt: Path, data_root: Path, out: Path,
                  resume: str | None = None, extra: tuple = (), switches=DEFAULT_TF32):
    """cli/train.py in-process with the TF32 ``switches`` (the backend's
    defaults): the Trainer, its launches, wall seconds and peak device
    memory."""
    from genpercept_tpu_torch.cli import train as train_cli

    argv = ["--config", str(recipe), "--checkpoint", str(ckpt), "--base_data_dir",
            str(data_root), "--output_dir", str(out), "--device", "cuda", *extra]
    argv += ["--resume_run", resume] if resume else []
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with tf32(*switches):
        trainer = train_cli.main(argv)
    torch.cuda.synchronize()
    rec = {"seconds": time.perf_counter() - t0, "launches": launch_counts(),
           "peak_bytes": torch.cuda.max_memory_allocated()}
    return trainer, rec


def step_walls_ms(log: dict) -> list:
    """Host ms between consecutive steps' first scalar (loss synchronised):
    each step's loader wait, batch upload and step."""
    t = [x[2] for x in log["train/loss"]]
    return [(b - a) * 1e3 for a, b in zip(t, t[1:])]


def eval_f64(ds, pred_dir: Path, alignment: str) -> dict:
    """cli/eval.py's protocol with every metric in float64 numpy (the numpy
    alignment is the CLI's own)."""
    from genpercept_tpu_torch.data import get_pred_name
    from genpercept_tpu_torch.eval import align_depth_least_square, depth2disparity

    rows = []
    for i in range(len(ds)):
        item = ds[i]
        rel = item["rgb_relative_path"]
        pred = np.load(pred_dir / Path(rel).parent / get_pred_name(Path(rel).name, ds.name_mode,
                                                                   ".npy"))
        gt = np.asarray(item["depth_raw_linear"], np.float64)
        valid = np.asarray(item["valid_mask_raw"]).astype(bool)
        if alignment == "least_square":
            pred, _, _ = align_depth_least_square(gt, pred, valid)
        else:
            gt_disp, nonneg = depth2disparity(gt, return_mask=True)
            disp, _, _ = align_depth_least_square(gt_disp, pred, valid & nonneg & (pred > 0))
            pred = depth2disparity(np.clip(disp, 1e-3, None))
        pred = np.clip(np.clip(pred, ds.min_depth, ds.max_depth), 1e-6, None)
        p = pred.astype(np.float32)[valid].astype(np.float64)
        g = gt.astype(np.float32)[valid].astype(np.float64)
        d = np.log(p) - np.log(g)
        ratio = np.maximum(p / g, g / p)
        rows.append({"abs_relative_difference": np.mean(np.abs(p - g) / g),
                     "squared_relative_difference": np.mean((p - g) ** 2 / g),
                     "rmse_linear": np.sqrt(np.mean((p - g) ** 2)),
                     "rmse_log": np.sqrt(np.mean(d**2)),
                     "log10": np.mean(np.abs(np.log10(p) - np.log10(g))),
                     "delta1_acc": np.mean(ratio < 1.25), "delta2_acc": np.mean(ratio < 1.25**2),
                     "delta3_acc": np.mean(ratio < 1.25**3),
                     "i_rmse": np.sqrt(np.mean((1 / p - 1 / g) ** 2)),
                     "silog_rmse": np.sqrt(max(np.mean(d**2) - np.mean(d) ** 2, 0.0)) * 100})
    return {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}


def eval_errors(got: dict, want: dict) -> dict:
    """Each metric's error as TE_EVAL_TOL measures it, and whether it is
    within its bar."""
    out = {}
    for k, v in want.items():
        if k.startswith("delta"):
            err, bar = abs(got[k] - v), TE_EVAL_TOL["delta_abs"]
        else:
            err = abs(got[k] - v) / abs(v)
            bar = TE_EVAL_TOL["silog_rel" if k == "silog_rmse" else "rel"]
        out[k] = {"err": err, "bar": bar, "ok": err <= bar}
    return out


def te_workspace(root: Path) -> dict:
    """The golden's weights as a published-layout base checkpoint and the
    recipes' data files under ``root``: what train_eval and train_extras
    train from."""
    unet_o, vae_o, fp = golden_oracles()
    check(fingerprint_matches(fp),
          "the golden's weights differ: this torch's default init is not the golden's")
    with np.load(GOLDEN) as zf:
        golden = {k: zf[k] for k in ("rgb", "ctx")}
    ckpt = write_oracle_checkpoint(root / "ckpt", unet_o, vae_o, SD21_ORACLE["unet"],
                                   SD21_ORACLE["vae"], golden["ctx"])
    del unet_o, vae_o
    t0 = time.perf_counter()
    data = write_train_data(root / "data")
    return {"root": root, "ckpt": ckpt, "golden": golden, "data": data,
            "data_s": time.perf_counter() - t0}


def phase_train_eval(train_run_ms: float | None = None, ws: dict | None = None) -> dict:
    """The loop at full width (section (u)): run A trains 2 steps of the
    recipe from its files and validates and visualizes at step 2; run R
    resumes A's final checkpoint with nothing left to train (its state
    against A's trainer); the export of A's final checkpoint; the dataset
    inference and eval CLIs on it; evaluate_dataset in bf16 and f32; run B
    resumes A to step 3; run C trains 3 steps straight. ``ws``: the base
    checkpoint and data of ``te_workspace`` (made in a temporary directory
    when not given)."""
    import csv

    from genpercept_tpu_torch.cli import eval as eval_cli
    from genpercept_tpu_torch.cli import export as export_cli
    from genpercept_tpu_torch.cli import infer as infer_cli
    from genpercept_tpu_torch.data import DatasetMode, get_dataset, get_pred_name
    from genpercept_tpu_torch.eval.harness import evaluate_dataset
    from genpercept_tpu_torch.io.weights import load_safetensors

    if ws is None:
        with tempfile.TemporaryDirectory() as tmp:
            return phase_train_eval(train_run_ms, te_workspace(Path(tmp)))
    t_phase = time.perf_counter()
    dev = "cuda"
    root, ckpt, golden, data, data_s = (ws[k] for k in ("root", "ckpt", "golden", "data",
                                                         "data_s"))
    # the eval-mode readers keep the files' raster (resize_to_hw acts on
    # training samples), so validation and visualization run at 480x640
    served = served_launches(TRAIN_HW)
    write_recipe(root / "recipe_a.yaml", data, 2, 2)
    write_recipe(root / "recipe_b.yaml", data, 3, 2)
    cfg_c = write_recipe(root / "recipe_c.yaml", data, 3, 0)
    sources = te_sources(cfg_c, 3)
    check(sources == ["hypersim"] * 3, f"the recipe's first steps draw {sources}")
    emit({"phase": "train_eval", "step": "data", "seconds": data_s, "samples": TE_SAMPLES,
          "step_sources": sources, "recipe": TE_RECIPE, "changed": list(TE_CHANGED)})

    # run A: 2 steps, validation and visualization at step 2
    run_a = root / "run"
    trainer, rec = train_cli_run(root / "recipe_a.yaml", ckpt, root / "data", run_a)
    log = metrics_log(run_a)
    vis = sorted(p.name for p in (run_a / "visualization" / "iter_000002").iterdir())
    val_tag = "val/hypersim/abs_relative_difference"
    val_s = log[val_tag][0][2] - log["train/grad"][-1][2]
    expect_a = {k: 2 * ACCUM * n + (TE_SAMPLES["val"] + TE_SAMPLES["vis"]) * served[k]
                for k, n in STEP_LAUNCHES.items()}
    rec_a = {"phase": "train_eval", "step": "run_a", **rec,
             "losses": [x[1] for x in log["train/loss"]],
             "val": {t.split("/")[-1]: v[0][1] for t, v in log.items()
                     if t.startswith("val/")},
             "val_s_per_image": val_s / TE_SAMPLES["val"], "vis_files": vis,
             "launches_expected": expect_a,
             "files": sorted(p.name for p in run_a.iterdir())}
    emit(rec_a)
    for f in ("config.yaml", "code_snapshot.tar.gz", "metrics.jsonl", "logging.log"):
        check((run_a / f).is_file(), f"run A wrote no {f}")
    check((run_a / "checkpoint" / "final" / "state.pt").is_file(), "run A: no final")
    check([x[0] for x in log["train/loss"]] == [1, 2], f"run A steps {log['train/loss']}")
    check(all(math.isfinite(x) for x in rec_a["losses"]), f"run A losses {rec_a['losses']}")
    check(log[val_tag][0][0] == 2 and math.isfinite(log[val_tag][0][1]),
          f"run A validation {log.get(val_tag)}")
    check(vis == [f"hypersim_{j:03d}.png" for j in range(TE_SAMPLES["vis"])],
          f"run A visualization {vis}")
    check(rec["launches"] == expect_a, f"run A launches {rec['launches']} != {expect_a}")

    # run R: A's recipe resumed from its final checkpoint, nothing left
    # to train: the CLI's restore against A's trainer, bit for bit
    restored, rec_r0 = train_cli_run(root / "recipe_a.yaml", ckpt, root / "data", run_a,
                                     resume="final")
    opt_a, opt_r = trainer.optimizer, restored.optimizer
    restore_diff = {
        "trainable": max(float((p.detach().float() - restored.trainable[k].detach().float())
                               .abs().max()) for k, p in trainer.trainable.items()),
        "adam": max(float((opt_a.state[p][m].float() - opt_r.state[q][m].float()).abs().max())
                    for p, q in zip(trainer.trainable.values(), restored.trainable.values())
                    for m in ("mu", "nu")),
        "mu_dtype": str(opt_r.state[next(iter(restored.trainable.values()))]["mu"].dtype),
        "count": [g["count"] for g in opt_r.param_groups],
        "counters": restored._counters() == trainer._counters()}
    del restored
    emit({"phase": "train_eval", "step": "restore", **rec_r0, **restore_diff})
    check(restore_diff["trainable"] == 0.0 and restore_diff["adam"] == 0.0
          and restore_diff["counters"] and restore_diff["mu_dtype"] == "torch.bfloat16"
          and restore_diff["count"] == [g["count"] for g in opt_a.param_groups],
          f"the resumed state differs from run A's: {restore_diff}")
    check(not any(rec_r0["launches"].values()), "run R launched a kernel")

    # the export of A's final checkpoint
    exp = root / "export"
    t0 = time.perf_counter()
    export_cli.main(["--run_dir", str(run_a), "--base_checkpoint", str(ckpt), "--name",
                     "final", "--output_dir", str(exp), "--device", dev])
    export_s = time.perf_counter() - t0
    exported = load_safetensors(str(exp / "unet" / "diffusion_pytorch_model.safetensors"))
    trained = {k[len("unet."):]: p.detach() for k, p in trainer.trainable.items()}
    export_err = max(float((exported[k] - p.float().cpu()).abs().max())
                     for k, p in trained.items())
    base_unet = load_safetensors(str(ckpt / "unet" / "diffusion_pytorch_model.safetensors"))
    moved = max(float((exported[k] - base_unet[k]).abs().max()) for k in trained)
    rgb = torch.from_numpy(golden["rgb"]).to(dev)
    m_exp = load_genpercept_checkpoint(str(exp), base_ckpt_dir=str(ckpt), device=dev)
    m_swap = load_genpercept_checkpoint(str(ckpt), device=dev)
    m_swap.unet.load_state_dict(trained)
    pred_exp = build_single_infer(m_exp, PipelineConfig())(rgb)
    pred_swap = build_single_infer(m_swap, PipelineConfig())(rgb)
    del trainer, trained, m_swap, exported, base_unet
    torch.cuda.empty_cache()
    rec_x = {"phase": "train_eval", "step": "export", "seconds": export_s,
             "files": sorted(str(p.relative_to(exp)) for p in exp.rglob("*") if p.is_file()),
             "unet_vs_trained_max": export_err, "unet_moved_from_base_max": moved,
             "depth_vs_swapped_max": float((pred_exp - pred_swap).abs().max())}
    emit(rec_x)
    check(export_err == 0.0, f"export: a UNet tensor differs from the trained one ({export_err})")
    check(moved > 0.0, "export: the trained UNet equals the base")
    check(rec_x["depth_vs_swapped_max"] == 0.0,
          f"export: depth {rec_x['depth_vs_swapped_max']} from the swapped-in pipeline")

    # infer -> eval on the export, NYU's layout
    nyu_cfg, nyu_yaml = write_nyu_layout(root / "nyu")
    ds = get_dataset(nyu_cfg, str(root / "nyu"), DatasetMode.EVAL)
    want = sorted(str(Path(p[0]).parent / get_pred_name(Path(p[0]).name, ds.name_mode,
                                                         ".npy")) for p in ds.filenames)
    pred_dir = root / "eval_pred"
    reset_counts()
    t0 = time.perf_counter()
    with tf32(*DEFAULT_TF32):
        infer_cli.main(["--checkpoint", str(exp), "--base_ckpt_dir", str(ckpt),
                        "--dataset_config", str(nyu_yaml), "--base_data_dir",
                        str(root / "nyu"), "--output_dir", str(pred_dir), "--device", dev])
    infer_s = time.perf_counter() - t0
    infer_launches = launch_counts()
    infer_expect = {k: NYU_IMAGES * n for k, n in served_launches((576, 768)).items()}
    got_files = sorted(str(p.relative_to(pred_dir)) for p in pred_dir.rglob("*")
                       if p.is_file())
    evals = {}
    for alignment in ("least_square", "least_square_disparity"):
        out = root / f"eval_{alignment}"
        t0 = time.perf_counter()
        summary_cli = eval_cli.main(["--dataset_config", str(nyu_yaml), "--base_data_dir",
                                     str(root / "nyu"), "--prediction_dir", str(pred_dir),
                                     "--output_dir", str(out), "--alignment", alignment,
                                     "--device", dev])
        eval_s = time.perf_counter() - t0
        with open(out / "per_sample_metrics.csv", newline="") as f:
            rows = list(csv.DictReader(f))
        errors = eval_errors(summary_cli, eval_f64(ds, pred_dir, alignment))
        evals[alignment] = {"summary": summary_cli, "errors": errors,
                            "s_per_image": eval_s / len(ds),
                            "csv_samples": [r["sample"] for r in rows],
                            "eval_metrics_txt": (out / "eval_metrics.txt").read_text()}
    rec_e = {"phase": "train_eval", "step": "infer_eval", "infer_s": infer_s,
             "infer_s_per_image": infer_s / len(ds), "infer_launches": infer_launches,
             "infer_files": got_files, "eval": evals}
    emit(rec_e)
    check(got_files == want, f"infer CLI files {got_files} != {want}")
    check(infer_launches == infer_expect, f"infer launches {infer_launches}")
    for alignment, e in evals.items():
        bad = {k: v for k, v in e["errors"].items() if not v["ok"]}
        check(not bad, f"eval {alignment}: off the float64 recomputation {bad}")
        check(sorted(e["csv_samples"]) == want, f"eval {alignment}: csv {e['csv_samples']}")
        check(e["eval_metrics_txt"].startswith("Eval metrics: dataset nyu_v2"),
              f"eval {alignment}: eval_metrics.txt")

    # the batched harness on the same dataset, kernels against plain
    harness = {}
    b = 2
    sizes = [b] * (len(ds) // b) + ([len(ds) % b] if len(ds) % b else [])
    h_expect = {k: 0 for k in COUNTERS}
    for n in sizes:
        for k, v in ddim_launches(60, 80, n, 1).items():
            h_expect[k] += v
    for dt in (torch.bfloat16, torch.float32):
        reset_counts()
        t0 = time.perf_counter()
        res = evaluate_dataset(m_exp, ds, batch_size=b, processing_res=768, dtype=dt,
                               device=dev)
        secs = time.perf_counter() - t0
        counts = launch_counts()
        reset_counts()
        with reference_kernels():
            ref = evaluate_dataset(m_exp, ds, batch_size=b, processing_res=768, dtype=dt,
                                   device=dev)
        ref_counts = launch_counts()
        diff = {k: abs(res[k] - ref[k]) for k in ("abs_relative_difference", "delta1_acc")}
        harness[str(dt)] = {"metrics": res, "reference": ref, "diff": diff,
                            "bar": TE_HARNESS_TOL[dt], "s_per_image": secs / len(ds),
                            "launches": counts, "launches_reference": ref_counts}
    emit({"phase": "train_eval", "step": "harness", "launches_expected": h_expect,
          **harness})
    for dt in (torch.bfloat16, torch.float32):
        h = harness[str(dt)]
        check(h["launches"] == h_expect, f"harness {dt}: launches {h['launches']}")
        check(not any(h["launches_reference"].values()),
              f"harness {dt}: kernels under reference_kernels()")
        check(all(v <= TE_HARNESS_TOL[dt] for v in h["diff"].values()),
              f"harness {dt}: {h['diff']}")
    del m_exp
    shutil.rmtree(exp)

    # run B: A resumed from its final checkpoint to step 3
    trainer, rec_b = train_cli_run(root / "recipe_b.yaml", ckpt, root / "data", run_a,
                                   resume="final")
    check(trainer.effective_iter == 3, f"run B ended at iter {trainer.effective_iter}")
    del trainer
    log_b = metrics_log(run_a)
    shutil.rmtree(run_a)
    expect_b = {k: ACCUM * n for k, n in STEP_LAUNCHES.items()}
    # run C: 3 steps straight, validation off, as one NCCL rank (a process
    # group of one, started by the CLI's --coordinator_address): its steps
    # 1-2 against A's, which ran without torch.distributed
    run_c = root / "run_c"
    trainer, rec_c = train_cli_run(
        root / "recipe_c.yaml", ckpt, root / "data", run_c,
        extra=("--coordinator_address", f"localhost:{free_port()}", "--num_processes", "1",
               "--process_id", "0"))
    del trainer
    log_c = metrics_log(run_c)
    shutil.rmtree(run_c)
    torch.cuda.empty_cache()
    loss_b = [x for x in log_b["train/loss"] if x[0] == 3]
    loss_c = [x[1] for x in log_c["train/loss"]]
    walls = step_walls_ms(log_c)
    rec_r = {"phase": "train_eval", "step": "resume", "run_b": rec_b, "run_c": rec_c,
             "losses_a": rec_a["losses"], "losses_c": loss_c,
             "loss_b_step3": loss_b[0][1] if loss_b else None,
             "launches_expected_b": expect_b,
             "launches_expected_c": {k: STEPS * ACCUM * n
                                     for k, n in STEP_LAUNCHES.items()},
             "run_c_process_group": "nccl, world 1 (--coordinator_address)",
             "cli_step_wall_ms": walls, "cli_ms_per_step": float(np.median(walls)),
             "train_run_ms_per_step": train_run_ms}
    # reported, not bounded: the resumed run restarts the sample stream
    # (the trainer saves final after leaving its epoch, as JAX's), so its
    # step 3 draws the stream's first batch with fresh flips and C's its
    # third: the same 32 images in another order, other flips
    rec_r["step3_rel_diff"] = (abs(rec_r["loss_b_step3"] - loss_c[2]) / abs(loss_c[2])
                               if loss_b else None)
    rec_r["steps12_rel_diff_a_c"] = [abs(a - c) / abs(c)
                                     for a, c in zip(rec_a["losses"], loss_c)]
    emit(rec_r)
    check(len(loss_b) == 1 and [x[0] for x in log_b["train/loss"]] == [1, 2, 3],
          f"run B did not continue at iter 3: {log_b['train/loss']}")
    check(rec_b["launches"] == expect_b, f"run B launches {rec_b['launches']}")
    check(rec_c["launches"] == rec_r["launches_expected_c"],
          f"run C launches {rec_c['launches']}")
    check(len(loss_c) == 3 and all(math.isfinite(x) for x in loss_c), f"run C {loss_c}")
    check(math.isfinite(rec_r["loss_b_step3"]), f"run B's step 3 loss {rec_r['loss_b_step3']}")
    check(max(rec_r["steps12_rel_diff_a_c"]) <= DP_LOSS_TOL,
          f"run C (one NCCL rank) against run A: {rec_r['steps12_rel_diff_a_c']}")
    summary = {"cli_ms_per_step": rec_r["cli_ms_per_step"], "train_run_ms_per_step": train_run_ms,
               "peak_bytes": rec_c["peak_bytes"], "val_s_per_image": rec_a["val_s_per_image"],
               "export_s": export_s,
               "eval_s_per_image": {a: e["s_per_image"] for a, e in evals.items()},
               "infer_s_per_image": rec_e["infer_s_per_image"],
               "harness_s_per_image": {k: h["s_per_image"] for k, h in harness.items()},
               "seconds": time.perf_counter() - t_phase}
    emit({"phase": "train_eval", "step": "summary", **summary})
    return summary


# train_extras: the other recipe families through cli/train.py, from
# te_workspace's checkpoint and files, each for TX_STEPS optimizer steps of
# its accumulation (recipe files merged with only TE_CHANGED keys set)
TX_RUNS = {
    "normal": "configs/train/main_paper/normal.yaml",
    "dis_latent": "configs/train/others/dis_mse_with_latent_loss.yaml",
    "dpt_head": "configs/train/ablation/components/dpt_head_identity_mse_loss.yaml",
    "lora": "configs/train/depth_lora.yaml",
    "marigold": "configs/train/depth_marigold.yaml",
    "rgb_blending": "configs/train/ablation/beta_values/rgb_blending_0p00085_0p012.yaml",
}
# one optimizer step a run: the depth cut that keeps the whole script within
# its time limit (a second step's wall, the recipe's ms per step after the
# first, is not read). LoRA takes two: its adapters' B starts at zero and
# the recipe's warmup gives the first step a learning rate of 0, so only a
# second step shows that the adapters train
TX_STEPS = 1
TX_RUN_STEPS = {"lora": 2}
# each run's fidelity check (kernels against reference_kernels(), one
# micro-batch's first images: the plain attention at 768^2 holds its
# scores in memory), in the run's dtype and, for a bf16 run, in f32 too, on
# f32 copies of the same weights: the loss to GRAD_TOL's bars in both. The
# f32 pair is free of bf16's conditioning, so it is the kernels' witness:
# its gradients meet GRAD_TOL's f32 bar (1e-4) wherever the loss is smooth
# (TX_SMOOTH) and on TX_F32_BOUNDED (normal's angular: 1.63e-5 in two
# runs). A recipe with another loss runs a second check with mse alone in
# its mode (their conditioning: SSI's median branch, see GRAD_TOL; grad's
# and l1's signs; angular's arccos, a derivative of 1 / sqrt(1 - cos^2),
# up to ~70 at the 1 - 1e-4 clip; the metric3d losses' sorted medians and
# thresholds, whose f32 pair reads 0.166), but where it would repeat a
# check already made (TX_MSE_MADE: normal's f32 recipe gradients are
# bounded; metric3d's config with mse alone is phase (g)'s bounded
# grad_check, on other weights). Every bf16 check meets "to_f32":
# the kernels' gradients no farther from the f32 plain path's than 1.2x
# the bf16 plain path's. The two bf16 paths' own distance is reported, not
# bounded: it is set by the weights' bf16 conditioning, which the plain
# path's distance to f32 measures (the checkpoint's weights, mse alone, 8
# images at 480x640: 0.067 between the paths, each ~0.10 from f32, where
# the training phase's seed weights read 1.36e-2 against 0.0212 and
# GRAD_TOL's 2.5e-2 was set; NVIDIA H100 80GB HBM3, 700.00 W)
TX_FIDELITY_IMAGES = {480 * 640: 8, 768 * 768: 2}
TX_SMOOTH = {"mse", "latent_mse"}
TX_F32_BOUNDED = ("normal",)
TX_MSE_MADE = ("normal", "metric3d")
TX_METRIC3D = ("mse", "vnl", "hdnr", "hdsnr")
TX_METRIC3D_REPS = 3


def train_step_launches(hw: tuple, micro: int, decode: bool) -> dict:
    """K1-K4 launches of one training micro-step with the recipes' remat
    (the UNet and the VAE decode recomputed in the backward), derived from
    the routing predicates: K1 at the two encoder passes' mid blocks, each
    flash-routed UNet self-attention forward and recomputed, and the
    decoder's mid block (forward and recomputed) when the pixel losses
    decode; K2 at each routed feed-forward, twice; K3 and K4 once per
    flash-routed attention in the backward. A DPT head or latent losses
    alone leave the decoder out."""
    from genpercept_tpu_torch.ops.attention import routes_to_flash

    lh, lw = hw[0] // 8, hw[1] // 8
    u = f = 0
    h, w = lh, lw
    for level, n in UNET_TRANSFORMERS.items():
        u += n * routes_to_flash(h * w, h * w, 64)
        f += n * ff.supported(micro, h * w, UNET_WIDTHS[level])
        h, w = (h + 1) // 2, (w + 1) // 2
    e = int(routes_to_flash(lh * lw, lh * lw, 512))
    d = e if decode else 0
    return {**{k: 0 for k in COUNTERS}, "K1": 2 * e + 2 * u + 2 * d, "K2": 2 * f,
            "K3": u + d, "K4": u + d}


def write_extra_recipe(path: Path, recipe: str, data: dict, steps: int = TX_STEPS) -> dict:
    """``recipe`` merged as the CLI merges it, pointed at te_workspace's
    files by dataset name (Hypersim with normals in normal mode), ``steps``
    steps, no checkpoint, validation or visualization periods. Returns the
    merged config."""
    import yaml

    from genpercept_tpu_torch.utils.config import recursive_load_config

    with contextlib.chdir(Path(__file__).resolve().parent):
        original = json.loads(json.dumps(recursive_load_config(recipe)))
    cfg = copy.deepcopy(original)
    mode = cfg.get("pipeline", {}).get("kwargs", {}).get("mode", cfg.get("mode", "depth"))
    train = cfg["dataset"]["train"]
    for entry in tx_entries(train):
        key = {"hypersim": "train_gt" if mode == "normal" else "train", "vkitti": "vkitti",
               "dis5k": "dis5k"}[entry["name"]]
        entry["dir"], entry["filenames"] = data[key]
    for split in ("val", "vis"):
        for entry in cfg["dataset"].get(split) or []:
            entry["dir"], entry["filenames"] = data[split]
    cfg["max_iter"] = steps
    cfg.setdefault("trainer", {}).update(save_period=0, validation_period=0,
                                         visualization_period=0)
    a, b = flat_config(original), flat_config(cfg)
    changed = sorted(k for k in a.keys() | b.keys() if a.get(k) != b.get(k))
    check(a.keys() <= b.keys() and all(k.endswith(TE_CHANGED) for k in changed),
          f"{recipe} changed beyond {TE_CHANGED}: {changed}")
    path.write_text(yaml.safe_dump(cfg))
    return cfg


def tx_entries(train: dict) -> list:
    """The datasets get_dataset builds from a recipe's dataset.train: the
    list of a mixture, else the entry itself (a recipe that merges a single
    dataset over a mixture keeps the mixture's unused list)."""
    return train["dataset_list"] if train.get("name") == "mixed" else [train]


def tx_geometry(cfg: dict) -> tuple:
    """(train raster, micro-batch, accumulation, per-step sources of the
    first max_iter steps replayed from the sampler)."""
    train = cfg["dataset"]["train"]
    entries = tx_entries(train)
    micro = cfg["dataloader"].get("max_train_batch_size", 2)
    accum = max(int(cfg["dataloader"].get("effective_batch_size", 32) / micro), 1)
    sizes = [TE_SAMPLES["hypersim" if e["name"] != "vkitti" else "vkitti"] for e in entries]
    sampler = MixedBatchSampler([range(n) for n in sizes], batch_size=micro * accum,
                                prob=train.get("prob_ls") if train.get("name") == "mixed"
                                else None,
                                generator=np.random.default_rng(
                                    cfg["trainer"].get("init_seed", 0)))
    sources = []
    while len(sources) < cfg["max_iter"]:  # an epoch of a single 32-sample source is one step
        for b in sampler:
            sources.append(entries[int(b[0] >= sizes[0])]["name"])
            if len(sources) == cfg["max_iter"]:
                break
    return tuple(entries[0].get("resize_to_hw") or TRAIN_HW), micro, accum, sources


def tx_batch(trainer, hw: tuple, images: int) -> dict:
    """The first ``images`` of a micro-batch from the trainer's loader: the
    first of its batches drawn from a source at the recipe's raster (the
    mixture's other source, vKITTI, has its own and no normals)."""
    for raw in trainer.train_loader:
        if tuple(raw["rgb_norm"].shape[1:3]) == tuple(hw):
            break
    batch = trainer._device_batch(raw)
    if trainer.cfg.grad_accum_steps > 1:
        batch = {k: v[0] for k, v in batch.items()}
    return {k: v[:images] for k, v in batch.items()}


@contextlib.contextmanager
def frozen_f32(trainer):
    """The trainer's frozen bf16 tensors (its storage cast under bf16
    compute) widened to f32 inside the block and narrowed back after, both
    exactly: an f32 pass then rounds no gradient to bf16 on its way to a
    trainable tensor (LoRA's adapters sit behind the bf16 base weights)."""
    cast = [x for x in trainer.frozen.values() if x.dtype == torch.bfloat16]
    for x in cast:
        x.data = x.data.float()
    try:
        yield
    finally:
        for x in cast:
            x.data = x.data.to(torch.bfloat16)


def tx_fidelity(trainer, cfg, batch: dict) -> dict:
    """One micro-batch through build_loss_fn and backward on the trainer's
    live modules, with the kernels and under reference_kernels(), draws
    from a generator seeded SEED in each: loss, gradients' global relative
    L2 and launches. A bf16 run repeats the pair in f32 on f32 copies of its
    weights ("f32": the kernels against the plain path without bf16's
    conditioning) and records both bf16 gradients' distances to the f32
    plain path's ("to_f32")."""
    names = list(trainer.trainable)
    params = [trainer.trainable[k] for k in names]

    def one(c, plain: bool):
        reset_counts()
        with reference_kernels() if plain else contextlib.nullcontext():
            loss, aux = build_loss_fn(c, trainer.models)(batch,
                                                         torch.Generator().manual_seed(SEED))
            grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
        torch.cuda.synchronize()
        return loss.item(), {k: v.item() for k, v in aux.items()}, dict(zip(names, grads)), \
            launch_counts()

    def compare(got, ref) -> dict:
        (loss, aux, grads, counts), (r_loss, r_aux, r_grads, r_counts) = got, ref
        return {"loss": loss, "aux": aux, "loss_reference": r_loss, "aux_reference": r_aux,
                "loss_rel_diff": abs(loss - r_loss) / abs(r_loss),
                "grad_rel_l2_global": rel_l2(grads, r_grads),
                "grads_finite": all(bool(torch.isfinite(g).all()) for g in grads.values()),
                "grads_nonzero": sum(bool(g.abs().max() > 0) for g in grads.values()),
                "launches": counts, "launches_reference": r_counts}

    got, ref = one(cfg, False), one(cfg, True)
    rec = {"images": batch["rgb_norm"].shape[0], "losses": list(cfg.loss_names),
           **compare(got, ref)}
    if cfg.compute_dtype == torch.bfloat16:
        f32_cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
        with frozen_f32(trainer):
            f32_ref = one(f32_cfg, True)
            rec["grad_rel_l2_to_f32"] = rel_l2(got[2], f32_ref[2])
            rec["grad_rel_l2_to_f32_reference"] = rel_l2(ref[2], f32_ref[2])
            del got, ref
            rec["f32"] = compare(one(f32_cfg, False), f32_ref)
        del f32_ref
    else:
        del got, ref
    torch.cuda.empty_cache()
    return rec


def tx_fidelity_checks(name: str, trainer, hw: tuple, micro: int, decode: bool) -> dict:
    """The fidelity of one of train_extras' runs: tx_fidelity on the first
    images of a micro-batch with the run's losses and, where one of them is
    not smooth, again with mse alone in the run's mode; each held to
    GRAD_TOL as the comment above TX_FIDELITY_IMAGES sets out."""
    tcfg = trainer.cfg
    images = min(micro, TX_FIDELITY_IMAGES[hw[0] * hw[1]])
    batch = tx_batch(trainer, hw, images)
    fids = {"recipe": tx_fidelity(trainer, tcfg, batch)}
    if not set(tcfg.loss_names) <= TX_SMOOTH and name not in TX_MSE_MADE:
        fids["mse"] = tx_fidelity(trainer, dataclasses.replace(tcfg, loss_names=("mse",)), batch)
    del batch
    emit({"phase": "train_extras", "run": name, "step": "fidelity", **fids})
    f32_tol = GRAD_TOL[torch.float32]
    for kind, fid in fids.items():
        smooth = set(fid["losses"]) <= TX_SMOOTH
        want = train_step_launches(hw, images, decode if kind == "recipe"
                                   else trainer.models.dpt_head is None)
        pairs = [(str(tcfg.compute_dtype), fid)] + ([("f32", fid["f32"])] if "f32" in fid else [])
        for dt, f in pairs:
            tol = GRAD_TOL[torch.float32 if dt == "f32" else tcfg.compute_dtype]
            check(f["grads_finite"] and f["grads_nonzero"] > 0, f"{name} {kind} {dt}: gradients")
            check(f["launches"] == want, f"{name} {kind} {dt}: launches {f['launches']} != {want}")
            check(not any(f["launches_reference"].values()),
                  f"{name} {kind} {dt}: kernels under reference_kernels()")
            check(f["loss_rel_diff"] <= tol["loss"],
                  f"{name} {kind} {dt}: loss {f['loss_rel_diff']} > {tol['loss']}")
        f32 = fid.get("f32", fid)
        if smooth or name in TX_F32_BOUNDED:
            check(f32["grad_rel_l2_global"] <= f32_tol["grads"],
                  f"{name} {kind}: f32 gradients {f32['grad_rel_l2_global']} > {f32_tol['grads']}")
        if "f32" in fid:
            tol = GRAD_TOL[torch.bfloat16]
            check(fid["grad_rel_l2_to_f32"] <= tol["to_f32"] * fid["grad_rel_l2_to_f32_reference"],
                  f"{name} {kind}: gradients {fid['grad_rel_l2_to_f32']} from f32, the plain "
                  f"path's {fid['grad_rel_l2_to_f32_reference']}")
    return fids


def tx_run(name: str, ws: dict) -> tuple:
    """One recipe through cli/train.py at its own micro-batch, then its
    fidelity check. Returns the Trainer, the run's directory, its record and
    its merged config."""
    from genpercept_tpu_torch.cli.train import resolve_train_config
    from genpercept_tpu_torch.utils.config import Config

    root = ws["root"]
    recipe, steps = TX_RUNS[name], TX_RUN_STEPS.get(name, TX_STEPS)
    cfg = write_extra_recipe(root / f"x_{name}.yaml", recipe, ws["data"], steps)
    hw, micro, accum, sources = tx_geometry(cfg)
    check(sources == [("dis5k" if "dis5k" in sources else "hypersim")] * steps,
          f"{name}: the first steps draw {sources}")
    run_dir = root / f"x_{name}"
    trainer, rec = train_cli_run(root / f"x_{name}.yaml", ws["ckpt"], root / "data", run_dir)
    tcfg = trainer.cfg
    check(tcfg == resolve_train_config(Config(cfg), grad_accum_steps=accum,
                                       mode=tcfg.mode), f"{name}: the CLI's config")
    check(tcfg.remat_unet and tcfg.remat_granularity == "unet" and tcfg.remat_vae_decode,
          f"{name}: the launch counts assume the recipes' remat")
    decode = trainer.models.dpt_head is None and any(
        not n.startswith("latent") for n in tcfg.loss_names)
    per_micro = train_step_launches(hw, micro, decode)
    log = metrics_log(run_dir)
    walls = step_walls_ms(log)
    rec = {"phase": "train_extras", "run": name, "recipe": recipe, "mode": tcfg.mode,
           "arch": tcfg.arch, "losses": list(tcfg.loss_names),
           "compute_dtype": str(tcfg.compute_dtype), "hw": list(hw), "micro": micro,
           "accum": accum, "steps": [x[0] for x in log["train/loss"]],
           "step_losses": [x[1] for x in log["train/loss"]],
           "ms_per_step": walls[-1] if walls else None, "step_walls_ms": walls,
           "peak_bytes": rec["peak_bytes"], "seconds": rec["seconds"],
           "launches": rec["launches"],
           "launches_expected": {k: steps * accum * n for k, n in per_micro.items()}}
    check(rec["steps"] == list(range(1, steps + 1))
          and all(math.isfinite(x) for x in rec["step_losses"]), f"{name}: losses {rec}")
    check(rec["launches"] == rec["launches_expected"],
          f"{name}: launches {rec['launches']} != {rec['launches_expected']}")
    rec["fidelity"] = tx_fidelity_checks(name, trainer, hw, micro, decode)
    return trainer, run_dir, rec, cfg


def gc_cuda() -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def tx_serve_check(name: str, ws: dict, export_dir: Path, mode: str, models) -> dict:
    """cli/run.py on the exported directory (over the base for the VAE) with
    the backend's defaults, each npy against ``models`` (the trained
    weights in memory) through the pipeline on the decoded images (0.0)."""
    from PIL import Image

    from genpercept_tpu_torch.cli import run as run_cli

    img_dir = ws["root"] / f"x_{name}_images"
    if not img_dir.exists():
        write_cli_images(img_dir)
    paths = sorted(img_dir.glob("*.png"))
    decoded = []
    for p in paths:
        with Image.open(p) as im:
            decoded.append(np.asarray(im.convert("RGB")))
    out_dir = ws["root"] / f"x_{name}_pred"
    with tf32(*DEFAULT_TF32):
        reset_counts()
        t0 = time.perf_counter()
        run_cli.main(["--checkpoint", str(export_dir), "--base_ckpt_dir", str(ws["ckpt"]),
                      "--input_rgb_dir", str(img_dir), "--output_dir", str(out_dir),
                      "--mode", mode])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = launch_counts()
        pipe = GenPerceptPipeline(models, PipelineConfig(mode=mode))
        direct = [pipe(im) for im in decoded]
    rec = {"mode": mode, "images": len(paths), "seconds": secs, "launches": counts,
           "npy_max_abs_diff_vs_memory": check_cli_outputs(paths, out_dir, mode, direct),
           "pred_std": [float(np.std(o.pred_np)) for o in direct]}
    shutil.rmtree(out_dir)
    check(rec["npy_max_abs_diff_vs_memory"] == 0.0,
          f"{name}: the exported checkpoint's CLI output differs from the trained models'")
    check(min(rec["pred_std"]) > 1e-6, f"{name}: a constant prediction")
    return rec


def tx_export(run_dir: Path, ws: dict, name: str) -> tuple:
    from genpercept_tpu_torch.cli import export as export_cli

    exp = ws["root"] / f"x_{name}_export"
    t0 = time.perf_counter()
    export_cli.main(["--run_dir", str(run_dir), "--base_checkpoint", str(ws["ckpt"]), "--name",
                     "final", "--output_dir", str(exp), "--device", "cuda"])
    return exp, {"export_s": time.perf_counter() - t0,
                 "files": sorted(str(p.relative_to(exp)) for p in exp.rglob("*") if p.is_file())}


def tx_metric3d(ws: dict) -> dict:
    """(g): build_train_step with TX_METRIC3D on the main-paper recipe's
    config (bf16, 8 x 4 at 480x640) over Hypersim's reader, whose samples
    carry its K scaled to 480x640 (mirrored on flips): TX_STEPS steps
    (CUDA events), launches, peak memory; each metric3d loss's forward and
    backward on a step's prediction (CUDA events, mean of TX_METRIC3D_REPS
    after a warm-up); the fidelity as every run's (tx_fidelity_checks: the
    losses, and mse alone at PR 2's 8 images)."""
    from genpercept_tpu_torch.data import DatasetMode, get_dataset
    from genpercept_tpu_torch.data.transforms import get_depth_normalizer
    from genpercept_tpu_torch.train import metric3d_losses as m3d

    cfg = dataclasses.replace(TRAIN_CFG, loss_names=TX_METRIC3D, grad_accum_steps=ACCUM)
    ds = get_dataset({"name": "hypersim", "dir": ws["data"]["train"][0],
                      "filenames": ws["data"]["train"][1], "resize_to_hw": list(TRAIN_HW)},
                     str(ws["root"] / "data"), DatasetMode.TRAIN,
                     depth_transform=get_depth_normalizer(
                         {"type": "scale_shift_depth", "clip": True, "norm_min": -1.0,
                          "norm_max": 1.0, "min_max_quantile": 0.02}),
                     augmentation_args={"lr_flip_p": 0.5})
    loader = DataLoader(ds, MixedBatchSampler([ds], batch_size=ACCUM * MICRO,
                                              generator=np.random.default_rng(SEED)))
    models = load_genpercept_checkpoint(str(ws["ckpt"]), device="cuda")
    trainer = Trainer(cfg, models, loader, str(ws["root"] / "x_metric3d"), max_iter=TX_STEPS,
                      save_period=0, main_seed=SEED)
    step = trainer.step_fn  # build_train_step's
    raws = []
    while len(raws) < TX_STEPS:  # an epoch of the 32 samples is one step
        for raw in loader:
            raws.append(raw)
            if len(raws) == TX_STEPS:
                break
    k_hs = ws["data"]["train"]
    check(all("intrinsic" in r for r in raws), "Hypersim's training samples carry no K")
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    times, metrics = [], []
    for i, raw in enumerate(raws):
        batch = trainer._device_batch(raw)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        m = step(batch, torch.Generator().manual_seed(SEED + i))
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        metrics.append({k: float(v) for k, v in m.items()})
    counts = launch_counts()
    expect = {k: TX_STEPS * ACCUM * n for k, n in train_step_launches(TRAIN_HW, MICRO, True).items()}
    peak = torch.cuda.max_memory_allocated()
    # each metric3d loss alone on a prediction of the step's shape
    batch = {k: v[0] for k, v in trainer._device_batch(raws[0]).items()}
    pred = (torch.rand(batch["valid_mask"].shape, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED)) * 2 + 1).requires_grad_()
    targ = batch["gt_norm"][..., 0] + 2.0
    mask, k = batch["valid_mask"], batch["intrinsic"]
    gen = torch.Generator().manual_seed(SEED)
    fns = {"vnl": lambda: m3d.vnl_loss(pred, targ, mask, k, gen),
           "hdnr": lambda: m3d.hdnl_random_loss(pred, targ, mask, gen),
           "hdsnr": lambda: m3d.hdsnl_random_loss(pred, targ, mask, gen)}
    loss_ms = {}
    for name, fn in fns.items():
        torch.autograd.grad(fn(), pred)
        torch.cuda.synchronize()
        ts = []
        for _ in range(TX_METRIC3D_REPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            torch.autograd.grad(fn(), pred)
            end.record()
            torch.cuda.synchronize()
            ts.append(start.elapsed_time(end))
        loss_ms[name] = float(np.mean(ts))
    fid = tx_fidelity_checks("metric3d", trainer, TRAIN_HW, MICRO, True)
    rec = {"phase": "train_extras", "run": "metric3d", "losses": list(TX_METRIC3D),
           "intrinsic_first": raws[0]["intrinsic"][0].tolist(), "step_ms": times,
           "step_metrics": metrics, "peak_bytes": peak, "launches": counts,
           "launches_expected": expect, "loss_ms": loss_ms, "loss_ms_batch": list(pred.shape),
           "fidelity": fid, "data": list(k_hs)}
    del trainer, models, step, pred
    gc_cuda()
    shutil.rmtree(ws["root"] / "x_metric3d", ignore_errors=True)
    check(counts == expect, f"metric3d: launches {counts} != {expect}")
    check(all(math.isfinite(v) for m in metrics for v in m.values()), f"metric3d: {metrics}")
    return rec


def phase_train_extras(ws: dict | None = None) -> dict:
    """(v) every other recipe family on the card through the entry points
    (te_workspace's base checkpoint and files): (a) normal (angular), (b)
    dis with the latent loss, (c) a fresh DPT-identity head in
    disparity_dpt_head mode, exported and served by cli/run.py, (d) LoRA
    rank 128 (the base UNet stored in bf16 and bit for bit after the
    steps, the adapters moved), exported merged and served, (e) marigold in f32 (8-channel
    conv_in, multi-resolution noise), (f) rgb_blending under its betas,
    (g) the metric3d losses in build_train_step. Each run: ms per step,
    peak memory, exact launches, a micro-batch's fidelity."""
    from genpercept_tpu_torch.io.weights import load_safetensors
    from genpercept_tpu_torch.train.lora import merge_lora

    if ws is None:
        with tempfile.TemporaryDirectory() as tmp:
            return phase_train_extras(te_workspace(Path(tmp)))
    t_phase = time.perf_counter()
    check(train_step_launches(TRAIN_HW, MICRO, True) == STEP_LAUNCHES,
          "the derived launches differ from the main recipe's")
    out = {}
    for name in TX_RUNS:
        trainer, run_dir, rec, cfg = tx_run(name, ws)
        if name == "dpt_head":
            check(trainer.models.dpt_head is not None
                  and trainer.models.dpt_head.cfg.final_act == "identity", "no fresh identity head")
            exp, rec["export"] = tx_export(run_dir, ws, name)
            check("dpt_head_identity/model.safetensors" in rec["export"]["files"],
                  f"DPT export files {rec['export']['files']}")
            models = load_genpercept_checkpoint(str(ws["ckpt"]), device="cuda")
            models.unet.load_state_dict({k[5:]: v for k, v in trainer.trainable.items()
                                         if k.startswith("unet.")})
            models.dpt_head = trainer.models.dpt_head
            rec["serve"] = tx_serve_check(name, ws, exp, "disparity_dpt_head", models)
            del models
            shutil.rmtree(exp)
        if name == "lora":
            base = load_safetensors(str(ws["ckpt"] / "unet" / "diffusion_pytorch_model.safetensors"))
            live = trainer.models.unet.state_dict()
            # the frozen base is stored in the compute dtype, as JAX's Trainer does
            store = next(iter(live.values())).dtype
            rec["base_unet_dtype"] = str(store)
            rec["base_unet_max_abs_change"] = max(float((live[k].float().cpu() - v.to(store)
                                                         .float()).abs().max())
                                                  for k, v in base.items())
            check(store == trainer.cfg.compute_dtype, f"LoRA: the base UNet is stored in {store}")
            lora = {k: v.detach() for k, v in trainer.models.unet_lora.items()}
            rec["lora_b_max_abs"] = max(float(v.abs().max()) for k, v in lora.items()
                                        if k.endswith("lora_B"))
            rec["lora_params"] = sum(v.numel() for v in lora.values())
            check(rec["base_unet_max_abs_change"] == 0.0, "LoRA: the base UNet moved")
            check(rec["lora_b_max_abs"] > 0.0, "LoRA: no adapter moved")
            check(all(k.startswith("unet_lora.") for k in trainer.trainable), "LoRA: trainable")
            exp, rec["export"] = tx_export(run_dir, ws, name)
            models = load_genpercept_checkpoint(str(ws["ckpt"]), device="cpu")
            merged = merge_lora(models.unet, {k: v.cpu() for k, v in lora.items()})
            # the step's merge on the card against the host's on the same stored base
            host = merge_lora(models.unet.to(store), {k: v.cpu() for k, v in lora.items()})
            gpu_merged = merge_lora(trainer.models.unet, lora)
            rec["merge_cpu_vs_card_max"] = max(float((gpu_merged[k].cpu().float()
                                                      - host[k].float()).abs().max())
                                               for k in host)
            del gpu_merged, host
            models = load_genpercept_checkpoint(str(ws["ckpt"]), device="cuda")
            models.unet.load_state_dict(merged)
            rec["serve"] = tx_serve_check(name, ws, exp, "depth", models)
            del models, merged
            shutil.rmtree(exp)
        if name == "marigold":
            check(trainer.models.unet.cfg.in_channels == 8
                  and tuple(trainer.models.unet.conv_in.weight.shape[1:]) == (8, 3, 3),
                  "marigold: conv_in not widened")
            check(trainer.cfg.multi_res_noise_strength == 0.9, "marigold: no multi-res noise")
        emit(rec)
        out[name] = rec
        del trainer
        shutil.rmtree(run_dir)
        gc_cuda()
    out["metric3d"] = tx_metric3d(ws)
    emit(out["metric3d"])
    summary = {"phase": "train_extras", "step": "summary",
               "ms_per_step": {k: r.get("ms_per_step") for k, r in out.items()},
               "peak_gb": {k: r["peak_bytes"] / 1e9 for k, r in out.items()},
               "micro": {k: r.get("micro") for k, r in out.items()},
               "loss_ms": out["metric3d"]["loss_ms"],
               "seconds": time.perf_counter() - t_phase}
    emit(summary)
    return summary


# int8_extras: GPTQ rounding against round-to-nearest, the fake-quant
# attribution modes and int8 on a DPT-identity checkpoint, on the golden's
# weights (te_workspace's checkpoint) in bf16 with INT8_CFG
FAKE_PER_FORWARD = {"K1": K1_PER_FORWARD, "K2": K2_PER_FORWARD, "K5": 0, "K6": 0, "K7": 0,
                    "K8": 0, **NO_S}  # only the conv hooks change: 17 / 5 at 768^2, batch 2
DPT_INT8_PER_FORWARD = {**INT8_PER_FORWARD, "K6": 1}  # no decoder, so no decoder attention
DPT_CALIB_PER_FORWARD = {**CALIB_PER_FORWARD, "K1": CALIB_PER_FORWARD["K1"] - 1}
INT8_DEV_BAR = 1e-2  # int8_mean_dev, as the pipeline's own self-check warns
# fake:wa's deviation from full precision against the int8 path's, relative:
# the attribution's use (w alone, a alone, both against the real error). The
# two paths agree per layer (tests/test_torch_quant_gptq.py: 1e-4), but an
# activation code that float rounding moves across .5 in one of them changes
# the next layer's input by a step, so at full width their depth maps differ
# from each other about as much as each differs from full precision
# (reported as mean_dev_vs_int8)
FAKE_WA_REL = 0.15


def gptq_timer():
    """Patches quant.gptq_round to add its synchronised seconds into the
    returned list's one entry; returns (list, undo)."""
    spent = [0.0]
    real = tq.gptq_round

    def timed_round(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        return out

    tq.gptq_round = timed_round
    return spent, lambda: setattr(tq, "gptq_round", real)


def int8_calibration(models, cfg, images) -> tuple:
    """A pipeline calibrated on images[:2] (the first .batch): the pipeline,
    its record (seconds, peak device memory, launches, int8_mean_dev)."""
    pipe = GenPerceptPipeline(models, cfg, device="cuda")
    gc_cuda()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    first = pipe.batch(images[:2], batch_size=2)
    torch.cuda.synchronize()
    rec = {"calibration_batch_s": time.perf_counter() - t0,
           "calibration_s": pipe.calibration_seconds,
           "peak_bytes_over_weights": torch.cuda.max_memory_allocated() - base,
           "launches_calibration_batch": fwd_counts(launch_counts()),
           "int8_mean_dev": pipe.int8_mean_dev,
           "quantized_layers": {g: len(t) for g, t in pipe.vae_quant.items()}}
    return pipe, first, rec


def phase_int8_extras(ws: dict) -> dict:
    """(w) GPTQ int8 against round-to-nearest on the same images, the fake
    modes, a save/load round trip, and int8 on a DPT-identity checkpoint
    through the pipeline and cli/run.py (--data_parallel at one device)."""
    from PIL import Image

    from genpercept_tpu_torch.cli import run as cli

    dt = torch.bfloat16
    t_phase = time.perf_counter()
    images = list(natural_like_images(SEED, 4, 768))
    forwards = len(images) // 2
    models = load_genpercept_checkpoint(str(ws["ckpt"]), dtype=dt, device="cuda")
    expect_calib = {k: CALIB_PER_FORWARD[k] + INT8_PER_FORWARD[k] for k in INT8_PER_FORWARD}
    expect_batch = {k: n * forwards for k, n in INT8_PER_FORWARD.items()}
    recs, pipes = {}, {}
    for name, gptq in (("rtn", False), ("gptq", True)):
        cfg = PipelineConfig(dtype=dt, int8_gptq=gptq, **INT8_CFG)
        spent, undo = gptq_timer()
        try:
            pipe, _, rec = int8_calibration(models, cfg, images)
        finally:
            undo()
        rec["gptq_round_s"] = spent[0]
        reset_counts()
        outs = [o.pred_np for o in pipe.batch(images, batch_size=2)]
        torch.cuda.synchronize()
        rec["launches_batch"] = fwd_counts(launch_counts())
        recs[name], pipes[name] = rec, (pipe, outs)
        check(rec["launches_calibration_batch"] == expect_calib,
              f"{name}: calibration launches {rec['launches_calibration_batch']}")
        check(rec["launches_batch"] == expect_batch, f"{name}: .batch launches "
              f"{rec['launches_batch']}")
        check(rec["int8_mean_dev"] is not None and rec["int8_mean_dev"] <= INT8_DEV_BAR,
              f"{name}: int8_mean_dev {rec['int8_mean_dev']}")
        check(all(np.isfinite(o).all() and o.min() >= 0.0 and o.max() <= 1.0 for o in outs),
              f"{name}: depth not finite or outside [0, 1]")
    check(recs["gptq"]["gptq_round_s"] > 0.0 and recs["rtn"]["gptq_round_s"] == 0.0,
          "GPTQ rounding ran where it should not, or not where it should")
    gptq, g_outs = pipes["gptq"]
    rtn_codes = pipes["rtn"][0].vae_quant
    moved = {g: sum(int((q.w_int8 != rtn_codes[g][k].w_int8).sum()) for k, q in t.items())
             for g, t in gptq.vae_quant.items()}
    check(moved["enc"] > 0 and moved["dec"] > 0 and moved["unet"] == 0,
          f"GPTQ codes moved {moved}: the VAE's only")
    # the round trip of the GPTQ tree
    with tempfile.TemporaryDirectory() as tmp:
        gptq.save_calibration(f"{tmp}/gptq.npz")
        fresh = GenPerceptPipeline(models, gptq.cfg, device="cuda")
        fresh.load_calibration(f"{tmp}/gptq.npz")
    round_trip = max(float(np.abs(o.pred_np - g).max())
                     for o, g in zip(fresh.batch(images, batch_size=2), g_outs))
    del fresh
    check(round_trip == 0.0, f"GPTQ calibration round trip changed depth by {round_trip}")

    # the fake modes on the GPTQ tree, against full precision and int8, in
    # bf16 (reported) and in f32 with TF32 off (held)
    x = torch.as_tensor(np.stack(images[:2]), device="cuda")
    fake, int8_vs_fp = {}, {}
    for fdt in (dt, torch.float32):
        key = "bf16" if fdt == dt else "f32"
        m = models if fdt == dt else load_genpercept_checkpoint(str(ws["ckpt"]), device="cuda")
        cfg = dataclasses.replace(gptq.cfg, dtype=fdt)
        fp = build_single_infer(m, PipelineConfig(dtype=fdt))(x)
        real = build_single_infer(m, cfg, "quant")(x, gptq.vae_quant)
        int8_vs_fp[key] = float((real - fp).abs().mean())
        fake[key] = {}
        for side in ("w", "a", "wa"):
            reset_counts()
            y = build_single_infer(m, cfg, f"fake:{side}")(x, gptq.vae_quant)
            torch.cuda.synchronize()
            counts = fwd_counts(launch_counts())
            fake[key][side] = {"mean_dev_vs_fp": float((y - fp).abs().mean()),
                               "mean_dev_vs_int8": float((y - real).abs().mean()),
                               "launches": counts}
            check(bool(torch.isfinite(y).all()), f"fake:{side} {key} not finite")
            check(counts == FAKE_PER_FORWARD, f"fake:{side} {key} launches {counts}")
        del fp, real, y, m
        gc_cuda()
    for key, f in fake.items():
        ratio = f["wa"]["mean_dev_vs_fp"] / int8_vs_fp[key]
        check(abs(ratio - 1.0) <= FAKE_WA_REL,
              f"fake:wa {key}: {ratio} of the int8 path's deviation from full precision")
        check(max(f["w"]["mean_dev_vs_fp"], f["a"]["mean_dev_vs_fp"]) < int8_vs_fp[key],
              f"fake:w / fake:a {key} deviate more than int8: {f}")
    del x
    rec = {"phase": "int8_extras", "step": "gptq", "dtype": str(dt), "config": INT8_CFG,
           "round_to_nearest": recs["rtn"], "gptq": recs["gptq"], "gptq_codes_moved": moved,
           "gptq_vs_rtn_mean_dev": float(np.mean([np.abs(a - b).mean() for a, b in
                                                   zip(g_outs, pipes["rtn"][1])])),
           "round_trip_max_abs_diff": round_trip, "fake": fake, "int8_vs_fp": int8_vs_fp,
           "bars": {"int8_mean_dev": INT8_DEV_BAR, "fake_wa_over_int8_dev": FAKE_WA_REL}}
    emit(rec)
    del pipes, gptq, rtn_codes, models
    gc_cuda()

    # int8 on a DPT-identity checkpoint: the pipeline, then cli/run.py
    root = ws["root"]
    head = init_params_(DPTHead(DPT_IDENTITY), torch.Generator().manual_seed(SEED + DPT_SEED))
    dpt = write_dpt_checkpoint(root / "ckpt_dpt_int8", ws["ckpt"], head.state_dict(),
                               DPT_IDENTITY)
    m_dpt = load_genpercept_checkpoint(str(dpt), dtype=dt, device="cuda")
    cfg_dpt = PipelineConfig(mode="disparity_dpt_head", dtype=dt, **INT8_CFG)
    pipe, _, rec_dpt = int8_calibration(m_dpt, cfg_dpt, images)
    reset_counts()
    d_outs = [o.pred_np for o in pipe.batch(images, batch_size=2)]
    rec_dpt["launches_batch"] = fwd_counts(launch_counts())
    rec_dpt["groups"] = {g: len(t) for g, t in pipe.vae_quant.items()}
    expect_dpt_calib = {k: DPT_CALIB_PER_FORWARD[k] + DPT_INT8_PER_FORWARD[k]
                        for k in DPT_INT8_PER_FORWARD}
    check(rec_dpt["groups"]["dec"] == 0 and rec_dpt["groups"]["enc"] > 0
          and rec_dpt["groups"]["unet"] > 0, f"DPT int8 groups {rec_dpt['groups']}")
    check(rec_dpt["launches_calibration_batch"] == expect_dpt_calib,
          f"DPT int8 calibration launches {rec_dpt['launches_calibration_batch']}")
    check(rec_dpt["launches_batch"] == {k: n * forwards for k, n in DPT_INT8_PER_FORWARD.items()},
          f"DPT int8 .batch launches {rec_dpt['launches_batch']}")
    check(rec_dpt["int8_mean_dev"] is not None and rec_dpt["int8_mean_dev"] <= INT8_DEV_BAR,
          f"DPT int8_mean_dev {rec_dpt['int8_mean_dev']}")
    check(all(np.isfinite(o).all() for o in d_outs), "DPT int8 depth not finite")
    del pipe, m_dpt
    gc_cuda()
    paths = write_cli_images(root / "images_int8")
    decoded = []
    for p in paths:
        with Image.open(p) as im:
            decoded.append(np.asarray(im.convert("RGB")))
    out_dir = root / "out_dpt_int8"
    argv = ["--checkpoint", str(dpt), "--input_rgb_dir", str(root / "images_int8"),
            "--output_dir", str(out_dir), "--mode", "disparity_dpt_head", "--bf16",
            "--int8_vae", "--int8_unet", "--batch_size", "2", "--data_parallel"]
    # one 768^2 batch of two (the calibration forward and the self-check, the
    # UNet's convs hooked and its feed-forward full precision) and one
    # 576x768 forward, the decoder's attention absent from each
    f768, f576 = ddim_launches(96, 96, 2, 1), ddim_launches(72, 96, 1, 1)
    expect_cli = {**{k: 0 for k in COUNTERS}, "K1": 2 * (f768["K1"] - 1) + f576["K1"] - 1,
                  "K2": 2 * f768["K2"] + f576["K2"]}
    reset_counts()
    t0 = time.perf_counter()
    cli.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_counts = launch_counts()
    direct = GenPerceptPipeline(
        load_genpercept_checkpoint(str(dpt), dtype=dt, device="cuda"),
        PipelineConfig(mode="disparity_dpt_head", dtype=dt, int8_vae=True, int8_unet=True),
        device="cuda").batch(decoded, batch_size=2)
    cli_diff = check_cli_outputs(paths, out_dir, "disparity_dpt_head", direct)
    rec_cli = {"seconds": cli_s, "launches": cli_counts, "launches_expected": expect_cli,
               "npy_max_abs_diff_vs_pipeline": cli_diff, "argv_flags": argv[6:]}
    emit({"phase": "int8_extras", "step": "dpt_head", "pipeline": rec_dpt, "cli": rec_cli,
          "seconds": time.perf_counter() - t_phase})
    check(cli_diff == 0.0, f"DPT int8 CLI: an npy differs from the pipeline's by {cli_diff}")
    check(cli_counts == expect_cli, f"DPT int8 CLI launches {cli_counts} != {expect_cli}")
    del direct
    shutil.rmtree(out_dir)
    gc_cuda()
    return {"rtn": recs["rtn"], "gptq": recs["gptq"], "fake": fake, "dpt": rec_dpt}


# data_parallel: cli/train.py with two gloo ranks on the one card (NCCL
# refuses two ranks on one GPU) against one process on the same global
# micro-batch of 2 (one image a rank), an effective batch of 2, one
# optimizer step; the main-paper recipe with the
# keys below changed as well: f32 (and f32 Adam moments) for the bounded
# reading, the recipe's bf16 for the reported one; no warmup (the first
# update moves). The recipe's flip augmentation stays: a rank draws the
# whole global batch's flips and keeps its own (DataLoader(shard=))
DP_WORLD, DP_EFF = 2, 2
DP_CHANGED = TE_CHANGED + ("max_train_batch_size", "effective_batch_size", "mixed_precision",
                           "mu_dtype", "warmup_steps")
# the runs' losses: the recipe's without least-squares SSI, whose gradients
# at random weights are ill-conditioned (section (g): its median branch;
# the training phase reports them unbounded); the bf16 runs take the same
# two, so that the tensor-parallel bf16 run has f32 gradients of its own
# losses to be held against
DP_LOSSES = ("mse_loss", "grad_loss")
DP_LOSS_TOL = 1e-6  # f32 with TF32 off, relative: the reduction over the global batch
# the gradient (Adam's first moment), global relative L2: a rank's call on
# one image rounds otherwise than one process's on two, which the backward
# amplifies (the CPU test holds 1e-4 on a tiny UNet with unequal masks).
# Its witness (dp_split_witness): the one-process step rebuilt in this
# process, its gradient taken image by image against batched. The two
# ranks' gradient is held to DP_GRAD_TOL and to DP_GRAD_WITNESS_X times the
# witness read in the same run (on an H100: 7.0743e-4 against the
# witness's 7.0732e-4; two runs of the backward differ by ~1e-6), and
# their update to DP_UPDATE_WITNESS_X times Adam's first update of the
# witness's two gradients (the gaps' signs flip lr g / (|g| + eps) where
# |g| is below them; the parameters' own rounding adds ~1e-3 of it)
DP_GRAD_TOL, DP_GRAD_WITNESS_X, DP_UPDATE_WITNESS_X = 1e-3, 1.1, 1.5
# --zero1 against plain data parallelism: two runs of the card's backward
# are not bit for bit (its atomics: the first moments read 6.9e-7 and
# 9.3e-7 of their largest apart in two runs on an H100), so the first
# moments within 1e-5 of their largest, and the update (final - base, over
# dp_compare's parameters) within 1e-2 global relative L2 of plain's: the
# noise flips Adam's first step (lr g / (|g| + eps)) only where |g| is
# below it, where a share that one rank failed to take from the other
# would leave half the update out (~0.7). The ranks' parameters are equal
DP_ZERO1_MU_REL, DP_ZERO1_UPDATE_REL = 1e-5, 1e-2
DP_TIMEOUT_S = 600
# tensor parallelism (--model_parallel TP_M, one model group of two gloo
# ranks on the card, the one-process runs' global micro-batch on each): the
# f32 loss to DP_LOSS_TOL; the gradient to TP_GRAD_TOL and TP_GRAD_WITNESS_X
# times, the update to TP_UPDATE_WITNESS_X times the split's witness (the
# one-process step under parallel.tensor.emulated(TP_M): every split layer's
# partial products summed in TP_M parts in the ranks' order, read in the
# same run). The witness itself reads 6.128e-4 (the ranks 6.128e-4, 1.00003x
# it; NVIDIA H100 80GB HBM3, 700.00 W): a 1e-7 change of the row-parallel
# sums moves this random-weight gradient as the batch split's does (7.07e-4,
# DP_GRAD_TOL), so TP_GRAD_TOL is DP_GRAD_TOL, and the witness ratio and
# TP_WITNESS_GRAD_TOL below are the bars that see a fault. In bf16 the gathered gradient's distance to the f32
# one-process gradient within TP_TO_F32_X times the one-process bf16
# gradient's (the "to_f32" bar of the training phases). TP_K2: two 768^2
# images, whose 18432 level-0 rows route K2 on each rank's inner share
TP_GRAD_TOL, TP_GRAD_WITNESS_X, TP_UPDATE_WITNESS_X, TP_TO_F32_X = DP_GRAD_TOL, 1.1, 1.5, 1.2
# the ranks' gathered gradient against the witness's own (tp_to_witness),
# global relative L2: the witness sums what the ranks sum in their order, so
# its forward is theirs bit for bit and only the card's backward differs
# from run to run (its atomics): read 1.0985e-6 (NVIDIA H100 80GB HBM3,
# 700.00 W; 0.0 on the CPU, tests/test_torch_tensor_parallel.py), where a
# split summed in another order alone reads the 6e-4 both stand from one
# process
TP_WITNESS_GRAD_TOL = 1e-5
TP_K2_HW, TP_K2_MICRO = (768, 768), 2


def write_dp_recipe(path: Path, data: dict, micro: int, f32: bool, max_iter: int,
                    save_period: int = 0, val_period: int = 0,
                    resize: tuple | None = None) -> dict:
    """TE_RECIPE merged as the CLI merges it, with only DP_CHANGED keys set:
    te_workspace's files, ``micro`` images a process in micro-steps of an
    effective batch of DP_EFF, the periods, no warmup, DP_LOSSES, with
    ``f32`` f32 compute and moments, and with ``resize`` the training
    images resized to it (``resize_to_hw``). Returns the merged config."""
    import yaml

    from genpercept_tpu_torch.utils.config import recursive_load_config

    with contextlib.chdir(Path(__file__).resolve().parent):
        original = json.loads(json.dumps(recursive_load_config(TE_RECIPE)))
    cfg = copy.deepcopy(original)
    hs, vk = cfg["dataset"]["train"]["dataset_list"]
    for entry, key in ((hs, "train"), (vk, "vkitti"), (cfg["dataset"]["val"][0], "val"),
                       (cfg["dataset"]["vis"][0], "vis")):
        entry["dir"], entry["filenames"] = data[key]
    cfg["max_iter"] = max_iter
    cfg["trainer"].update(save_period=save_period, validation_period=val_period,
                          visualization_period=0)
    cfg["dataloader"].update(max_train_batch_size=micro, effective_batch_size=DP_EFF)
    cfg["lr_scheduler"]["kwargs"]["warmup_steps"] = 0
    cfg["loss"]["name"] = list(DP_LOSSES)
    if f32:
        cfg["mixed_precision"] = "no"
        cfg["optimizer"]["mu_dtype"] = "f32"
    free = ("loss.name.",)
    if resize is not None:
        for i, entry in enumerate((hs, vk)):
            entry["resize_to_hw"] = list(resize)
            free += (f"dataset.train.dataset_list.{i}.resize_to_hw",)
    a, b = flat_config(original), flat_config(cfg)
    changed = sorted(k for k in a.keys() | b.keys() if a.get(k) != b.get(k))
    check({k for k in a if not k.startswith(free)} == {k for k in b if not k.startswith(free)}
          and all(k.endswith(DP_CHANGED) or k.startswith(free) for k in changed),
          f"the recipe changed beyond {DP_CHANGED}: {changed}")
    path.write_text(yaml.safe_dump(cfg))
    return cfg


def dp_trained_state(trainer, keep: bool) -> dict | None:
    """The trainer's parameters and Adam first moments by name, in the
    one-process layout, f32 copies on the card (rank 0 holds at most three
    at once), where ``keep`` (rank 0); a ZeRO-1 optimizer gathers its ranks'
    shares and a model group its tensor-parallel shards, so every rank
    calls this."""
    sd = trainer.optimizer.state_dict()
    params = {k: p.detach() for k, p in trainer.trainable.items()}
    if trainer.splits:
        params, sd = trainer.one_process_state(sd)
    if not keep:
        return None
    names, dev = list(trainer.trainable), trainer.device
    return {"params": {k: p.float().clone() for k, p in params.items()},
            "mu": {names[i]: st["mu"].to(dev, torch.float32) for i, st in sd["state"].items()}}


def tp_to_f32(state: dict, one: dict, f32: dict, device) -> dict:
    """A bf16 run's gathered gradient (Adam's first moment) against the f32
    one-process gradient, beside the one-process bf16 gradient's distance,
    over the parameters whose f32 first moment reaches 1e-6 of the
    largest."""
    top = max(float(v.abs().max()) for v in f32["mu"].values())
    keep = [k for k in f32["mu"] if float(f32["mu"][k].abs().max()) >= 1e-6 * top]
    return {"to_f32": dp_rel_l2(state["mu"], f32["mu"], keep, device),
            "one_to_f32": dp_rel_l2(one["mu"], f32["mu"], keep, device)}


def tp_to_witness(state: dict, path: Path, device) -> dict:
    """A tensor-parallel run's gathered gradient (Adam's first moment, (1 -
    b1) g after one step) against the split's witness (dp_split_witness's
    gradient under ``tensor.emulated(TP_M)``, the same sums in the same
    order in one process), global relative L2 over the witness's
    parameters; the file (written beside the first jobs) is waited for and
    deleted once read."""
    deadline = time.perf_counter() + DP_TIMEOUT_S
    while not path.is_file():
        check(time.perf_counter() < deadline, f"dp: no witness at {path}")
        time.sleep(0.5)
    g = torch.load(path, map_location="cpu", mmap=True)
    rel = dp_rel_l2(state["mu"], {k: (1 - 0.9) * v.to(device) for k, v in g.items()}, list(g),
                    device)
    del g
    path.unlink()
    return {"witness_grad_rel_l2": rel}


def tp_checkpoint_diff(trainer, run: Path) -> dict:
    """The largest |difference| between this rank's parameters and Adam
    moments (its shares of the split ones) and its share of the run's final
    checkpoint, which is written whole (0.0: the checkpoint is the gather
    of the shards)."""
    from genpercept_tpu_torch.io.checkpoints import load_train_checkpoint

    ck = load_train_checkpoint(str(run / "checkpoint"), "final", map_location="cpu")
    names, splits = list(trainer.trainable), trainer.splits

    def diff(saved, own, name):
        mine = TP.local_share(saved, splits.get(name))
        return float((mine.float() - own.detach().cpu().float()).abs().max())

    moments = ck["opt_state"]["state"]
    own = trainer.optimizer.state_dict()["state"]
    return {"ckpt_params_max_abs_diff": max(diff(ck["trainable"][k], p, k)
                                            for k, p in trainer.trainable.items()),
            "ckpt_moments_max_abs_diff": max(diff(moments[i][m], st[m], names[i])
                                             for i, st in own.items() for m in ("mu", "nu")),
            "ckpt_moments": len(moments)}


def dp_rel_l2(a: dict, b: dict, keys, device, base: dict | None = None) -> float:
    """Global relative L2 of a against b (of a - base against b - base) over
    ``keys``, each pair summed on ``device``."""
    num = den = 0.0
    for k in keys:
        x, y = a[k].to(device), b[k].to(device)
        if base is not None:
            z = base[k].to(device)
            x, y = x - z, y - z
        num += float((x - y).double().square().sum())
        den += float(y.double().square().sum())
    return math.sqrt(num / den)


def dp_compare(ranks: dict, one: dict, base: dict, device) -> dict:
    """Two ranks' step against one process's: the gradient as Adam's first
    moment (0.1 g) and the update (final - base), global relative L2 over
    the parameters whose first moment reaches 1e-6 of the largest (a bias
    before a GroupNorm has a gradient of rounding noise alone, and Adam's
    first step moves any parameter by ~lr whatever its gradient's size)."""
    top = max(float(v.abs().max()) for v in one["mu"].values())
    keep = [k for k in one["mu"] if float(one["mu"][k].abs().max()) >= 1e-6 * top]
    return {"grad_rel_l2": dp_rel_l2(ranks["mu"], one["mu"], keep, device),
            "update_rel_l2": dp_rel_l2(ranks["params"], one["params"], keep, device, base),
            "params_compared": len(keep), "params": len(one["mu"])}


def dp_split_witness(ws: dict, recipe_cfg: dict, tp_file: Path, device: str = "cuda") -> dict:
    """The batch split's own rounding, in one process on the card: the
    one-process reference's first step rebuilt from its recipe (the CLI's
    reader, sampler and flips over te_workspace's files, the step's
    timesteps from the Trainer's first seed, the checkpoint's weights), its
    f32 (TF32 off) loss gradient taken batched and image by image, each
    image's losses over the batch's counts (replayed), the images'
    gradients summed: what two ranks compute, without a process group.
    Global relative L2 over the parameters whose gradient reaches 1e-6 of
    the largest, as dp_compare; the losses as a relative difference. The
    ``tp_`` readings are the tensor split's witness (tp_split_witness): the
    batched gradient under ``tensor.emulated(TP_M)``, every split layer's
    partial products summed in TP_M parts in the ranks' order; its gradient
    is written to ``tp_file`` for the ranks."""
    from genpercept_tpu_torch import parallel
    from genpercept_tpu_torch.cli.train import resolve_train_config, sampler_prob
    from genpercept_tpu_torch.data import DatasetMode, get_dataset
    from genpercept_tpu_torch.data.sampler import ConcatDataset
    from genpercept_tpu_torch.data.transforms import get_depth_normalizer
    from genpercept_tpu_torch.utils.config import Config
    from genpercept_tpu_torch.utils.seeding import generate_seed_sequence

    t0 = time.perf_counter()
    rc = Config(recipe_cfg)
    cfg = resolve_train_config(rc, grad_accum_steps=1, mode="depth")
    check(cfg.compute_dtype == torch.float32 and cfg.arch == "genpercept",
          f"dp witness: {cfg.compute_dtype}, {cfg.arch}")
    datasets = get_dataset(rc.get_path("dataset.train"), str(ws["root"] / "data"),
                           DatasetMode.TRAIN,
                           depth_transform=get_depth_normalizer(
                               rc.get_path("depth_normalization")),
                           augmentation_args=rc.get("augmentation"))
    seed = rc["trainer"]["init_seed"]
    sampler = MixedBatchSampler(datasets, batch_size=DP_EFF, prob=sampler_prob(rc),
                                generator=np.random.default_rng(seed))
    raw = next(iter(DataLoader(ConcatDataset(datasets), sampler)))
    batch = {"rgb_norm": raw["rgb_norm"],
             "gt_norm": np.repeat(raw["depth_raw_norm"][..., None], 3, -1),
             "valid_mask": raw["valid_mask_raw"]}
    batch = {k: torch.as_tensor(np.asarray(v, bool if k == "valid_mask" else np.float32),
                                device=device) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(
        generate_seed_sequence(seed, rc["max_iter"] + 1)[0] % (2**63))
    t = torch.randint(0, cfg.num_train_timesteps, (DP_EFF,), generator=gen).to(device)
    models = load_genpercept_checkpoint(str(ws["ckpt"]), device=device)
    trainable, _, _ = init_train_state(models, cfg)
    params = list(trainable.values())
    loss_fn = build_loss_fn(cfg, models)
    counts: list = []

    def grads(rows, replay: bool):
        """The loss and gradient of batch[rows]; the counts its losses
        divide by recorded (batched) or replayed (an image)."""
        sums = (train_losses.global_sum, parallel.global_sum)
        it = iter(list(counts))

        def count(x):
            if replay:
                return next(it)
            counts.append(x.detach().clone())
            return x

        train_losses.global_sum = parallel.global_sum = count
        try:
            loss, _ = loss_fn({k: v[rows] for k, v in batch.items()}, draws={"t": t[rows]})
            g = torch.autograd.grad(loss, params)
        finally:
            train_losses.global_sum, parallel.global_sum = sums
        return loss.item(), dict(zip(trainable, g))

    with tf32(False, False):
        loss_b, g_b = grads(slice(0, DP_EFF), False)
        split = [grads(slice(i, i + 1), True) for i in range(DP_EFF)]
        with TP.emulated(TP_M):
            loss_t, g_t = grads(slice(0, DP_EFF), True)
    top = max(float(v.abs().max()) for v in g_b.values())
    keep = [k for k in g_b if float(g_b[k].abs().max()) >= 1e-6 * top]
    g_s = {k: sum(g[k] for _, g in split) for k in keep}
    # for the ranks (tp_to_witness), whole once it has its name
    torch.save({k: g_t[k].cpu() for k in keep}, f"{tp_file}.part")
    Path(f"{tp_file}.part").rename(tp_file)
    loss_s = sum(x for x, _ in split)

    def adam_first(g):  # OptaxAdam's first update over lr, in f32
        b1, b2, eps = 0.9, 0.999, 1e-8
        mu, nu = (1 - b1) * g, (1 - b2) * g * g
        return (mu / (1 - b1)) / (torch.sqrt(nu / (1 - b2)) + eps)

    rec = {"loss_batched": loss_b, "loss_split": loss_s,
           "loss_rel_diff": abs(loss_s - loss_b) / abs(loss_b),
           "grad_rel_l2": dp_rel_l2(g_s, g_b, keep, device),
           "update_rel_l2": dp_rel_l2({k: adam_first(g_s[k]) for k in keep},
                                      {k: adam_first(g_b[k]) for k in keep}, keep, device),
           "tp_loss": loss_t, "tp_loss_rel_diff": abs(loss_t - loss_b) / abs(loss_b),
           "tp_grad_rel_l2": dp_rel_l2(g_t, g_b, keep, device),
           "tp_update_rel_l2": dp_rel_l2({k: adam_first(g_t[k]) for k in keep},
                                         {k: adam_first(g_b[k]) for k in keep}, keep, device),
           "params_compared": len(keep),
           "params": len(g_b), "losses": list(cfg.loss_names), "t": t.tolist(),
           "valid_fraction": [float(m.float().mean()) for m in batch["valid_mask"]],
           "seconds": time.perf_counter() - t0}
    del models, trainable, params, g_b, g_s, g_t, split, loss_fn, counts
    gc_cuda()
    return rec


def dp_rank_main(args: list) -> None:
    """One rank under torchrun (``python3 chip_smoke.py dp_rank JOBS``): the
    jobs of the JSON file JOBS ({"ckpt", "jobs"}) in order, each {"name",
    "kind", "precision", "argv", ...} through cli/train.py on cuda:0. A "solo" job is a one-process
    reference: rank 0 runs it with no process group while the others wait;
    the solo jobs come first. The "ranks" jobs run on every rank in one
    gloo group from torchrun's environment, started once (the CLI uses the
    group it finds; a job's argv may split the UNet over a model group,
    --model_parallel). Rank 0 keeps each run's parameters and first moments
    on the card, in the one-process layout, compares them ("compare": a
    solo run; "equal": an earlier run; "to_f32": a bf16 run's gradient
    against an f32 solo run's, beside the "compare" run's; each state
    dropped after the last job that reads it; "witness": the file of
    dp_split_witness's emulated-split gradient, read and deleted), deletes the run's
    checkpoints as soon as it has read them (but the one "keep" names; the
    machine's disk takes a few checkpoints, not all of them), and writes
    <out>.rank<r>.json per job. "ckpt_check": every rank holds its share of
    the final checkpoint against its own parameters and moments."""
    import os

    from genpercept_tpu_torch import parallel
    from genpercept_tpu_torch.cli import train as train_cli
    from genpercept_tpu_torch.io.weights import load_safetensors

    rank = int(os.environ["RANK"])
    spec = json.loads(Path(args[0]).read_text())
    device = "cuda:0"
    torch.cuda.set_device(0)
    base, states = None, {}
    last_use = {}  # a run's state is dropped after the last job that reads it
    for i, job in enumerate(spec["jobs"]):
        for key in ("compare", "equal", "to_f32"):
            if job.get(key):
                last_use[job[key]] = i
    for i, job in enumerate(spec["jobs"]):
        out, run = Path(job["out"]), Path(job["run"])
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = job["precision"] != "f32"
        rec = {"rank": rank, "name": job["name"]}
        if job["kind"] == "solo":
            # before the group starts: a second group in one process hung
            check(not parallel.is_distributed(), "dp: a solo job after the ranks' jobs")
            if rank == 0:
                reset_counts()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                trainer = train_cli.main([*job["argv"], "--device", device])
                torch.cuda.synchronize()
                rec.update(seconds=time.perf_counter() - t0, launches=launch_counts(),
                           peak_bytes=torch.cuda.max_memory_allocated())
                states[job["name"]] = dp_trained_state(trainer, True)
                del trainer
                shutil.rmtree(run / "checkpoint")
                Path(f"{out}.rank0.json").write_text(json.dumps(rec))
            else:
                while not Path(f"{out}.rank0.json").is_file():
                    time.sleep(1.0)
            continue
        parallel.init_distributed(multihost=True, backend="gloo")
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = train_cli.main([*job["argv"], "--multihost", "--device", device])
        torch.cuda.synchronize()
        rec.update(seconds=time.perf_counter() - t0, launches=launch_counts(),
                   peak_bytes=torch.cuda.max_memory_allocated(),
                   effective_iter=trainer.effective_iter,
                   model_parallel=parallel.model_world(),
                   param_sum=sum(float(p.detach().double().sum())
                                 for p in trainer.trainable.values()),
                   # the parameters a model group replicates
                   replicated_sum=sum(float(p.detach().double().sum())
                                      for k, p in trainer.trainable.items()
                                      if k not in trainer.splits))
        if job.get("ckpt_check"):
            rec.update(tp_checkpoint_diff(trainer, run))
        # a collective under ZeRO-1 or tensor parallelism
        state = dp_trained_state(trainer, rank == 0)
        del trainer
        gc_cuda()
        if rank == 0:
            if job["name"] in last_use:
                states[job["name"]] = state
            log = metrics_log(run)
            rec["loss"] = log["train/loss"][-1][1] if "train/loss" in log else None
            rec["terms"] = {t: v[-1][1] for t, v in log.items() if t.startswith("train/")}
            if (job.get("compare") or job.get("equal")) and base is None:
                base = {f"unet.{k}": v.to(device, torch.float32) for k, v in load_safetensors(
                    str(Path(spec["ckpt"]) / "unet" /
                        "diffusion_pytorch_model.safetensors")).items()}
            if job.get("compare"):
                rec.update(dp_compare(state, states[job["compare"]], base, device))
            if job.get("to_f32"):
                rec.update(tp_to_f32(state, states[job["compare"]], states[job["to_f32"]], device))
            if job.get("witness"):
                rec.update(tp_to_witness(state, Path(job["witness"]), device))
            if job.get("equal"):
                other = states[job["equal"]]
                rec["vs_equal"] = dp_compare(state, other, base, device)
                rec["params_max_abs_diff"] = max(
                    float((state["params"][k].to(device) - other["params"][k].to(device))
                          .abs().max()) for k in other["params"])
                rec["mu_max_abs_diff"] = max(
                    float((state["mu"][k].to(device) - other["mu"][k].to(device)).abs().max())
                    for k in other["mu"])
                rec["mu_max"] = max(float(v.abs().max()) for v in other["mu"].values())
                del other
            for name in [n for n, last in last_use.items() if last == i]:
                states.pop(name, None)
            del state
            rec["files"] = sorted(p.name for p in run.iterdir())
            for name in ("final", "_old_final", "latest"):
                if name != job.get("keep") and (run / "checkpoint" / name).exists():
                    shutil.rmtree(run / "checkpoint" / name)
        Path(f"{out}.rank{rank}.json").write_text(json.dumps(rec))
        parallel.barrier()
    parallel.shutdown()


def dp_launch(ws: dict, jobs: list, meanwhile=None) -> tuple:
    """The jobs (dp_rank_main's) under one torchrun of DP_WORLD ranks
    (--standalone: a rendezvous on this host), ``meanwhile()`` run in this
    process while they start; returns {name: [the records of the ranks that
    ran it]}, the ranks' output, the wall and what ``meanwhile`` returned."""
    root = ws["root"]
    for job in jobs:
        job["out"] = str(root / f"dp_{job['name']}")
        job["argv"] = ["--config", str(job.pop("recipe")), "--checkpoint", str(ws["ckpt"]),
                       "--base_data_dir", str(root / "data"), "--output_dir", job["run"],
                       *job.get("argv", ())]
    (root / "dp_jobs.json").write_text(json.dumps({"ckpt": str(ws["ckpt"]), "jobs": jobs}))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(DP_WORLD), str(Path(__file__).resolve()), "dp_rank", str(root / "dp_jobs.json")]
    t0 = time.perf_counter()
    log_path = root / "dp_ranks.log"
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(cmd, stdout=log_file, stderr=subprocess.STDOUT,
                                cwd=Path(__file__).resolve().parent)
        during = None
        try:
            during = meanwhile() if meanwhile else None
            proc.wait(timeout=max(DP_TIMEOUT_S - (time.perf_counter() - t0), 1))
        except BaseException as err:  # the limit, or a fault of meanwhile()
            proc.terminate()  # torchrun stops its workers on SIGTERM
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            if not isinstance(err, subprocess.TimeoutExpired):
                raise
    log = log_path.read_text()
    print(log[-20000:], file=sys.stderr, flush=True)
    check(proc.returncode == 0, f"dp: torchrun exited {proc.returncode}:\n{log[-3000:]}")
    out = {}
    for job in jobs:
        ranks = [0] if job["kind"] == "solo" else range(DP_WORLD)
        out[job["name"]] = [json.loads(Path(f"{job['out']}.rank{r}.json").read_text())
                            for r in ranks]
    return out, log, time.perf_counter() - t0, during


def tp_checks(recs: dict, witness: dict, expect: dict, run: dict) -> dict:
    """The tensor-parallel jobs' records, emitted and held to their bars:
    the f32 loss, gradient and update against the one-process run and the
    split's witness (the gradient also directly against the witness's); the bf16 gradient's distance to the f32 one-process
    gradient beside the one-process bf16 gradient's; each rank's exact
    K1-K4 launches (``expect``: by job), peak memory and seconds; the
    ranks' replicated parameters equal; validation at step 1 on rank 0's
    model group, written by rank 0; each rank's shards and moments equal
    to its share of the final checkpoint."""
    out = {}
    for name in ("tp_f32", "tp_bf16", "tp_k2"):
        ranks = recs[name]
        rec = out[name] = {
            "phase": "data_parallel", "step": name, "model_parallel": TP_M,
            "launches": [r["launches"] for r in ranks],
            "peak_gb": [r["peak_bytes"] / 1e9 for r in ranks],
            "seconds": [r["seconds"] for r in ranks], "loss": ranks[0]["loss"],
            "terms": ranks[0]["terms"]}
        check(all(r["model_parallel"] == TP_M and r["effective_iter"] == 1 for r in ranks)
              and math.isfinite(rec["loss"]), f"tp {name}: {ranks}")
        check(len({r["replicated_sum"] for r in ranks}) == 1,
              f"tp {name}: the ranks' replicated parameters differ {ranks}")
        check(rec["launches"] == [expect[name]] * TP_M,
              f"tp {name}: launches {rec['launches']} != {expect[name]} a rank")
    f, r0 = out["tp_f32"], recs["tp_f32"][0]
    f["loss_one"] = metrics_log(Path(run["one_f32"]))["train/loss"][0][1]
    f.update(loss_rel_diff=abs(f["loss"] - f["loss_one"]) / abs(f["loss_one"]),
             **{k: r0[k] for k in ("grad_rel_l2", "update_rel_l2", "params_compared",
                                   "witness_grad_rel_l2")},
             witness={k: witness[k] for k in ("tp_loss_rel_diff", "tp_grad_rel_l2",
                                              "tp_update_rel_l2")})
    val = metrics_log(Path(run["tp_f32"])).get("val/hypersim/abs_relative_difference", [])
    f["val_steps"] = [v[0] for v in val]
    b, r0 = out["tp_bf16"], recs["tp_bf16"][0]
    b.update(loss_one=metrics_log(Path(run["one_bf16"]))["train/loss"][0][1],
             **{k: r0[k] for k in ("grad_rel_l2", "update_rel_l2", "to_f32", "one_to_f32")})
    k2 = out["tp_k2"]
    k2.update({k: [r[k] for r in recs["tp_k2"]] for k in (
        "ckpt_params_max_abs_diff", "ckpt_moments_max_abs_diff", "ckpt_moments")})
    for rec in out.values():
        emit(rec)
    check(f["loss_rel_diff"] <= DP_LOSS_TOL,
          f"tp f32: loss {f['loss']} against one process's {f['loss_one']}")
    check(f["grad_rel_l2"] <= min(TP_GRAD_TOL, TP_GRAD_WITNESS_X * witness["tp_grad_rel_l2"]),
          f"tp f32: gradient {f['grad_rel_l2']} from one process's (the split's witness "
          f"{witness['tp_grad_rel_l2']})")
    check(f["witness_grad_rel_l2"] <= TP_WITNESS_GRAD_TOL,
          f"tp f32: gradient {f['witness_grad_rel_l2']} from the split's witness's")
    check(f["update_rel_l2"] <= TP_UPDATE_WITNESS_X * witness["tp_update_rel_l2"],
          f"tp f32: update {f['update_rel_l2']} from one process's (the split's witness "
          f"{witness['tp_update_rel_l2']})")
    check(f["val_steps"] == [1], f"tp f32: validation at {f['val_steps']}")
    check(b["to_f32"] <= TP_TO_F32_X * b["one_to_f32"],
          f"tp bf16: gradient {b['to_f32']} from the f32 one-process gradient, one process's "
          f"bf16 {b['one_to_f32']}")
    check(all(n["K2"] > 0 for n in k2["launches"]), f"tp K2: launches {k2['launches']}")
    check(all(x == 0.0 for x in k2["ckpt_params_max_abs_diff"] + k2["ckpt_moments_max_abs_diff"])
          and all(n > 0 for n in k2["ckpt_moments"]),
          f"tp: the final checkpoint is not the ranks' shards gathered {k2}")
    summary = {"model_parallel": TP_M,
               "f32": {k: f[k] for k in ("loss_rel_diff", "grad_rel_l2", "update_rel_l2",
                                         "witness_grad_rel_l2")},
               "witness": f["witness"],
               "bf16": {k: b[k] for k in ("to_f32", "one_to_f32")},
               "launches": {n: out[n]["launches"][0] for n in out},
               "peak_gb": {n: out[n]["peak_gb"] for n in out},
               "seconds": {n: out[n]["seconds"] for n in out},
               "bars": {"loss": DP_LOSS_TOL, "grad": TP_GRAD_TOL, "grad_witness_x":
                        TP_GRAD_WITNESS_X, "grad_to_witness": TP_WITNESS_GRAD_TOL,
                        "update_witness_x": TP_UPDATE_WITNESS_X, "to_f32_x": TP_TO_F32_X}}
    return {"summary": summary, "records": out}


def resumed_trainer(recipe_cfg: dict, ckpt: Path, run_dir: Path, device: str = "cuda"):
    """A one-process Trainer of the recipe over the base checkpoint, resumed
    from run_dir's final checkpoint by ``Trainer.load_checkpoint``, as
    ``cli/train.py --resume_run final`` does, without the loader and the
    final checkpoint the CLI writes after a run with nothing left to
    train."""
    from genpercept_tpu_torch.cli.train import resolve_train_config
    from genpercept_tpu_torch.utils.config import Config

    cfg = resolve_train_config(Config(recipe_cfg), grad_accum_steps=1, mode="depth")
    models = load_genpercept_checkpoint(str(ckpt), device=device)
    trainer = Trainer(cfg, models, None, str(run_dir), max_iter=1, save_period=0)
    trainer.load_checkpoint("final")
    return trainer


def tp_one_process_resume(ws: dict, recipe_cfg: dict, run_dir: Path) -> dict:
    """One process (no process group) resumes the tensor-parallel run's
    final checkpoint: its trainable parameters and Adam moments against the
    checkpoint's (0.0: whole tensors, the one-process layout). With
    tp_checkpoint_diff on the ranks, the one process holds what the ranks
    held. The checkpoint is deleted after."""
    from genpercept_tpu_torch.io.checkpoints import load_train_checkpoint

    t0 = time.perf_counter()
    trainer = resumed_trainer(recipe_cfg, ws["ckpt"], run_dir)
    ck = load_train_checkpoint(str(run_dir / "checkpoint"), "final", map_location="cuda")
    names = list(trainer.trainable)
    own = trainer.optimizer.state_dict()["state"]
    rec = {"params_max_abs_diff": max(
               float((p.detach().float() - ck["trainable"][k].float()).abs().max())
               for k, p in trainer.trainable.items()),
           "moments_max_abs_diff": max(
               float((st[m].float() - ck["opt_state"]["state"][i][m].float()).abs().max())
               for i, st in own.items() for m in ("mu", "nu")),
           "params": len(names), "moments": len(own),
           "effective_iter": trainer.effective_iter, "seconds": time.perf_counter() - t0}
    del trainer, ck, own
    gc_cuda()
    shutil.rmtree(run_dir / "checkpoint")
    return rec


def phase_data_parallel(ws: dict) -> dict:
    """(x) cli/train.py data- and tensor-parallel on the one card, under one
    torchrun: the one-process references (rank 0 alone, no process group,
    f32 and bf16) then two gloo ranks on the same global micro-batch, in
    f32 with TF32 off (loss and gradient held, the update reported) and in
    bf16 (reported); --zero1 (the same step, the whole Adam state gathered
    for its checkpoint); rank 0's run directory and validation; both ranks
    resumed from the ZeRO-1 run's checkpoint by the CLI. Tensor parallelism
    (--model_parallel TP_M, tp_checks): the two ranks one model group on
    the one-process runs' micro-batch, f32 (held to the split's witness,
    validation on both ranks) and bf16 (held against the f32 one-process
    gradient), and two 768^2 images a rank routing K2 on its inner share,
    whose final checkpoint is each rank's shards gathered and resumes in
    one process. Exact launches a rank. The batch and tensor splits' own
    rounding is read in this process while the first jobs run
    (dp_split_witness)."""
    t_phase = time.perf_counter()
    root, data = ws["root"], ws["data"]
    accum = DP_EFF // DP_WORLD
    recipes, cfgs = {}, {}
    for name, micro, f32, save, val, resize in (("one_f32", DP_WORLD, True, 0, 0, None),
                                                ("two_f32", 1, True, 0, 1, None),
                                                ("zero1", 1, True, 0, 0, None),
                                                ("one_bf16", DP_WORLD, False, 0, 0, None),
                                                ("two_bf16", 1, False, 0, 0, None),
                                                ("tp_f32", DP_WORLD, True, 0, 1, None),
                                                ("tp_k2", TP_K2_MICRO, False, 0, 0, TP_K2_HW)):
        recipes[name] = root / f"dp_{name}.yaml"
        cfgs[name] = cfg = write_dp_recipe(recipes[name], data, micro, f32, 1, save, val,
                                           resize)
    train = cfg["dataset"]["train"]
    sizes = [TE_SAMPLES["hypersim"], TE_SAMPLES["vkitti"]]
    first = next(iter(MixedBatchSampler(
        [range(n) for n in sizes], batch_size=DP_EFF, prob=train["prob_ls"],
        generator=np.random.default_rng(cfg["trainer"]["init_seed"]))))
    check(all(i < sizes[0] for i in first), "the first step does not draw Hypersim")
    served = served_launches(TRAIN_HW)
    per_rank = {k: accum * n for k, n in train_step_launches(TRAIN_HW, 1, True).items()}
    with_val = {k: n + TE_SAMPLES["val"] * served[k] for k, n in per_rank.items()}
    one_expect = {k: accum * n for k, n in train_step_launches(TRAIN_HW, DP_WORLD, True).items()}
    run = {n: str(root / n) for n in ("one_f32", "two_f32", "zero1", "one_bf16", "two_bf16",
                                      "tp_f32", "tp_bf16", "tp_k2")}
    tp_argv = ["--model_parallel", str(TP_M)]
    tp_file = root / "tp_witness_grad.pt"

    def witness_meanwhile():  # on the card beside the first jobs
        rec = dp_split_witness(ws, cfgs["one_f32"], tp_file)
        gc_cuda()  # the ranks share the card with this process
        return rec

    recs, log, wall, witness = dp_launch(ws, [
        {"name": "one_f32", "kind": "solo", "precision": "f32", "recipe": recipes["one_f32"],
         "run": run["one_f32"]},
        {"name": "one_bf16", "kind": "solo", "precision": "bf16", "recipe": recipes["one_bf16"],
         "run": run["one_bf16"]},
        {"name": "tp_f32", "kind": "ranks", "precision": "f32", "recipe": recipes["tp_f32"],
         "run": run["tp_f32"], "argv": tp_argv, "compare": "one_f32", "witness": str(tp_file)},
        {"name": "tp_bf16", "kind": "ranks", "precision": "bf16", "recipe": recipes["one_bf16"],
         "run": run["tp_bf16"], "argv": tp_argv, "compare": "one_bf16", "to_f32": "one_f32"},
        {"name": "two_bf16", "kind": "ranks", "precision": "bf16", "recipe": recipes["two_bf16"],
         "run": run["two_bf16"], "compare": "one_bf16"},
        {"name": "two_f32", "kind": "ranks", "precision": "f32", "recipe": recipes["two_f32"],
         "run": run["two_f32"], "compare": "one_f32"},
        {"name": "zero1", "kind": "ranks", "precision": "f32", "recipe": recipes["zero1"],
         "run": run["zero1"], "argv": ["--zero1"], "equal": "two_f32", "keep": "final"},
        {"name": "resumed", "kind": "ranks", "precision": "f32", "recipe": recipes["zero1"],
         "run": run["zero1"], "argv": ["--zero1", "--resume_run", "final"], "equal": "zero1"},
        {"name": "tp_k2", "kind": "ranks", "precision": "bf16", "recipe": recipes["tp_k2"],
         "run": run["tp_k2"], "argv": tp_argv, "ckpt_check": True, "keep": "final"}],
        witness_meanwhile)
    emit({"phase": "data_parallel", "step": "split_witness", **witness})
    check(witness["loss_rel_diff"] <= DP_LOSS_TOL, f"dp witness: loss {witness}")
    out: dict = {"torchrun_wall_s": wall}
    for precision in ("f32", "bf16"):
        one, two = recs[f"one_{precision}"][0], recs[f"two_{precision}"]
        log_one = metrics_log(Path(run[f"one_{precision}"]))
        loss_one = log_one["train/loss"][0][1]
        loss_two = two[0]["loss"]
        terms = {t: {"one": v[0][1], "two": two[0]["terms"].get(t)} for t, v in log_one.items()
                 if t.startswith("train/")}
        rec = {"phase": "data_parallel", "step": precision, "world": DP_WORLD,
               "micro_per_rank": 1, "global_micro": DP_WORLD, "accum": accum,
               "loss_one": loss_one, "loss_two": loss_two,
               "loss_rel_diff": abs(loss_two - loss_one) / abs(loss_one), "terms": terms,
               **{k: two[0][k] for k in ("grad_rel_l2", "update_rel_l2", "params_compared",
                                         "params")},
               "one_process": one, "ranks": two}
        out[precision] = rec
        emit(rec)
        check(one["launches"] == one_expect, f"dp one {precision}: launches {one['launches']}")
        want = [with_val if precision == "f32" else per_rank, per_rank]
        check([r["launches"] for r in two] == want,
              f"dp two {precision}: launches {[r['launches'] for r in two]} != {want}")
        check(two[0]["param_sum"] == two[1]["param_sum"],
              f"dp two {precision}: the ranks' parameters differ")
        check(math.isfinite(loss_two) and all(r["effective_iter"] == 1 for r in two),
              f"dp two {precision}: {loss_two}, {two}")
    check(out["f32"]["loss_rel_diff"] <= DP_LOSS_TOL,
          f"dp f32: loss {out['f32']['loss_two']} against one process's "
          f"{out['f32']['loss_one']}")
    out["f32"]["grad_witness_rel_l2"] = witness["grad_rel_l2"]
    # the witness rebuilt the one-process step: the same loss
    wl = abs(witness["loss_batched"] - out["f32"]["loss_one"]) / abs(out["f32"]["loss_one"])
    out["f32"]["witness_loss_rel_diff"] = wl
    check(wl <= DP_LOSS_TOL, f"dp witness: loss {witness['loss_batched']} against the one "
          f"process's {out['f32']['loss_one']}")
    check(out["f32"]["grad_rel_l2"] <= min(DP_GRAD_TOL, DP_GRAD_WITNESS_X * witness["grad_rel_l2"]),
          f"dp f32: gradient {out['f32']['grad_rel_l2']} from one process's (the batch "
          f"split's witness {witness['grad_rel_l2']})")
    out["f32"]["update_witness_rel_l2"] = witness["update_rel_l2"]
    check(out["f32"]["update_rel_l2"] <= DP_UPDATE_WITNESS_X * witness["update_rel_l2"],
          f"dp f32: update {out['f32']['update_rel_l2']} from one process's (the batch "
          f"split's witness {witness['update_rel_l2']})")
    # rank 0's run directory: one writer, validation at step 1
    two_dir = Path(run["two_f32"])
    files = recs["two_f32"][0]["files"]
    log_text = (two_dir / "logging.log").read_text()
    val = metrics_log(two_dir).get("val/hypersim/abs_relative_difference", [])
    z, r = recs["zero1"], recs["resumed"]
    rec_z = {"phase": "data_parallel", "step": "zero1_files_resume",
             "zero1_update_rel_l2_vs_plain": z[0]["vs_equal"]["update_rel_l2"],
             "plain_update_rel_l2_vs_one": out["f32"]["update_rel_l2"],
             "zero1_params_max_abs_diff_vs_plain": z[0]["params_max_abs_diff"],
             "zero1_mu_max_abs_diff_vs_plain": z[0]["mu_max_abs_diff"],
             "zero1_mu_max": z[0]["mu_max"], "zero1_ranks": z,
             "resumed_ranks": r, "resumed_lines": log.count("resumed at iter 1"),
             "rank0_files": files, "val_steps": [v[0] for v in val],
             "logging_ranks": [f"rank={i}/{DP_WORLD}" in log_text for i in range(DP_WORLD)]}
    emit(rec_z)
    for f in ("config.yaml", "code_snapshot.tar.gz", "metrics.jsonl", "logging.log",
              "checkpoint"):
        check(f in files, f"dp: rank 0 wrote no {f}")
    check(rec_z["val_steps"] == [1], f"dp: validation at {rec_z['val_steps']}")
    check(rec_z["logging_ranks"] == [True] + [False] * (DP_WORLD - 1),
          f"dp: logging.log holds other ranks' lines {rec_z['logging_ranks']}")
    check(z[0]["mu_max_abs_diff"] <= DP_ZERO1_MU_REL * z[0]["mu_max"]
          and rec_z["zero1_update_rel_l2_vs_plain"] <= DP_ZERO1_UPDATE_REL,
          f"dp --zero1: update {rec_z['zero1_update_rel_l2_vs_plain']} (global relative L2), "
          f"moments {z[0]['mu_max_abs_diff']} of {z[0]['mu_max']} from plain data parallel")
    check(z[0]["param_sum"] == z[1]["param_sum"], f"dp --zero1: the ranks' parameters differ {z}")
    check([x["launches"] for x in z] == [per_rank, per_rank],
          f"dp --zero1 launches {[x['launches'] for x in z]}")
    check(all(x["effective_iter"] == 1 and x["param_sum"] == z[0]["param_sum"]
              and not any(x["launches"].values()) for x in r)
          and r[0]["params_max_abs_diff"] == 0.0 and r[0]["mu_max_abs_diff"] == 0.0
          and rec_z["resumed_lines"] == DP_WORLD,
          f"dp resume: {r}, {rec_z['resumed_lines']} ranks resumed")
    # both ranks of the model group validate
    tp = tp_checks(recs, witness, {
        "tp_f32": {k: n + TE_SAMPLES["val"] * served[k] for k, n in one_expect.items()},
        "tp_bf16": one_expect, "tp_k2": train_step_launches(TP_K2_HW, TP_K2_MICRO, True)}, run)
    tp["one_process_resume"] = tp_one_process_resume(ws, cfgs["tp_k2"], Path(run["tp_k2"]))
    emit({"phase": "data_parallel", "step": "tp_one_process_resume",
          **tp["one_process_resume"]})
    check(tp["one_process_resume"]["params_max_abs_diff"] == 0.0
          and tp["one_process_resume"]["moments_max_abs_diff"] == 0.0,
          f"tp: one process resumed from the ranks' checkpoint {tp['one_process_resume']}")
    for d in run.values():
        shutil.rmtree(d, ignore_errors=True)
    summary = {"phase": "data_parallel", "step": "summary",
               **{p: {k: out[p][k] for k in ("loss_rel_diff", "grad_rel_l2", "update_rel_l2")}
                  for p in ("f32", "bf16")},
               "split_witness": {k: witness[k] for k in ("loss_rel_diff", "grad_rel_l2",
                                                           "update_rel_l2")},
               "witness_loss_vs_one": out["f32"]["witness_loss_rel_diff"],
               "zero1_update_rel_l2_vs_plain": rec_z["zero1_update_rel_l2_vs_plain"],
               "bars": {"loss": DP_LOSS_TOL, "grad": DP_GRAD_TOL,
                        "grad_witness_x": DP_GRAD_WITNESS_X,
                        "update_witness_x": DP_UPDATE_WITNESS_X,
                        "zero1_update": DP_ZERO1_UPDATE_REL, "zero1_mu": DP_ZERO1_MU_REL},
               "rank_peak_gb": [x["peak_bytes"] / 1e9 for x in recs["two_f32"]],
               "tp": tp["summary"],
               "torchrun_wall_s": wall, "seconds": time.perf_counter() - t_phase}
    emit(summary)
    return summary


def kernel_record(name, source, replaces, launches, max_abs_err, ms, plain_ms, bd: Bound,
                  library_ms):
    return {"name": name, "route": "cuda", "source": f"genpercept_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": max_abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bd.ms, "bound_by": bd.by,
            "library_ms": library_ms}


WALLS: dict = {}  # phase -> wall seconds


def timed(name: str, fn, *args, **kwargs):
    """fn(*args, **kwargs), its wall seconds printed on a line of their own
    and kept in WALLS."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    WALLS[name] = time.perf_counter() - t0
    emit({"phase_wall": name, "seconds": WALLS[name]})
    return out


def main() -> None:
    t_start = time.perf_counter()
    name = timed("device", phase_device)
    timed("build", phase_build)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k1 = timed("k1", phase_k1, gen)
    k2 = timed("k2", phase_k2, gen)
    unet, vae, clip = timed("build_models", build_models, gen)
    sl = timed("slice", phase_slice, unet, vae, clip)
    k34 = timed("k34", phase_k34, gen)
    tr = timed("train", phase_train, unet, vae, clip)
    f32, bf16 = torch.float32, torch.bfloat16
    k5 = timed("k5", phase_k5)
    k6 = timed("k6", phase_k6)
    i8 = timed("int8_slice", phase_int8_slice, unet, vae, clip, sl[bf16]["img_per_s"])
    k8 = timed("k8", phase_k8)
    k7 = timed("k7", phase_k7)
    fv = timed("fused_slice", phase_fused_slice, unet, vae, clip, sl)
    timed("k2_wide", phase_k2_wide)
    timed("k6_d64", phase_k6_d64)
    s14 = timed("s14", phase_s14)
    paths = timed("scripts", phase_scripts)
    timed("checkpoint_cli", phase_checkpoint_cli)
    timed("marigold", phase_marigold)
    timed("serve", phase_serve)
    with tempfile.TemporaryDirectory() as tmp:
        ws = timed("te_workspace", te_workspace, Path(tmp))
        timed("train_eval", phase_train_eval, tr["run"]["ms_per_step"], ws)
        timed("train_extras", phase_train_extras, ws)
        timed("int8_extras", phase_int8_extras, ws)
        timed("data_parallel", phase_data_parallel, ws)
    emit({"phase_walls": WALLS, "total_seconds": time.perf_counter() - t_start})
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
    if sys.argv[1:2] == ["dp_rank"]:  # one rank of phase_data_parallel, under torchrun
        dp_rank_main(sys.argv[2:])
    else:
        main()
