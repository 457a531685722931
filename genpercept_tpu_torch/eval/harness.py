"""Batched evaluation harness.

Counterpart of ``genpercept_tpu/eval/harness.py``. Eval datasets have
fixed raster sizes (NYU 480x640, the KITTI crop 352x1216, ...), so whole
batches go through the pipeline step at the dataset's raster, then the
closed-form least-squares alignment, the clips and all 10 metrics on the
models' device; the reference evaluates one sample at a time with numpy
lstsq (``cli/eval.py``). With ``devices`` (the counterpart of JAX's
``mesh=``) each batch's forward is split between a replica of the models
on each device, and the metrics run on the first over the whole batch.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from genpercept_tpu_torch.eval.alignment import align_depth_least_square_torch
from genpercept_tpu_torch.eval.metrics import METRIC_FUNCS
from genpercept_tpu_torch.ops.resize import resize
from genpercept_tpu_torch.pipeline import GenPerceptPipeline, PipelineConfig, build_single_infer


def build_eval_step(models, pipe_cfg: PipelineConfig, min_depth: float,
                    max_depth: float, alignment: str = "least_square",
                    devices: Optional[List] = None):
    """Returns eval_step(rgb01, gt, valid) -> {metric: 0-dim tensor, the
    batch's mean}; rgb01 (B, H, W, 3) in [0, 1], gt (B, H', W') metric depth
    and valid (B, H', W') bool, all on the models' device. ``devices``: the
    forward runs data-parallel over them (GenPerceptPipeline's split), the
    models on the first."""
    if devices and len(devices) > 1:
        infer = GenPerceptPipeline(models, pipe_cfg, devices=devices)._forward
    else:
        infer = build_single_infer(models, pipe_cfg)
    max_d = float(min(max_depth, 1e8))

    @torch.no_grad()
    def eval_step(rgb01, gt, valid):
        pred = infer(rgb01)  # (B, H, W) in [0, 1]
        if pred.shape[1:] != gt.shape[1:]:
            pred = resize(pred[..., None], tuple(gt.shape[1:3]), "bilinear")[..., 0]
        if alignment == "least_square":
            pred, _, _ = align_depth_least_square_torch(gt, pred, valid)
        elif alignment == "least_square_disparity":
            # the mask takes pred > 0 too and the aligned disparity clips at
            # 1e-3 (reference eval.py:177-197)
            gt_disp = torch.where(gt > 0, 1.0 / torch.clamp(gt, min=1e-8), 0.0)
            aligned, _, _ = align_depth_least_square_torch(
                gt_disp, pred, valid & (gt > 0) & (pred > 0))
            pred = 1.0 / torch.clamp(aligned, min=1e-3)
        pred = torch.clamp(pred, min_depth, max_d)
        pred = torch.clamp(pred, min=1e-6)
        return {name: fn(pred, gt, valid) for name, fn in METRIC_FUNCS.items()}

    return eval_step


def evaluate_dataset(
    models,
    dataset,
    mode: str = "depth",
    batch_size: int = 4,
    alignment: str = "least_square",
    processing_res: int = 768,
    dtype: torch.dtype = torch.bfloat16,
    limit: Optional[int] = None,
    device: torch.device | str = "cuda",
    devices: Optional[List] = None,
) -> Dict[str, float]:
    """The eval protocol over ``dataset`` (EVAL mode items) in batches of
    ``batch_size``, each batch weighted by its sample count. ``models`` must
    already be on ``device``, the card unless the caller asks for the CPU.
    ``processing_res`` is recorded in the pipeline config as the JAX harness
    does; the step runs at the dataset's raster. ``devices`` (the first one
    the models' device) splits each batch's forward between them."""
    if devices:
        device = devices[0]
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("evaluate_dataset runs on the card by default and no CUDA device "
                           "is available; pass device=\"cpu\"")
    if models.device.type != device.type:
        raise ValueError(f"the models are on {models.device}, evaluate_dataset was asked "
                         f"for {device}")
    pipe_cfg = PipelineConfig(mode=mode, processing_res=processing_res,
                              match_input_res=False, dtype=dtype)
    step = build_eval_step(models, pipe_cfg, dataset.min_depth, dataset.max_depth, alignment,
                           devices=devices)

    totals: Dict[str, float] = {k: 0.0 for k in METRIC_FUNCS}
    n_samples = 0
    n = min(len(dataset), limit) if limit else len(dataset)
    buf = []
    for i in range(n):
        buf.append(dataset[i])
        if len(buf) < batch_size and i != n - 1:
            continue
        rgb01 = np.stack([(s["rgb_norm"] + 1.0) / 2.0 for s in buf])
        gt = np.stack([s["depth_raw_linear"] for s in buf])
        valid = np.stack([s["valid_mask_raw"] for s in buf])
        out = step(torch.as_tensor(rgb01, dtype=torch.float32, device=device),
                   torch.as_tensor(gt, dtype=torch.float32, device=device),
                   torch.as_tensor(valid, dtype=torch.bool, device=device))
        # weight each batch by its sample count so a smaller final batch is
        # not over-weighted (the reference's per-sample averaging)
        for k, v in out.items():
            totals[k] += float(v) * len(buf)
        n_samples += len(buf)
        buf = []
    return {k: v / max(n_samples, 1) for k, v in totals.items()}
