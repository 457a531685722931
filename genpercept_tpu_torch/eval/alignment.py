"""Eval-time affine alignment of affine-invariant predictions to metric GT.

Counterpart of ``genpercept_tpu/eval/alignment.py``: the least-squares
(scale, shift) fit on masked pixels in numpy (the offline eval CLI and the
trainer's validation), the same fit in closed form over a batch in torch
(the batched harness), and depth <-> disparity for numpy arrays and torch
tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _nearest_downsample_np(x: np.ndarray, scale: float) -> np.ndarray:
    """The reference's downsample, as it behaves: it hands the squeezed
    (H, W) array to nn.Upsample as a 3-D (1, H, W) tensor, which torch reads
    as (N, C, L) and interpolates over the last axis only. So only W shrinks
    (to floor(w * scale), source index floor(i / scale)); H is untouched."""
    w = x.shape[-1]
    ow = int(w * scale)
    xs = np.minimum((np.arange(ow) / scale).astype(int), w - 1)
    return x[..., xs]


def align_depth_least_square(
    gt_arr: np.ndarray,
    pred_arr: np.ndarray,
    valid_mask_arr: np.ndarray,
    return_scale_shift: bool = True,
    max_resolution: Optional[int] = None,
):
    """lstsq (scale, shift) of pred onto gt over the valid pixels, optionally
    on the W-only nearest downsample when the raster exceeds max_resolution;
    returns pred * scale + shift (and the scale and shift)."""
    ori_shape = pred_arr.shape
    gt = np.squeeze(gt_arr)
    pred = np.squeeze(pred_arr)
    valid = np.squeeze(valid_mask_arr)

    if max_resolution is not None:
        scale_factor = float(np.min(max_resolution / np.array(gt.shape[-2:])))
        if scale_factor < 1:
            gt = _nearest_downsample_np(gt, scale_factor)
            pred = _nearest_downsample_np(pred, scale_factor)
            valid = _nearest_downsample_np(valid.astype(np.float32), scale_factor) > 0.5

    gt_m = gt[valid].reshape(-1, 1)
    pred_m = pred[valid].reshape(-1, 1)
    A = np.concatenate([pred_m, np.ones_like(pred_m)], axis=-1)
    X = np.linalg.lstsq(A, gt_m, rcond=None)[0]
    scale, shift = float(X[0, 0]), float(X[1, 0])

    aligned = (pred_arr * scale + shift).reshape(ori_shape)
    if return_scale_shift:
        return aligned, scale, shift
    return aligned


def align_depth_least_square_torch(
    gt: torch.Tensor, pred: torch.Tensor, valid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-sample closed-form (s, t) of the same normal equations, batched:
    (B, H, W) -> aligned (B, H, W), s (B,), t (B,). A singular system
    (|det| <= 1e-12) divides by 1 instead."""
    m = valid.float()
    a00 = (m * pred * pred).sum(dim=(-1, -2))
    a01 = (m * pred).sum(dim=(-1, -2))
    a11 = m.sum(dim=(-1, -2))
    b0 = (m * pred * gt).sum(dim=(-1, -2))
    b1 = (m * gt).sum(dim=(-1, -2))
    det = a00 * a11 - a01 * a01
    safe = torch.where(torch.abs(det) > 1e-12, det, 1.0)
    s = (a11 * b0 - a01 * b1) / safe
    t = (-a01 * b0 + a00 * b1) / safe
    aligned = pred * s[..., None, None] + t[..., None, None]
    return aligned, s, t


def depth2disparity(depth, return_mask: bool = False):
    """1 / depth where depth > 0, else 0 (numpy arrays or torch tensors)."""
    mask = depth > 0
    if isinstance(depth, torch.Tensor):
        disparity = torch.where(mask, 1.0 / torch.where(mask, depth, 1.0), 0.0)
    else:
        disparity = np.where(mask, 1.0 / np.where(mask, depth, 1.0), 0.0)
    if return_mask:
        return disparity, mask
    return disparity


def disparity2depth(disparity, **kwargs):
    return depth2disparity(disparity, **kwargs)
