"""Label normalizers and training preprocess transforms (host-side numpy).

Rebuilds `src/util/depth_transform.py` (quantile scale/shift depth and
disparity normalizers) and the per-task `_training_preprocess` rules of
`src/dataset/base_dataset.py:432-523` as pure numpy — these run in data
workers, feeding already-normalized arrays to the device.

A copy of ``genpercept_tpu/data/transforms.py``, which imports no jax.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def _quantile_min_max(depth: np.ndarray, valid: np.ndarray, q: float):
    vals = depth[valid]
    if vals.size == 0:
        return float(depth.min()), float(depth.max())
    # torch.quantile uses linear interpolation, like np.quantile default
    lo, hi = np.quantile(vals, [q, 1.0 - q])
    return float(lo), float(hi)


def scale_shift_depth_normalize(
    depth: np.ndarray,
    valid_mask: Optional[np.ndarray] = None,
    norm_min: float = -1.0,
    norm_max: float = 1.0,
    quantile: float = 0.02,
    clip: bool = True,
) -> np.ndarray:
    """ScaleShiftDepthNormalizer (depth_transform.py:70-127): 2%/98%
    quantiles of valid depths -> linear map to [norm_min, norm_max]."""
    if valid_mask is None:
        valid_mask = np.ones_like(depth, bool)
    valid_mask = valid_mask & (depth > 0)
    lo, hi = _quantile_min_max(depth, valid_mask, quantile)
    rng = norm_max - norm_min
    out = (depth - lo) / max(hi - lo, 1e-8) * rng + norm_min
    if clip:
        out = np.clip(out, norm_min, norm_max)
    return out.astype(np.float32)


def scale_shift_disparity_normalize(
    depth: np.ndarray,
    valid_mask: Optional[np.ndarray] = None,
    norm_min: float = -1.0,
    norm_max: float = 1.0,
    quantile: float = 0.02,
    clip: bool = True,
) -> np.ndarray:
    """ScaleShiftDisparityNormalizer (depth_transform.py:130-193): same
    quantile window but applied in 1/d space; invalid pixels to norm_min."""
    if valid_mask is None:
        valid_mask = np.ones_like(depth, bool)
    valid_mask = valid_mask & (depth > 0)
    lo, hi = _quantile_min_max(depth, valid_mask, quantile)
    # reference (depth_transform.py:168-177): disp = 1/depth with invalid
    # pixels at depth 0 -> +inf, so they are EXCLUDED from the min taken
    # next (inf never wins a min); using 0 or any finite placeholder there
    # shifts the renormalization window (caught by the reference-module
    # oracle, tests/test_reference_oracle.py)
    with np.errstate(divide="ignore", invalid="ignore"):
        disp = np.where(valid_mask, 1.0 / np.maximum(depth, 1e-12), np.inf)
    disp_min, disp_max = 1.0 / max(hi, 1e-12), 1.0 / max(lo, 1e-12)
    out = (disp - disp_min) / max(disp_max - disp_min, 1e-12)
    mn = out.min()  # min over valid pixels (invalid are +inf)
    out = np.where(valid_mask, out, mn)
    rng = norm_max - norm_min
    out = (out - mn) / max(out.max() - mn, 1e-12) * rng + norm_min
    out = np.where(valid_mask, out, norm_min)
    if clip:
        out = np.clip(out, norm_min, norm_max)
    return out.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class DepthNormalizer:
    """Config-driven normalizer (get_depth_normalizer,
    depth_transform.py:21-45)."""

    kind: str = "scale_shift_depth"  # or scale_shift_disparity
    norm_min: float = -1.0
    norm_max: float = 1.0
    min_max_quantile: float = 0.02
    clip: bool = True
    # far_plane_at_max/is_absolute flags (class attrs in the reference)
    far_plane_at_max: bool = True
    is_absolute: bool = False

    def __call__(self, depth, valid_mask=None):
        fn = {
            "scale_shift_depth": scale_shift_depth_normalize,
            "scale_shift_disparity": scale_shift_disparity_normalize,
        }[self.kind]
        return fn(depth, valid_mask, self.norm_min, self.norm_max,
                  self.min_max_quantile, self.clip)

    def scale_back(self, norm):
        return (norm - self.norm_min) / (self.norm_max - self.norm_min)

    def denormalize(self, norm, **kwargs):
        return self.scale_back(norm)


def get_depth_normalizer(cfg_normalizer) -> DepthNormalizer:
    """cfg with .type in {scale_shift_depth, scale_shift_disparity} and
    norm_min/norm_max/min_max_quantile/clip fields (config-yaml driven)."""
    if cfg_normalizer is None:
        return DepthNormalizer(kind="scale_shift_depth")
    kind = {
        "scale_shift_depth": "scale_shift_depth",
        "scale_shift_disparity": "scale_shift_disparity",
    }[getattr(cfg_normalizer, "type", cfg_normalizer.get("type"))]

    def g(name, default):
        if hasattr(cfg_normalizer, name):
            return getattr(cfg_normalizer, name)
        return cfg_normalizer.get(name, default)

    return DepthNormalizer(
        kind=kind,
        norm_min=g("norm_min", -1.0),
        norm_max=g("norm_max", 1.0),
        min_max_quantile=g("min_max_quantile", 0.02),
        clip=g("clip", True),
    )


# ------------------------------------------------- per-task preprocess rules

def normalize_normals(normals: np.ndarray) -> np.ndarray:
    """L2-normalize surface normals (base_dataset.py:452-460)."""
    norm = np.linalg.norm(normals, axis=-1, keepdims=True)
    return (normals / np.maximum(norm, 1e-8)).astype(np.float32)


def min_max_to_pm1(x: np.ndarray) -> np.ndarray:
    """Per-image min-max -> [-1, 1] for matting/dis/seg GT
    (base_dataset.py:463-484)."""
    lo, hi = float(x.min()), float(x.max())
    return ((x - lo) / max(hi - lo, 1e-8) * 2.0 - 1.0).astype(np.float32)


def fill_invalid_with_far_plane(
    gt: np.ndarray, valid_mask: np.ndarray, far_value: float = 1.0
) -> np.ndarray:
    """Set invalid pixels to the far plane (base_dataset.py:487-495)."""
    return np.where(valid_mask, gt, far_value).astype(np.float32)


def horizontal_flip(rgb, gt, valid_mask, mode: str):
    """LR-flip augmentation; surface normals negate the x component
    (base_dataset.py:515-523)."""
    rgb = rgb[:, ::-1].copy()
    gt = gt[:, ::-1].copy()
    valid_mask = valid_mask[:, ::-1].copy()
    if mode == "normal":
        gt = gt.copy()
        gt[..., 0] = -gt[..., 0]
    return rgb, gt, valid_mask
