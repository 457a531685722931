"""The 10 depth evaluation metrics and MetricTracker, in torch.

Counterpart of ``genpercept_tpu/eval/metrics.py``, with its reductions: a
per-image masked mean, then the mean over the batch; ``log10`` a masked mean
over the whole batch at once; ``silog_rmse`` clamped at 0 and multiplied by
100. Every function takes (B, H, W) tensors and an optional boolean mask and
computes on the inputs' device.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def _per_image_mean(value: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is not None:
        value = torch.where(mask, value, 0.0)
        n = mask.sum(dim=(-1, -2))
    else:
        n = value.shape[-1] * value.shape[-2]
    return value.sum(dim=(-1, -2)) / n


def _masked(d: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    return d if mask is None else torch.where(mask, d, 0.0)


def abs_relative_difference(pred, target, valid_mask=None):
    return _per_image_mean(torch.abs(pred - target) / target, valid_mask).mean()


def squared_relative_difference(pred, target, valid_mask=None):
    return _per_image_mean((pred - target) ** 2 / target, valid_mask).mean()


def rmse_linear(pred, target, valid_mask=None):
    return torch.sqrt(_per_image_mean((pred - target) ** 2, valid_mask)).mean()


def rmse_log(pred, target, valid_mask=None):
    d = _masked(torch.log(pred) - torch.log(target), valid_mask)
    return torch.sqrt(_per_image_mean(d**2, valid_mask)).mean()


def log10(pred, target, valid_mask=None):
    d = torch.abs(torch.log10(pred) - torch.log10(target))
    if valid_mask is not None:
        return torch.where(valid_mask, d, 0.0).sum() / valid_mask.sum()
    return d.mean()


def threshold_percentage(pred, target, thresh, valid_mask=None):
    ratio = torch.maximum(pred / target, target / pred)
    bit = (ratio < thresh).float()
    return _per_image_mean(bit, valid_mask).mean()


def delta1_acc(pred, target, valid_mask=None):
    return threshold_percentage(pred, target, 1.25, valid_mask)


def delta2_acc(pred, target, valid_mask=None):
    return threshold_percentage(pred, target, 1.25**2, valid_mask)


def delta3_acc(pred, target, valid_mask=None):
    return threshold_percentage(pred, target, 1.25**3, valid_mask)


def i_rmse(pred, target, valid_mask=None):
    d = _masked(1.0 / pred - 1.0 / target, valid_mask)
    return torch.sqrt(_per_image_mean(d**2, valid_mask)).mean()


def silog_rmse(pred, target, valid_mask=None):
    d = torch.log(pred) - torch.log(target)
    if valid_mask is not None:
        d = torch.where(valid_mask, d, 0.0)
        n = valid_mask.sum(dim=(-1, -2))
    else:
        n = target.shape[-1] * target.shape[-2]
    first = (d**2).sum(dim=(-1, -2)) / n
    second = d.sum(dim=(-1, -2)) ** 2 / (n**2)
    # first - second == Var[d] >= 0 mathematically; clamp f32 cancellation
    return torch.sqrt(torch.clamp((first - second).mean(), min=0.0)) * 100.0


METRIC_FUNCS = {
    "abs_relative_difference": abs_relative_difference,
    "squared_relative_difference": squared_relative_difference,
    "rmse_linear": rmse_linear,
    "rmse_log": rmse_log,
    "log10": log10,
    "delta1_acc": delta1_acc,
    "delta2_acc": delta2_acc,
    "delta3_acc": delta3_acc,
    "i_rmse": i_rmse,
    "silog_rmse": silog_rmse,
}


def compute_metrics(pred, target, valid_mask=None, names=None) -> Dict[str, torch.Tensor]:
    """The named metrics (all by default) as 0-dim tensors. pred/target:
    (B, H, W) or (H, W) metric depth."""
    if pred.ndim == 2:
        pred, target = pred[None], target[None]
        if valid_mask is not None:
            valid_mask = valid_mask[None]
    names = names or list(METRIC_FUNCS)
    return {n: METRIC_FUNCS[n](pred, target, valid_mask) for n in names}


class MetricTracker:
    """Streaming mean per key, each update weighted by its sample count."""

    def __init__(self, *keys: str):
        self._totals = {k: 0.0 for k in keys}
        self._counts = {k: 0 for k in keys}

    def reset(self):
        for k in self._totals:
            self._totals[k] = 0.0
            self._counts[k] = 0

    def update(self, key: str, value: float, n: int = 1):
        if key not in self._totals:
            self._totals[key] = 0.0
            self._counts[key] = 0
        self._totals[key] += float(value) * n
        self._counts[key] += n

    def avg(self, key: str) -> float:
        return self._totals[key] / max(self._counts[key], 1)

    def result(self) -> Dict[str, float]:
        return {k: self.avg(k) for k in self._totals}
