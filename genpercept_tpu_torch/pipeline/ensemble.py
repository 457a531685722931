"""Test-time ensembling of affine-invariant predictions on PyTorch.

Counterpart of ``genpercept_tpu/pipeline/ensemble.py``: the members are
aligned to their composite by a fixed number of closed-form least-squares
rounds on the predictions' device,

  repeat K times:
    composite <- median over members of (s_i * d_i + t_i)
    (s_i, t_i) <- least-squares alignment of d_i to the composite
  reduce by median (or mean), then min-max to [0, 1],

with a per-pixel median-absolute-deviation uncertainty.

The median is NumPy's (and ``jnp.median``'s): the midpoint of the two
middle members when their count is even. ``torch.median`` returns the lower
one, so it is taken from a sort along the member axis.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _median(x: torch.Tensor) -> torch.Tensor:
    """The median over dim 0, the two middle values' midpoint for even counts."""
    s = torch.sort(x, dim=0).values
    n = x.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def _lstsq_scale_shift(pred: torch.Tensor, target: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per member: argmin_{s,t} ||s*pred + t - target||^2 (2x2 normal
    equations); pred (E, H, W), target (H, W) -> s, t (E,)."""
    dims = (1, 2)
    a00 = (pred * pred).mean(dim=dims)
    a01 = pred.mean(dim=dims)
    b0 = (pred * target).mean(dim=dims)
    b1 = target.mean()
    det = a00 - a01 * a01
    s = (b0 - a01 * b1) / det.clamp(min=1e-12)
    return s, b1 - s * a01


def _init_scale_shift(preds: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each member's [min, max] mapped to [0, 1]."""
    lo = preds.amin(dim=(1, 2))
    hi = preds.amax(dim=(1, 2))
    s = 1.0 / (hi - lo).clamp(min=1e-6)
    return s, -s * lo


@torch.no_grad()
def ensemble_predictions(preds: torch.Tensor, reduction: str = "median", iters: int = 3,
                         scale_invariant: bool = True, shift_invariant: bool = True,
                         return_uncertainty: bool = False):
    """preds: (E, H, W) members -> (H, W) merged in [0, 1], in f32 on the
    members' device; with ``return_uncertainty`` also the per-pixel median
    absolute deviation of the aligned members, in merged-output units."""
    preds = preds.float()
    if scale_invariant or shift_invariant:
        def kept(s, t):
            return (s if scale_invariant else torch.ones_like(s),
                    t if shift_invariant else torch.zeros_like(t))

        s, t = kept(*_init_scale_shift(preds))
        for _ in range(iters):
            composite = _median(s[:, None, None] * preds + t[:, None, None])
            s, t = kept(*_lstsq_scale_shift(preds, composite))
        aligned = s[:, None, None] * preds + t[:, None, None]
    else:
        aligned = preds

    if reduction == "median":
        merged = _median(aligned)
    elif reduction == "mean":
        merged = aligned.mean(dim=0)
    else:
        raise ValueError(reduction)
    uncertainty = _median((aligned - merged[None]).abs())

    lo, hi = merged.min(), merged.max()
    span = (hi - lo).clamp(min=1e-6)
    merged = (merged - lo) / span
    if return_uncertainty:
        return merged, uncertainty / span
    return merged
