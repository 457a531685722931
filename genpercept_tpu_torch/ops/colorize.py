"""Depth colorization with the ColorBrewer 'Spectral' colormap (a 256-entry
LUT built by piecewise-linear interpolation of the 11 anchors, then a
gather and lerp on the tensor's device)."""

from __future__ import annotations

import numpy as np
import torch

# ColorBrewer Spectral-11 anchors (public domain data), low -> high.
_SPECTRAL_ANCHORS = np.array(
    [
        [158, 1, 66],
        [213, 62, 79],
        [244, 109, 67],
        [253, 174, 97],
        [254, 224, 139],
        [255, 255, 191],
        [230, 245, 152],
        [171, 221, 164],
        [102, 194, 165],
        [50, 136, 189],
        [94, 79, 162],
    ],
    dtype=np.float64,
) / 255.0


def _build_lut(n: int = 256) -> np.ndarray:
    xs = np.linspace(0.0, 1.0, len(_SPECTRAL_ANCHORS))
    ts = np.linspace(0.0, 1.0, n)
    lut = np.stack(
        [np.interp(ts, xs, _SPECTRAL_ANCHORS[:, c]) for c in range(3)], axis=-1
    )
    return lut.astype(np.float32)


SPECTRAL_LUT = _build_lut()


def colorize_depth(depth: torch.Tensor, vmin: float = 0.0, vmax: float = 1.0,
                   reverse: bool = False) -> torch.Tensor:
    """depth: (..., H, W) in [vmin, vmax] -> (..., H, W, 3) float32 in [0,1]."""
    lut = torch.as_tensor(SPECTRAL_LUT, device=depth.device)
    t = (depth.float() - vmin) / max(vmax - vmin, 1e-8)
    t = t.clamp(0.0, 1.0)
    if reverse:
        t = 1.0 - t
    pos = t * (lut.shape[0] - 1)
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=lut.shape[0] - 1)
    frac = (pos - lo)[..., None]
    return lut[lo] * (1.0 - frac) + lut[hi] * frac
