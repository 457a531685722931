"""Natural-image-like inputs for int8 calibration, from a seed.

Counterpart of ``genpercept_tpu/utils/synthetic.py::natural_like_images``
(same recipe, numpy's generator in place of ``jax.random``): smooth
low-frequency gradients, one hard-edged rectangle per image and mild noise,
closer to natural-image statistics (spatially correlated, edge-bearing) than
uniform noise. The JAX package measured int8 fidelity on such images.
"""

from __future__ import annotations

import numpy as np


def natural_like_images(seed: int, batch: int, res: int) -> np.ndarray:
    """(batch, res, res, 3) float32 in [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, res), np.linspace(0, 1, res), indexing="ij")
    ang = rng.uniform(0, 2 * np.pi, (batch, 1, 1, 3))
    phase = rng.uniform(0, 1, (batch, 1, 1, 3))
    base = 0.5 + 0.4 * np.sin(2 * np.pi * (np.cos(ang) * yy[None, :, :, None]
                                           + np.sin(ang) * xx[None, :, :, None] + phase))
    c = rng.uniform(size=(batch, 4))
    y0, x0 = c[:, 0] * 0.6, c[:, 1] * 0.6
    y1, x1 = y0 + 0.2 + 0.2 * c[:, 2], x0 + 0.2 + 0.2 * c[:, 3]
    inside = ((yy[None] >= y0[:, None, None]) & (yy[None] <= y1[:, None, None])
              & (xx[None] >= x0[:, None, None]) & (xx[None] <= x1[:, None, None]))
    img = np.where(inside[..., None], 1.0 - base, base)
    img = img + 0.02 * rng.standard_normal((batch, res, res, 3))
    return np.clip(img, 0.0, 1.0).astype(np.float32)
