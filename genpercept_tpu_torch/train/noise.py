"""Multi-resolution (pyramid) noise for marigold-style training.

Counterpart of ``genpercept_tpu/train/noise.py`` on NCHW tensors: a sum of
bilinear-upsampled gaussians at progressively coarser resolutions, weighted
strength^i, then rescaled to unit (population) variance. The ``original``
and ``random_step`` strategies pick one of ``N_RATIO_BINS`` downscale
ratios, 2 + 2 (j + 0.5) / 8, as the JAX package quantizes the reference's
continuous ratio in [2, 4).

Split in two: ``multi_res_noise_draw`` takes every random number from a
``torch.Generator`` (the full-size gaussian, the ratio's index, one gaussian
per pyramid level) and ``multi_res_noise_core`` sums them. A test can hand
the core another generator's draws.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

N_RATIO_BINS = 8
RATIOS = tuple(2.0 + 2.0 * (j + 0.5) / N_RATIO_BINS for j in range(N_RATIO_BINS))
STRATEGIES = ("original", "random_step", "every_layer", "power_of_two")


def pyramid_sizes(h: int, w: int, strategy: str, ratio_index: int = 0) -> List[Tuple[int, int]]:
    """The (h, w) of each pyramid level, in the order they are drawn."""
    sizes = []
    if strategy in ("original", "random_step"):
        ratio = RATIOS[ratio_index]
        ch, cw = h, w
        for i in range(10):
            if strategy == "original":
                ch, cw = max(1, int(h / (ratio ** i))), max(1, int(w / (ratio ** i)))
            else:  # repeated division by the same ratio
                ch, cw = max(1, int(ch / ratio)), max(1, int(cw / ratio))
            sizes.append((ch, cw))
            if ch == 1 or cw == 1:
                break
    elif strategy == "every_layer":
        ch, cw = h, w
        for _ in range(int(math.log2(min(h, w)))):
            ch, cw = max(1, ch // 2), max(1, cw // 2)
            sizes.append((ch, cw))
    elif strategy == "power_of_two":
        for i in range(10):
            ch, cw = max(1, int(h / 2 ** i)), max(1, int(w / 2 ** i))
            sizes.append((ch, cw))
            if ch == 1 or cw == 1:
                break
    else:
        raise ValueError(f"unknown downscale strategy: {strategy}")
    return sizes


def multi_res_noise_draw(generator: Optional[torch.Generator], shape, strategy: str,
                         dtype=torch.float32, device=None):
    """-> (noise (B, C, H, W), ratio index or None, [gaussian per level]),
    drawn in ``dtype`` from ``generator`` (on its device), then moved to
    ``device``."""
    b, c, h, w = shape
    gdev = generator.device if generator is not None else None

    def randn(*s):
        return torch.randn(s, generator=generator, dtype=dtype, device=gdev).to(device)

    noise = randn(b, c, h, w)
    idx = None
    if strategy in ("original", "random_step"):
        idx = int(torch.randint(0, N_RATIO_BINS, (), generator=generator, device=gdev))
    levels = [randn(b, c, ch, cw) for ch, cw in pyramid_sizes(h, w, strategy, idx or 0)]
    return noise, idx, levels


def upsample_bilinear(x: torch.Tensor, hw) -> torch.Tensor:
    """Half-pixel bilinear upsampling with clamped edges: what
    ``jax.image.resize(..., "linear")`` computes when no axis shrinks."""
    if tuple(x.shape[2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False,
                         antialias=False)


def multi_res_noise_core(noise: torch.Tensor, levels: List[torch.Tensor],
                         strength: Union[float, torch.Tensor], strategy: str) -> torch.Tensor:
    """noise + sum_i up(level_i) * strength^i, divided by its population std
    (reduced in f32, rounded to the noise's dtype). ``strength`` is a float
    or a per-sample (B, 1, 1, 1) tensor (annealed), which, as in JAX,
    promotes a bf16 sum to f32. The ``original``/``random_step`` levels are
    summed apart and added once, the others added to the noise one by one,
    in the JAX package's order."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown downscale strategy: {strategy}")
    hw = noise.shape[2:]
    if strategy in ("original", "random_step"):
        acc = torch.zeros_like(noise)
        for i, g in enumerate(levels):
            acc = acc + upsample_bilinear(g, hw) * (strength ** i)
        noise = noise + acc
    else:
        for i, g in enumerate(levels):
            noise = noise + upsample_bilinear(g, hw) * (strength ** i)
    std = noise.float().std(correction=0).to(noise.dtype)
    return noise / std


def multi_res_noise_like(generator: Optional[torch.Generator], shape,
                         strength: Union[float, torch.Tensor] = 0.9,
                         downscale_strategy: str = "original", dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """Pyramid noise of NCHW ``shape``: the draw, then the core."""
    if isinstance(strength, torch.Tensor) and strength.ndim > 0:
        strength = strength.reshape(-1, 1, 1, 1)
    noise, _, levels = multi_res_noise_draw(generator, shape, downscale_strategy, dtype, device)
    return multi_res_noise_core(noise, levels, strength, downscale_strategy)
