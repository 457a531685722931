"""Image resize with the TPU package's semantics, NHWC layout.

``resize`` reproduces ``jax.image.resize`` as ``genpercept_tpu/ops/resize.py``
calls it: each resized axis is one matrix of separable kernel weights
(triangle for bilinear, Keys cubic for bicubic), the kernel widened by the
downscale factor when antialiasing, columns normalised to sum to one, and
samples outside the input zeroed. ``nearest-exact`` and align-corners
bilinear are index formulas.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


_KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic}


def _weight_mat(n_in: int, n_out: int, kernel, antialias: bool,
                device) -> torch.Tensor:
    """(n_in, n_out) float32 resampling weights, as jax.image computes them."""
    scale = n_out / n_in
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample_f = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * inv_scale - 0.5
    x = (sample_f[None, :]
         - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]).abs() \
        / kernel_scale
    w = kernel(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize(x: torch.Tensor, out_hw: Tuple[int, int], method: str = "bilinear",
           antialias: bool = True) -> torch.Tensor:
    """x: (N, H, W, C) -> (N, out_h, out_w, C)."""
    n, h, w, c = x.shape
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    if method in ("nearest", "nearest_exact", "nearest-exact"):
        return _nearest_exact(x, (oh, ow))
    kernel = _KERNELS[method]
    out = x.float()
    if h != oh:
        wy = _weight_mat(h, oh, kernel, antialias, x.device)
        out = torch.einsum("nhwc,ho->nowc", out, wy)
    if w != ow:
        wx = _weight_mat(w, ow, kernel, antialias, x.device)
        out = torch.einsum("nhwc,wo->nhoc", out, wx)
    return out.to(x.dtype)


def _nearest_exact(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """torch 'nearest-exact': src index = floor((i + 0.5) * in/out)."""
    h, w = x.shape[1], x.shape[2]
    oh, ow = out_hw
    ys = torch.floor((torch.arange(oh, dtype=torch.float32, device=x.device) + 0.5)
                     * (h / oh)).long().clamp(0, h - 1)
    xs = torch.floor((torch.arange(ow, dtype=torch.float32, device=x.device) + 0.5)
                     * (w / ow)).long().clamp(0, w - 1)
    return x[:, ys][:, :, xs]


def resize_bilinear_align_corners(x: torch.Tensor,
                                  out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with align_corners=True: src = i * (in-1)/(out-1)."""
    h, w = x.shape[1], x.shape[2]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x

    def lerp(n_in, n_out):
        if n_out == 1 or n_in == 1:
            idx = torch.zeros(n_out, dtype=torch.long, device=x.device)
            return idx, idx, torch.zeros(n_out, dtype=torch.float32, device=x.device)
        src = torch.arange(n_out, dtype=torch.float32, device=x.device) \
            * ((n_in - 1) / (n_out - 1))
        lo = torch.floor(src).long().clamp(0, n_in - 1)
        hi = torch.clamp(lo + 1, max=n_in - 1)
        return lo, hi, src - lo

    xf = x.float()
    ylo, yhi, yf = lerp(h, oh)
    xlo, xhi, xw = lerp(w, ow)
    top, bot = xf[:, ylo], xf[:, yhi]
    rows = top + (bot - top) * yf[None, :, None, None]
    left, right = rows[:, :, xlo], rows[:, :, xhi]
    return (left + (right - left) * xw[None, None, :, None]).to(x.dtype)


def max_res_shape(h: int, w: int, max_edge: int) -> Tuple[int, int]:
    """Long-side resize target, aspect preserving, floored like torchvision."""
    scale = max_edge / max(h, w)
    return max(int(h * scale), 1), max(int(w * scale), 1)
