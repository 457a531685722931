"""Normalization ops with the TPU package's numerics (channels on axis 1).

group_norm keeps ``genpercept_tpu/ops/norms.py``'s choices: one-pass fp32
statistics (sum and sum of squares), the variance clamped at >= 0, and the
affine folded into one fp32 ``x*a + b``. SD2.1 uses eps 1e-6 in the VAE and
the transformer input norm, 1e-5 in the UNet resnets.
"""

from __future__ import annotations

import torch


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-5,
               native_apply: bool = False) -> torch.Tensor:
    """x: (N, C, ...) -> same shape and dtype; scale/bias: (C,).

    native_apply: the ``x*a + b`` apply in x's dtype instead of f32 (the
    statistics stay f32), as the JAX package's training decode path under
    remat does; a no-op for f32 inputs."""
    n, c = x.shape[:2]
    g = num_groups
    cg = c // g
    count = (x.numel() // (n * c)) * cg
    xf = x.float()
    reduce_dims = tuple(range(2, x.ndim))
    sum_g = xf.sum(dim=reduce_dims).reshape(n, g, cg).sum(dim=-1)
    sumsq_g = (xf * xf).sum(dim=reduce_dims).reshape(n, g, cg).sum(dim=-1)
    mean_g = sum_g / count
    # clamp: the one-pass E[x^2] - mean^2 can go slightly negative in fp32
    var_g = torch.clamp(sumsq_g / count - mean_g * mean_g, min=0.0)
    inv_c = torch.rsqrt(var_g + eps).repeat_interleave(cg, dim=1)  # (N, C)
    mean_c = mean_g.repeat_interleave(cg, dim=1)
    a = inv_c * scale.float()[None]
    b = bias.float()[None] - mean_c * a
    bshape = (n, c) + (1,) * (x.ndim - 2)
    if native_apply and x.dtype != torch.float32:
        return x * a.reshape(bshape).to(x.dtype) + b.reshape(bshape).to(x.dtype)
    return (xf * a.reshape(bshape) + b.reshape(bshape)).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, stats in fp32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)
