"""Sinusoidal timestep embeddings (diffusers' SD2.1 convention)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       max_period: float = 10000.0,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """timesteps: (B,) int or float -> (B, dim)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    freqs = torch.exp(exponent)
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb.to(dtype)
