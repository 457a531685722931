"""Convolutions on NCHW activations with OIHW weights.

Counterparts of ``genpercept_tpu/ops/conv.py``. The weight is cast to the
input's dtype and the bias added after the convolution, in the output dtype,
as the TPU package does.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

Padding = Union[int, Tuple[Tuple[int, int], Tuple[int, int]]]


def _add_bias(out: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    if bias is None:
        return out
    return out + bias.to(out.dtype).reshape((1, -1) + (1,) * (out.ndim - 2))


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
           stride: int = 1, padding: Padding = 1) -> torch.Tensor:
    """x: (N, Ci, H, W), weight: (Co, Ci, kh, kw). ``padding`` is an int or
    explicit ((top, bottom), (left, right)), e.g. the VAE encoder's
    asymmetric ((0, 1), (0, 1))."""
    if not isinstance(padding, int):
        (top, bottom), (left, right) = padding
        if top == bottom and left == right:
            padding = (top, left)
        else:
            x = F.pad(x, (left, right, top, bottom))
            padding = 0
    out = F.conv2d(x, weight.to(x.dtype), None, stride=stride, padding=padding)
    return _add_bias(out, bias)


def nearest_up2_conv3x3(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor | None = None) -> torch.Tensor:
    """conv3x3(nearest_upsample_x2(x)), padding 1: the plain form of the TPU
    package's collapsed 4x4 lhs-dilated kernel. (N, Ci, H, W) -> (N, Co, 2H, 2W)."""
    up = F.interpolate(x, scale_factor=2, mode="nearest")
    return conv2d(up, weight, bias, stride=1, padding=1)


def conv1x1(x: torch.Tensor, weight: torch.Tensor,
            bias: torch.Tensor | None = None) -> torch.Tensor:
    """1x1 conv over channels; weight (Co, Ci, 1, 1) or (Co, Ci).
    Rank-4 x is NCHW; other ranks carry channels last."""
    w2 = weight.reshape(weight.shape[0], weight.shape[1])
    if x.ndim == 4:
        return conv2d(x, w2[:, :, None, None], bias, stride=1, padding=0)
    out = torch.matmul(x, w2.to(x.dtype).t())
    return out if bias is None else out + bias.to(out.dtype)
