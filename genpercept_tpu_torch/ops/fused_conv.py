"""Fused GroupNorm -> SiLU -> conv3x3 (+ residual): the Hopper kernel K8 and
its plain version.

Counterpart of ``genpercept_tpu/ops/fused_conv.py``. The kernel
(``csrc/fused_gn_silu_conv3x3.cu``) replaces the TPU kernel ``_kernel``: the
normalize + SiLU is applied to the input tile while it is staged for an
implicit-GEMM 3x3 convolution, so the normalized tensor never reaches device
memory, and the resblock's skip-add rides along as an optional residual.
The GroupNorm statistics are plain torch ops in the wrapper (``gn_affine``),
as the TPU package leaves them to XLA, folded into per-(sample, channel) f32
coefficients a, b.

Rounding points are the TPU kernel's, not the unfused resblock's:
y = x*a + b and y*sigmoid(y) in f32, rounded to x's dtype; products
accumulated in f32; + bias and + residual in f32, then one cast to x's dtype.
The padding is zero after the transform.

Inference only, as in the TPU package (no VJP): on the card the wrapper
raises when an input requires grad under grad mode. Layouts are the port's:
x and residual NCHW, the weight OIHW.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from genpercept_tpu_torch import _build
from genpercept_tpu_torch.ops import _dispatch
from genpercept_tpu_torch.ops.fused_ff import _bias_f32

_TH = 8  # the TPU kernel's stripe height; only ``supported`` reads it


def supported(x_shape, co: int, temb=None) -> bool:
    """The TPU package's routing predicate, read from an NCHW shape."""
    n, c, h, w = x_shape
    return (temb is None and h % _TH == 0 and h >= 2 * _TH and c % 128 == 0
            and co % 128 == 0 and w % 8 == 0)


def gn_affine(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              groups: int = 32, eps: float = 1e-6):
    """GroupNorm over NCHW x folded into y = x*a + b: (a, b), each (N, C)
    f32. The TPU package's statistics: mean and mean of squares over (HW,
    C/G) in f32, the variance clamped at 0, rsqrt."""
    n, c = x.shape[:2]
    xf = x.float().reshape(n, groups, -1)
    mean_g = xf.mean(dim=-1)
    sq_g = xf.square().mean(dim=-1)
    var_g = torch.clamp(sq_g - mean_g * mean_g, min=0.0)
    rstd = torch.rsqrt(var_g + eps).repeat_interleave(c // groups, dim=1)
    mean = mean_g.repeat_interleave(c // groups, dim=1)
    a = scale.float()[None] * rstd
    b = bias.float()[None] - mean * a
    return a.contiguous(), b.contiguous()


@contextlib.contextmanager
def _f32_convs():
    """cuDNN convolutions in full f32 inside (PyTorch lets them take TF32 by
    default)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _fused_gn_silu_conv3x3_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                               conv_w: torch.Tensor, conv_b: torch.Tensor | None,
                               residual: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version with the kernel's rounding points; a, b from gn_affine."""
    dt = x.dtype
    y = x.float() * a[:, :, None, None] + b[:, :, None, None]
    h = (y * torch.sigmoid(y)).to(dt).float()
    with _f32_convs():
        acc = F.conv2d(h, conv_w.to(dt).float(), padding=1)
    acc = acc + _bias_f32(conv_b, conv_w.shape[0], x.device)[None, :, None, None]
    if residual is not None:
        acc = acc + residual.float()
    return acc.to(dt)


def _split_tf32_weights(conv_w: torch.Tensor) -> torch.Tensor:
    """(Co, C, 3, 3) -> (2, 9, Co, C) f32: the f32 body's weights, split once a
    call as the body splits its activated input (csrc/common.cuh split_tf32):
    hi = w rounded to tf32 (10 mantissa bits) to nearest with ties away from
    zero, by an add and a mask of the bits; lo = w - hi (exact in f32)
    truncated to tf32. Taps in row-major order, input channels contiguous."""
    co, c = conv_w.shape[:2]
    w = conv_w.float().permute(2, 3, 0, 1).reshape(9, co, c).contiguous()
    hi = ((w.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    lo = ((w - hi).view(torch.int32) & -0x2000).view(torch.float32)
    return torch.stack((hi, lo))


def _refuse_grad(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} is inference only (no backward, as in the TPU "
                           "package): call it under torch.no_grad()")


def fused_gn_silu_conv3x3(x: torch.Tensor, gn_scale: torch.Tensor, gn_bias: torch.Tensor,
                          conv_w: torch.Tensor, conv_b: torch.Tensor | None,
                          residual: torch.Tensor | None = None, groups: int = 32,
                          eps: float = 1e-6) -> torch.Tensor:
    """conv3x3(silu(group_norm(x)), padding 1) + bias (+ residual): the
    statistics (``gn_affine``), then K8 (``fused_conv_apply``).
    x: (N, C, H, W) f32/bf16; conv_w: (Co, C, 3, 3), cast to x's dtype;
    residual: (N, Co, H, W) in x's dtype -> (N, Co, H, W) in x's dtype."""
    a, b = gn_affine(x, gn_scale, gn_bias, groups, eps)
    return fused_conv_apply(x, a, b, conv_w, conv_b, residual)


def fused_conv_apply(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                     conv_w: torch.Tensor, conv_b: torch.Tensor | None,
                     residual: torch.Tensor | None = None) -> torch.Tensor:
    """K8 on x with the folded GroupNorm (a, b from gn_affine).

    CPU tensors take the plain version; CUDA tensors launch the kernel, and
    ``fused_gn_silu_conv3x3.launches`` counts the launches."""
    if not _dispatch.use_kernel(x):
        return _fused_gn_silu_conv3x3_ref(x, a, b, conv_w, conv_b, residual)
    _refuse_grad("fused_gn_silu_conv3x3", x, a, b, conv_w, conv_b, residual)
    n, c, h, w = x.shape
    co = conv_w.shape[0]
    code = _dispatch.dtype_code(x, "fused_gn_silu_conv3x3")
    if (conv_w.shape != (co, c, 3, 3) or c % 32 or co % 128 or w % 8 or n > 65535
            or a.shape != (n, c) or b.shape != (n, c)
            or any(t.device != x.device for t in (a, b, conv_w))
            or (residual is not None and (residual.shape != (n, co, h, w)
                                          or residual.dtype != x.dtype
                                          or residual.device != x.device))):
        raise ValueError(
            f"fused_gn_silu_conv3x3: no kernel for x {tuple(x.shape)} {x.dtype}, "
            f"w {tuple(conv_w.shape)}, residual "
            f"{None if residual is None else (tuple(residual.shape), residual.dtype)}")
    a, b = a.float().contiguous(), b.float().contiguous()
    # bf16 body: (Co, 3, 3, C), channels contiguous per tap; f32 body: the
    # weights split to tf32 hi and lo, (2, 9, Co, C)
    wt = (_split_tf32_weights(conv_w) if x.dtype == torch.float32
          else conv_w.to(x.dtype).permute(0, 2, 3, 1).contiguous())
    bias = _bias_f32(conv_b, co, x.device)
    xc = x.contiguous()
    res = None if residual is None else residual.contiguous()
    out = torch.empty((n, co, h, w), dtype=x.dtype, device=x.device)
    err = _build.load().fused_gn_silu_conv3x3(
        xc.data_ptr(), a.data_ptr(), b.data_ptr(), wt.data_ptr(), bias.data_ptr(),
        None if res is None else res.data_ptr(), out.data_ptr(), n, c, co, h, w, code,
        _dispatch.stream_handle(x))
    _build.check(err, "fused_gn_silu_conv3x3")
    fused_gn_silu_conv3x3.launches += 1
    return out


fused_gn_silu_conv3x3.launches = 0
