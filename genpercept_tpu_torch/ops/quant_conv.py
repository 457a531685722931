"""W8A8 conv3x3 with the input quantized in the kernel: the Hopper kernel K7
and its plain version.

Counterpart of ``genpercept_tpu/ops/quant_conv.py``. The kernel
(``csrc/quantized_conv3x3.cu``) replaces the TPU kernel ``_kernel``: it
quantizes the input tile per channel while staging it (symmetric,
clip(round(x * inv_a), -127, 127), round half to even), accumulates the nine
shifted-window int8 products in int32 and writes acc * o_scale + bias, cast
once to x's dtype. No code tensor, im2col or int32 product reaches device
memory. The plain version is ``quant.qconv_apply`` on the symmetric 3x3
stride-1 pad-1 ``QConv`` with the same operands; kernel and plain version
are bit-identical.

As in the TPU package, nothing routes to it: the int8 pipeline runs its
convolutions through ``quant.qconv_apply`` (the production default is
asymmetric, which this kernel does not take). Its one caller is
``scripts/profile_quant_conv_torch.py``. Inference only: on the card the
wrapper raises when an input requires grad under grad mode.
"""

from __future__ import annotations

import torch

from genpercept_tpu_torch import _build
from genpercept_tpu_torch.ops import _dispatch
from genpercept_tpu_torch.ops.fused_conv import _refuse_grad
from genpercept_tpu_torch.ops.fused_ff import _bias_f32
from genpercept_tpu_torch.ops.quant import QConv, qconv_apply

_TH = 8  # the TPU kernel's stripe height; only ``supported`` reads it


def supported(x_shape, co: int, kind: str = "3x3", stride=1) -> bool:
    """The TPU package's predicate, read from an NCHW shape: stride-1 3x3,
    channels multiples of 128, height a multiple of 8 and >= 16, width a
    multiple of 8. The kernel itself takes any multiple of 64 channels."""
    n, c, h, w = x_shape
    return (kind == "3x3" and stride in (1, (1, 1)) and h % _TH == 0 and h >= 2 * _TH
            and c % 128 == 0 and co % 128 == 0 and w % 8 == 0)


def _quantized_conv3x3_ref(x: torch.Tensor, w_int8: torch.Tensor, inv_a: torch.Tensor,
                           o_scale: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """Plain version: qconv_apply on the symmetric 3x3 stride-1 pad-1 QConv."""
    q = QConv(w_int8, inv_a.float(), o_scale.float(), None if bias is None else bias.float(),
              "3x3", (1, 1), ((1, 1), (1, 1)))
    return qconv_apply(q, x)


def quantized_conv3x3(x: torch.Tensor, w_int8: torch.Tensor, inv_a: torch.Tensor,
                      o_scale: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """K7. x: (N, C, H, W) f32/bf16; w_int8: (Co, C, 3, 3) int8 (the port's
    QConv layout); inv_a: (C,) f32 = 127/a; o_scale, bias: (Co,) f32 ->
    (N, Co, H, W) in x's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if not _dispatch.use_kernel(x):
        return _quantized_conv3x3_ref(x, w_int8, inv_a, o_scale, bias)
    _refuse_grad("quantized_conv3x3", x)
    n, c, h, w = x.shape
    co = w_int8.shape[0]
    code = _dispatch.dtype_code(x, "quantized_conv3x3")
    if (w_int8.shape != (co, c, 3, 3) or w_int8.dtype != torch.int8 or c % 64 or co % 64
            or n > 65535 or any(t.device != x.device for t in (w_int8, inv_a, o_scale))):
        raise ValueError(f"quantized_conv3x3: no kernel for x {tuple(x.shape)}, "
                         f"w {tuple(w_int8.shape)} {w_int8.dtype}")
    wt = w_int8.permute(0, 2, 3, 1).contiguous()  # (Co, 3, 3, C)
    xc = x.contiguous()
    ia, osc = inv_a.float().contiguous(), o_scale.float().contiguous()
    b = _bias_f32(bias, co, x.device)
    out = torch.empty((n, co, h, w), dtype=x.dtype, device=x.device)
    err = _build.load().quantized_conv3x3(
        xc.data_ptr(), ia.data_ptr(), wt.data_ptr(), osc.data_ptr(), b.data_ptr(),
        out.data_ptr(), n, c, co, h, w, code, _dispatch.stream_handle(x))
    _build.check(err, "quantized_conv3x3")
    quantized_conv3x3.launches += 1
    return out


quantized_conv3x3.launches = 0
