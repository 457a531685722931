"""Fused GEGLU feed-forward: the Hopper kernel and its plain version.

Counterpart of ``genpercept_tpu/ops/fused_ff.py``. The kernel
(``csrc/fused_geglu_ff_fwd.cu``) replaces the TPU kernel ``_kernel``: one
pass takes a block of rows through proj -> GEGLU -> down-projection and the
(rows, 4C) hidden and gate tensors never reach device memory. Rounding points
are the TPU kernel's: hidden and gate rounded to x's dtype after the f32
accumulate and bias, the GEGLU product in f32 with XLA's rational erf,
rounded again, then the down-projection accumulated in f32.

Weights are in PyTorch's Linear layouts: w1 (2*inner, C) holding the hidden
rows then the gate rows, w2 (C, inner).
"""

from __future__ import annotations

import torch

from genpercept_tpu_torch import _build
from genpercept_tpu_torch.ops import _dispatch

_ROW_BLK = 512  # the TPU kernel's row block; only ``supported`` reads it
_KERNEL_C = 320

_ERF_ALPHA = (0.00022905065861350646, 0.0034082910107109506,
              0.050955695062380861, 0.18520832239976145, 1.128379143519084)
_ERF_BETA = (-1.1791602954361697e-7, 2.3547966471313185e-5,
             0.0010179625278914885, 0.014070470171167667, 0.11098505178285362,
             0.49746925110067538, 1.0)


def _erf_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 erf (clamped rational approximation in x^2), as the TPU
    kernel computes it."""
    x = x.clamp(-3.832506856900711, 3.832506856900711)
    x2 = x * x

    def horner(coeffs):
        acc = torch.full_like(x2, coeffs[0])
        for c in coeffs[1:]:
            acc = acc * x2 + c
        return acc

    return x * horner(_ERF_ALPHA) / horner(_ERF_BETA)


def supported(b: int, s: int, c: int) -> bool:
    """The TPU package's routing predicate: C == 320, rows a multiple of 512."""
    return c == _KERNEL_C and (b * s) % _ROW_BLK == 0


def _bias_f32(b: torch.Tensor | None, n: int, device) -> torch.Tensor:
    if b is None:
        return torch.zeros(n, dtype=torch.float32, device=device)
    return b.float().contiguous()


def _fused_geglu_ff_ref(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor | None,
                        w2: torch.Tensor, b2: torch.Tensor | None) -> torch.Tensor:
    """Plain version with the kernel's rounding points. x: (..., C)."""
    dt = x.dtype
    inner = w1.shape[0] // 2
    c = x.shape[-1]
    b1f = _bias_f32(b1, 2 * inner, x.device)
    b2f = _bias_f32(b2, c, x.device)
    xf = x.float()
    w1f = w1.to(dt).float()
    h = (torch.matmul(xf, w1f[:inner].t()) + b1f[:inner]).to(dt).float()
    g = (torch.matmul(xf, w1f[inner:].t()) + b1f[inner:]).to(dt).float()
    a = (h * (0.5 * g * (1.0 + _erf_f32(g * 2.0 ** -0.5)))).to(dt).float()
    return (torch.matmul(a, w2.to(dt).float().t()) + b2f).to(dt)


def fused_geglu_ff(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor | None,
                   w2: torch.Tensor, b2: torch.Tensor | None) -> torch.Tensor:
    """x: (B, S, C) -> (B, S, C). Forward only.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if not _dispatch.use_kernel(x):
        return _fused_geglu_ff_ref(x, w1, b1, w2, b2)
    bsz, s, c = x.shape
    inner = w1.shape[0] // 2
    code = _dispatch.dtype_code(x, "fused_geglu_ff")
    if c != _KERNEL_C or inner % 64 or w1.shape != (2 * inner, c) \
            or w2.shape != (c, inner):
        raise ValueError(
            f"fused_geglu_ff: no kernel for x {tuple(x.shape)}, "
            f"w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    x2 = x.reshape(bsz * s, c).contiguous()
    w1c = w1.to(x.dtype).contiguous()
    w2c = w2.to(x.dtype).contiguous()
    b1f = _bias_f32(b1, 2 * inner, x.device)
    b2f = _bias_f32(b2, c, x.device)
    y = torch.empty_like(x2)
    lib = _build.load()
    err = lib.fused_geglu_ff_fwd(
        x2.data_ptr(), w1c.data_ptr(), b1f.data_ptr(), w2c.data_ptr(),
        b2f.data_ptr(), y.data_ptr(), bsz * s, c, inner, code,
        _dispatch.stream_handle(x))
    _build.check(err, "fused_geglu_ff_fwd")
    fused_geglu_ff.launches += 1
    return y.reshape(bsz, s, c)


fused_geglu_ff.launches = 0
