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

A second kernel, K5 ``csrc/fused_geglu_ff_int8.cu``, runs the W8A8 feed-forward
of int8 inference (``fused_geglu_ff_int8``, section below).

``fused_geglu_ff`` is differentiable, as the JAX package's ``custom_vjp``:
the forward is the kernel and saves only the inputs; the backward recomputes
the plain composition (``_geglu_ff_composition``, the rounding points of
JAX's ``_xla_geglu_ff``) and takes its vector-Jacobian product. The TPU has
no backward kernel here, so none is ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from genpercept_tpu_torch import _build
from genpercept_tpu_torch.ops import _dispatch

_ROW_BLK = 512  # the TPU kernel's row block; only ``supported`` reads it
_KERNEL_C = 320  # the width the routing predicate takes
# widths with a kernel body, by dtype: the pipeline routes C=320 only; the
# profiling scripts also run the bf16 kernel at the UNet's C=640 and 1280
_BODY_C = {torch.float32: (320,), torch.bfloat16: (320, 640, 1280)}

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


def _fused_geglu_ff_fwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor | None,
                        w2: torch.Tensor, b2: torch.Tensor | None) -> torch.Tensor:
    """K2. x: (B, S, C) -> (B, S, C); C=320 in f32 or bf16, C=640 or 1280
    in bf16. Ragged row counts are masked in the kernel.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if not _dispatch.use_kernel(x):
        return _fused_geglu_ff_ref(x, w1, b1, w2, b2)
    bsz, s, c = x.shape
    inner = w1.shape[0] // 2
    code = _dispatch.dtype_code(x, "fused_geglu_ff")
    if c not in _BODY_C[x.dtype] or inner % 64 or w1.shape != (2 * inner, c) \
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
    rows = bsz * s
    # the bf16 bodies' counters and f32 partial sums (the wide body's
    # every block, C=320's split ones)
    nbytes = lib.fused_geglu_ff_scratch_bytes(rows, c, inner, code)
    scratch = torch.empty(nbytes // 4, dtype=torch.float32, device=x.device) if nbytes else None
    err = lib.fused_geglu_ff_fwd(
        x2.data_ptr(), w1c.data_ptr(), b1f.data_ptr(), w2c.data_ptr(),
        b2f.data_ptr(), y.data_ptr(), None if scratch is None else scratch.data_ptr(),
        rows, c, inner, code, _dispatch.stream_handle(x))
    _build.check(err, "fused_geglu_ff_fwd")
    _fused_geglu_ff_fwd.launches += 1
    return y.reshape(bsz, s, c)


_fused_geglu_ff_fwd.launches = 0


def _geglu_ff_composition(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor | None,
                          w2: torch.Tensor, b2: torch.Tensor | None) -> torch.Tensor:
    """The unfused feed-forward in x's dtype (JAX ``_xla_geglu_ff``): hidden
    and gate projections, exact-erf GELU and product, down-projection."""
    dt = x.dtype
    inner = w1.shape[0] // 2

    def proj(w, b):
        out = torch.matmul(x, w.to(dt).t())
        return out if b is None else out + b.to(dt)

    h = proj(w1[:inner], None if b1 is None else b1[:inner])
    g = proj(w1[inner:], None if b1 is None else b1[inner:])
    out = torch.matmul(h * F.gelu(g), w2.to(dt).t())
    return out if b2 is None else out + b2.to(dt)


class FusedGegluFF(torch.autograd.Function):
    """K2 forward; backward = the VJP of ``_geglu_ff_composition``,
    recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return _fused_geglu_ff_fwd(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(saved, ctx.needs_input_grad)]
            out = _geglu_ff_composition(*inputs)
        wanted = [t for t in inputs if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g))
        return tuple(next(grads) if t is not None and t.requires_grad else None
                     for t in inputs)


def fused_geglu_ff(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor | None,
                   w2: torch.Tensor, b2: torch.Tensor | None) -> torch.Tensor:
    """x: (B, S, C) -> (B, S, C). Differentiable: K2 forward, plain backward."""
    return FusedGegluFF.apply(x, w1, b1, w2, b2)


# ------------------------------------------------------- int8 (W8A8) path
#
# K5 ``csrc/fused_geglu_ff_int8.cu`` replaces the TPU kernel _kernel_int8
# (reached through fused_geglu_ff_int8): per row, quantize x (shifted by
# zp) with the hidden half's scales, two int8 products against W_h and W_g,
# int32 -> f32 * o_scale + bias, h and g rounded to x's dtype, the GEGLU
# product with XLA's erf rounded to x's dtype, a quantized with the
# down-projection's zp and scales, an int8 product against W2, the
# epilogue. Every f32 step is one rounded operation, in both versions.


def supported_int8(b: int, s: int, c: int) -> bool:
    """The TPU package's routing predicate for the int8 kernel: C=320 with
    rows a multiple of 512, C=640 with rows a multiple of 256."""
    if c == 320:
        return (b * s) % 512 == 0
    if c == 640:
        return (b * s) % 256 == 0
    return False


def _fused_geglu_ff_int8_ref(x2: torch.Tensor, qh, qg, q2) -> torch.Tensor:
    """Plain version of K5 on (rows, C); int32 products on torch._int_mm."""
    from genpercept_tpu_torch.ops.quant import int8_matmul, quantize_activation

    dt = x2.dtype

    def epilogue(acc, q):
        y = acc.float() * q.o_scale
        return y if q.bias is None else y + q.bias

    xq = quantize_activation(x2, qh.inv_a, qh.zp)
    h = epilogue(int8_matmul(xq, qh.w_int8), qh).to(dt).float()
    g = epilogue(int8_matmul(xq, qg.w_int8), qg).to(dt).float()
    a = (h * (0.5 * g * (1.0 + _erf_f32(g * 2.0 ** -0.5)))).to(dt).float()
    aq = quantize_activation(a, q2.inv_a, q2.zp)
    return epilogue(int8_matmul(aq, q2.w_int8), q2).to(dt)


def _vec(v: torch.Tensor | None, n: int, device) -> torch.Tensor:
    if v is None:
        return torch.zeros(n, dtype=torch.float32, device=device)
    return _aligned(v.float().contiguous())


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data does not start on 16 bytes (the
    kernel reads x and the vectors by 16-byte loads and bulk copies, the
    weights by TMA)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def fused_geglu_ff_int8(x: torch.Tensor, qh, qg, q2) -> torch.Tensor:
    """K5. x: (B, S, C); qh/qg: QDense of the GEGLU hidden/gate halves
    (w_int8 (inner, C)), q2: QDense of the down-projection (w_int8
    (C, inner)) -> (B, S, C) in x's dtype. Inference only. qg shares qh's
    input scales (both were calibrated on the same x), as in the TPU kernel.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    bsz, s, c = x.shape
    rows = bsz * s
    x2 = x.reshape(rows, c)
    if not _dispatch.use_kernel(x):
        return _fused_geglu_ff_int8_ref(x2, qh, qg, q2).reshape(bsz, s, c)
    code = _dispatch.dtype_code(x, "fused_geglu_ff_int8")
    inner = qh.w_int8.shape[0]
    if (c not in (320, 640) or inner % 128 or qh.w_int8.shape != (inner, c)
            or qg.w_int8.shape != (inner, c) or q2.w_int8.shape != (c, inner)
            or any(q.w_int8.dtype != torch.int8 or q.w_int8.device != x.device
                   for q in (qh, qg, q2))):
        raise ValueError(f"fused_geglu_ff_int8: no kernel for x {tuple(x.shape)}, "
                         f"w_h {tuple(qh.w_int8.shape)}, w2 {tuple(q2.w_int8.shape)}")
    dev = x.device
    x2 = _aligned(x2.contiguous())
    ws = [_aligned(q.w_int8.contiguous()) for q in (qh, qg, q2)]
    vecs = [_vec(qh.inv_a, c, dev), _vec(qh.zp, c, dev),
            _vec(qh.o_scale, inner, dev), _vec(qh.bias, inner, dev),
            _vec(qg.o_scale, inner, dev), _vec(qg.bias, inner, dev),
            _vec(q2.inv_a, inner, dev), _vec(q2.zp, inner, dev),
            _vec(q2.o_scale, c, dev), _vec(q2.bias, c, dev)]
    y = torch.empty_like(x2)
    lib = _build.load()
    # the int32 partial sums of the row blocks the kernel's walk splits
    nbytes = lib.fused_geglu_ff_int8_scratch_bytes(rows, c, inner)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev) if nbytes else None
    err = lib.fused_geglu_ff_int8(
        x2.data_ptr(), *(w.data_ptr() for w in ws), *(v.data_ptr() for v in vecs),
        y.data_ptr(), None if scratch is None else scratch.data_ptr(), rows, c, inner, code,
        _dispatch.stream_handle(x))
    _build.check(err, "fused_geglu_ff_int8")
    fused_geglu_ff_int8.launches += 1
    return y.reshape(bsz, s, c)


fused_geglu_ff_int8.launches = 0
