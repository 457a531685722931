"""Flash attention (non-causal), forward and backward: the Hopper kernels and
their plain versions.

Counterpart of ``genpercept_tpu/ops/flash_attention.py``. Three kernels
replace the TPU's three, and in none do the (Sq x Sk) matrices reach device
memory:

- K1 ``csrc/flash_attn_fwd.cu`` (TPU ``_flash_kernel``), via ``_flash_bhsd``:
  the output and ``lse2``, the base-2 logsumexp of the scaled logits
  (``m*c + log2 l`` with ``c = scale*log2 e``), as the TPU kernel returns;
- K3 ``flash_attn_bwd_dq`` and K4 ``flash_attn_bwd_dkv`` in
  ``csrc/flash_attn_bwd.cu`` (TPU ``_flash_bwd_dq_kernel`` and
  ``_flash_bwd_dkv_kernel``), via ``_flash_bwd_bhsd``: dq, and dk with dv,
  from the saved ``lse2`` and ``dsum = rowsum(dO*O)``;
- K6 ``csrc/flash_attn_int8.cu`` (TPU ``_flash_int8_kernel``), via
  ``_flash_int8_codes``: the inference-only W8A8 attention (section below).

``flash_attention`` is differentiable: an autograd Function whose forward is
K1 and whose backward is K3 and K4, as the JAX package's ``custom_vjp``.

``supported`` and the block table behind it are the TPU package's, kept so
that the attention routing (``ops/attention.py``) takes the same decisions,
with one narrowing: the kernel is built for the head dims SD2.1 runs (64 in
the UNet, 512 in the VAE mid block), where the TPU package also took 128
and 256. The CUDA kernel tiles on its own and handles ragged lengths by
masking.
"""

from __future__ import annotations

import ctypes

import torch

from genpercept_tpu_torch import _build
from genpercept_tpu_torch.ops import _dispatch

_LOG2E = 1.4426950408889634
_KERNEL_D = (64, 512)  # head dims with a kernel body


def _pick_block(s: int, cap: int,
                candidates=(1536, 1152, 1024, 768, 576, 512, 384, 256, 128,
                            64)) -> int | None:
    for b in candidates:
        if b <= cap and s % b == 0:
            return b
    return None


def _blocks(sq: int, sk: int, d: int):
    """The TPU kernel's (q, k) block choice; only ``supported`` reads it."""
    if d <= 128:
        if sk == 2304:
            return _pick_block(sq, 768), sk
        return _pick_block(sq, 1152), _pick_block(sk, 1536)
    return _pick_block(sq, 512), _pick_block(sk, 1536)


def supported(sq: int, sk: int, d: int) -> bool:
    """The TPU package's predicate for shapes flash_attention takes, on the
    head dims of ``_KERNEL_D``."""
    if d not in _KERNEL_D:
        return False
    q_blk, k_blk = _blocks(sq, sk, d)
    if k_blk is None:
        q_blk, k_blk = _blocks(sq, max(128, -(-sk // 128) * 128), d)
    return q_blk is not None and k_blk is not None


def _to_bhsd(x: torch.Tensor, b: int, s: int, h: int, d: int) -> torch.Tensor:
    if h == 1:
        return x.reshape(b, s, d)
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d)


def _from_bhsd(x: torch.Tensor, b: int, s: int, h: int, d: int) -> torch.Tensor:
    if h == 1:
        return x.reshape(b, s, 1, d)
    return x.reshape(b, h, s, d).permute(0, 2, 1, 3)


def _flash_bhsd_ref(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                    scale: float):
    """Plain version of the kernel: the same function in one softmax pass.

    Logits in f32 (bf16 products are exact in f32), the max on raw logits,
    p rounded to v's dtype, l the sum of the rounded p. Returns
    (out (BH, Sq, D) in q's dtype, lse2 (BH, Sq, 1) f32)."""
    c = scale * _LOG2E
    s = torch.matmul(qh.float(), kh.float().transpose(1, 2))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s * c - m * c).to(vh.dtype).float()
    del s
    l = p.sum(dim=-1, keepdim=True)
    out = (torch.matmul(p, vh.float()) / l).to(qh.dtype)
    return out, m * c + torch.log2(l)


def _check_kernel_args(name: str, qh: torch.Tensor, kh: torch.Tensor,
                       *rest: torch.Tensor) -> int:
    """Raise on what the kernels do not take; return the dtype code. ``rest``
    holds tensors shaped as v (first) and then as q."""
    bh, sq, d = qh.shape
    sk = kh.shape[1]
    code = _dispatch.dtype_code(qh, name)
    if d not in _KERNEL_D:
        raise ValueError(f"{name}: no kernel for head dim {d}")
    shapes = [kh.shape, rest[0].shape] + [x.shape for x in rest[1:]]
    if shapes != [(bh, sk, d)] * 2 + [(bh, sq, d)] * (len(rest) - 1):
        raise ValueError(f"{name}: shapes {qh.shape} {shapes}")
    if any(x.dtype != qh.dtype or x.device != qh.device for x in (kh, *rest)):
        raise ValueError(f"{name}: inputs differ in dtype or device")
    return code


def _flash_bhsd(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                scale: float, kv_valid: int | None = None):
    """K1. qh: (BH, Sq, D); kh/vh: (BH, Sk, D) -> (out, lse2).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if kv_valid is not None:
        raise NotImplementedError("kv_valid masking is not ported yet")
    if not _dispatch.use_kernel(qh):
        return _flash_bhsd_ref(qh, kh, vh, scale)
    bh, sq, d = qh.shape
    sk = kh.shape[1]
    code = _check_kernel_args("flash_attention", qh, kh, vh)
    qh, kh, vh = qh.contiguous(), kh.contiguous(), vh.contiguous()
    out = torch.empty_like(qh)
    lse = torch.empty((bh, sq, 1), dtype=torch.float32, device=qh.device)
    lib = _build.load()
    err = lib.flash_attn_fwd(
        qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), out.data_ptr(),
        lse.data_ptr(), bh, sq, sk, d, ctypes.c_float(scale), code,
        _dispatch.stream_handle(qh))
    _build.check(err, "flash_attn_fwd")
    _flash_bhsd.launches += 1
    return out, lse


_flash_bhsd.launches = 0


def _flash_bwd_bhsd_ref(qh, kh, vh, do, lse, dsum, scale: float):
    """Plain version of K3 and K4: the same math in one pass over full
    matrices, with the kernels' rounding points. P and dP in f32; dS rounded
    to k's dtype for dq and to q's dtype for dk; P rounded to dO's dtype for
    dv; f32 accumulates, outputs in the input dtypes. Returns (dq, dk, dv)."""
    c = scale * _LOG2E
    qf, kf, vf, dof = qh.float(), kh.float(), vh.float(), do.float()
    p = torch.exp2(torch.matmul(qf, kf.transpose(1, 2)) * c - lse)
    ds = p * (torch.matmul(dof, vf.transpose(1, 2)) - dsum) * scale
    dv = torch.matmul(p.to(do.dtype).float().transpose(1, 2), dof).to(vh.dtype)
    del p
    dq = torch.matmul(ds.to(kh.dtype).float(), kf).to(qh.dtype)
    dk = torch.matmul(ds.to(qh.dtype).float().transpose(1, 2), qf).to(kh.dtype)
    return dq, dk, dv


def _flash_bwd_dq(qh, kh, vh, do, lse, dsum, scale: float) -> torch.Tensor:
    """K3 on CUDA tensors: dq (BH, Sq, D)."""
    bh, sq, d = qh.shape
    code = _check_kernel_args("flash_attn_bwd_dq", qh, kh, vh, do)
    dq = torch.empty_like(qh)
    err = _build.load().flash_attn_bwd_dq(
        qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dsum.data_ptr(), dq.data_ptr(), bh, sq, kh.shape[1], d,
        ctypes.c_float(scale), code, _dispatch.stream_handle(qh))
    _build.check(err, "flash_attn_bwd_dq")
    _flash_bwd_dq.launches += 1
    return dq


def _flash_bwd_dkv(qh, kh, vh, do, lse, dsum, scale: float):
    """K4 on CUDA tensors: (dk, dv), each (BH, Sk, D)."""
    bh, sq, d = qh.shape
    code = _check_kernel_args("flash_attn_bwd_dkv", qh, kh, vh, do)
    dk, dv = torch.empty_like(kh), torch.empty_like(vh)
    err = _build.load().flash_attn_bwd_dkv(
        qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dsum.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, sq, kh.shape[1], d,
        ctypes.c_float(scale), code, _dispatch.stream_handle(qh))
    _build.check(err, "flash_attn_bwd_dkv")
    _flash_bwd_dkv.launches += 1
    return dk, dv


_flash_bwd_dq.launches = 0
_flash_bwd_dkv.launches = 0


def _flash_bwd_bhsd(qh, kh, vh, oh, do, lse, scale: float):
    """Backward of ``_flash_bhsd`` from its saved output and lse2: dsum in
    f32 plain torch (as JAX computes it outside its Pallas calls), then K3
    and K4 on CUDA tensors or the plain version on CPU ones. -> (dq, dk, dv)."""
    dsum = (do.float() * oh.float()).sum(dim=-1, keepdim=True)
    if not _dispatch.use_kernel(qh):
        return _flash_bwd_bhsd_ref(qh, kh, vh, do, lse, dsum, scale)
    qh, kh, vh, do = qh.contiguous(), kh.contiguous(), vh.contiguous(), do.contiguous()
    lse = lse.contiguous()
    dq = _flash_bwd_dq(qh, kh, vh, do, lse, dsum, scale)
    dk, dv = _flash_bwd_dkv(qh, kh, vh, do, lse, dsum, scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """(B, S, H, D) flash attention: K1 forward, K3 and K4 backward. Saves
    q, k, v in the (BH, S, D) layout, the output and lse2."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        b, sq, h, d = q.shape
        sk = k.shape[1]
        qh, kh, vh = (_to_bhsd(x, b, s, h, d) for x, s in ((q, sq), (k, sk), (v, sk)))
        out, lse = _flash_bhsd(qh, kh, vh, scale)
        ctx.save_for_backward(qh, kh, vh, out, lse)
        ctx.scale, ctx.dims = scale, (b, sq, sk, h, d)
        return _from_bhsd(out, b, sq, h, d)

    @staticmethod
    def backward(ctx, g):
        qh, kh, vh, out, lse = ctx.saved_tensors
        b, sq, sk, h, d = ctx.dims
        dq, dk, dv = _flash_bwd_bhsd(qh, kh, vh, out, _to_bhsd(g, b, sq, h, d), lse,
                                     ctx.scale)
        return (_from_bhsd(dq, b, sq, h, d), _from_bhsd(dk, b, sk, h, d),
                _from_bhsd(dv, b, sk, h, d), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, Sq, H, D), k/v: (B, Sk, H, D) -> (B, Sq, H, D). Differentiable."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if not supported(sq, sk, d):
        raise ValueError(f"flash_attention unsupported shape {(sq, sk, d)}")
    return FlashAttention.apply(q, k, v, scale)


# ------------------------------------------------- int8 forward (d=512)
#
# K6 ``csrc/flash_attn_int8.cu`` replaces the TPU kernel _flash_int8_kernel
# (reached through _flash_int8_bhsd). q and k arrive as int8 with per-row f32
# scales, v as int8 with per-column scales, quantized here in torch as the
# JAX package does in XLA. Per k block of the TPU kernel's partition
# (``_blocks(sq, sk, d)[1]``): logits s32 * (qs * ks), the base-2 online
# softmax, pq = round(p * 127) as int8 against the running max at the end of
# the block, the same pq into PV (int32) and into the row sum; out =
# acc * vs / l. Because pq is rounded against the max of a whole block, the
# result depends on the block partition, and kernel and plain version take
# the TPU's.


def _rowq(x: torch.Tensor, dim: int):
    """Symmetric int8 along ``dim`` (per row: -1; per column of v: 1) ->
    (codes, f32 scales with ``dim`` kept)."""
    xf = x.float()
    s = xf.abs().amax(dim=dim, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.clamp(torch.round(xf / s), -127.0, 127.0).to(torch.int8), s


def _int8_k_block(sq: int, sk: int, d: int) -> int:
    k_blk = _blocks(sq, sk, d)[1]
    if k_blk is None:
        raise ValueError(f"flash_attention_int8: no k block for {(sq, sk, d)}")
    return k_blk


def _flash_int8_ref(q8, k8, v8, qs, ks, vs, scale: float, k_blk: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """Plain version of K6: the TPU kernel's per-block steps on whole
    (Sq, k_blk) blocks, int32 products on torch._int_mm. q8/k8/v8 (BH, S, D)
    int8, qs (BH, Sq, 1), ks (BH, Sk, 1), vs (BH, 1, D) f32 -> (BH, Sq, D)."""
    from genpercept_tpu_torch.ops.quant import int8_matmul

    bh, sq, d = q8.shape
    c = scale * _LOG2E
    out = torch.empty((bh, sq, d), dtype=dtype, device=q8.device)
    for b in range(bh):
        m = torch.full((sq, 1), -1e30, device=q8.device)
        acc = torch.zeros((sq, d), device=q8.device)
        l = torch.zeros((sq, 1), device=q8.device)
        for k0 in range(0, k8.shape[1], k_blk):
            s32 = int8_matmul(q8[b], k8[b, k0:k0 + k_blk])
            s = s32.float() * (qs[b] * ks[b, k0:k0 + k_blk, 0][None, :])
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            pq = torch.round(torch.exp2(s * c - m_new * c) * 127.0).to(torch.int8)
            alpha = torch.exp2((m - m_new) * c)
            m = m_new
            pv = int8_matmul(pq, v8[b, k0:k0 + k_blk].t().contiguous())
            acc = acc * alpha + pv.float()
            l = l * alpha + pq.float().sum(dim=-1, keepdim=True)
        out[b] = (acc * vs[b] / l).to(dtype)
    return out


def int8_operands(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor):
    """K6's operands, quantized in torch as the JAX package does in XLA:
    q and k per row, v per column -> (q8, k8, v8, qs, ks, vs)."""
    q8, qs = _rowq(qh, -1)
    k8, ks = _rowq(kh, -1)
    v8, vs = _rowq(vh, 1)
    return q8, k8, v8, qs, ks, vs


def _flash_int8_codes(q8, k8, v8, qs, ks, vs, scale: float, k_blk: int,
                      dtype: torch.dtype) -> torch.Tensor:
    """K6 on int8 operands (see _flash_int8_ref) -> (BH, Sq, D) in dtype.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if not _dispatch.use_kernel(q8):
        return _flash_int8_ref(q8, k8, v8, qs, ks, vs, scale, k_blk, dtype)
    bh, sq, d = q8.shape
    sk = k8.shape[1]
    code = _dispatch.dtype_code(dtype, "flash_attention_int8")
    if (d != 512 or k_blk % 64 or k_blk > 1536 or sk % k_blk
            or k8.shape != (bh, sk, d) or v8.shape != (bh, sk, d)
            or qs.shape != (bh, sq, 1) or ks.shape != (bh, sk, 1) or vs.shape != (bh, 1, d)
            or any(t.dtype != torch.int8 for t in (q8, k8, v8))
            or any(t.dtype != torch.float32 for t in (qs, ks, vs))
            or any(t.device != q8.device for t in (k8, v8, qs, ks, vs))):
        raise ValueError(f"flash_attention_int8: no kernel for q {tuple(q8.shape)}, "
                         f"k {tuple(k8.shape)}, v {tuple(v8.shape)}, k block {k_blk}")
    q8, k8, qs, ks, vs = (t.contiguous() for t in (q8, k8, qs, ks, vs))
    vt = v8.transpose(1, 2).contiguous()  # (BH, D, Sk): PV's B operand, k-major
    out = torch.empty((bh, sq, d), dtype=dtype, device=q8.device)
    err = _build.load().flash_attn_int8(
        q8.data_ptr(), k8.data_ptr(), vt.data_ptr(), qs.data_ptr(), ks.data_ptr(),
        vs.data_ptr(), out.data_ptr(), bh, sq, sk, d, k_blk,
        ctypes.c_float(scale * _LOG2E), code, _dispatch.stream_handle(q8))
    _build.check(err, "flash_attn_int8")
    _flash_int8_codes.launches += 1
    return out


_flash_int8_codes.launches = 0


def _flash_int8_bhsd(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """qh: (BH, Sq, D), kh/vh: (BH, Sk, D) float -> (BH, Sq, D) in qh's
    dtype: the operands quantized, then K6 with the TPU's k-block partition."""
    k_blk = _int8_k_block(qh.shape[1], kh.shape[1], qh.shape[2])
    return _flash_int8_codes(*int8_operands(qh, kh, vh), scale, k_blk, qh.dtype)


def flash_attention_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float | None = None) -> torch.Tensor:
    """Inference-only int8 flash attention, (B, S, H, D) in and out, for the
    VAE mid block's one head of d=512."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, sq, h, d = q.shape
    sk = k.shape[1]
    out = _flash_int8_bhsd(_to_bhsd(q, b, sq, h, d), _to_bhsd(k, b, sk, h, d),
                           _to_bhsd(v, b, sk, h, d), scale)
    return _from_bhsd(out, b, sq, h, d)
