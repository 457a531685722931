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
  from the saved ``lse2`` and ``dsum = rowsum(dO*O)``.

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
