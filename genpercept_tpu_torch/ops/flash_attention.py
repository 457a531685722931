"""Flash attention forward (non-causal): the Hopper kernel and its plain version.

Counterpart of ``genpercept_tpu/ops/flash_attention.py``. The kernel
(``csrc/flash_attn_fwd.cu``) replaces the TPU kernel ``_flash_kernel``: the
(Sq x Sk) logits never reach device memory. ``_flash_bhsd`` returns the
output and ``lse2``, the base-2 logsumexp of the scaled logits
(``m*c + log2 l`` with ``c = scale*log2 e``), as the TPU kernel does.

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


def _flash_bhsd(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                scale: float, kv_valid: int | None = None):
    """qh: (BH, Sq, D); kh/vh: (BH, Sk, D) -> (out, lse2).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if kv_valid is not None:
        raise NotImplementedError("kv_valid masking is not ported yet")
    if not _dispatch.use_kernel(qh):
        return _flash_bhsd_ref(qh, kh, vh, scale)
    bh, sq, d = qh.shape
    sk = kh.shape[1]
    code = _dispatch.dtype_code(qh, "flash_attention")
    if d not in _KERNEL_D:
        raise ValueError(f"flash_attention: no kernel for head dim {d}")
    if kh.shape != (bh, sk, d) or vh.shape != (bh, sk, d):
        raise ValueError(f"flash_attention: shapes {qh.shape} {kh.shape} {vh.shape}")
    if not (kh.dtype == vh.dtype == qh.dtype
            and kh.device == vh.device == qh.device):
        raise ValueError("flash_attention: q, k, v differ in dtype or device")
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, Sq, H, D), k/v: (B, Sk, H, D) -> (B, Sq, H, D). Forward only."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if not supported(sq, sk, d):
        raise ValueError(f"flash_attention unsupported shape {(sq, sk, d)}")
    out, _ = _flash_bhsd(_to_bhsd(q, b, sq, h, d), _to_bhsd(k, b, sk, h, d),
                         _to_bhsd(v, b, sk, h, d), scale)
    return _from_bhsd(out, b, sq, h, d)
