"""Attention entry point for the UNet and the VAE, (B, S, H, D) layout.

``dot_product_attention`` routes exactly as ``genpercept_tpu/ops/attention.py``
does: long self-attention ((sq >= 2048 and sk >= 2048) or sq == sk == 576,
on a shape ``flash_attention.supported`` takes) goes to flash attention,
everything else (cross-attention over 77 text tokens, the UNet mid block at
144 tokens) to the plain softmax below. The thresholds were chosen on the TPU
and are not yet measured on the card. Flash attention then runs its CUDA
kernel for CUDA tensors and its plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from genpercept_tpu_torch.ops import flash_attention as fa


def _math_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Plain softmax attention: f32 logits and PV accumulate (exact products
    for bf16 inputs), probabilities rounded to q's dtype."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(q.dtype)


def routes_to_flash(sq: int, sk: int, d: int) -> bool:
    """The TPU package's routing predicate, without its backend test: the
    wrapper picks kernel or plain version from the tensor's device."""
    return (((sq >= 2048 and sk >= 2048) or (sq == sk and sq == 576))
            and fa.supported(sq, sk, d))


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float | None = None) -> torch.Tensor:
    """q: (B, Sq, H, D), k/v: (B, Sk, H, D) -> (B, Sq, H, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if routes_to_flash(q.shape[1], k.shape[1], q.shape[-1]):
        return fa.flash_attention(q, k, v, scale=scale)
    return _math_attention(q, k, v, scale)


def attention_projection(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor | None = None) -> torch.Tensor:
    """Linear layer in x's dtype; weight (Dout, Din) as nn.Linear keeps it."""
    out = torch.matmul(x, weight.to(x.dtype).t())
    return out if bias is None else out + bias.to(out.dtype)
