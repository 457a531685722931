"""Shared SD2.1 building blocks as nn.Modules (NCHW activations).

Counterpart of ``genpercept_tpu/models/layers.py``, with its int8 hooks
(``conv_fn``/``dense_fn``/``name``) and its ``fused`` resblock path (the
fused GroupNorm -> SiLU -> conv3x3 kernel, ``ops/fused_conv.py``). Each
module's ``state_dict`` keys are the JAX param-tree keys joined with ``.``
(the diffusers names), with PyTorch layouts: conv weights OIHW, linear
weights (out, in). The modules hold parameters; each block is applied by a
plain function of the same name as in the JAX package (``resnet_block``,
``vae_attention``, ...) that takes the module in place of the param tree.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from genpercept_tpu_torch.ops import conv2d, group_norm, layer_norm
from genpercept_tpu_torch.parallel import tensor as TP
from genpercept_tpu_torch.ops import fused_conv as FC
from genpercept_tpu_torch.ops.attention import (
    attention_projection,
    dot_product_attention,
)
from genpercept_tpu_torch.ops.conv import conv1x1, nearest_up2_conv3x3
from genpercept_tpu_torch.ops.flash_attention import flash_attention_int8
from genpercept_tpu_torch.ops.fused_ff import (
    fused_geglu_ff,
    fused_geglu_ff_int8,
    supported as ff_supported,
    supported_int8 as ff_supported_int8,
)


class Norm(nn.Module):
    """Affine parameters of a GroupNorm or LayerNorm (keys weight, bias)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))


def dense(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return attention_projection(x, m.weight, m.bias)


def conv(m: nn.Conv2d, x: torch.Tensor, stride: int = 1, padding=1) -> torch.Tensor:
    return conv2d(x, m.weight, m.bias, stride=stride, padding=padding)


# The int8 hooks (ops/quant.py): conv_fn(name, weight, bias, x, *, kind,
# stride, padding) and dense_fn(name, weight, bias, x), called with the
# diffusers dotted names (the JAX package's, so that quantized trees and
# calibration files match). None runs the layer in full precision.


def _hooked_conv(conv_fn, name: str, m: nn.Conv2d, x: torch.Tensor, **geometry):
    if conv_fn is None:
        return conv(m, x, **geometry)
    return conv_fn(name, m.weight, m.bias, x, **geometry)


def _hooked_dense(dense_fn, name: str, m: nn.Linear, x: torch.Tensor):
    if dense_fn is None:
        return dense(m, x)
    return dense_fn(name, m.weight, m.bias, x)


def checkpointed(fn, *args, **kwargs):
    """fn(*args, **kwargs) with its activations recomputed in the backward
    instead of saved (``torch.utils.checkpoint``, non-reentrant); the
    counterpart of ``jax.checkpoint``. No random numbers are drawn inside."""
    return torch.utils.checkpoint.checkpoint(
        functools.partial(fn, **kwargs), *args, use_reentrant=False,
        preserve_rng_state=False)


@torch.no_grad()
def init_params_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's init scheme (models/layers.py dense_init/conv_init/
    norm_init, clip_text embeddings), drawn from ``generator``: weights
    uniform in +-1/sqrt(fan_in), biases zero, norms (1, 0), embeddings
    normal * 0.02."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, Norm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 0.02, generator=generator)
    return module


# ------------------------------------------------------------- resnet block

class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, temb_dim: int | None):
        super().__init__()
        self.norm1 = Norm(cin)
        self.conv1 = nn.Conv2d(cin, cout, 3)
        self.norm2 = Norm(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3)
        if temb_dim is not None:
            self.time_emb_proj = nn.Linear(temb_dim, cout)
        if cin != cout:
            self.conv_shortcut = nn.Conv2d(cin, cout, 1)


def resnet_block(p: ResnetBlock, x: torch.Tensor, temb: torch.Tensor | None = None,
                 eps: float = 1e-5, native_norm: bool = False, conv_fn=None,
                 name: str = "", fused: bool = False) -> torch.Tensor:
    """diffusers ResnetBlock2D: GN -> SiLU -> conv -> (+temb) -> GN -> SiLU
    -> conv -> +shortcut. native_norm: GroupNorm apply in x's dtype (the
    training decode path under remat). conv_fn hooks conv1 and conv2 as
    ``name``.conv1/.conv2; the shortcut stays full precision.

    fused=True (inference only): without temb and conv_fn, where the fused
    kernel's predicate holds, both GN -> SiLU -> conv sequences run as the
    fused kernel, the second with the skip as its residual."""
    if fused and temb is None and conv_fn is None \
            and FC.supported(x.shape, p.conv1.weight.shape[0]):
        h = FC.fused_gn_silu_conv3x3(x, p.norm1.weight, p.norm1.bias, p.conv1.weight,
                                     p.conv1.bias, eps=eps)
        skip = x
        if hasattr(p, "conv_shortcut"):
            skip = conv1x1(x, p.conv_shortcut.weight, p.conv_shortcut.bias)
        return FC.fused_gn_silu_conv3x3(h, p.norm2.weight, p.norm2.bias, p.conv2.weight,
                                        p.conv2.bias, residual=skip, eps=eps)
    h = F.silu(group_norm(x, p.norm1.weight, p.norm1.bias, 32, eps, native_norm))
    h = _hooked_conv(conv_fn, name + ".conv1", p.conv1, h)
    if temb is not None and hasattr(p, "time_emb_proj"):
        t = dense(p.time_emb_proj, F.silu(temb))
        h = h + t[:, :, None, None].to(h.dtype)
    h = F.silu(group_norm(h, p.norm2.weight, p.norm2.bias, 32, eps, native_norm))
    h = _hooked_conv(conv_fn, name + ".conv2", p.conv2, h)
    if hasattr(p, "conv_shortcut"):
        x = conv1x1(x, p.conv_shortcut.weight, p.conv_shortcut.bias)
    return x + h


# ---------------------------------------------------------- up/down sampling

class Downsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3)


def downsample2d(p: Downsample, x: torch.Tensor, asymmetric_pad: bool = False,
                 conv_fn=None, name: str = "") -> torch.Tensor:
    """Stride-2 conv; the VAE encoder pads (0,1,0,1), the UNet symmetric 1."""
    pad = ((0, 1), (0, 1)) if asymmetric_pad else 1
    return _hooked_conv(conv_fn, name + ".conv", p.conv, x, stride=2, padding=pad)


class Upsample(nn.Module):
    def __init__(self, c: int, cout: int | None = None):
        super().__init__()
        self.conv = nn.Conv2d(c, cout or c, 3)


def upsample2d(p: Upsample, x: torch.Tensor, out_hw: tuple | None = None,
               conv_fn=None, name: str = "") -> torch.Tensor:
    """Nearest upsample (x2 or to an explicit size) then 3x3 conv. conv_fn
    hooks the x2 form only (as the collapsed 4x4 kernel, kind "up4x4"); the
    explicit-size form stays full precision, as in the JAX package."""
    h, w = x.shape[2:]
    if out_hw is None or tuple(out_hw) == (2 * h, 2 * w):
        if conv_fn is not None:
            return conv_fn(name + ".conv", p.conv.weight, p.conv.bias, x, kind="up4x4")
        return nearest_up2_conv3x3(x, p.conv.weight, p.conv.bias)
    oh, ow = out_hw
    # F.interpolate mode='nearest': src = floor(i * in / out)
    ys = torch.clamp(torch.arange(oh, device=x.device) * h // oh, max=h - 1)
    xs = torch.clamp(torch.arange(ow, device=x.device) * w // ow, max=w - 1)
    return conv(p.conv, x[:, :, ys][:, :, :, xs])


# ------------------------------------------------- VAE single-head attention

class VAEAttention(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.group_norm = Norm(c)
        self.to_q = nn.Linear(c, c)
        self.to_k = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])


def vae_attention(p: VAEAttention, x: torch.Tensor, eps: float = 1e-6,
                  int8: bool = False, dense_fn=None, name: str = "") -> torch.Tensor:
    """Single-head self-attention over spatial tokens (VAE mid block).
    int8=True runs QK^T and PV through the int8 flash attention (inference
    only); dense_fn hooks the four projections."""
    n, c, h, w = x.shape
    y = group_norm(x, p.group_norm.weight, p.group_norm.bias, 32, eps)
    y = y.reshape(n, c, h * w).transpose(1, 2)  # (N, HW, C)
    q = _hooked_dense(dense_fn, name + ".to_q", p.to_q, y)[:, :, None, :]
    k = _hooked_dense(dense_fn, name + ".to_k", p.to_k, y)[:, :, None, :]
    v = _hooked_dense(dense_fn, name + ".to_v", p.to_v, y)[:, :, None, :]
    attend = flash_attention_int8 if int8 else dot_product_attention
    o = attend(q, k, v)[:, :, 0, :]
    o = _hooked_dense(dense_fn, name + ".to_out.0", p.to_out[0], o)
    return x + o.transpose(1, 2).reshape(n, c, h, w)


# -------------------------------------------- transformer (UNet attn blocks)

class CrossAttention(nn.Module):
    def __init__(self, c: int, context_dim: int | None):
        super().__init__()
        kv_in = context_dim if context_dim is not None else c
        self.to_q = nn.Linear(c, c, bias=False)
        self.to_k = nn.Linear(kv_in, c, bias=False)
        self.to_v = nn.Linear(kv_in, c, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])


def _split_attention(shares, x: torch.Tensor, context: torch.Tensor | None, d: int,
                     bias: torch.Tensor | None) -> torch.Tensor:
    """Tensor-parallel attention (``parallel/tensor.py``): each share's
    heads through q, k, v (column-parallel), attention and its rows of
    to_out.0 (row-parallel), the partial products summed over the model
    group and the bias added once."""
    b, s, _ = x.shape
    parts = []
    for wq, wk, wv, wo in shares:
        xr = TP.copy_to_model(x)
        ctx = xr if context is None else context  # the frozen text states take no gradient
        h = wq.shape[0] // d
        q = attention_projection(xr, wq).reshape(b, s, h, d)
        k = attention_projection(ctx, wk).reshape(b, ctx.shape[1], h, d)
        v = attention_projection(ctx, wv).reshape(b, ctx.shape[1], h, d)
        parts.append(attention_projection(dot_product_attention(q, k, v).reshape(b, s, h * d),
                                          wo))
    return TP.reduce_from_model(parts, bias)


def cross_attention(p: CrossAttention, x: torch.Tensor, context: torch.Tensor | None,
                    heads: int, dense_fn=None, name: str = "") -> torch.Tensor:
    """x: (B, S, C); context: (B, Sk, Ck) or None for self-attention.
    dense_fn hooks q and out (and k, v of self-attention; cross-attention's
    k and v over the text tokens are never hooked). Split over a model
    group (or ``tensor.emulated``), a rank runs its own heads."""
    b, s, c = x.shape
    ctx = x if context is None else context
    kv_fn = dense_fn if context is None else None
    d = c // heads
    shares = TP.attention_shares(p, heads)
    if shares is not None:
        if dense_fn is not None:
            raise ValueError("the int8 hooks do not run tensor-parallel")
        return _split_attention(shares, x, context, d, p.to_out[0].bias)
    q = _hooked_dense(dense_fn, name + ".to_q", p.to_q, x).reshape(b, s, heads, d)
    k = _hooked_dense(kv_fn, name + ".to_k", p.to_k, ctx).reshape(b, ctx.shape[1], heads, d)
    v = _hooked_dense(kv_fn, name + ".to_v", p.to_v, ctx).reshape(b, ctx.shape[1], heads, d)
    o = dot_product_attention(q, k, v).reshape(b, s, c)
    return _hooked_dense(dense_fn, name + ".to_out.0", p.to_out[0], o)


class GEGLUProj(nn.Module):
    def __init__(self, c: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(c, 2 * inner)


class FeedForward(nn.Module):
    def __init__(self, c: int, mult: int = 4):
        super().__init__()
        inner = c * mult
        self.net = nn.ModuleDict({"0": GEGLUProj(c, inner), "2": nn.Linear(inner, c)})


def _geglu_ff(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor | None, w2: torch.Tensor,
              b2: torch.Tensor | None) -> torch.Tensor:
    """The fused GEGLU kernel where the TPU package takes its own (C == 320,
    rows a multiple of 512; a share's inner width a multiple of 64), else
    two column-half projections, exact GELU and the down-projection."""
    inner = w1.shape[0] // 2
    if ff_supported(x.shape[0], x.shape[1], x.shape[2]) and inner % 64 == 0:
        return fused_geglu_ff(x, w1, b1, w2, b2)
    hidden = attention_projection(x, w1[:inner], None if b1 is None else b1[:inner])
    gate = attention_projection(x, w1[inner:], None if b1 is None else b1[inner:])
    return attention_projection(hidden * F.gelu(gate), w2, b2)


def feed_forward(p: FeedForward, x: torch.Tensor, dense_fn=None, name: str = "") -> torch.Tensor:
    """GEGLU feed-forward. Where the TPU package takes its fused kernel
    (C == 320, rows a multiple of 512) this takes the fused GEGLU kernel;
    elsewhere two column-half projections, exact GELU, down-projection.
    Split over a model group (or ``tensor.emulated``), a rank runs its
    share of the inner width, the down-projection's bias withheld and added
    once after the sum over the group.

    With dense_fn: the two halves are hooked as ``name``.net.0.proj:h / :g
    and the down-projection as .net.2. When the hook's quantized tree holds
    all three and the tensor is not on the CPU, the feed-forward runs as the
    fused int8 kernel where ``supported_int8`` holds, as the JAX package does
    on an accelerator; elsewhere the unfused composition."""
    proj, down = p.net["0"].proj, p.net["2"]
    inner = proj.weight.shape[0] // 2
    b = proj.bias
    shares = TP.ff_shares(p)
    if shares is not None:
        if dense_fn is not None:
            raise ValueError("the int8 hooks do not run tensor-parallel")
        return TP.reduce_from_model([_geglu_ff(TP.copy_to_model(x), w1, b1, w2, None)
                                     for w1, b1, w2 in shares], down.bias)
    if dense_fn is not None:
        qtree = getattr(dense_fn, "qtree", None)
        if qtree is not None and x.device.type != "cpu":
            qs = [qtree.get(name + k) for k in (".net.0.proj:h", ".net.0.proj:g", ".net.2")]
            if all(q is not None for q in qs) and ff_supported_int8(*x.shape):
                return fused_geglu_ff_int8(x, *qs)
        hidden = dense_fn(name + ".net.0.proj:h", proj.weight[:inner],
                          None if b is None else b[:inner], x)
        gate = dense_fn(name + ".net.0.proj:g", proj.weight[inner:],
                        None if b is None else b[inner:], x)
        return _hooked_dense(dense_fn, name + ".net.2", down, hidden * F.gelu(gate))
    return _geglu_ff(x, proj.weight, b, down.weight, down.bias)


class TransformerBlock(nn.Module):
    def __init__(self, c: int, context_dim: int):
        super().__init__()
        self.norm1 = Norm(c)
        self.attn1 = CrossAttention(c, None)
        self.norm2 = Norm(c)
        self.attn2 = CrossAttention(c, context_dim)
        self.norm3 = Norm(c)
        self.ff = FeedForward(c)


def transformer_block(p: TransformerBlock, x: torch.Tensor, context: torch.Tensor,
                      heads: int, dense_fn=None, name: str = "") -> torch.Tensor:
    """BasicTransformerBlock: self-attn, cross-attn, GEGLU FF (pre-LN)."""
    h = layer_norm(x, p.norm1.weight, p.norm1.bias)
    x = x + cross_attention(p.attn1, h, None, heads, dense_fn, name + ".attn1")
    h = layer_norm(x, p.norm2.weight, p.norm2.bias)
    x = x + cross_attention(p.attn2, h, context, heads, dense_fn, name + ".attn2")
    h = layer_norm(x, p.norm3.weight, p.norm3.bias)
    return x + feed_forward(p.ff, h, dense_fn, name + ".ff")


class SpatialTransformer(nn.Module):
    def __init__(self, c: int, context_dim: int, depth: int = 1):
        super().__init__()
        self.norm = Norm(c)
        self.proj_in = nn.Linear(c, c)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(c, context_dim) for _ in range(depth)])
        self.proj_out = nn.Linear(c, c)


def spatial_transformer(p: SpatialTransformer, x: torch.Tensor, context: torch.Tensor,
                        heads: int, dense_fn=None, name: str = "") -> torch.Tensor:
    """Transformer2DModel with use_linear_projection=True (SD2.1):
    GN(eps 1e-6) -> flatten -> proj_in -> blocks -> proj_out -> +residual."""
    n, c, h, w = x.shape
    y = group_norm(x, p.norm.weight, p.norm.bias, 32, 1e-6)
    y = y.reshape(n, c, h * w).transpose(1, 2)
    y = _hooked_dense(dense_fn, name + ".proj_in", p.proj_in, y)
    for i, blk in enumerate(p.transformer_blocks):
        y = transformer_block(blk, y, context, heads, dense_fn,
                              f"{name}.transformer_blocks.{i}")
    y = _hooked_dense(dense_fn, name + ".proj_out", p.proj_out, y)
    return x + y.transpose(1, 2).reshape(n, c, h, w)
