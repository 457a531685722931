"""SD2.1 UNet2DConditionModel as an nn.Module (NCHW), exact path only.

Counterpart of ``genpercept_tpu/models/unet.py::unet_apply`` without
``return_features`` (the DPT head's taps).
Geometry (SD2.1): 4-channel latent, block_out_channels (320, 640, 1280,
1280), 2 resnets per block, cross-attention on 1024-d CLIP states, heads
(5, 10, 20, 20) of dim 64, linear projections in the transformers.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from genpercept_tpu_torch.models.layers import (
    Downsample,
    Norm,
    ResnetBlock,
    SpatialTransformer,
    Upsample,
    checkpointed,
    conv,
    dense,
    downsample2d,
    resnet_block,
    spatial_transformer,
    upsample2d,
)
from genpercept_tpu_torch.ops import group_norm, timestep_embedding


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    down_block_has_attn: Tuple[bool, ...] = (True, True, True, False)
    attention_heads: Tuple[int, ...] = (5, 10, 20, 20)
    cross_attention_dim: int = 1024
    norm_eps: float = 1e-5


SD21_UNET = UNetConfig()


class _UNetBlock(nn.Module):
    def __init__(self, resnets, attentions=None, downsample=None, upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([downsample])
        if upsample is not None:
            self.upsamplers = nn.ModuleList([upsample])


class _TimeEmbedding(nn.Module):
    def __init__(self, c: int, temb_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(c, temb_dim)
        self.linear_2 = nn.Linear(temb_dim, temb_dim)


class UNet2DConditionModel(nn.Module):
    def __init__(self, cfg: UNetConfig = SD21_UNET):
        super().__init__()
        self.cfg = cfg
        chans = cfg.block_out_channels
        n_blocks = len(chans)
        temb_dim = chans[0] * 4
        ctx = cfg.cross_attention_dim
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3)
        self.time_embedding = _TimeEmbedding(chans[0], temb_dim)

        down, cin = [], chans[0]
        for i, cout in enumerate(chans):
            res, attn = [], []
            for _ in range(cfg.layers_per_block):
                res.append(ResnetBlock(cin, cout, temb_dim))
                cin = cout
                if cfg.down_block_has_attn[i]:
                    attn.append(SpatialTransformer(cout, ctx))
            last = i == n_blocks - 1
            down.append(_UNetBlock(res, attn, downsample=None if last else Downsample(cout)))
        self.down_blocks = nn.ModuleList(down)

        c = chans[-1]
        self.mid_block = _UNetBlock(
            [ResnetBlock(c, c, temb_dim), ResnetBlock(c, c, temb_dim)],
            [SpatialTransformer(c, ctx)])

        up = []
        rev = tuple(reversed(chans))
        rev_attn = tuple(reversed(cfg.down_block_has_attn))
        for i in range(n_blocks):
            cout, prev_out = rev[i], rev[max(i - 1, 0)]
            res, attn = [], []
            for j in range(cfg.layers_per_block + 1):
                res_skip = (rev[min(i + 1, n_blocks - 1)]
                            if j == cfg.layers_per_block else cout)
                res_in = prev_out if j == 0 else cout
                res.append(ResnetBlock(res_in + res_skip, cout, temb_dim))
                if rev_attn[i]:
                    attn.append(SpatialTransformer(cout, ctx))
            last = i == n_blocks - 1
            up.append(_UNetBlock(res, attn, upsample=None if last else Upsample(cout)))
        self.up_blocks = nn.ModuleList(up)

        self.conv_norm_out = Norm(chans[0])
        self.conv_out = nn.Conv2d(chans[0], cfg.out_channels, 3)


def _unit(rb, attn, h: torch.Tensor, skip: Optional[torch.Tensor],
          temb: torch.Tensor, ctx: torch.Tensor, heads: int, eps: float,
          conv_fn=None, dense_fn=None, name: str = "") -> torch.Tensor:
    """One (resnet [+ transformer]) unit, the skip concatenated first on the
    up path: what ``remat="block"`` checkpoints. ``name`` is the block's
    path and the unit's index, e.g. "down_blocks.0.{}.1"."""
    if skip is not None:
        h = torch.cat([h, skip], dim=1)
    h = resnet_block(rb, h, temb, eps, conv_fn=conv_fn, name=name.format("resnets"))
    if attn is not None:
        h = spatial_transformer(attn, h, ctx, heads, dense_fn, name.format("attentions"))
    return h


def unet_apply(unet: UNet2DConditionModel, sample: torch.Tensor,
               timesteps: torch.Tensor, encoder_hidden_states: torch.Tensor,
               remat: Optional[str] = None, conv_fn=None, dense_fn=None) -> torch.Tensor:
    """sample: (N, 4, h, w); timesteps: (N,) or scalar; text states
    (N, 77, ctx). Returns the v-prediction (N, 4, h, w).

    remat (training): "unet" recomputes the whole UNet forward in the
    backward (one checkpoint, the JAX training step's ``jax.checkpoint``
    around it); "block" checkpoints each (resnet [+ transformer]) unit, so
    the backward holds one unit's internals at a time.

    conv_fn / dense_fn (ops/quant.py, inference only) hook every resnet,
    down- and upsampler conv and every transformer projection and
    feed-forward matmul; conv_in/conv_out, the time embedding,
    cross-attention k/v and the attention itself stay full precision."""
    hooked = conv_fn is not None or dense_fn is not None
    if remat is not None and hooked:
        raise ValueError("remat is a training feature; the int8 hooks are inference")
    if remat == "unet":
        return checkpointed(unet_apply, unet, sample, timesteps, encoder_hidden_states)
    if remat not in (None, "block"):
        raise ValueError(f"remat={remat!r}")
    if remat == "block":
        unit = functools.partial(checkpointed, _unit)
    else:
        unit = functools.partial(_unit, conv_fn=conv_fn, dense_fn=dense_fn)
    cfg = unet.cfg
    chans = cfg.block_out_channels
    ctx = encoder_hidden_states
    eps = cfg.norm_eps
    if timesteps.ndim == 0:
        timesteps = timesteps.expand(sample.shape[0])
    temb = timestep_embedding(timesteps, chans[0])
    te = unet.time_embedding
    temb = dense(te.linear_2, F.silu(dense(te.linear_1, temb))).to(sample.dtype)

    h = conv(unet.conv_in, sample)
    residuals = [h]
    for i, blk in enumerate(unet.down_blocks):
        attns = getattr(blk, "attentions", None)
        for j, rb in enumerate(blk.resnets):
            h = unit(rb, None if attns is None else attns[j], h, None, temb, ctx,
                     cfg.attention_heads[i], eps, name=f"down_blocks.{i}.{{}}.{j}")
            residuals.append(h)
        if hasattr(blk, "downsamplers"):
            h = downsample2d(blk.downsamplers[0], h, conv_fn=conv_fn,
                             name=f"down_blocks.{i}.downsamplers.0")
            residuals.append(h)

    mid = unet.mid_block
    h = unit(mid.resnets[0], mid.attentions[0], h, None, temb, ctx,
             cfg.attention_heads[-1], eps, name="mid_block.{}.0")
    h = unit(mid.resnets[1], None, h, None, temb, ctx, 0, eps, name="mid_block.{}.1")

    rev_heads = tuple(reversed(cfg.attention_heads))
    for i, blk in enumerate(unet.up_blocks):
        attns = getattr(blk, "attentions", None)
        for j, rb in enumerate(blk.resnets):
            h = unit(rb, None if attns is None else attns[j], h, residuals.pop(), temb,
                     ctx, rev_heads[i], eps, name=f"up_blocks.{i}.{{}}.{j}")
        if hasattr(blk, "upsamplers"):
            # match the next skip's spatial size (diffusers upsample_size)
            target = tuple(residuals[-1].shape[2:]) if residuals else None
            h = upsample2d(blk.upsamplers[0], h, target, conv_fn=conv_fn,
                           name=f"up_blocks.{i}.upsamplers.0")

    out = F.silu(group_norm(h, unet.conv_norm_out.weight, unet.conv_norm_out.bias,
                            32, eps))
    return conv(unet.conv_out, out)
