"""SD2.1 AutoencoderKL (VAE) as an nn.Module, NCHW.

Counterpart of ``genpercept_tpu/models/vae.py``, with its ``fused`` path
(every resblock through the fused GroupNorm -> SiLU -> conv3x3 kernel where
its predicate holds, inference only):
  encode: encoder -> quant_conv -> posterior mean (first 4 ch) * 0.18215
  decode: / 0.18215 -> post_quant_conv -> decoder
State-dict keys are the diffusers names (encoder.down_blocks.N.resnets.M...).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from genpercept_tpu_torch.models.layers import (
    Downsample,
    Norm,
    ResnetBlock,
    Upsample,
    VAEAttention,
    checkpointed,
    conv,
    downsample2d,
    resnet_block,
    upsample2d,
    vae_attention,
)
from genpercept_tpu_torch.ops import fused_conv as FC
from genpercept_tpu_torch.ops import group_norm
from genpercept_tpu_torch.ops.conv import conv1x1


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


SD21_VAE = VAEConfig()


class _Block(nn.Module):
    """A down/up block: ``resnets`` and optionally ``downsamplers`` or
    ``upsamplers`` (each a one-element list, as diffusers names them)."""

    def __init__(self, resnets, downsample=None, upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([downsample])
        if upsample is not None:
            self.upsamplers = nn.ModuleList([upsample])


class _MidBlock(nn.Module):
    def __init__(self, c: int, temb_dim: int | None, attention: nn.Module):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock(c, c, temb_dim), ResnetBlock(c, c, temb_dim)])
        self.attentions = nn.ModuleList([attention])


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3)
        blocks, cin = [], chans[0]
        for i, cout in enumerate(chans):
            res = []
            for _ in range(cfg.layers_per_block):
                res.append(ResnetBlock(cin, cout, None))
                cin = cout
            last = i == len(chans) - 1
            blocks.append(_Block(res, downsample=None if last else Downsample(cout)))
        self.down_blocks = nn.ModuleList(blocks)
        c = chans[-1]
        self.mid_block = _MidBlock(c, None, VAEAttention(c))
        self.conv_norm_out = Norm(c)
        self.conv_out = nn.Conv2d(c, 2 * cfg.latent_channels, 3)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans = tuple(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, chans[0], 3)
        self.mid_block = _MidBlock(chans[0], None, VAEAttention(chans[0]))
        blocks, cin = [], chans[0]
        for i, cout in enumerate(chans):
            res = []
            for _ in range(cfg.layers_per_block + 1):
                res.append(ResnetBlock(cin, cout, None))
                cin = cout
            last = i == len(chans) - 1
            blocks.append(_Block(res, upsample=None if last else Upsample(cout)))
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = Norm(chans[-1])
        self.conv_out = nn.Conv2d(chans[-1], cfg.out_channels, 3)


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig = SD21_VAE):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)


def _gn_silu_conv(h, norm: Norm, conv_m: nn.Conv2d, groups: int,
                  native_norm: bool = False, fused: bool = False):
    """Final GN -> SiLU -> conv3x3; the fused kernel where fused and its
    predicate hold (never at SD2.1's widths: Co is 8 or 3)."""
    if fused and groups == 32 and FC.supported(h.shape, conv_m.weight.shape[0]):
        return FC.fused_gn_silu_conv3x3(h, norm.weight, norm.bias, conv_m.weight,
                                        conv_m.bias)
    h = F.silu(group_norm(h, norm.weight, norm.bias, groups, 1e-6, native_norm))
    return conv(conv_m, h)


def vae_encoder_apply(vae: AutoencoderKL, x: torch.Tensor, conv_fn=None,
                      attn_int8: bool = False, dense_fn=None,
                      fused: bool = False) -> torch.Tensor:
    """x: (N, 3, H, W) in [-1, 1] -> moments (N, 8, H/8, W/8).

    fused=True runs the resblocks through the fused GN -> SiLU -> conv3x3
    kernel (inference only; see ops/fused_conv.py). conv_fn (ops/quant.py)
    hooks every resnet and downsampler conv; conv_in, conv_out and the
    shortcuts stay full precision. attn_int8 runs the
    mid-block attention through the int8 flash attention and dense_fn hooks
    its projections (inference only)."""
    enc, cfg = vae.encoder, vae.cfg
    h = conv(enc.conv_in, x)
    for i, blk in enumerate(enc.down_blocks):
        for j, rb in enumerate(blk.resnets):
            h = resnet_block(rb, h, None, eps=1e-6, conv_fn=conv_fn,
                             name=f"encoder.down_blocks.{i}.resnets.{j}", fused=fused)
        if hasattr(blk, "downsamplers"):
            h = downsample2d(blk.downsamplers[0], h, asymmetric_pad=True, conv_fn=conv_fn,
                             name=f"encoder.down_blocks.{i}.downsamplers.0")
    mid = enc.mid_block
    h = resnet_block(mid.resnets[0], h, None, eps=1e-6, conv_fn=conv_fn,
                     name="encoder.mid_block.resnets.0", fused=fused)
    h = vae_attention(mid.attentions[0], h, int8=attn_int8, dense_fn=dense_fn,
                      name="encoder.mid_block.attentions.0")
    h = resnet_block(mid.resnets[1], h, None, eps=1e-6, conv_fn=conv_fn,
                     name="encoder.mid_block.resnets.1", fused=fused)
    h = _gn_silu_conv(h, enc.conv_norm_out, enc.conv_out, cfg.norm_num_groups, fused=fused)
    return conv1x1(h, vae.quant_conv.weight, vae.quant_conv.bias)


def vae_encode(vae: AutoencoderKL, x: torch.Tensor, conv_fn=None,
               attn_int8: bool = False, dense_fn=None, fused: bool = False) -> torch.Tensor:
    """Deterministic latent: posterior mean, scaled. (N, 3, H, W) -> (N, 4, h, w)."""
    moments = vae_encoder_apply(vae, x, conv_fn, attn_int8, dense_fn, fused)
    return moments[:, : vae.cfg.latent_channels] * vae.cfg.scaling_factor


def vae_decode(vae: AutoencoderKL, z: torch.Tensor, remat: bool = False, conv_fn=None,
               attn_int8: bool = False, dense_fn=None, fused: bool = False) -> torch.Tensor:
    """z: (N, 4, h, w) scaled latent -> (N, 3, 8h, 8w).

    remat=True (training, gradients flowing through the frozen decoder):
    each resnet block, the attention and each upsampler is checkpointed, so
    only block boundaries are saved for the backward, and the GroupNorm
    apply runs in the compute dtype, as the JAX package's decode under remat.
    conv_fn, attn_int8 and dense_fn: the int8 hooks, and fused the fused
    resblocks, as in vae_encoder_apply."""
    cfg, dec = vae.cfg, vae.decoder

    def ckpt(fn, *args, **kwargs):
        return checkpointed(fn, *args, **kwargs) if remat else fn(*args, **kwargs)

    def rb(p, h, name):
        return ckpt(resnet_block, p, h, None, eps=1e-6, native_norm=remat,
                    conv_fn=conv_fn, name=name, fused=fused)

    z = z / cfg.scaling_factor
    z = conv1x1(z, vae.post_quant_conv.weight, vae.post_quant_conv.bias)
    h = conv(dec.conv_in, z)
    mid = dec.mid_block
    h = rb(mid.resnets[0], h, "decoder.mid_block.resnets.0")
    h = ckpt(vae_attention, mid.attentions[0], h, int8=attn_int8, dense_fn=dense_fn,
             name="decoder.mid_block.attentions.0")
    h = rb(mid.resnets[1], h, "decoder.mid_block.resnets.1")
    for i, blk in enumerate(dec.up_blocks):
        for j, p in enumerate(blk.resnets):
            h = rb(p, h, f"decoder.up_blocks.{i}.resnets.{j}")
        if hasattr(blk, "upsamplers"):
            h = ckpt(upsample2d, blk.upsamplers[0], h, conv_fn=conv_fn,
                     name=f"decoder.up_blocks.{i}.upsamplers.0")
    return _gn_silu_conv(h, dec.conv_norm_out, dec.conv_out, cfg.norm_num_groups,
                         native_norm=remat, fused=fused)
