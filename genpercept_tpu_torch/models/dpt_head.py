"""DPT decode head on the UNet's up-block features, as an nn.Module (NCHW).

Counterpart of ``genpercept_tpu/models/dpt_head.py`` (the reference's
``DPTNeckHeadForUnetAfterUpsample[Identity]``, transformers' DPT neck and
head with the reassemble stage left out):

  input: the four up-block features reversed, finest first:
         [(320, H), (640, H), (1280, H/2), (1280, H/4)] for latent size H
  1. nearest x2 + 3x3 conv on feature 0 (Upsample2D)      -> (320, 2H)
  2. neck convs: a bias-free 3x3 per level to 256
  3. fusion stage, coarsest first: pre-activation residual units, x2
     bilinear (align_corners=True), 1x1 projection        -> (256, 8H)
  4. head: [3x3 projection + ReLU] -> 3x3 to 128 -> x2 bilinear
     (align_corners=True) -> 3x3 to 32 -> ReLU -> 1x1 to 1 -> final_act

Every variant of the JAX module: ``final_act`` relu, identity or
elu_plus_one; ``upsample_first_feature``; ``use_neck=False`` (four
bias-free 3x3 ``feature_adapt_conv_N`` in place of the neck, the head on
adapted[head_in_index]). State-dict keys are the published ones
(feature_upsample_0.conv, neck.convs.N, neck.fusion_stage.layers.N.
{projection, residual_layer1, residual_layer2}.{convolution1, convolution2},
head.projection, head.head.{0,2,4}).
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from genpercept_tpu_torch.models.layers import conv, init_params_
from genpercept_tpu_torch.ops.conv import conv1x1, nearest_up2_conv3x3
from genpercept_tpu_torch.ops.resize import resize_bilinear_align_corners


@dataclasses.dataclass(frozen=True)
class DPTHeadConfig:
    neck_hidden_sizes: tuple = (320, 640, 1280, 1280)
    fusion_hidden_size: int = 256
    add_projection: bool = True
    head_in_index: int = -1
    final_act: str = "relu"  # "relu" | "identity" | "elu_plus_one"
    upsample_first_feature: bool = True
    use_neck: bool = True


DPT_GENERAL = DPTHeadConfig()
DPT_IDENTITY = DPTHeadConfig(final_act="identity")
DPT_ELU = DPTHeadConfig(final_act="elu_plus_one")


class _ConvHolder(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3)


class _ResidualUnit(nn.Module):
    def __init__(self, f: int):
        super().__init__()
        self.convolution1 = nn.Conv2d(f, f, 3)
        self.convolution2 = nn.Conv2d(f, f, 3)


class _FusionLayer(nn.Module):
    def __init__(self, f: int, first: bool):
        super().__init__()
        self.projection = nn.Conv2d(f, f, 1)
        if not first:
            self.residual_layer1 = _ResidualUnit(f)
        self.residual_layer2 = _ResidualUnit(f)


class _FusionStage(nn.Module):
    def __init__(self, f: int, n: int):
        super().__init__()
        self.layers = nn.ModuleList([_FusionLayer(f, i == 0) for i in range(n)])


class _Neck(nn.Module):
    def __init__(self, sizes: tuple, f: int):
        super().__init__()
        self.convs = nn.ModuleList([nn.Conv2d(c, f, 3, bias=False) for c in sizes])
        self.fusion_stage = _FusionStage(f, len(sizes))


class _Head(nn.Module):
    def __init__(self, f: int, add_projection: bool):
        super().__init__()
        if add_projection:
            self.projection = nn.Conv2d(f, f, 3)
        self.head = nn.ModuleDict({"0": nn.Conv2d(f, f // 2, 3),
                                   "2": nn.Conv2d(f // 2, 32, 3),
                                   "4": nn.Conv2d(32, 1, 1)})


class DPTHead(nn.Module):
    def __init__(self, cfg: DPTHeadConfig = DPT_GENERAL):
        super().__init__()
        self.cfg = cfg
        sizes, f = cfg.neck_hidden_sizes, cfg.fusion_hidden_size
        if cfg.use_neck:
            self.neck = _Neck(sizes, f)
        else:
            for i, c in enumerate(sizes):
                self.add_module(f"feature_adapt_conv_{i}", nn.Conv2d(c, f, 3, bias=False))
        if cfg.upsample_first_feature:
            self.feature_upsample_0 = _ConvHolder(sizes[0], sizes[0])
        self.head = _Head(f, cfg.add_projection)


def init_dpt_head(generator: torch.Generator | None, cfg: DPTHeadConfig = DPT_GENERAL,
                  device=None, dtype=torch.float32) -> DPTHead:
    """A fresh head with the JAX package's scheme (``init_dpt_head``,
    ``conv_init``): every weight uniform in +-1/sqrt(fan_in), biases zero,
    drawn from ``generator`` (on ``device``); equal to JAX's in
    distribution, not in value."""
    with torch.device("meta"):
        head = DPTHead(cfg)
    return init_params_(head.to(dtype).to_empty(device=device or "cpu"), generator)


def _up2_align_corners(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear resize with align_corners=True on NCHW."""
    h, w = x.shape[2:]
    y = resize_bilinear_align_corners(x.permute(0, 2, 3, 1), (2 * h, 2 * w))
    return y.permute(0, 3, 1, 2)


def _preact_residual(p: _ResidualUnit, x: torch.Tensor) -> torch.Tensor:
    h = conv(p.convolution1, F.relu(x))
    return x + conv(p.convolution2, F.relu(h))


def _fusion_layer(p: _FusionLayer, x: torch.Tensor,
                  residual: torch.Tensor | None) -> torch.Tensor:
    if residual is not None:
        x = x + _preact_residual(p.residual_layer1, residual)
    x = _up2_align_corners(_preact_residual(p.residual_layer2, x))
    return conv1x1(x, p.projection.weight, p.projection.bias)


def dpt_head_apply(head: DPTHead, hidden_states: List[torch.Tensor]) -> torch.Tensor:
    """hidden_states: four NCHW features, finest first (the UNet's
    ``return_features`` reversed). Returns (B, 8 H_latent, 8 W_latent)."""
    cfg = head.cfg
    if len(hidden_states) != len(cfg.neck_hidden_sizes):
        raise ValueError(f"{len(hidden_states)} features for "
                         f"{len(cfg.neck_hidden_sizes)} neck levels")
    hs = list(hidden_states)
    if cfg.upsample_first_feature:
        c = head.feature_upsample_0.conv
        hs[0] = nearest_up2_conv3x3(hs[0], c.weight, c.bias)

    if cfg.use_neck:
        feats = [conv(m, h) for m, h in zip(head.neck.convs, hs)][::-1]
        layers = head.neck.fusion_stage.layers
        fused = _fusion_layer(layers[0], feats[0], None)
        outputs = [fused]
        for layer, feat in zip(layers[1:], feats[1:]):
            fused = _fusion_layer(layer, fused, feat)
            outputs.append(fused)
    else:
        outputs = [conv(getattr(head, f"feature_adapt_conv_{i}"), h)
                   for i, h in enumerate(hs)]

    h = outputs[cfg.head_in_index]
    p = head.head
    if cfg.add_projection:
        h = F.relu(conv(p.projection, h))
    h = _up2_align_corners(conv(p.head["0"], h))
    h = F.relu(conv(p.head["2"], h))
    h = conv1x1(h, p.head["4"].weight, p.head["4"].bias)
    if cfg.final_act == "relu":
        h = F.relu(h)
    elif cfg.final_act == "elu_plus_one":
        h = F.elu(h) + 1.0
    elif cfg.final_act != "identity":
        raise ValueError(f"final_act={cfg.final_act!r}")
    return h[:, 0]
