"""W8A8 conv3x3 with the input quantized in the kernel: the Hopper kernel K7
and its plain version.

Counterpart of ``genpercept_tpu/ops/quant_conv.py``. The kernel
(``csrc/quantized_conv3x3.cu``) replaces the TPU kernel ``_kernel``: it
quantizes the input tile per channel while staging it (symmetric,
clip(round(x * inv_a), -127, 127), round half to even), accumulates the nine
shifted-window int8 products in int32 and writes acc * o_scale + bias, cast
once to x's dtype. No code tensor, im2col or int32 product reaches device
memory. The plain version is ``quant.qconv_apply`` on the symmetric 3x3
stride-1 pad-1 ``QConv`` with the same operands; kernel and plain version
are bit-identical.

As in the TPU package, nothing routes to it: the int8 pipeline runs its
convolutions through ``quant.qconv_apply`` (the production default is
asymmetric, which this kernel does not take). Its one caller is
``scripts/profile_quant_conv_torch.py``. Inference only: on the card the
wrapper raises when an input requires grad under grad mode.
"""

from __future__ import annotations

import torch

from genpercept_tpu_torch import _build
from genpercept_tpu_torch.ops import _dispatch
from genpercept_tpu_torch.ops.fused_conv import _refuse_grad, _tap_major_weights
from genpercept_tpu_torch.ops.fused_ff import _bias_f32
from genpercept_tpu_torch.ops.quant import QConv, qconv_apply

_TH = 8  # the TPU kernel's stripe height; only ``supported`` reads it
_TW = 16  # the kernel's tile columns
_CL = 2  # CTAs of a cluster of the kernel, sharing every weight tap


def supported(x_shape, co: int, kind: str = "3x3", stride=1) -> bool:
    """The TPU package's predicate, read from an NCHW shape: stride-1 3x3,
    channels multiples of 128, height a multiple of 8 and >= 16, width a
    multiple of 8. The kernel itself takes any multiple of 64 channels, any
    height and a width whose rows are whole 16-byte units (a multiple of 8
    in bf16, of 4 in f32)."""
    n, c, h, w = x_shape
    return (kind == "3x3" and stride in (1, (1, 1)) and h % _TH == 0 and h >= 2 * _TH
            and c % 128 == 0 and co % 128 == 0 and w % 8 == 0)


def _tiling(co: int) -> tuple[int, int]:
    """The kernel's tile for Co output channels (``launch_for`` in
    csrc/quantized_conv3x3.cu): (BN output channels, MB m blocks of 64
    pixels a consumer warpgroup); a tile is 8 MB rows x 16 columns."""
    for bn, mb in ((256, 1), (128, 2), (160, 1), (64, 2)):
        if co % bn == 0:
            return bn, mb
    raise ValueError(f"quantized_conv3x3: no tile for {co} output channels")


def tile_walk(n: int, co: int, h: int, w: int, clusters: int):
    """The kernel's walk (``QTileOf``): for every unit each cluster takes, in
    its order, and each CTA of the cluster, (cluster, rank, image, first
    output channel, first row, first column, stored). A grid of ``clusters``
    clusters walks units v = cluster, cluster + clusters, ...: output
    channels (v % cblocks) BN.. of pixel tiles 2 (v // cblocks) and
    2 (v // cblocks) + 1 (columns first, then rows, then images); past the
    last tile a CTA takes the last tile and stores nothing."""
    bn, mb = _tiling(co)
    th = 8 * mb
    tiles_w, tiles_h = -(-w // _TW), -(-h // th)
    ntiles, cblocks = n * tiles_h * tiles_w, co // bn
    units = -(-ntiles // _CL) * cblocks
    for ci in range(clusters):
        for v in range(ci, units, clusters):
            for rank in range(_CL):
                px = v // cblocks * _CL + rank
                stored = px < ntiles
                px = min(px, ntiles - 1)
                yield (ci, rank, px // (tiles_h * tiles_w), v % cblocks * bn,
                       px // tiles_w % tiles_h * th, px % tiles_w * _TW, stored)


def weight_l2_bytes(n: int, c: int, co: int, h: int, w: int) -> int:
    """The weight bytes a call reads from L2, reckoned from the tiles: each
    unit of the walk (a cluster's pair of pixel tiles, one channel block)
    brings its 9 C BN weights once, by multicast to both CTAs."""
    bn, mb = _tiling(co)
    ntiles = n * -(-h // (8 * mb)) * -(-w // _TW)
    return -(-ntiles // _CL) * (co // bn) * 9 * c * bn


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data does not start on a 16-byte boundary."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _quantized_conv3x3_ref(x: torch.Tensor, w_int8: torch.Tensor, inv_a: torch.Tensor,
                           o_scale: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """Plain version: qconv_apply on the symmetric 3x3 stride-1 pad-1 QConv."""
    q = QConv(w_int8, inv_a.float(), o_scale.float(), None if bias is None else bias.float(),
              "3x3", (1, 1), ((1, 1), (1, 1)))
    return qconv_apply(q, x)


def quantized_conv3x3(x: torch.Tensor, w_int8: torch.Tensor, inv_a: torch.Tensor,
                      o_scale: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """K7. x: (N, C, H, W) f32/bf16; w_int8: (Co, C, 3, 3) int8 (the port's
    QConv layout); inv_a: (C,) f32 = 127/a; o_scale, bias: (Co,) f32 ->
    (N, Co, H, W) in x's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if not _dispatch.use_kernel(x):
        return _quantized_conv3x3_ref(x, w_int8, inv_a, o_scale, bias)
    _refuse_grad("quantized_conv3x3", x)
    n, c, h, w = x.shape
    co = w_int8.shape[0]
    code = _dispatch.dtype_code(x, "quantized_conv3x3")
    # TMA reads x's rows, and the kernel stores the output's, in 16-byte units
    if (w_int8.shape != (co, c, 3, 3) or w_int8.dtype != torch.int8 or c % 64 or co % 64
            or w % (16 // x.element_size()) or n > 65535
            or any(t.device != x.device for t in (w_int8, inv_a, o_scale))):
        raise ValueError(f"quantized_conv3x3: no kernel for x {tuple(x.shape)} {x.dtype}, "
                         f"w {tuple(w_int8.shape)} {w_int8.dtype}")
    wt = _tap_major_weights(w_int8)  # (9, Co, C)
    # TMA and the bulk copies read 16-byte-aligned rows and vectors
    xc, ia, osc, b = (_aligned16(t.contiguous()) for t in (
        x, inv_a.float(), o_scale.float(), _bias_f32(bias, co, x.device)))
    out = torch.empty((n, co, h, w), dtype=x.dtype, device=x.device)
    err = _build.load().quantized_conv3x3(
        xc.data_ptr(), ia.data_ptr(), wt.data_ptr(), osc.data_ptr(), b.data_ptr(),
        out.data_ptr(), n, c, co, h, w, code, _dispatch.stream_handle(x))
    _build.check(err, "quantized_conv3x3")
    quantized_conv3x3.launches += 1
    return out


quantized_conv3x3.launches = 0
