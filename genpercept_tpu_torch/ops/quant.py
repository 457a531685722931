"""W8A8 int8 quantization: calibration statistics, quantized convolutions
and dense layers, the calibration hooks, and the calibration file.

Counterpart of ``genpercept_tpu/ops/quant.py`` with the same algebra:

  activation: per-input-channel range (absmax / MSE clip, or an asymmetric
      [zp, a] pair); xq = clip(round((x - zp) * 127/a), -127, 127) int8
  weight:     w' = w * a[ci]/127 folded into the input axis, then
      per-output-channel s[co]; wq = clip(round(w'/s), -127, 127) int8
  output:     y = (xq . wq) * s[co] + bias     (int32 sums, f32 epilogue)
and, asymmetric, the zero-point constant sum(zp * w_hat) folded into bias.

Layouts are the port's: conv weights OIHW (a 4x4 kernel for the collapsed
upsampler), dense weights (out, in) as ``nn.Linear`` keeps them,
activations NCHW for convolutions and channels-last for dense layers.
``save_calibration`` and ``load_calibration`` read and write the JAX
package's ``.npz`` layout (HWIO conv weights, (in, out) dense weights), so
either package reads a file the other wrote.

The integer products run on ``torch._int_mm`` (int8 x int8 -> int32; cuBLASLt
on the card): PyTorch has no int8 convolution, so a convolution is an int8
im2col matrix times the weight matrix, taken in row chunks. The int32 sums
are exact, so they equal the JAX package's s8 convolution's. These are
library products, as the JAX package left them to XLA; the kernels of the
int8 path are K5 (``ops/fused_ff.py``) and K6 (``ops/flash_attention.py``).

GPTQ (``gptq_round``) rounds the weights with error compensation against
the calibrated code-domain input Gram of each layer (``conv_input_hessian``,
``dense_input_hessian``), calibration-time work in PyTorch; the
``make_fakequant_conv_fn`` hooks simulate one side of the quantization in
full precision, to attribute the int8 error to weights or activations.
"""

from __future__ import annotations

import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from genpercept_tpu_torch.ops.attention import attention_projection
from genpercept_tpu_torch.ops.conv import conv2d, nearest_up2_conv3x3

# Candidate clip fractions of the per-channel MSE-optimal scale search.
CLIP_CANDIDATES = (1.0, 0.9, 0.8, 0.7, 0.6, 0.5, 0.4)
# rows x inner width of one int8 im2col chunk (bytes): bounds the largest
# temporary of a quantized convolution
_IM2COL_BYTES = 1 << 28

Geometry = Tuple[Tuple[int, int], Tuple[Tuple[int, int], Tuple[int, int]]]


@dataclasses.dataclass
class QConv:
    """Quantized convolution: w_int8 (Co, Ci, kh, kw) int8 (4x4 for kind
    'up4x4'), inv_a (Ci,) f32 = 127/a, o_scale (Co,) f32, bias (Co,) f32 or
    None, zp (Ci,) f32 zero-point or None (symmetric); static geometry
    kind ('3x3' | 'up4x4'), stride (sh, sw), padding ((t, b), (l, r))."""

    w_int8: torch.Tensor
    inv_a: torch.Tensor
    o_scale: torch.Tensor
    bias: Optional[torch.Tensor]
    kind: str
    stride: Tuple[int, int]
    padding: Tuple[Tuple[int, int], Tuple[int, int]]
    zp: Optional[torch.Tensor] = None


@dataclasses.dataclass
class QDense:
    """Quantized linear layer: w_int8 (dout, din) int8, inv_a (din,) f32,
    o_scale (dout,) f32, bias (dout,) f32 or None, zp (din,) f32 or None."""

    w_int8: torch.Tensor
    inv_a: torch.Tensor
    o_scale: torch.Tensor
    bias: Optional[torch.Tensor]
    zp: Optional[torch.Tensor] = None


# ------------------------------------------------------- calibration stats
#
# Each takes channels-last x (..., C) and reduces over every other axis.


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.float().reshape(-1, x.shape[-1])


def absmax_per_channel(x: torch.Tensor) -> torch.Tensor:
    """Per-channel absolute max -> (C,) f32."""
    return _rows(x).abs().amax(dim=0)


def mse_optimal_clip(x: torch.Tensor) -> torch.Tensor:
    """Per-channel clip minimizing the symmetric int8 quantization MSE over
    CLIP_CANDIDATES fractions of absmax -> (C,) f32."""
    xf = _rows(x)
    a0 = xf.abs().amax(dim=0).clamp_min(1e-8)
    errs = []
    for frac in CLIP_CANDIDATES:
        s = (a0 * frac) / 127.0
        xq = torch.clamp(torch.round(xf / s), -127.0, 127.0) * s
        errs.append((xq - xf).square().mean(dim=0))
    best = torch.stack(errs).argmin(dim=0)
    fracs = torch.tensor(CLIP_CANDIDATES, dtype=torch.float32, device=x.device)
    return a0 * fracs[best]


def _lo_hi(xf: torch.Tensor):
    return xf.amin(dim=0).clamp_max(0.0), xf.amax(dim=0).clamp_min(0.0)


def _snap(z: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """(2, C) [zp, a] with zp moved so that real 0 encodes onto an integer."""
    q0 = torch.round(-z * 127.0 / a)
    return torch.stack([-q0 * a / 127.0, a])


def mse_optimal_clip_asym(x: torch.Tensor) -> torch.Tensor:
    """Asymmetric per-channel range -> (2, C) f32 [zp, a]: the MSE argmin over
    midpoint-shrink, hi-shrink and lo-shrink candidates of the range [lo, hi]
    (which holds 0), zp snapped so that 0 encodes exactly."""
    xf = _rows(x)
    lo, hi = _lo_hi(xf)
    z0 = (lo + hi) / 2.0
    a0 = ((hi - lo) / 2.0).clamp_min(1e-8)
    cands = []  # (zp, a, feasible)
    for frac in CLIP_CANDIDATES:
        a = a0 * frac
        cands.append((z0, a, a >= z0.abs() * (1.0 + 1.0 / 127.0)))
        if frac < 1.0:
            cands.append(((lo + hi * frac) / 2.0, ((hi * frac - lo) / 2.0).clamp_min(1e-8), None))
            cands.append(((lo * frac + hi) / 2.0, ((hi - lo * frac) / 2.0).clamp_min(1e-8), None))
    errs, zps, amps = [], [], []
    for zp_c, a_c, ok in cands:
        s = a_c / 127.0
        xq = zp_c + torch.clamp(torch.round((xf - zp_c) / s), -127.0, 127.0) * s
        err = (xq - xf).square().mean(dim=0)
        errs.append(err if ok is None else torch.where(ok, err, torch.inf))
        zps.append(zp_c)
        amps.append(a_c)
    best = torch.stack(errs).argmin(dim=0, keepdim=True)
    z = torch.stack(zps).gather(0, best)[0]
    a = torch.stack(amps).gather(0, best)[0]
    return _snap(z, a)


def minmax_asym(x: torch.Tensor) -> torch.Tensor:
    """Searchless asymmetric range -> (2, C) [zp, a], zp snapped."""
    lo, hi = _lo_hi(_rows(x))
    return _snap((lo + hi) / 2.0, ((hi - lo) / 2.0).clamp_min(1e-8))


def _calib_stat(x: torch.Tensor, clip_search: bool, asymmetric: bool) -> torch.Tensor:
    if asymmetric:
        return mse_optimal_clip_asym(x) if clip_search else minmax_asym(x)
    return mse_optimal_clip(x) if clip_search else absmax_per_channel(x)


def merge_stats(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Symmetric (C,) stats max-merge; asymmetric (2, C) [zp, a] stats merge
    by the union of the ranges [zp - a, zp + a]."""
    out = {}
    for k in a:
        sa, sb = a[k], b[k]
        if sa.ndim == 2:
            lo = torch.minimum(sa[0] - sa[1], sb[0] - sb[1])
            hi = torch.maximum(sa[0] + sa[1], sb[0] + sb[1])
            out[k] = torch.stack([(lo + hi) / 2.0, (hi - lo) / 2.0])
        else:
            out[k] = torch.maximum(sa, sb)
    return out


# the calibration record's entries that average over chunks
SIDE_CHANNELS = ("corr", "hess")


def _moved(tree, device: torch.device):
    """A tensor, or nested dicts of them, on ``device``."""
    if isinstance(tree, dict):
        return {k: _moved(v, device) for k, v in tree.items()}
    return tree.to(device)


def calibrate_chunked(calib_fn: Callable | Sequence[Callable], rgb: torch.Tensor, *extra,
                      chunk: int = 4):
    """Run calib_fn(rgb[lo:hi], *extra[lo:hi]) -> (pred, stats) over batch
    chunks and merge, as the JAX package does: range stats union across
    chunks; the side channels, bias-correction residuals ("corr") and GPTQ
    input Grams ("hess"), {group: {path: tensor}} each, average weighted by
    chunk size apart from the range merge; predictions concatenate. The
    merged stats depend on the chunking. extra tensors are sliced in step
    with rgb; None passes through.

    ``calib_fn`` may be a list, one function a device (data parallelism):
    the chunks then run in rounds, one a function, each round's functions
    at once in threads, and their results are moved to rgb's device and
    merged one at a time in the chunks' order, so the merged record is the
    one a single function gives over the same chunks."""
    fns = list(calib_fn) if isinstance(calib_fn, (list, tuple)) else [calib_fn]
    b = rgb.shape[0]
    chunk = max(1, min(chunk, b))

    def merge_val(x, y):
        if isinstance(x, dict):
            return merge_stats(x, y)
        return merge_stats({"_": x}, {"_": y})["_"]

    def run(i, lo):
        hi = min(lo + chunk, b)
        sliced = tuple(e[lo:hi] if isinstance(e, torch.Tensor) and e.ndim > 0 else e
                       for e in extra)
        return fns[i](rgb[lo:hi], *sliced)

    def results():
        """(lo, (pred, stats)) of every chunk, in order, on rgb's device."""
        starts = list(range(0, b, chunk))
        if len(fns) == 1:
            for lo in starts:
                yield lo, run(0, lo)
            return
        with ThreadPoolExecutor(max_workers=len(fns)) as pool:
            for r in range(0, len(starts), len(fns)):
                futures = [(lo, pool.submit(run, i, lo))
                           for i, lo in enumerate(starts[r:r + len(fns)])]
                for lo, fut in futures:
                    pred, stats = fut.result()
                    yield lo, (pred.to(rgb.device), _moved(stats, rgb.device))
                del futures

    preds, merged, n_images = [], None, 0
    sums: Dict[str, Dict] = {}
    for lo, (pred, stats) in results():
        hi = min(lo + chunk, b)
        preds.append(pred)
        sz = hi - lo
        n_images += sz
        for key in SIDE_CHANNELS:
            side = stats.pop(key, None)
            if side is None:
                continue
            side = {g: {k: v * sz for k, v in d.items()} for g, d in side.items()}
            sums[key] = side if key not in sums else {
                g: {k: sums[key][g][k] + side[g][k] for k in side[g]} for g in side}
        merged = stats if merged is None else {k: merge_val(merged[k], stats[k])
                                               for k in stats}
    out = dict(merged)
    for key, total in sums.items():
        out[key] = {g: {k: v / n_images for k, v in d.items()} for g, d in total.items()}
    pred = preds[0] if len(preds) == 1 else torch.cat(preds, dim=0)
    return pred, out


# ------------------------------------------------------------------- GPTQ


def _code_rows_bf16(xf: torch.Tensor, zp: Optional[torch.Tensor],
                    a: torch.Tensor) -> torch.Tensor:
    """Channels-last f32 activations -> their int8-domain codes (x - zp) *
    127/a, unclipped and unrounded, rounded to bf16 as the JAX package
    feeds its Gram products."""
    if zp is not None:
        xf = xf - zp
    return (xf * (127.0 / a)).to(torch.bfloat16)


def _gram(cols: torch.Tensor) -> torch.Tensor:
    """cols (n, d) bf16 -> cols^T cols in f32. Products of bf16 values are
    exact in f32 (and in TF32), so this is JAX's dot_general(bf16, bf16,
    preferred_element_type=f32) up to the order of the sums."""
    c = cols.float()
    return c.t() @ c


def conv_input_hessian(x: torch.Tensor, a_stat: torch.Tensor, *, stride=(1, 1),
                       padding=((1, 1), (1, 1))) -> torch.Tensor:
    """The GPTQ Hessian proxy H = sum c c^T of a 3x3 convolution's im2col'd
    input in the int8 code domain -> (9 Ci, 9 Ci) f32; x NCHW. Rows and
    columns run (kh * 3 + kw) * Ci + ci, the JAX package's order. The input
    is padded first, so that after the zero-point shift a pad position
    carries the code of real 0, as qconv_apply's padding does. Taken in row
    chunks of _IM2COL_BYTES."""
    zp, a = _split_stat(a_stat, 1.0)
    (pt, pb), (pl, pr) = padding
    xf = F.pad(x.float().permute(0, 2, 3, 1), (0, 0, pl, pr, pt, pb))
    xb = _code_rows_bf16(xf, zp, a)
    sh, sw = stride
    n, hp, wp, ci = xb.shape
    ho, wo = (hp - 3) // sh + 1, (wp - 3) // sw + 1
    d = 9 * ci
    h = torch.zeros((d, d), dtype=torch.float32, device=x.device)
    rows = max(1, min(ho, _IM2COL_BYTES // max(1, wo * d * 4)))
    for b in range(n):
        for h0 in range(0, ho, rows):
            h1 = min(ho, h0 + rows)
            cols = torch.stack(
                [xb[b, dh + h0 * sh:dh + (h1 - 1) * sh + 1:sh, dw:dw + (wo - 1) * sw + 1:sw]
                 for dh in range(3) for dw in range(3)], dim=2)  # (h, wo, 9, Ci)
            h += _gram(cols.reshape(-1, d))
    return h


def dense_input_hessian(x: torch.Tensor, a_stat: torch.Tensor) -> torch.Tensor:
    """Dense counterpart of conv_input_hessian: x (..., din) -> (din, din)."""
    zp, a = _split_stat(a_stat, 1.0)
    return _gram(_code_rows_bf16(_rows(x), zp, a))


@torch.no_grad()
def gptq_round(wf: torch.Tensor, o_scale: torch.Tensor, H: torch.Tensor,
               damp: float = 0.01) -> torch.Tensor:
    """GPTQ error-compensated rounding (Frantar et al. 2022) of the
    activation-folded weight wf (d, Co), rows the input dims, onto the
    per-output-channel grid o_scale -> int8 (d, Co). The JAX package's
    sequence in f32: H damped by damp * mean(diag H) + 1e-12, U the upper
    Cholesky factor of its inverse (H^-1 = U^T U), then row by row the
    nearest code q_i, the error (w_i - q_i o_scale) / u_ii folded into the
    rows not yet rounded, all in f32 but the inverse and its Cholesky
    factor, taken in float64. With H = I it is round-to-nearest."""
    d = wf.shape[0]
    w = wf.float().clone()
    s = o_scale.float()
    hf = H.float()
    hd = hf + (damp * hf.diagonal().mean() + 1e-12) * torch.eye(d, dtype=torch.float32,
                                                                 device=hf.device)
    # the inverse and its factor in float64: in f32 the card's inverse of
    # a 4608-row Gram is not positive-definite to working precision
    u = torch.linalg.cholesky(torch.linalg.inv(hd.double())).t().float()
    q = torch.empty_like(w)
    u_diag = torch.clamp(u.diagonal(), min=1e-12)
    for i in range(d):
        qi = torch.clamp(torch.round(w[i] / s), -127.0, 127.0)
        err = (w[i] - qi * s) / u_diag[i]
        # u[i, :i] is zero: the rows already rounded stay as they are
        w[i:] -= torch.outer(u[i, i:], err)
        q[i] = qi
    return q.to(torch.int8)


# ------------------------------------------------------------- quantizing


def _mse_optimal_clip_cols(wf: torch.Tensor) -> torch.Tensor:
    """Per-column clip minimizing int8 MSE of a (rows, Co) matrix -> (Co,)."""
    a0 = wf.abs().amax(dim=0).clamp_min(1e-12)
    errs = []
    for frac in CLIP_CANDIDATES:
        s = a0 * frac / 127.0
        wq = torch.clamp(torch.round(wf / s), -127.0, 127.0) * s
        errs.append((wq - wf).square().mean(dim=0))
    best = torch.stack(errs).argmin(dim=0)
    fracs = torch.tensor(CLIP_CANDIDATES, dtype=torch.float32, device=wf.device)
    return a0 * fracs[best]


def _norm_geometry(stride, padding) -> Geometry:
    if isinstance(stride, int):
        stride = (stride, stride)
    if isinstance(padding, int):
        padding = ((padding, padding), (padding, padding))
    elif isinstance(padding, tuple) and padding and not isinstance(padding[0], tuple):
        padding = (padding, padding)
    return tuple(stride), tuple(tuple(p) for p in padding)


def _collapse_up_kernel(w: torch.Tensor) -> torch.Tensor:
    """3x3 OIHW -> the 4x4 kernel that a 2x lhs-dilated input with padding 2
    needs for conv3x3(nearest_up2(x)): the separable row/column collapse."""
    r = torch.cat([w[:, :, :1], w[:, :, :1] + w[:, :, 1:2], w[:, :, 1:2] + w[:, :, 2:3],
                   w[:, :, 2:3]], dim=2)
    return torch.cat([r[..., :1], r[..., :1] + r[..., 1:2], r[..., 1:2] + r[..., 2:3],
                      r[..., 2:3]], dim=3)


def _split_stat(a_stat: torch.Tensor, margin: float):
    """A stat -> (zp | None, half-range a), a widened by margin around the
    midpoint and zp re-snapped so that real 0 still encodes exactly."""
    if a_stat.ndim == 2:
        zp = a_stat[0].float()
        a = (a_stat[1].float() * margin).clamp_min(1e-8)
        q0 = torch.round(-zp * 127.0 / a)
        return -q0 * a / 127.0, a
    return None, (a_stat.float() * margin).clamp_min(1e-8)


def _round_codes(wf: torch.Tensor, o_scale: torch.Tensor) -> torch.Tensor:
    """wf with its output channels on dim 0, o_scale (Co,) -> int8 codes."""
    s = o_scale.reshape((-1,) + (1,) * (wf.ndim - 1))
    return torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)


def quantize_conv(weight: torch.Tensor, bias: Optional[torch.Tensor], a_stat: torch.Tensor, *,
                  kind: str = "3x3", stride=1, padding=1, margin: float = 1.1,
                  weight_clip: bool = False, hess: Optional[torch.Tensor] = None) -> QConv:
    """QConv from an OIHW weight and a calibrated input stat ((C,) symmetric
    or (2, C) [zp, a]). up4x4 takes the covering symmetric range (the
    lhs-dilation zeros are algebraic zeros, so no zero-point folds there).
    hess (9 Ci, 9 Ci), the layer's code-domain input Gram: the weight
    rounds by gptq_round instead of to nearest (not for up4x4, whose
    collapsed kernel meets the dilation's zeros, which the Gram does not
    model)."""
    w = weight.float()
    if kind == "up4x4":
        w = _collapse_up_kernel(w)
    zp, a = _split_stat(a_stat, margin)
    if zp is not None and kind == "up4x4":
        a = (zp.abs() + a).clamp_min(1e-8)
        zp = None
    wf = w * (a / 127.0)[None, :, None, None]
    if weight_clip:
        clip = _mse_optimal_clip_cols(wf.permute(2, 3, 1, 0).reshape(-1, wf.shape[0]))
        o_scale = (clip / 127.0).clamp_min(1e-12)
    else:
        o_scale = (wf.abs().amax(dim=(1, 2, 3)) / 127.0).clamp_min(1e-12)
    if hess is not None and kind != "up4x4":
        # the (9 Ci, Co) matrix in conv_input_hessian's row order
        co, ci, kh, kw = wf.shape
        rows = wf.permute(2, 3, 1, 0).reshape(-1, co)
        wq = gptq_round(rows, o_scale, hess.to(wf.device)).reshape(kh, kw, ci, co)
        wq = wq.permute(3, 2, 0, 1).contiguous()
    else:
        wq = _round_codes(wf, o_scale)
    stride, padding = _norm_geometry(stride, padding)
    bias = None if bias is None else bias.float()
    if zp is not None:
        # the offset constant uses the QUANTIZED weight, so that weight
        # rounding cancels exactly: y = (sum xq*wq)*o_scale + sum zp*w_hat
        z_co = torch.einsum("oihw,i->o", wq.float(), zp * (127.0 / a)) * o_scale
        bias = z_co if bias is None else bias + z_co
    return QConv(wq, 127.0 / a, o_scale, bias, kind, stride, padding, zp)


def quantize_dense(weight: torch.Tensor, bias: Optional[torch.Tensor], a_stat: torch.Tensor, *,
                   margin: float = 1.1, weight_clip: bool = False,
                   hess: Optional[torch.Tensor] = None) -> QDense:
    """QDense from an (out, in) weight and a calibrated input stat; hess
    (din, din), the code-domain input Gram, rounds it by gptq_round."""
    w = weight.float()
    zp, a = _split_stat(a_stat, margin)
    wf = w * (a / 127.0)[None, :]
    if weight_clip:
        o_scale = (_mse_optimal_clip_cols(wf.t()) / 127.0).clamp_min(1e-12)
    else:
        o_scale = (wf.abs().amax(dim=1) / 127.0).clamp_min(1e-12)
    if hess is not None:
        wq = gptq_round(wf.t(), o_scale, hess.to(wf.device)).t().contiguous()
    else:
        wq = _round_codes(wf, o_scale)
    bias = None if bias is None else bias.float()
    if zp is not None:
        z_o = (wq.float() @ (zp * (127.0 / a))) * o_scale
        bias = z_o if bias is None else bias + z_o
    return QDense(wq, 127.0 / a, o_scale, bias, zp)


# --------------------------------------------------------------- applying


def quantize_activation(x: torch.Tensor, inv_a: torch.Tensor, zp: Optional[torch.Tensor],
                        dim: int = -1) -> torch.Tensor:
    """clip(round((x - zp) * inv_a), -127, 127) as int8, per channel along
    ``dim``, in f32 with one rounding per operation (round is half to even,
    as jnp.round)."""
    shape = [1] * x.ndim
    shape[dim] = -1
    xf = x.float()
    if zp is not None:
        xf = xf - zp.reshape(shape)
    return torch.clamp(torch.round(xf * inv_a.reshape(shape)), -127.0, 127.0).to(torch.int8)


def int8_matmul(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 times b_t (N, K) int8 transposed -> (M, N) int32, exact.
    On the card torch._int_mm needs M > 16 and K, N multiples of 8."""
    m, k = a.shape
    n = b_t.shape[0]
    if a.is_cuda and (m <= 16 or k % 8 or n % 8):
        raise ValueError(f"int8_matmul: no cuBLASLt int8 product for ({m}, {k}) x ({k}, {n})")
    return torch._int_mm(a, b_t.t())


def _epilogue(y32: torch.Tensor, o_scale: torch.Tensor, bias: Optional[torch.Tensor],
              dtype: torch.dtype) -> torch.Tensor:
    out = y32.float() * o_scale
    if bias is not None:
        out = out + bias
    return out.to(dtype)


def _conv_codes(xp: torch.Tensor, w_mat: torch.Tensor, taps, stride: Tuple[int, int],
                ho: int, wo: int) -> torch.Tensor:
    """Int8 convolution of the padded NHWC code tensor xp by im2col:
    taps [(dh, dw)] in w_mat's column order (tap-major, channel-minor),
    w_mat (Co, n_taps*Ci). Row chunks keep each im2col under _IM2COL_BYTES.
    -> (N, ho, wo, Co) int32."""
    n, _, _, ci = xp.shape
    sh, sw = stride
    k = len(taps) * ci
    out = torch.empty((n, ho, wo, w_mat.shape[0]), dtype=torch.int32, device=xp.device)
    rows = max(1, min(ho, _IM2COL_BYTES // max(1, wo * k)))
    for b in range(n):
        for h0 in range(0, ho, rows):
            h1 = min(ho, h0 + rows)
            cols = torch.stack(
                [xp[b, dh + h0 * sh:dh + (h1 - 1) * sh + 1:sh, dw:dw + (wo - 1) * sw + 1:sw]
                 for dh, dw in taps], dim=2)  # (h, wo, n_taps, Ci)
            out[b, h0:h1] = int8_matmul(cols.reshape(-1, k), w_mat).reshape(h1 - h0, wo, -1)
    return out


def _pad_codes(xq: torch.Tensor, padding, fill: Optional[torch.Tensor]) -> torch.Tensor:
    """NHWC int8 codes padded ((t, b), (l, r)) with the per-channel code
    ``fill`` (None: 0)."""
    (t, bm), (l, r) = padding
    n, h, w, c = xq.shape
    xp = torch.zeros((n, h + t + bm, w + l + r, c), dtype=torch.int8, device=xq.device)
    if fill is not None:
        xp[:] = fill
    xp[:, t:t + h, l:l + w] = xq
    return xp


def qconv_apply(q: QConv, x: torch.Tensor) -> torch.Tensor:
    """Quantize NCHW x per channel, int8 convolution, f32 epilogue -> NCHW
    in x's dtype. Asymmetric: the code tensor is padded with q0, the exact
    code of real 0, and convolved pad-free (JAX qconv_apply)."""
    xq = quantize_activation(x, q.inv_a, q.zp, dim=1).permute(0, 2, 3, 1)
    n, h, w, _ = xq.shape
    co = q.w_int8.shape[0]
    if q.kind == "up4x4":
        # the collapsed 4x4 kernel over a 2x lhs-dilated input, padding 2,
        # split by output phase: phase (a, b) meets only taps a, a+2 (rows)
        # and b, b+2 (columns), on rows i + (a + t) // 2 of the input padded
        # by one. The dilation zeros contribute nothing, so the int32 sums
        # are those of the dilated convolution.
        xp = _pad_codes(xq, ((1, 1), (1, 1)), None)
        y = torch.empty((n, 2 * h, 2 * w, co), dtype=torch.int32, device=x.device)
        for a in (0, 1):
            for b in (0, 1):
                th, tw = (a, a + 2), (b, b + 2)
                w_mat = q.w_int8[:, :, list(th)][:, :, :, list(tw)].permute(0, 2, 3, 1)
                taps = [((a + i) // 2, (b + j) // 2) for i in th for j in tw]
                y[:, a::2, b::2] = _conv_codes(xp, w_mat.reshape(co, -1), taps, (1, 1), h, w)
    else:
        fill = None
        if q.zp is not None:
            fill = torch.round(-q.zp * q.inv_a).to(torch.int8)
        xp = _pad_codes(xq, q.padding, fill)
        kh, kw = q.w_int8.shape[2:]
        sh, sw = q.stride
        ho = (xp.shape[1] - kh) // sh + 1
        wo = (xp.shape[2] - kw) // sw + 1
        w_mat = q.w_int8.permute(0, 2, 3, 1).reshape(co, -1)
        taps = [(dh, dw) for dh in range(kh) for dw in range(kw)]
        y = _conv_codes(xp, w_mat, taps, q.stride, ho, wo)
    out = _epilogue(y, q.o_scale, q.bias, x.dtype)
    return out.permute(0, 3, 1, 2).contiguous()


def qdense_apply(q: QDense, x: torch.Tensor) -> torch.Tensor:
    """Quantize x (..., din) per channel, int8 product, f32 epilogue."""
    xq = quantize_activation(x, q.inv_a, q.zp).reshape(-1, x.shape[-1])
    y = int8_matmul(xq, q.w_int8)
    return _epilogue(y, q.o_scale, q.bias, x.dtype).reshape(x.shape[:-1] + (-1,))


# ------------------------------------------------------------ the hooks
#
# The models take optional hooks for their quantizable layers:
#   conv_fn(name, weight, bias, x, *, kind="3x3", stride=1, padding=1) -> y
#   dense_fn(name, weight, bias, x) -> y
# with diffusers' dotted names (the JAX package's): x NCHW for conv_fn,
# channels-last for dense_fn.


def _fp_conv(weight, bias, x, kind, stride, padding):
    if kind == "up4x4":
        return nearest_up2_conv3x3(x, weight, bias)
    return conv2d(x, weight, bias, stride=stride, padding=padding)


def make_calib_conv_fn(stats: Dict[str, torch.Tensor], corr: Optional[Dict] = None,
                       clip_search: bool = False, margin: float = 1.1,
                       weight_clip: bool = False, asymmetric: bool = False,
                       hess: Optional[Dict] = None):
    """Records each conv input's stat into ``stats`` and runs the conv in full
    precision. With ``corr``, also quantizes the layer in place and records
    the per-output-channel mean of (y_fp - y_int8) for bias correction. With
    ``hess``, also records the input's code-domain Gram for GPTQ (not for
    up4x4): (9 Ci)^2 f32, 85 MB at the VAE's 512 channels."""

    def conv_fn(name, weight, bias, x, *, kind="3x3", stride=1, padding=1):
        a = _calib_stat(x.movedim(1, -1), clip_search, asymmetric)
        stats[name] = a
        y = _fp_conv(weight, bias, x, kind, stride, padding)
        if hess is not None and kind != "up4x4":
            st, pd = _norm_geometry(stride, padding)
            hess[name] = conv_input_hessian(x, a, stride=st, padding=pd)
        if corr is not None:
            q = quantize_conv(weight, bias, a, kind=kind, stride=stride, padding=padding,
                              margin=margin, weight_clip=weight_clip)
            corr[name] = (y - qconv_apply(q, x)).float().mean(dim=(0, 2, 3))
        return y

    return conv_fn


def make_quant_conv_fn(qtree: Dict[str, QConv]):
    """Convs in ``qtree`` run int8; the rest full precision."""

    def conv_fn(name, weight, bias, x, *, kind="3x3", stride=1, padding=1):
        q = qtree.get(name)
        if q is not None:
            return qconv_apply(q, x)
        return _fp_conv(weight, bias, x, kind, stride, padding)

    return conv_fn


def make_calib_dense_fn(stats: Dict[str, torch.Tensor], corr: Optional[Dict] = None,
                        clip_search: bool = False, margin: float = 1.1,
                        weight_clip: bool = False, asymmetric: bool = False,
                        hess: Optional[Dict] = None):
    """Dense counterpart of make_calib_conv_fn."""

    def dense_fn(name, weight, bias, x):
        a = _calib_stat(x, clip_search, asymmetric)
        stats[name] = a
        y = attention_projection(x, weight, bias)
        if hess is not None:
            hess[name] = dense_input_hessian(x, a)
        if corr is not None:
            q = quantize_dense(weight, bias, a, margin=margin, weight_clip=weight_clip)
            y_q = qdense_apply(q, x)
            corr[name] = (y - y_q).float().reshape(-1, y.shape[-1]).mean(dim=0)
        return y

    return dense_fn


def make_quant_dense_fn(qtree: Dict):
    """Dense layers in ``qtree`` run int8. The function carries ``qtree`` so
    that ``models/layers.py::feed_forward`` can send a fully quantized GEGLU
    feed-forward to the fused int8 kernel."""

    def dense_fn(name, weight, bias, x):
        q = qtree.get(name)
        if q is not None:
            return qdense_apply(q, x)
        return attention_projection(x, weight, bias)

    dense_fn.qtree = qtree
    return dense_fn


@torch.no_grad()
def apply_bias_correction(qtree: Dict, corr: Dict) -> Dict:
    """bias += E[y_fp - y_int8] for every layer with a recorded correction."""
    out: Dict = {}
    for k, q in qtree.items():
        c = corr.get(k)
        if c is None:
            out[k] = q
            continue
        c = c.float()
        out[k] = dataclasses.replace(q, bias=c if q.bias is None else q.bias + c)
    return out


@torch.no_grad()
def quantize_from_stats(model: torch.nn.Module, stats: Dict[str, torch.Tensor],
                        margin: float = 1.1, asymmetric_downsample: bool = True,
                        weight_clip: bool = False, hess: Optional[Dict] = None) -> Dict:
    """The {path: QConv | QDense} tree of every calibrated layer of ``model``.
    A path resolves with ``get_submodule``; a 2-D weight quantizes as a dense
    layer, and a ':h' / ':g' suffix picks the hidden / gate half of a GEGLU
    projection. Downsamplers are stride 2 (padding ((0,1),(0,1)) with
    ``asymmetric_downsample``, else 1), upsamplers the collapsed 4x4 kernel,
    everything else a stride-1, pad-1 3x3. ``hess`` {path: Gram}: those
    layers round by GPTQ, the rest to nearest."""
    hess = hess or {}
    qtree: Dict = {}
    for path, stat in stats.items():
        base, _, tag = path.partition(":")
        node = model.get_submodule(base)
        w, b = node.weight, node.bias
        kw = dict(margin=margin, weight_clip=weight_clip)
        if w.ndim == 2:
            if tag:
                inner = w.shape[0] // 2
                sl = slice(0, inner) if tag == "h" else slice(inner, None)
                w, b = w[sl], None if b is None else b[sl]
            qtree[path] = quantize_dense(w, b, stat, hess=hess.get(path), **kw)
        elif "downsamplers" in path:
            pad = ((0, 1), (0, 1)) if asymmetric_downsample else 1
            qtree[path] = quantize_conv(w, b, stat, stride=2, padding=pad, hess=hess.get(path),
                                        **kw)
        elif "upsamplers" in path:
            qtree[path] = quantize_conv(w, b, stat, kind="up4x4", **kw)
        else:
            qtree[path] = quantize_conv(w, b, stat, hess=hess.get(path), **kw)
    return qtree


# ------------------------------------------------- error-attribution hooks


def make_fakequant_conv_fn(qtree: Dict[str, QConv], side: str):
    """Full-precision convolutions with one side of the quantization
    simulated, to attribute the int8 error (a diagnostic, never the
    production path): side "w" runs the dequantized int8 weight, wq *
    o_scale * 127/a, on exact activations, its bias without the folded
    zero-point constant; "a" quantizes and dequantizes the activation per
    channel (shifted by zp) before the original weight; "wa" both, equal
    to qconv_apply up to the order of the sums. up4x4 runs the collapsed
    4x4 kernel over the 2x lhs-dilated input. Layers absent from qtree run
    untouched."""
    if side not in ("w", "a", "wa"):
        raise ValueError(f"side must be w, a or wa, not {side!r}")

    def conv_fn(name, weight, bias, x, *, kind="3x3", stride=1, padding=1):
        q = qtree.get(name)
        if q is None:
            return _fp_conv(weight, bias, x, kind, stride, padding)
        ch = (1, -1, 1, 1)
        if "a" in side:
            xf = x.float()
            if q.zp is not None:
                xf = xf - q.zp.reshape(ch)
            xf = torch.clamp(torch.round(xf * q.inv_a.reshape(ch)), -127.0, 127.0) \
                / q.inv_a.reshape(ch)
            if q.zp is not None:
                # zp is snapped so that real 0 round-trips: the float conv's
                # zero padding stays the int8 path's
                xf = xf + q.zp.reshape(ch)
            x = xf.to(x.dtype)
        if "w" in side:
            wq = q.w_int8.float()
            w = (wq * q.o_scale[:, None, None, None] * q.inv_a[None, :, None, None]).to(x.dtype)
            b = q.bias
            if q.zp is not None and b is not None:
                # q.bias holds sum(zp * w_hat); real activations go in here
                b = b - torch.einsum("oihw,i->o", wq, q.zp * q.inv_a) * q.o_scale
        else:
            w = weight if kind != "up4x4" else _collapse_up_kernel(weight.float()).to(x.dtype)
            b = bias
        b = None if b is None else b.to(x.dtype)
        if kind == "up4x4":
            # the 4x4 kernel over the input dilated by 2 and padded by 2 is
            # the transposed convolution of stride 2 and padding 1 with the
            # kernel flipped
            y = F.conv_transpose2d(x, w.to(x.dtype).flip(2, 3).transpose(0, 1),
                                   stride=2, padding=1)
            return y if b is None else y + b.reshape(ch)
        return conv2d(x, w, b, stride=q.stride, padding=q.padding)

    return conv_fn


# -------------------------------------------------------- calibration file


@torch.no_grad()
def save_calibration(path, vq: Dict[str, Dict]) -> None:
    """Write a {'enc'|'dec'|'unet': {path: QConv|QDense}} tree to one .npz in
    the JAX package's layout: '|'-joined keys, conv weights HWIO, dense
    weights (in, out), static conv geometry in a JSON __meta__ entry."""
    arrays: Dict[str, np.ndarray] = {}
    meta: Dict[str, dict] = {}
    for group, tree in vq.items():
        for name, q in tree.items():
            key = f"{group}|{name}"
            if isinstance(q, QConv):
                meta[key] = {"type": "conv", "kind": q.kind, "stride": list(q.stride),
                             "padding": [list(p) for p in q.padding]}
                w = q.w_int8.permute(2, 3, 1, 0)
            else:
                meta[key] = {"type": "dense"}
                w = q.w_int8.t()
            arrays[key + "|w"] = w.contiguous().cpu().numpy()
            arrays[key + "|a"] = q.inv_a.cpu().numpy()
            arrays[key + "|s"] = q.o_scale.cpu().numpy()
            if q.bias is not None:
                arrays[key + "|b"] = q.bias.cpu().numpy()
            if q.zp is not None:
                arrays[key + "|z"] = q.zp.cpu().numpy()
    np.savez(path, __meta__=json.dumps(meta), **arrays)


def load_calibration(path, device: torch.device | str = "cpu") -> Dict[str, Dict]:
    """Inverse of save_calibration, onto ``device``."""

    def t(a):
        return torch.as_tensor(np.asarray(a)).to(device)

    vq: Dict[str, Dict] = {}
    with np.load(path) as z:
        meta = json.loads(str(z["__meta__"]))
        for key, m in meta.items():
            group, name = key.split("|", 1)
            w = t(z[key + "|w"])
            a, s = t(z[key + "|a"]), t(z[key + "|s"])
            b = t(z[key + "|b"]) if key + "|b" in z else None
            zp = t(z[key + "|z"]) if key + "|z" in z else None
            if m["type"] == "conv":
                q = QConv(w.permute(3, 2, 0, 1).contiguous(), a, s, b, m["kind"],
                          tuple(m["stride"]), tuple(tuple(p) for p in m["padding"]), zp)
            else:
                q = QDense(w.t().contiguous(), a, s, b, zp)
            vq.setdefault(group, {})[name] = q
    return vq
