"""Predictor API on PyTorch: the torch.hub-style interface of GenPercept v1.

Counterpart of ``genpercept_tpu/hub.py``: task-named constructors returning
a predictor with ``infer_pil`` (PIL in), ``infer_cv2`` (BGR uint8 in) and
``infer_rgb``, with the HWC3 conversion and the resize to a multiple of 64.
The JAX module resizes with cv2; here both resizes are torch with cv2's
semantics: LANCZOS4 going up and AREA going down on uint8 (fixed-point
coefficients, saturated), and INTER_LINEAR on the float32 prediction going
back. Loads local checkpoint directories; runs on the card unless the caller
asks for the CPU.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from genpercept_tpu_torch.ops.resize import resize_linear_halfpixel

# cv2's fixed-point resize of uint8: coefficients scaled by 2^11, two passes
COEF_BITS = 11
COEF_SCALE = 1 << COEF_BITS
_DBL_EPS = 2.220446049250313e-16


def _hwc3(x: np.ndarray) -> np.ndarray:
    """Grayscale/alpha -> 3-channel (hubconf.py:16-30 semantics)."""
    if x.ndim == 2:
        x = x[:, :, None]
    if x.shape[2] == 1:
        x = np.repeat(x, 3, axis=2)
    elif x.shape[2] == 4:
        rgb = x[..., :3].astype(np.float32)
        a = x[..., 3:4].astype(np.float32) / 255.0
        x = (rgb * a + 255.0 * (1.0 - a)).astype(np.uint8)
    return x


def _lanczos4(fx: float) -> list:
    """cv2's interpolateLanczos4: the 8 taps' weights at fraction fx,
    normalized in float32."""
    s45 = 0.70710678118654752440084436210485
    cs = ((1, 0), (-s45, -s45), (0, 1), (s45, -s45), (-1, 0), (s45, s45), (0, -1), (-s45, s45))
    y0 = -(fx + 3) * math.pi * 0.25
    s0, c0 = math.sin(y0), math.cos(y0)
    coeffs, total = [], np.float32(0.0)
    for i in range(8):
        yi = np.float32(fx + 3 - i)
        if abs(yi) >= 1e-6:
            y = -float(yi) * math.pi * 0.25
            coeffs.append(np.float32((cs[i][0] * s0 + cs[i][1] * c0) / (y * y)))
        else:
            coeffs.append(np.float32(1e30))
        total = np.float32(total + coeffs[-1])  # summed in order, in float32
    inv = np.float32(1.0) / total
    return [np.float32(c * inv) for c in coeffs]


def _area_grow_taps(n_in: int, n_out: int) -> tuple:
    """cv2's INTER_AREA on an axis that grows: two linear taps per output
    pixel at cv2's area positions, (left index, its weight, right weight)
    in 2^11, the right tap clamped to the edge."""
    inv_scale = n_out / n_in
    scale = 1.0 / inv_scale  # as cv2 holds it, not n_in / n_out
    lo, b0, b1 = [], [], []
    for dx in range(n_out):
        sx = math.floor(dx * scale)
        fx = np.float32((dx + 1) - (sx + 1) * inv_scale)
        fx = np.float32(0.0) if fx <= 0 else np.float32(fx - math.floor(fx))
        lo.append(min(sx, n_in - 1))
        b0.append(int(np.rint((np.float32(1.0) - fx) * COEF_SCALE)))
        b1.append(int(np.rint(fx * COEF_SCALE)))
    return np.asarray(lo), np.asarray(b0, np.int64), np.asarray(b1, np.int64)


def _fixed_taps(n_in: int, n_out: int, lanczos: bool) -> torch.Tensor:
    """(n_in, n_out) weights in 2^11 of cv2's generic resize of uint8 along
    one axis (the horizontal pass): LANCZOS4, 8 taps at float32((i + 0.5) *
    scale - 0.5), or INTER_AREA on a growing axis (``_area_grow_taps``; the last
    input column alone at the right edge); taps past the border clamp to
    the edge."""
    mat = np.zeros((n_in, n_out), np.int64)
    if lanczos:
        scale = 1.0 / (n_out / n_in)
        for dx in range(n_out):
            f = np.float32((dx + 0.5) * scale - 0.5)
            sx = math.floor(f)
            for k, c in enumerate(_lanczos4(float(f - np.float32(sx)))):
                mat[min(max(sx - 3 + k, 0), n_in - 1), dx] += int(np.rint(c * COEF_SCALE))
        return torch.from_numpy(mat)
    lo, b0, b1 = _area_grow_taps(n_in, n_out)
    for dx in range(n_out):
        if lo[dx] >= n_in - 1:
            mat[n_in - 1, dx] += COEF_SCALE
        else:
            mat[lo[dx], dx] += b0[dx]
            mat[lo[dx] + 1, dx] += b1[dx]
    return torch.from_numpy(mat)


def _area_taps(n_in: int, n_out: int) -> tuple:
    """cv2's INTER_AREA on a shrinking axis (computeResizeAreaTab): each
    output pixel the mean of the input interval it covers, the boundary
    pixels weighted by the fraction covered. Returns (index, weight)
    arrays of shape (n_out, taps) in cv2's order, padded with weight 0."""
    scale = 1.0 / (n_out / n_in)
    taps = []
    for dx in range(n_out):
        f1 = dx * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, n_in - 1)
        s1 = min(s1, s2)
        row = []
        if s1 - f1 > 1e-3:
            row.append((s1 - 1, (s1 - f1) / cell))
        row += [(sx, 1.0 / cell) for sx in range(s1, s2)]
        if f2 - s2 > 1e-3:
            row.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        taps.append(row)
    width = max(len(r) for r in taps)
    idx = np.zeros((n_out, width), np.int64)
    wt = np.zeros((n_out, width), np.float32)
    for dx, row in enumerate(taps):
        for t, (sx, a) in enumerate(row):
            idx[dx, t], wt[dx, t] = sx, a
    return torch.from_numpy(idx), torch.from_numpy(wt)


def _area_shrink(src: torch.Tensor, out_hw) -> torch.Tensor:
    """cv2's resizeArea of an (H, W, C) image in float32, its sums in its
    order: each row's taps across, then the rows' weighted sums down."""
    xi, xw = _area_taps(src.shape[1], out_hw[1])
    yi, yw = _area_taps(src.shape[0], out_hw[0])
    rows = torch.zeros((src.shape[0], out_hw[1], src.shape[2]), dtype=torch.float32)
    for t in range(xi.shape[1]):
        rows = rows + src[:, xi[:, t]] * xw[None, :, t, None]
    out = torch.zeros((out_hw[0],) + rows.shape[1:], dtype=torch.float32)
    for t in range(yi.shape[1]):
        out = out + rows[yi[:, t]] * yw[:, t, None, None]
    return out


def _resize_uint8(x: np.ndarray, out_hw, lanczos: bool) -> np.ndarray:
    """cv2.resize of an (H, W, C) uint8 image with INTER_LANCZOS4 or
    INTER_AREA, in torch on the host."""
    h, w = x.shape[:2]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x.copy()
    src = torch.from_numpy(np.asarray(x, np.float64))
    if not lanczos and oh <= h and ow <= w:
        # both axes shrink: means over the covered input (cv2's area path);
        # at integer factors (as cv2 tells them) box sums
        sy, sx = 1.0 / (oh / h), 1.0 / (ow / w)
        if abs(sy - round(sy)) < _DBL_EPS and abs(sx - round(sx)) < _DBL_EPS:
            ky, kx = round(sy), round(sx)
            sums = src.reshape(oh, ky, ow, kx, -1).sum(dim=(1, 3))
            if (ky, kx) == (2, 2):  # its vector path: (sum + 2) >> 2
                return ((sums + 2).floor_divide(4)).to(torch.uint8).numpy()
            out = sums.float() * np.float32(1.0 / (ky * kx))
        else:
            out = _area_shrink(src.float(), (oh, ow))
        return torch.round(out).clamp(0, 255).to(torch.uint8).numpy()
    # the generic path: integer taps in 2^11 per axis (sums exact in float64)
    rows = torch.einsum("hwc,wo->hoc", src, _fixed_taps(w, ow, lanczos).double())
    if lanczos:  # the vertical taps alike, then (sum + 2^21) >> 22, saturated
        out = torch.einsum("hoc,hp->poc", rows, _fixed_taps(h, oh, True).double())
        out = torch.floor((out + (1 << (2 * COEF_BITS - 1))) / (1 << (2 * COEF_BITS)))
        return out.clamp(0, 255).to(torch.uint8).numpy()
    # cv2's two-row vertical pass of uint8: (((b0 * (r0 >> 4)) >> 16) +
    # ((b1 * (r1 >> 4)) >> 16) + 2) >> 2, the second row clamped to the edge
    lo, b0, b1 = _area_grow_taps(h, oh)
    r = rows.to(torch.int64) >> 4
    r0, r1 = r[torch.from_numpy(lo)], r[torch.from_numpy(np.minimum(lo + 1, h - 1))]
    b0, b1 = torch.from_numpy(b0)[:, None, None], torch.from_numpy(b1)[:, None, None]
    out = (((b0 * r0) >> 16) + ((b1 * r1) >> 16) + 2) >> 2
    return out.clamp(0, 255).to(torch.uint8).numpy()


def _resize_multiple_of_64(x: np.ndarray, resolution: int) -> np.ndarray:
    h, w = x.shape[:2]
    k = resolution / min(h, w)
    nh = int(np.round(h * k / 64.0)) * 64
    nw = int(np.round(w * k / 64.0)) * 64
    return _resize_uint8(x, (nh, nw), lanczos=k > 1)


class BasePredictor:
    """One checkpoint's pipeline at the input's own resolution (processing_res
    0) after the resize to a multiple of 64; the prediction is resized back
    to the input's size. Runs on ``device``, the card unless the caller asks
    for the CPU; without a card the default raises."""

    def __init__(self, checkpoint_dir: str, mode: str, resolution: int = 512,
                 half_precision: bool = True, device: torch.device | str = "cuda"):
        from genpercept_tpu_torch.io.checkpoints import load_genpercept_checkpoint
        from genpercept_tpu_torch.pipeline import GenPerceptPipeline, PipelineConfig

        dtype = torch.bfloat16 if half_precision else torch.float32
        models = load_genpercept_checkpoint(checkpoint_dir, dtype=dtype, device=device)
        self.mode = mode
        self.resolution = resolution
        self.pipe = GenPerceptPipeline(
            models, PipelineConfig(mode=mode, processing_res=0, dtype=dtype), device=device)

    def infer_pil(self, image, image_resolution: Optional[int] = None) -> np.ndarray:
        return self.infer_rgb(np.asarray(image.convert("RGB")), image_resolution)

    def infer_cv2(self, image: np.ndarray, image_resolution: Optional[int] = None) -> np.ndarray:
        return self.infer_rgb(image[..., ::-1], image_resolution)

    def infer_rgb(self, rgb: np.ndarray, image_resolution: Optional[int] = None) -> np.ndarray:
        rgb = _hwc3(np.asarray(rgb, np.uint8))
        h, w = rgb.shape[:2]
        x = _resize_multiple_of_64(rgb, image_resolution or self.resolution)
        out = self.pipe(x, color_map=None)
        pred = torch.from_numpy(np.asarray(out.pred_np, np.float32))
        pred = resize_linear_halfpixel(pred.reshape(pred.shape[:2] + (-1,))[None], (h, w))[0]
        pred = pred.reshape((h, w) + tuple(out.pred_np.shape[2:])).numpy()
        if self.mode == "normal":
            # norm_to_rgb (v1 pipeline_genpercept.py:241-257): [-1,1] -> uint8
            n = pred * 2.0 - 1.0
            n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-8)
            return ((n + 1.0) * 0.5 * 255.0).astype(np.uint8)
        return pred


def GenPercept_Depth(local_file_path: str, **kw) -> BasePredictor:
    return BasePredictor(local_file_path, "depth", **kw)


def GenPercept_Normal(local_file_path: str, **kw) -> BasePredictor:
    return BasePredictor(local_file_path, "normal", **kw)


def GenPercept_Segmentation(local_file_path: str, **kw) -> BasePredictor:
    return BasePredictor(local_file_path, "seg", **kw)


def GenPercept_Matting(local_file_path: str, **kw) -> BasePredictor:
    return BasePredictor(local_file_path, "matting", **kw)


def GenPercept_Disparity(local_file_path: str, **kw) -> BasePredictor:
    return BasePredictor(local_file_path, "disparity", **kw)
