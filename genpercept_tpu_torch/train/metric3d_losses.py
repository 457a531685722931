"""Metric3D-family losses: VNL, HDNL and HDSNL.

Counterpart of ``genpercept_tpu/train/metric3d_losses.py`` (rebuilds of the
reference's ``VNL``, ``HDNL_random`` and ``HDSNL_random``) with static
shapes: masked reductions and sort-based lower medians instead of dynamic
selections.

- VNL (virtual normal): back-project depth with the camera intrinsics,
  sample point triplets over valid pixels (with replacement), compare the
  unit normals of the GT and predicted triangles; degenerate, near and
  collinear triplets filtered by the reference's thresholds; the lowest 25%
  of the surviving groups dropped.
- HDSNL: SSI-MAE inside ``random_num`` random crop windows (one set shared
  across the batch) and the whole image, over the total valid count.
- HDNL: SSI-MAE inside ``random_num`` random depth-range bands of the GT.

Each loss is a draw (``*_draw``: a ``torch.Generator`` -> indices, windows
or uniforms) and a core (``*_core``: the loss of those draws); ``vnl_loss``,
``hdnl_random_loss`` and ``hdsnl_random_loss`` chain the two. Each core
divides by the global batch's count (``parallel.global_sum``), as the
losses of ``train/losses.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from genpercept_tpu_torch.parallel import global_sum

_EPS = 1e-6
_BIG = 3.0e38


def _gdev(generator: Optional[torch.Generator]):
    return generator.device if generator is not None else None


def masked_lower_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The lower median over masked elements of the last axis (index
    (k - 1) // 2 of the k sorted valid entries); 0 where the mask is empty.
    Differentiable through the sort."""
    n_valid = mask.sum(-1)
    xs = torch.sort(torch.where(mask, x, torch.full_like(x, _BIG)), dim=-1).values
    idx = torch.clamp(torch.div(n_valid - 1, 2, rounding_mode="floor"), 0, x.shape[-1] - 1)
    med = torch.gather(xs, -1, idx[..., None])[..., 0]
    return torch.where(n_valid > 0, med, torch.zeros_like(med))


def ssi_mae_sum(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                mad_masked_gt: bool = True) -> torch.Tensor:
    """Per leading index, the sum over the mask of |gt_trans - pred_trans|
    with median/MAD normalization. pred/target/mask: (..., H, W), broadcast
    against each other; returns (...). ``mad_masked_gt=False`` is HDSNL's
    ssi_mae: the MAD sums |t - med| over every pixel, over the valid count."""
    shape = torch.broadcast_shapes(pred.shape, target.shape, mask.shape)
    lead = shape[:-2]
    pf = pred.expand(shape).reshape(lead + (-1,))
    tf = target.expand(shape).reshape(lead + (-1,))
    mf = mask.expand(shape).reshape(lead + (-1,))
    valid = mf.sum(-1) + _EPS
    mff = mf.to(pf.dtype)

    def trans(v):
        med = masked_lower_median(v, mf)
        diff = torch.abs(v - med[..., None])
        if mad_masked_gt:
            diff = diff * mff
        s = diff.sum(-1) / valid
        return (v - med[..., None]) / (s[..., None] + _EPS)

    return torch.sum(torch.abs(trans(tf) - trans(pf)) * mff, dim=-1)


# ------------------------------------------------------------------ HDSNL

def hdsnl_draw(generator: Optional[torch.Generator], h: int, w: int,
               random_num: int = 32) -> Tuple[torch.Tensor, ...]:
    """(crop h, crop w, y0, x0), each (random_num,) int64: the windows'
    sizes in [h/8, h/2) and [w/8, w/2), origins below h - h/8 and w - w/8."""
    g, dev = generator, _gdev(generator)
    lo_h, lo_w = int(0.125 * h), int(0.125 * w)
    ch = torch.randint(lo_h, max(int(0.5 * h), lo_h + 1), (random_num,), generator=g, device=dev)
    cw = torch.randint(lo_w, max(int(0.5 * w), lo_w + 1), (random_num,), generator=g, device=dev)
    y0 = torch.randint(0, max(h - lo_h, 1), (random_num,), generator=g, device=dev)
    x0 = torch.randint(0, max(w - lo_w, 1), (random_num,), generator=g, device=dev)
    return ch, cw, y0, x0


def rect_masks(windows, h: int, w: int, device=None) -> torch.Tensor:
    """(N, H, W) bool crop masks of the drawn windows."""
    ch, cw, y0, x0 = (v.to(device) for v in windows)
    y1, x1 = torch.clamp(y0 + ch, max=h), torch.clamp(x0 + cw, max=w)
    ys = torch.arange(h, device=device)[None, :, None]
    xs = torch.arange(w, device=device)[None, None, :]
    return ((ys >= y0[:, None, None]) & (ys < y1[:, None, None])
            & (xs >= x0[:, None, None]) & (xs < x1[:, None, None]))


def hdsnl_core(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor, windows,
               loss_weight: float = 1.0) -> torch.Tensor:
    """HDSNRandomLoss of (B, H, W) inputs on the drawn windows."""
    b, h, w = pred.shape
    crops = rect_masks(windows, h, w, pred.device)
    masks = mask[:, None] & crops[None]  # (B, N, H, W)
    loss = ssi_mae_sum(pred[:, None], target[:, None], masks, mad_masked_gt=False).sum()
    valid_pix = masks.sum()
    loss = loss + ssi_mae_sum(pred, target, mask, mad_masked_gt=False).sum()
    valid_pix = valid_pix + mask.sum()
    return loss / (global_sum(valid_pix) + _EPS) * loss_weight


def hdsnl_random_loss(pred, target, mask, generator=None, random_num: int = 32,
                      loss_weight: float = 1.0) -> torch.Tensor:
    windows = hdsnl_draw(generator, pred.shape[1], pred.shape[2], random_num)
    return hdsnl_core(pred, target, mask, windows, loss_weight)


# ------------------------------------------------------------------- HDNL

def hdnl_draw(generator: Optional[torch.Generator], b: int,
              random_num: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u1, u2), each (B, random_num) uniform in [0, 1): a band's start and
    width fractions per image."""
    g, dev = generator, _gdev(generator)
    u1 = torch.rand((b, random_num), generator=g, device=dev)
    u2 = torch.rand((b, random_num), generator=g, device=dev)
    return u1, u2


def hdnl_core(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor, uniforms,
              loss_weight: float = 1.0) -> torch.Tensor:
    """HDNRandomLoss of (B, H, W) inputs on the drawn uniforms: bands
    [lo, hi) of each image's valid GT range."""
    u1, u2 = (u.to(pred.device) for u in uniforms)
    big = torch.tensor(_BIG, dtype=target.dtype, device=target.device)
    has_valid = mask.flatten(1).any(1)
    max_d = torch.where(mask, target, -big).flatten(1).amax(1)
    min_d = torch.where(mask, target, big).flatten(1).amin(1)
    max_d = torch.where(has_valid, max_d, torch.zeros_like(max_d))[:, None]
    min_d = torch.where(has_valid, min_d, torch.zeros_like(min_d))[:, None]
    u1 = u1 * 0.75
    lo = u1 * (max_d - min_d) + min_d
    frac = u1 + 0.1 + u2 * torch.clamp(1.0 - _EPS - (u1 + 0.1), min=0.0)
    hi = frac * (max_d - min_d) + min_d
    t = target[:, None]
    bands = (t >= lo[..., None, None]) & (t < hi[..., None, None] + 1e-30) & mask[:, None]
    loss = ssi_mae_sum(pred[:, None], t, bands, mad_masked_gt=True).sum()
    return loss / (global_sum(bands.sum()) + _EPS) * loss_weight


def hdnl_random_loss(pred, target, mask, generator=None, random_num: int = 32,
                     loss_weight: float = 1.0) -> torch.Tensor:
    return hdnl_core(pred, target, mask, hdnl_draw(generator, pred.shape[0], random_num),
                     loss_weight)


# -------------------------------------------------------------------- VNL

def backproject(depth: torch.Tensor, intrinsic: torch.Tensor) -> torch.Tensor:
    """depth (B, H, W), intrinsic (B, 3, 3) -> points (B, H, W, 3); fx scales
    both axes, as the reference's."""
    b, h, w = depth.shape
    fx = intrinsic[:, 0, 0, None, None]
    u0 = intrinsic[:, 0, 2, None, None]
    v0 = intrinsic[:, 1, 2, None, None]
    ys = torch.arange(h, dtype=depth.dtype, device=depth.device)[None, :, None]
    xs = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, None, :]
    x = (xs - u0) * depth / fx
    y = (ys - v0) * depth / fx
    return torch.stack([x, y, depth], dim=-1)


def vnl_draw(generator: Optional[torch.Generator], mask: torch.Tensor,
             sample_ratio: float = 0.15) -> torch.Tensor:
    """(B, n, 3) flat pixel indices, n = int(0.15 H W): three points per
    group, each drawn uniformly over the image's valid pixels with
    replacement (anywhere when none is valid)."""
    b, h, w = mask.shape
    n = max(int(h * w * sample_ratio), 1)
    weights = mask.reshape(b, -1).to(device=_gdev(generator), dtype=torch.float32)
    weights = torch.where(weights.sum(1, keepdim=True) > 0, weights,
                          torch.ones_like(weights))
    cols = [torch.multinomial(weights, n, replacement=True, generator=generator)
            for _ in range(3)]
    return torch.stack(cols, dim=-1)


def vnl_core(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
             intrinsic: torch.Tensor, idx: torch.Tensor, delta_cos: float = 0.867,
             delta_diff: float = 0.005, delta_z: float = 1e-5, select: bool = True,
             loss_weight: float = 1.0) -> torch.Tensor:
    """VirtualNormalLoss of (B, H, W) inputs on the drawn triplets (B, n, 3)."""
    b, h, w = pred.shape
    idx = idx.to(pred.device)
    n = idx.shape[1]

    def gather(depth):
        pts = backproject(depth, intrinsic).reshape(b, -1, 3)
        flat = idx.reshape(b, -1)
        return torch.gather(pts, 1, flat[..., None].expand(-1, -1, 3)).reshape(b, n, 3, 3)

    g_gt, g_pr = gather(target), gather(pred)
    d12 = g_gt[:, :, 1] - g_gt[:, :, 0]
    d13 = g_gt[:, :, 2] - g_gt[:, :, 0]
    d23 = g_gt[:, :, 2] - g_gt[:, :, 1]
    diffs = torch.stack([d12, d13, d23], dim=2)  # (B, n, 3 pairs, 3 xyz)

    def safe_norm(x, keepdim=False):
        # sqrt has an infinite gradient at 0: keep it strictly positive
        return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim) + 1e-12)

    norms = safe_norm(diffs)  # (B, n, 3)
    dots = torch.einsum("bnpc,bnqc->bnpq", diffs, diffs)
    cos = dots / (norms[..., :, None] * norms[..., None, :] + _EPS)
    mask_cos = ((cos > delta_cos) | (cos < -delta_cos)).sum(dim=(2, 3)) > 3
    mask_pad = (g_gt[..., 2] > delta_z).sum(-1) == 3
    near = [(torch.abs(diffs[..., c]) < delta_diff).sum(-1) > 0 for c in range(3)]
    mask_near = ~((near[0] & near[1] & near[2]) | mask_cos)
    group_ok = mask_pad & mask_near

    gt_n = torch.linalg.cross(g_gt[:, :, 1] - g_gt[:, :, 0], g_gt[:, :, 2] - g_gt[:, :, 0],
                              dim=-1)
    z = g_pr[..., 2:3]
    z_fix = torch.where(z == 0.0, torch.full_like(z, 1e-4), z)
    g_pr = torch.cat([g_pr[..., :2], z_fix], dim=-1)
    pr_n = torch.linalg.cross(g_pr[:, :, 1] - g_pr[:, :, 0], g_pr[:, :, 2] - g_pr[:, :, 0],
                              dim=-1)
    gt_n = gt_n / (safe_norm(gt_n, keepdim=True) + _EPS)
    pr_n = pr_n / (safe_norm(pr_n, keepdim=True) + _EPS)
    g_loss = torch.sum(torch.abs(gt_n - pr_n), dim=-1)  # (B, n)
    zero = torch.zeros_like(g_loss)
    g_loss = torch.where(group_ok, g_loss, zero)

    if select:
        # drop the lowest 25% of the surviving groups: the threshold is the
        # masked losses' 25th percentile
        sorted_l = torch.sort(torch.where(group_ok, g_loss, torch.full_like(g_loss, _BIG)),
                              dim=-1).values
        n_ok = group_ok.sum(-1)
        q_idx = torch.clamp((n_ok.float() * 0.25).long(), 0, n - 1)
        thresh = torch.gather(sorted_l, -1, q_idx[:, None])
        keep = group_ok & (g_loss >= thresh)
        g_loss = torch.where(keep, g_loss, zero)
        count = keep.sum()
    else:
        count = group_ok.sum()
    return torch.sum(g_loss) / (global_sum(count) + _EPS) * loss_weight


def vnl_loss(pred, target, mask, intrinsic, generator=None, sample_ratio: float = 0.15,
             **kwargs) -> torch.Tensor:
    return vnl_core(pred, target, mask, intrinsic, vnl_draw(generator, mask, sample_ratio),
                    **kwargs)
