"""Perception training losses (mask-aware), in PyTorch.

Counterpart of ``genpercept_tpu/train/losses.py``, function for function.
All functions take (B, H, W) tensors (or (B, H, W, 3) for normals) and
boolean masks, and reduce as the reference does (batch-wise sum over the
total valid count), with masked arithmetic in place of NaN tricks. In a
data-parallel run the training losses' counts are the global batch's
(``parallel.global_sum``): each rank's loss is its share of the global
loss, and the shares add up to it.

Canonical depth recipe weights: mse x1.0, least-square SSI x0.5, grad x2.0,
on predictions shifted from [-1, 1] to [1, 3].
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from genpercept_tpu_torch.parallel import global_sum

_EPS = 1e-6


def _masked_sum_mean(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum(value * mask) over the global batch's count of mask."""
    return torch.sum(value * mask) / (global_sum(torch.sum(mask)) + _EPS)


# ------------------------------------------------------------ simple losses

def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return _masked_sum_mean((pred - target) ** 2, mask.to(pred.dtype))


def masked_l1(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return _masked_sum_mean(torch.abs(pred - target), mask.to(pred.dtype))


# -------------------------------------------------------------- latent losses

def silog_mse(pred: torch.Tensor, target: torch.Tensor, lam: float = 0.5,
              mask: torch.Tensor | None = None, log_pred: bool = False,
              batch_reduction: bool = True) -> torch.Tensor:
    """Per-image scale-invariant log MSE, then the batch mean."""
    lp = pred if log_pred else torch.log(torch.clamp(pred, min=_EPS))
    d = lp - torch.log(torch.clamp(target, min=_EPS))
    if mask is not None:
        d = torch.where(mask, d, torch.zeros_like(d))
        n = torch.sum(mask, dim=(-1, -2)).to(d.dtype)
    elif d.ndim >= 2:
        n = d.shape[-1] * d.shape[-2]
    else:
        n = d.shape[-1]
    dims = (-1, -2) if d.ndim >= 2 else (-1,)
    loss = torch.sum(d ** 2, dim=dims) / n - lam * torch.sum(d, dim=dims) ** 2 / (n ** 2)
    return torch.mean(loss) if batch_reduction else loss


def silog_rmse(pred: torch.Tensor, target: torch.Tensor, lam: float = 0.5,
               mask: torch.Tensor | None = None, log_pred: bool = False,
               alpha: float = 1.0) -> torch.Tensor:
    loss = silog_mse(pred, target, lam, mask=mask, log_pred=log_pred,
                     batch_reduction=False)
    return torch.mean(torch.sqrt(torch.clamp(loss, min=0.0) + _EPS)) * alpha


def mean_abs_rel(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target) / torch.clamp(torch.abs(target), min=_EPS))


def get_loss(loss_name: str, **kwargs):
    """Latent-loss factory: silog_mse / silog_rmse / mse_loss / l1_loss /
    l1_loss_with_mask / mean_abs_rel."""
    if loss_name == "silog_mse":
        lam = kwargs.get("lamb", 0.5)
        log_pred = kwargs.get("log_pred", True)
        return lambda pred, target, mask=None, **kw: silog_mse(
            pred, target, lam, mask=mask, log_pred=log_pred)
    if loss_name == "silog_rmse":
        lam = kwargs.get("lamb", 0.5)
        alpha = kwargs.get("alpha", 1.0)
        log_pred = kwargs.get("log_pred", True)
        return lambda pred, target, mask=None, **kw: silog_rmse(
            pred, target, lam, mask=mask, log_pred=log_pred, alpha=alpha)
    if loss_name == "mse_loss":
        return lambda pred, target, **kw: torch.mean((pred - target) ** 2)
    if loss_name == "l1_loss":
        return lambda pred, target, **kw: torch.mean(torch.abs(pred - target))
    if loss_name == "l1_loss_with_mask":
        return lambda pred, target, mask=None, **kw: masked_l1(
            pred, target, mask if mask is not None else torch.ones_like(pred, dtype=torch.bool))
    if loss_name == "mean_abs_rel":
        return lambda pred, target, **kw: mean_abs_rel(pred, target)
    raise ValueError(f"unknown loss: {loss_name}")


def l1_disp_loss(pred_disp: torch.Tensor, inv_depth: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    return _masked_sum_mean(torch.abs(pred_disp - inv_depth), mask.to(pred_disp.dtype))


def l1_inverse_loss(pred_depth: torch.Tensor, inv_depth: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Masked L1 of 10 / prediction against positive GT disparity."""
    m = mask & (inv_depth > 0)
    inv_pred = 10.0 / torch.clamp(pred_depth, min=_EPS)
    return _masked_sum_mean(torch.abs(inv_pred - inv_depth), m.to(pred_depth.dtype))


def sig_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
             lam: float = 0.85) -> torch.Tensor:
    m = mask.to(pred.dtype)
    n = torch.sum(m) + _EPS
    d = (torch.log(torch.clamp(pred, min=_EPS)) - torch.log(torch.clamp(target, min=_EPS))) * m
    return torch.sqrt(torch.clamp(torch.sum(d ** 2) / n - lam * (torch.sum(d) / n) ** 2,
                                  min=0.0))


# --------------------------------------------------- scale/shift invariance

def compute_scale_and_shift(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor):
    """Per-sample (s, t) minimizing ||m*(s*pred + t - target)||^2; (B,) each,
    zero where the system is singular."""
    m = mask.to(pred.dtype)
    dims = (1, 2)
    a00 = torch.sum(m * pred * pred, dim=dims)
    a01 = torch.sum(m * pred, dim=dims)
    a11 = torch.sum(m, dim=dims)
    b0 = torch.sum(m * pred * target, dim=dims)
    b1 = torch.sum(m * target, dim=dims)
    det = a00 * a11 - a01 * a01
    valid = det > 0
    safe_det = torch.where(valid, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    s = torch.where(valid, (a11 * b0 - a01 * b1) / safe_det, zero)
    t = torch.where(valid, (-a01 * b0 + a00 * b1) / safe_det, zero)
    return s, t


def _masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The LOWER median over masked elements per sample (index (k-1)//2 of
    the k valid entries, torch.nanmedian's); 1.0 where the mask is empty.
    x/mask: (B, N)."""
    n_valid = torch.sum(mask, dim=1)
    xs = torch.sort(torch.where(mask, x, torch.full_like(x, 3.0e38)), dim=1).values
    idx = torch.clamp((n_valid - 1) // 2, 0, x.shape[1] - 1)
    med = torch.gather(xs, 1, idx[:, None])[:, 0]
    return torch.where(n_valid > 0, med, torch.ones_like(med))


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median over axis 1 as jnp.median takes it: the MIDPOINT of the two
    middle values for an even count (torch.median returns the lower one)."""
    xs = torch.sort(x, dim=1).values
    n = x.shape[1]
    return (xs[:, (n - 1) // 2] + xs[:, n // 2]) * 0.5


def ssi_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
             align_type: str = "least_square") -> torch.Tensor:
    """Scale-and-shift-invariant L1. least_square: closed-form (s, t), the
    median ratio where s <= 0. medium: median/MAD normalization of each side
    (the MAD sums over ALL pixels, divided by the masked count, as the
    reference), then masked L1. (B, H, W) inputs."""
    b = pred.shape[0]
    m = mask.to(pred.dtype)
    if align_type == "least_square":
        s, t = compute_scale_and_shift(pred, target, mask)
        pf, tf = pred.reshape(b, -1), target.reshape(b, -1)
        mf = mask.reshape(b, -1) & (tf > 0)
        s_median = _masked_median(tf, mf) / (_masked_median(pf, mf) + 1e-8)
        scaled = torch.where((s <= 0)[:, None, None], pred * s_median[:, None, None],
                             pred * s[:, None, None] + t[:, None, None])
        return _masked_sum_mean(torch.abs(scaled - target), m)
    if align_type == "medium":
        eps = 1e-6
        pf, tf = pred.reshape(b, -1), target.reshape(b, -1)
        mf = mask.reshape(b, -1)
        n_valid = torch.sum(mf, dim=1).to(pred.dtype) + eps
        t_med = _median(tf)
        t_s = torch.sum(torch.abs(tf - t_med[:, None]), dim=1) / n_valid
        t_trans = (tf - t_med[:, None]) / (t_s[:, None] + eps)
        p_med = _median(pf)
        p_s = torch.sum(torch.abs(pf - p_med[:, None]), dim=1) / n_valid
        p_trans = (pf - p_med[:, None]) / (p_s[:, None] + eps)
        return _masked_sum_mean(torch.abs(p_trans - t_trans), mf.to(pred.dtype))
    raise ValueError(align_type)


# ------------------------------------------------------------ gradient loss

def _gradient_term(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor):
    """Gradient matching at one scale, batch-based reduction."""
    m = mask.to(pred.dtype)
    diff = (pred - target) * m
    gx = torch.abs(diff[:, :, 1:] - diff[:, :, :-1]) * (m[:, :, 1:] * m[:, :, :-1])
    gy = torch.abs(diff[:, 1:, :] - diff[:, :-1, :]) * (m[:, 1:, :] * m[:, :-1, :])
    image_loss = torch.sum(gx, dim=(1, 2)) + torch.sum(gy, dim=(1, 2))
    total_m = global_sum(torch.sum(m))
    return torch.where(total_m > 0, torch.sum(image_loss) / torch.clamp(total_m, min=1.0),
                       torch.zeros_like(total_m))


def gradient_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                  scales: int = 1) -> torch.Tensor:
    """Multi-scale gradient matching (the main-paper recipe uses 1 scale)."""
    total = 0.0
    for scale in range(scales):
        step = 2 ** scale
        total = total + _gradient_term(pred[:, ::step, ::step], target[:, ::step, ::step],
                                       mask[:, ::step, ::step])
    return total


def gradient_log_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                      scales: int = 1) -> torch.Tensor:
    """Log-space gradient loss over a two-pixel gap, normalized by the
    masked-gradient count; invalid targets shifted +100 before the log."""
    target_safe = target + torch.where(mask, 0.0, 100.0)
    diff = (torch.log(torch.clamp(pred, min=_EPS))
            - torch.log(torch.clamp(target_safe, min=_EPS)))
    m = mask.to(pred.dtype)
    total = 0.0
    for scale in range(scales):
        step = 2 ** scale
        d = diff[:, ::step, ::step]
        mm = m[:, ::step, ::step]
        v_m = mm[:, :-2, :] * mm[:, 2:, :]
        h_m = mm[:, :, :-2] * mm[:, :, 2:]
        v = torch.abs(d[:, :-2, :] - d[:, 2:, :]) * v_m
        h = torch.abs(d[:, :, :-2] - d[:, :, 2:]) * h_m
        n = torch.sum(v_m) + torch.sum(h_m) + 1e-6
        total = total + (torch.sum(v) + torch.sum(h)) / n
    return total / scales


# ----------------------------------------------------------- normals losses

def angular_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                 uncertainty_aware: bool = False, eps: float = 1e-4) -> torch.Tensor:
    """arccos of the cosine similarity, with the optional ELU-kappa
    uncertainty channel. pred: (B, H, W, 3 or 4); target (B, H, W, 3)."""
    n_pred = pred[..., :3]
    dot = torch.sum(n_pred * target, dim=-1)
    norm = torch.linalg.norm(n_pred, dim=-1) * torch.linalg.norm(target, dim=-1)
    cos = dot / torch.clamp(norm, min=1e-8)
    ang = torch.arccos(torch.clamp(cos, -1 + eps, 1 - eps))
    if uncertainty_aware or pred.shape[-1] == 4:
        kappa = F.elu(pred[..., 3]) + 1.01
        kappa_reg = torch.log1p(torch.exp(-kappa * math.pi)) - torch.log(kappa ** 2 + 1)
        loss = kappa_reg + kappa * ang
    else:
        loss = ang
    return _masked_sum_mean(loss, mask.to(loss.dtype))


def normal_l1_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    diff = torch.sum(torch.abs(pred[..., :3] - target), dim=-1)
    return _masked_sum_mean(diff, mask.to(diff.dtype))
