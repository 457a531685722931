"""Diffusion schedulers on PyTorch.

Counterpart of ``genpercept_tpu/diffusion/schedulers.py``: the config,
GenPercept's degenerate beta_start = beta_end = 1 schedule, the 'leading'
timestep spacing, the beta tables (``make_scheduler``), the forward-process
pieces of training (``add_noise``, ``get_velocity``) and the reverse steps
of the marigold and rgb_blending archs (``pred_original_sample``,
``ddim_step``, ``ddpm_step``). With beta == 1 everywhere alpha_bar_t == 0,
so ``add_noise`` returns the noise, ``get_velocity`` returns -x0, and the
v-prediction's original sample is exactly -v (see pipeline.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    power_beta_curve: float = 1.0
    prediction_type: str = "v_prediction"
    rescale_betas_zero_snr: bool = False
    clip_sample: bool = False
    clip_sample_range: float = 1.0
    thresholding: bool = False
    set_alpha_to_one: bool = False
    steps_offset: int = 1
    timestep_spacing: str = "leading"


# The degenerate config used by every GenPercept one-step checkpoint.
GENPERCEPT_SCHEDULER = SchedulerConfig(beta_start=1.0, beta_end=1.0)


def leading_timesteps(cfg: SchedulerConfig, num_inference_steps: int) -> np.ndarray:
    """'leading' timestep spacing (descending); [1] for one step."""
    step_ratio = cfg.num_train_timesteps // num_inference_steps
    ts = (np.arange(num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
    return ts + cfg.steps_offset


@dataclasses.dataclass
class SchedulerState:
    """The beta tables, f32 (the JAX package's SchedulerState)."""

    betas: torch.Tensor  # (T,)
    alphas_cumprod: torch.Tensor  # (T,)
    final_alpha_cumprod: torch.Tensor  # scalar


def _compute_betas(cfg: SchedulerConfig) -> np.ndarray:
    t = cfg.num_train_timesteps
    if cfg.beta_schedule == "linear":
        return np.linspace(cfg.beta_start, cfg.beta_end, t, dtype=np.float64)
    if cfg.beta_schedule == "scaled_linear":
        return np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5, t,
                           dtype=np.float64) ** 2
    if cfg.beta_schedule == "scaled_linear_power":
        p = cfg.power_beta_curve
        return np.linspace(cfg.beta_start ** (1.0 / p), cfg.beta_end ** (1.0 / p), t,
                           dtype=np.float64) ** p
    if cfg.beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(x):
            return np.cos((x + 0.008) / 1.008 * np.pi / 2) ** 2

        ts = np.arange(t, dtype=np.float64)
        return np.minimum(1.0 - alpha_bar((ts + 1) / t) / alpha_bar(ts / t), 0.999)
    raise ValueError(f"unknown beta schedule {cfg.beta_schedule!r}")


def _rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Shift alpha_bar so that the last step has exactly zero SNR."""
    sqrt_ab = np.sqrt(np.cumprod(1.0 - betas))
    a0, at = sqrt_ab[0].copy(), sqrt_ab[-1].copy()
    sqrt_ab = (sqrt_ab - at) * a0 / (a0 - at)
    ab = sqrt_ab ** 2
    return 1.0 - np.concatenate([ab[:1], ab[1:] / ab[:-1]])


def make_scheduler(cfg: SchedulerConfig, device=None) -> SchedulerState:
    betas = _compute_betas(cfg)
    if cfg.rescale_betas_zero_snr:
        betas = _rescale_zero_terminal_snr(betas)
    alphas_cumprod = np.cumprod(1.0 - betas)
    final = 1.0 if cfg.set_alpha_to_one else alphas_cumprod[0]

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return SchedulerState(f32(betas), f32(alphas_cumprod), f32(final))


def _extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    vals = table.to(t.device)[t]
    return vals.reshape(vals.shape + (1,) * (ndim - vals.ndim))


# JAX promotes a bf16 sample times the f32 table to f32; PyTorch keeps bf16
# when the table entry is 0-dim, so both cast to f32 explicitly.
def add_noise(state: SchedulerState, x0: torch.Tensor, noise: torch.Tensor,
              t: torch.Tensor) -> torch.Tensor:
    """q(x_t | x_0) = sqrt(abar) x0 + sqrt(1 - abar) eps, in f32."""
    abar = _extract(state.alphas_cumprod, t, x0.ndim)
    return torch.sqrt(abar) * x0.float() + torch.sqrt(1.0 - abar) * noise.float()


def get_velocity(state: SchedulerState, x0: torch.Tensor, noise: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
    """v target = sqrt(abar) eps - sqrt(1 - abar) x0, in f32."""
    abar = _extract(state.alphas_cumprod, t, x0.ndim)
    return torch.sqrt(abar) * noise.float() - torch.sqrt(1.0 - abar) * x0.float()


def pred_original_sample(cfg: SchedulerConfig, state: SchedulerState,
                         model_output: torch.Tensor, sample: torch.Tensor,
                         t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pred_x0, pred_epsilon) from the model output at timestep t, in f32."""
    abar = _extract(state.alphas_cumprod, t, sample.ndim)
    sqrt_a, sqrt_1ma = torch.sqrt(abar), torch.sqrt(1.0 - abar)
    out, x = model_output.float(), sample.float()
    if cfg.prediction_type == "epsilon":
        x0 = (x - sqrt_1ma * out) / sqrt_a
        eps = out
    elif cfg.prediction_type == "sample":
        x0 = out
        eps = (x - sqrt_a * x0) / sqrt_1ma
    elif cfg.prediction_type == "v_prediction":
        x0 = sqrt_a * x - sqrt_1ma * out
        eps = sqrt_a * out + sqrt_1ma * x
    else:
        raise ValueError(f"unknown prediction type {cfg.prediction_type!r}")
    if cfg.clip_sample:
        x0 = x0.clamp(-cfg.clip_sample_range, cfg.clip_sample_range)
    return x0, eps


def ddim_step(cfg: SchedulerConfig, state: SchedulerState, model_output: torch.Tensor,
              t: torch.Tensor, sample: torch.Tensor, num_inference_steps: int,
              eta: float = 0.0, noise: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One DDIM update, deterministic at eta = 0; t of shape (B,) or a
    scalar. Returns (prev_sample, pred_x0), both f32: the caller casts back."""
    prev_t = t - cfg.num_train_timesteps // num_inference_steps
    table = state.alphas_cumprod.to(t.device)
    abar_prev = torch.where(prev_t >= 0, table[prev_t.clamp(min=0)],
                            state.final_alpha_cumprod.to(t.device))
    abar_prev = abar_prev.reshape(abar_prev.shape + (1,) * (sample.ndim - abar_prev.ndim))
    x0, eps = pred_original_sample(cfg, state, model_output, sample, t)
    if eta > 0.0:
        if noise is None:
            raise ValueError("eta > 0 requires noise")
        abar_t = _extract(state.alphas_cumprod, t, sample.ndim)
        variance = (1.0 - abar_prev) / (1.0 - abar_t) * (1.0 - abar_t / abar_prev)
        std = eta * torch.sqrt(variance)
        dir_xt = torch.sqrt(1.0 - abar_prev - std ** 2) * eps
        prev = torch.sqrt(abar_prev) * x0 + dir_xt + std * noise.float()
    else:
        prev = torch.sqrt(abar_prev) * x0 + torch.sqrt(1.0 - abar_prev) * eps
    return prev, x0


def ddpm_step(cfg: SchedulerConfig, state: SchedulerState, model_output: torch.Tensor,
              t: torch.Tensor, sample: torch.Tensor, noise: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ancestral DDPM update. Returns (prev_sample, pred_x0), both f32."""
    abar_t = _extract(state.alphas_cumprod, t, sample.ndim)
    lead = abar_t.shape[:t.ndim] + (1,) * (abar_t.ndim - t.ndim)
    abar_prev = torch.where((t - 1 >= 0).reshape(lead),
                            _extract(state.alphas_cumprod, (t - 1).clamp(min=0), sample.ndim),
                            torch.ones_like(abar_t))
    beta_t = 1.0 - abar_t / abar_prev
    alpha_t = 1.0 - beta_t
    x0, _ = pred_original_sample(cfg, state, model_output, sample, t)
    # the posterior mean's coefficients (Ho et al. eq. 7)
    coef_x0 = torch.sqrt(abar_prev) * beta_t / (1.0 - abar_t)
    coef_xt = torch.sqrt(alpha_t) * (1.0 - abar_prev) / (1.0 - abar_t)
    mean = coef_x0 * x0 + coef_xt * sample.float()
    variance = ((1.0 - abar_prev) / (1.0 - abar_t) * beta_t).clamp(min=1e-20)
    std = torch.where((t > 0).reshape(lead), torch.sqrt(variance), torch.zeros_like(variance))
    return mean + std * noise.float(), x0
