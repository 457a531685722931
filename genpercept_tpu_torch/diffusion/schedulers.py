"""The scheduler pieces the one-step path and the training step need.

Counterpart of a subset of ``genpercept_tpu/diffusion/schedulers.py``: the
config, GenPercept's degenerate beta_start = beta_end = 1 schedule, the
'leading' timestep spacing, the beta tables (``make_scheduler``) and the
forward-process pieces of training (``add_noise``, ``get_velocity``). With
beta == 1 everywhere alpha_bar_t == 0, so ``add_noise`` returns the noise,
``get_velocity`` returns -x0, and the v-prediction's original sample is
exactly -v (see pipeline.py).
"""

from __future__ import annotations

import dataclasses

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
