"""The scheduler pieces the one-step path needs.

Counterpart of a subset of ``genpercept_tpu/diffusion/schedulers.py``: the
config, GenPercept's degenerate beta_start = beta_end = 1 schedule and the
'leading' timestep spacing. With beta == 1 everywhere alpha_bar_t == 0, so
the v-prediction's original sample is exactly -v (see pipeline.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np


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
