from genpercept_tpu_torch.diffusion.schedulers import (
    GENPERCEPT_SCHEDULER,
    SchedulerConfig,
    leading_timesteps,
)

__all__ = ["GENPERCEPT_SCHEDULER", "SchedulerConfig", "leading_timesteps"]
