from genpercept_tpu_torch.diffusion.schedulers import (
    GENPERCEPT_SCHEDULER,
    SchedulerConfig,
    SchedulerState,
    add_noise,
    get_velocity,
    leading_timesteps,
    make_scheduler,
)

__all__ = ["GENPERCEPT_SCHEDULER", "SchedulerConfig", "SchedulerState", "add_noise",
           "get_velocity", "leading_timesteps", "make_scheduler"]
