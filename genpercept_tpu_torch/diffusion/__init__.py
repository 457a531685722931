from genpercept_tpu_torch.diffusion.schedulers import (
    GENPERCEPT_SCHEDULER,
    SchedulerConfig,
    SchedulerState,
    add_noise,
    ddim_step,
    ddpm_step,
    get_velocity,
    leading_timesteps,
    make_scheduler,
    pred_original_sample,
)

__all__ = ["GENPERCEPT_SCHEDULER", "SchedulerConfig", "SchedulerState", "add_noise",
           "ddim_step", "ddpm_step", "get_velocity", "leading_timesteps", "make_scheduler",
           "pred_original_sample"]
