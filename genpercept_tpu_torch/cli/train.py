"""Training configuration from a recipe file.

Counterpart of ``genpercept_tpu/cli/train.py::resolve_train_config``: maps a
merged recipe config (``utils.config.recursive_load_config``) to a
``TrainConfig``. The CLI entry point itself waits for the checkpoint loader
and the dataset readers, which are not ported yet.
"""

from __future__ import annotations

import dataclasses
import re

import torch

from genpercept_tpu_torch.diffusion import GENPERCEPT_SCHEDULER, SchedulerConfig
from genpercept_tpu_torch.train import TrainConfig

# reference loss names (config ``loss.name``) -> the training step's names
_PIXEL_LOSSES = {
    "mse_loss": "mse", "least_square_ssi_loss": "ssi", "medium_ssi_loss": "ssi_medium",
    "grad_loss": "grad", "angular_loss": "angular", "l1_loss": "l1",
    "vnl_loss": "vnl", "hdnr_loss": "hdnr", "hdsnr_loss": "hdsnr",
}
# without ``loss.customized_loss`` the single name selects a latent loss
_LATENT_LOSSES = {
    "mse_loss": "latent_mse", "mse": "latent_mse", "latent_mse": "latent_mse",
    "l1_loss": "latent_l1", "l1_loss_with_mask": "latent_l1",
    "mean_abs_rel": "latent_mean_abs_rel",
}


def resolve_train_config(cfg, grad_accum_steps: int = 1, mode: str = None) -> TrainConfig:
    """Pure: no model or dataset IO, so every recipe file is testable."""
    if mode is None:
        mode = cfg.get_path("pipeline.kwargs.mode", cfg.get("mode", "depth"))

    arch = cfg.get("arch")
    if arch is None:
        if cfg.get_path("pipeline.name") == "MarigoldPipeline":
            arch = ("rgb_blending" if cfg.get_path("pipeline.kwargs.rgb_blending")
                    else "marigold")
        else:
            arch = "genpercept"

    # genpercept trains on the degenerate beta = 1 schedule; marigold
    # ablations name a hf_configs/scheduler_beta_{start}_{end} directory
    if arch == "genpercept":
        sched_cfg = GENPERCEPT_SCHEDULER
    else:
        sched_cfg = SchedulerConfig()
        sp = cfg.get_path("model.scheduler_path")
        if sp:
            m = re.search(r"scheduler_beta_([0-9.]+)_([0-9.]+)", sp)
            if not m:
                raise ValueError(f"cannot parse betas from scheduler_path: {sp}")
            sched_cfg = SchedulerConfig(beta_start=float(m.group(1)),
                                        beta_end=float(m.group(2)))
        for k in ("beta_start", "beta_end", "beta_schedule", "power_beta_curve",
                  "rescale_betas_zero_snr"):
            v = cfg.get_path(f"scheduler.{k}")
            if v is not None:
                sched_cfg = dataclasses.replace(sched_cfg, **{k: v})

    lr_cfg = cfg.get_path("lr_scheduler.kwargs", {}) or {}
    raw_losses = cfg.get_path("loss.name") or cfg.get_path(
        "loss.customized_loss_names", ["latent_mse"])
    if isinstance(raw_losses, str):
        raw_losses = [raw_losses]
    if cfg.get_path("loss.customized_loss", False):
        losses = tuple(_PIXEL_LOSSES.get(n, n) for n in raw_losses)
        # an extra latent MSE on the raw UNet prediction
        if cfg.get_path("loss.with_latent_loss", False):
            if cfg.get_path("model.customized_head"):
                raise NotImplementedError(
                    "with_latent_loss is incompatible with a customized (DPT) head: "
                    "there is no latent prediction to supervise")
            losses = ("latent_mse",) + losses
    else:
        unknown = [n for n in raw_losses if n not in _LATENT_LOSSES]
        if unknown:
            raise ValueError(
                f"unsupported latent loss name(s) {unknown} with customized_loss: false "
                f"- supported: {sorted(_LATENT_LOSSES)} (pixel-space losses like "
                "ssi/grad need customized_loss: true)")
        losses = tuple(_LATENT_LOSSES[n] for n in raw_losses)
    mrn = cfg.get_path("multi_res_noise") or {}
    return TrainConfig(
        mode=mode,
        arch=arch,
        scheduler=sched_cfg,
        loss_names=losses,
        lr=cfg.get_path("lr", 3e-5),
        decoder_lr=cfg.get_path("decoder_lr"),
        lr_total_iter_length=lr_cfg.get("total_iter_length", lr_cfg.get("total_iter", 25000)),
        lr_final_ratio=lr_cfg.get("final_ratio", 0.01),
        lr_warmup_steps=lr_cfg.get("warmup_steps", 100),
        grad_accum_steps=grad_accum_steps,
        fix_timesteps=cfg.get_path("model.fix_timesteps", cfg.get("fix_timesteps")),
        train_unet=cfg.get_path("model.train_unet", True),
        train_vae_decoder=cfg.get_path("model.train_vae_decoder", False),
        unet_lora_rank=cfg.get_path("model.unet_lora_rank"),
        multi_res_noise_strength=mrn.get("strength"),
        multi_res_noise_strategy=mrn.get("downscale_strategy", "original"),
        multi_res_noise_annealed=mrn.get("annealed", False),
        remat_unet=cfg.get_path("model.remat_unet", True),
        remat_granularity=cfg.get_path("model.remat_granularity", "unet"),
        adam_mu_dtype=torch.bfloat16 if cfg.get_path("optimizer.mu_dtype") == "bf16" else None,
        compute_dtype=(torch.bfloat16 if cfg.get_path("mixed_precision") == "bf16"
                       else torch.float32),
    )
