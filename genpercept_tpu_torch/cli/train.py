"""Training driver CLI on PyTorch (rebuild of reference `accelerate_train.py`).

    python -m genpercept_tpu_torch.cli.train --config configs/train/main_paper/depth.yaml \
        --base_data_dir $BASE_DATA_DIR --checkpoint /path/to/sd21 \
        --output_dir out/ [--resume_run latest] [--bf16_masters] [--device cuda]

Counterpart of ``genpercept_tpu/cli/train.py``, with its flags and
``--device``: the merged recipe (``resolve_train_config``), config.yaml
and a code snapshot in the run directory, the optional wandb run, the
effective batch as grad accumulation, the mixed train loader and the
val/vis loaders over the dataset readers, the model-surgery ablation axes
(``apply_model_overrides``: from-scratch parts, a fresh DPT head, a text
prompt), marigold's 8-channel conv_in, the Trainer and its resume. Runs on
the card unless ``--device cpu`` is given.

Data and tensor parallel across processes (``parallel/``), one process a
device:

    torchrun --nproc_per_node N -m genpercept_tpu_torch.cli.train ... --multihost \
        [--model_parallel M]
    python -m genpercept_tpu_torch.cli.train ... --coordinator_address HOST:PORT \
        --num_processes N --process_id I [--model_parallel M]

The N ranks form N / M model groups of M consecutive ranks (the JAX
package's ``reshape(data, model)`` mesh; M must divide N): a group splits
the UNet's attention heads and GEGLU inner width over its ranks
(``parallel/tensor.py``) and holds one replica. Each rank runs on
cuda:<local rank> (or the device ``--device`` names with an index), every
rank iterates the same seeded sampler stream over global batches of
max_train_batch_size x N/M x accum and loads its data index's slice; the
effective batch sets accum = effective_batch_size / (max_train_batch_size
x N/M). ``--data_parallel`` -1 takes every replica; another value must
equal N/M. NCCL on the card, gloo on the CPU. ``--zero1`` shards the Adam
moments over the replicas.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import re
import time

import torch

from genpercept_tpu_torch.diffusion import GENPERCEPT_SCHEDULER, SchedulerConfig
from genpercept_tpu_torch.train import TrainConfig, replace_unet_conv_in

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


def build_parser():
    p = argparse.ArgumentParser(description="GenPercept training (PyTorch)")
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", required=True, help="base SD2.1 checkpoint dir")
    p.add_argument("--base_data_dir", default=os.environ.get("BASE_DATA_DIR", ""))
    p.add_argument("--output_dir", required=True)
    p.add_argument("--resume_run", default=None, help="resume from checkpoint name")
    p.add_argument("--exit_after", type=int, default=-1, help="minutes; save+exit")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--no_wandb", action="store_true",
                   help="accepted for reference-CLI parity (wandb is already off by "
                        "default, matching the reference's forced disable)")
    p.add_argument("--wandb", action="store_true",
                   help="mirror metrics to wandb (requires the wandb package; "
                        "tensorboard scalars sync via sync_tensorboard)")
    p.add_argument("--data_parallel", type=int, default=-1,
                   help="data-parallel ranks (-1: every process; another value must equal "
                        "their count)")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="tensor parallelism: ranks a model group, which split the UNet's "
                        "attention heads and GEGLU inner width (must divide the processes)")
    p.add_argument("--zero1", action="store_true",
                   help="shard the optimizer state across the data-parallel ranks (ZeRO-1; "
                        "the reference's DeepSpeed hook, accelerate_train.py:198-202)")
    p.add_argument("--coordinator_address", default=None,
                   help="host:port of process 0: start the process group with "
                        "--num_processes and --process_id")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--multihost", action="store_true",
                   help="start the process group from torchrun's or SLURM's environment")
    p.add_argument("--bf16_masters", action="store_true",
                   help="keep the TRAINABLE master weights (and Adam's second moment, "
                        "which takes their dtype) in bf16")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    return p


def _rank_device(args, world: int) -> torch.device:
    """This rank's device: --device, or with more than one rank and no
    index on a cuda --device, cuda:<local rank>. Refuses a card that is
    not there, and a --data_parallel other than the replica count (the
    ranks over --model_parallel)."""
    from genpercept_tpu_torch import parallel

    replicas = world // args.model_parallel
    if args.data_parallel not in (-1, replicas):
        raise ValueError(f"--data_parallel {args.data_parallel} with {world} process(es) at "
                         f"--model_parallel {args.model_parallel}: start one process per "
                         "data-parallel rank and model-parallel rank")
    device = torch.device(args.device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("cli/train.py trains on the card by default and no CUDA device is "
                           "available; pass --device cpu")
    if device.index is None and world > 1:
        device = torch.device("cuda", parallel.local_rank())
    if (device.index or 0) >= torch.cuda.device_count():
        raise RuntimeError(f"{device} is not there: {torch.cuda.device_count()} visible "
                           "card(s)")
    return device


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


def sampler_prob(cfg):
    """The train mixture's probabilities, for a ``mixed`` dataset only: a
    single-dataset recipe (dis, matting, seg) merged over the depth recipe
    inherits the depth mixture's prob_ls, which the JAX CLI hands to the
    sampler with one dataset, and numpy's choice raises."""
    if cfg.get_path("dataset.train.name") != "mixed":
        return None
    return cfg.get_path("dataset.train.prob_ls")


def apply_model_overrides(cfg, models, seed) -> None:
    """The model-surgery ablation axes (reference config/ablation/):
    from-scratch UNet or VAE decoder, re-initialised in place with the JAX
    package's scheme (``models.init_params_``) from generators seeded
    ``seed`` and ``seed + 1``, and a fresh DPT head (``model.customized_head``
    on a checkpoint without one; DPT_IDENTITY when the name holds
    "identity") from ``seed + 2``, as JAX seeds its keys (equal in
    distribution, not in value); a fixed text prompt."""
    from genpercept_tpu_torch.models import DPT_GENERAL, DPT_IDENTITY, init_dpt_head, init_params_

    def generator(offset: int) -> torch.Generator:
        return torch.Generator(device=models.device).manual_seed((seed or 0) + offset)

    if cfg.get_path("model.unet_from_scratch"):
        init_params_(models.unet, generator(0))
    if cfg.get_path("model.vae_decoder_from_scratch"):
        gen = generator(1)
        init_params_(models.vae.decoder, gen)
        init_params_(models.vae.post_quant_conv, gen)
    head_name = cfg.get_path("model.customized_head")
    if head_name and models.dpt_head is None:
        head_cfg = DPT_IDENTITY if "identity" in head_name else DPT_GENERAL
        models.dpt_head = init_dpt_head(generator(2), head_cfg, device=models.device)
    text_input = cfg.get_path("model.text_input")
    if text_input:
        models.text_embed = models.encode_prompt(text_input)


def main(argv=None):
    """Train as the recipe says; returns the Trainer after its last step."""
    import tarfile

    import numpy as np
    import yaml

    from genpercept_tpu_torch import parallel
    from genpercept_tpu_torch.data import DatasetMode, MixedBatchSampler, get_dataset
    from genpercept_tpu_torch.data.sampler import ConcatDataset, DataLoader
    from genpercept_tpu_torch.data.transforms import get_depth_normalizer
    from genpercept_tpu_torch.io.checkpoints import load_genpercept_checkpoint
    from genpercept_tpu_torch.train.trainer import Trainer
    from genpercept_tpu_torch.utils.config import recursive_load_config
    from genpercept_tpu_torch.utils.logging_util import (
        config_logging,
        init_wandb,
        load_wandb_job_id,
        save_wandb_job_id,
    )
    from genpercept_tpu_torch.utils.seeding import seed_all

    args = build_parser().parse_args(argv)
    # the process group before any CUDA work
    started = parallel.init_distributed(
        args.coordinator_address, args.num_processes, args.process_id, args.multihost,
        device_type=torch.device(args.device).type)
    world, rank = parallel.world(), parallel.rank()
    parallel.set_model_parallel(args.model_parallel)  # refuses a world M does not divide
    data_world, data_rank = parallel.data_world(), parallel.data_rank()
    device = _rank_device(args, world)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    cfg = recursive_load_config(args.config)
    # run artifacts are rank 0's: the others would write the same files
    main_rank = rank == 0
    config_logging(cfg.get("logging"), out_dir=args.output_dir if main_rank else None)
    logging.info(f"config: {args.config}")

    # the merged config for resume, and a snapshot of the code tree
    # (accelerate_train.py:268-282)
    os.makedirs(args.output_dir, exist_ok=True)
    if main_rank:
        with open(os.path.join(args.output_dir, "config.yaml"), "w") as f:
            yaml.safe_dump(dict(cfg), f)
        if not args.resume_run:
            pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            with tarfile.open(os.path.join(args.output_dir, "code_snapshot.tar.gz"),
                              "w:gz") as tar:
                tar.add(pkg_root, arcname="genpercept_tpu_torch")
        # wandb stays off unless asked for (the reference forces it off,
        # accelerate_train.py:139-140); metrics.jsonl is the primary stream
        wandb_run = init_wandb(
            args.wandb, project="genpercept_tpu", dir=args.output_dir,
            id=load_wandb_job_id(args.output_dir) if args.resume_run else None,
            resume="allow" if args.resume_run else None)
        if wandb_run is not None and args.wandb:
            save_wandb_job_id(wandb_run, args.output_dir)

    seed = args.seed if args.seed is not None else cfg.get("trainer", {}).get("init_seed", 0)
    seed_all(seed)

    # effective batch -> grad accumulation over the replicas
    # (accelerate_train.py:180-184; JAX's n_data)
    eff_bs = cfg.get_path("dataloader.effective_batch_size", 32)
    max_bs = cfg.get_path("dataloader.max_train_batch_size", 2)
    accum = max(int(eff_bs / (max_bs * data_world)), 1)
    logging.info(f"device={device} rank={rank}/{world} model_parallel={args.model_parallel} "
                 f"eff_bs={eff_bs} per_step_bs={max_bs * data_world} grad_accum={accum}")

    mode = cfg.get_path("pipeline.kwargs.mode", cfg.get("mode", "depth"))
    # each dataset's own resize_to_hw reaches its reader through get_dataset
    datasets = get_dataset(
        cfg.get_path("dataset.train"), args.base_data_dir, DatasetMode.TRAIN,
        depth_transform=get_depth_normalizer(cfg.get_path("depth_normalization")),
        augmentation_args=cfg.get("augmentation"))
    if not isinstance(datasets, list):
        datasets = [datasets]
    # every rank iterates the same seeded stream of global batches and
    # loads its data index's slice of each (a model group loads one slice)
    sampler = MixedBatchSampler(datasets, batch_size=max_bs * data_world * accum,
                                prob=sampler_prob(cfg), generator=np.random.default_rng(seed))
    train_loader = DataLoader(ConcatDataset(datasets), sampler,
                              shard=(data_rank, data_world, accum) if data_world > 1 else None)

    def eval_loaders(key):
        out = {}
        for ds_cfg in cfg.get_path(key, []) or []:
            ds = get_dataset(ds_cfg, args.base_data_dir, DatasetMode.EVAL)
            one = MixedBatchSampler([ds], batch_size=1, shuffle=False,
                                    generator=np.random.default_rng(0))
            out[ds_cfg["name"]] = DataLoader(ConcatDataset([ds]), one)
        return out

    models = load_genpercept_checkpoint(args.checkpoint, device=device)
    apply_model_overrides(cfg, models, seed)
    train_cfg = resolve_train_config(cfg, grad_accum_steps=accum, mode=mode)
    if args.bf16_masters:
        train_cfg = dataclasses.replace(train_cfg, master_dtype=torch.bfloat16)
    if train_cfg.arch == "marigold" and models.unet.cfg.in_channels == 4:
        # marigold concatenates [rgb_latent, noisy]: the 8-channel conv_in
        replace_unet_conv_in(models.unet)

    trainer = Trainer(
        cfg=train_cfg,
        models=models,
        train_loader=train_loader,
        val_loaders=eval_loaders("dataset.val"),
        out_dir=args.output_dir,
        max_iter=cfg.get_path("max_iter", 30000),
        save_period=cfg.get_path("trainer.save_period", 50),
        val_period=cfg.get_path("trainer.validation_period", 0),
        vis_period=cfg.get_path("trainer.visualization_period", 0),
        vis_loaders=eval_loaders("dataset.vis"),
        main_seed=seed,
        zero1=args.zero1,
    )
    if args.resume_run:
        trainer.load_checkpoint(args.resume_run)

    t_end = time.time() + args.exit_after * 60 if args.exit_after > 0 else None
    trainer.train(t_end=t_end)
    if started:
        parallel.shutdown()
    return trainer


if __name__ == "__main__":
    main()
