"""Dataset inference CLI on PyTorch (rebuild of reference `infer.py`).

    python -m genpercept_tpu_torch.cli.infer --checkpoint /path/to/ckpt \
        --dataset_config configs/dataset/eval/nyu.yaml --base_data_dir DATA \
        --output_dir out/ [--half_precision] [--prompt TEXT] [--device cuda]

Counterpart of ``genpercept_tpu/cli/infer.py``, with the same flags and
``--device``: runs the pipeline over an eval dataset's RGB images and saves
one .npy prediction per image, named by the dataset's prediction-name
convention under the rgb path's directory, ready for the eval CLI. With
``--seed`` each image draws the marigold arch's noise from a fresh
generator seeded with it. Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import logging
import os
import os.path as osp
import sys

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="GenPercept dataset inference (PyTorch)")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--base_ckpt_dir", default=None,
                   help="SD2.1 base checkpoint supplying vae/text_encoder/"
                        "tokenizer for unet-only checkpoints (default: "
                        "$BASE_CKPT_DIR, reference accelerate_train.py env "
                        "fallback)")
    p.add_argument("--dataset_config", required=True, help="dataset yaml")
    p.add_argument("--base_data_dir", default=os.environ.get("BASE_DATA_DIR", ""))
    p.add_argument("--output_dir", required=True)
    p.add_argument("--mode", default="depth")
    p.add_argument("--archs", default="genpercept")
    p.add_argument("--denoise_steps", type=int, default=1)
    p.add_argument("--ensemble_size", type=int, default=1)
    p.add_argument("--processing_res", type=int, default=768)
    p.add_argument("--resample_method", default="bilinear")
    p.add_argument("--half_precision", action="store_true")
    p.add_argument("--fix_timesteps", type=int, default=None)
    p.add_argument("--prompt", default="", help="text prompt (reference infer.py:183)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--overwrite", action="store_true",
                   help="overwrite a non-empty output dir (the reference "
                        "asks interactively, infer.py:249-267; here it is "
                        "an explicit flag so batch scripts stay unattended)")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    return p


def main(argv=None):
    import torch

    from genpercept_tpu_torch.data import DatasetMode, get_dataset, get_pred_name
    from genpercept_tpu_torch.io.checkpoints import load_genpercept_checkpoint
    from genpercept_tpu_torch.pipeline import GenPerceptPipeline, PipelineConfig
    from genpercept_tpu_torch.utils.config import recursive_load_config

    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if (osp.isdir(args.output_dir) and os.listdir(args.output_dir)
            and not args.overwrite):
        # the reference confirms interactively (infer.py:249-267); do the
        # same on a TTY, and fail fast when headless (batch jobs must not
        # hang on stdin)
        if sys.stdin is not None and sys.stdin.isatty():
            while True:
                resp = input(
                    f"The directory '{args.output_dir}' already exists. "
                    "Are you sure to continue? (y/n): ").strip().lower()
                if resp == "y":
                    break
                if resp == "n":
                    raise SystemExit("Exiting...")
                print("Invalid input. Please enter 'y' (for Yes) or 'n' "
                      "(for No).")
        else:
            raise SystemExit(
                f"output dir {args.output_dir} is not empty; pass "
                "--overwrite to replace existing predictions"
            )
    if args.archs == "genpercept":
        args.denoise_steps, args.ensemble_size = 1, 1

    cfg_data = recursive_load_config(args.dataset_config)
    dataset_cfg = cfg_data.get("dataset", cfg_data)
    dataset = get_dataset(dataset_cfg, args.base_data_dir, DatasetMode.RGB_ONLY)

    dtype = torch.bfloat16 if args.half_precision else torch.float32
    models = load_genpercept_checkpoint(args.checkpoint, dtype=dtype,
                                        base_ckpt_dir=args.base_ckpt_dir, device=args.device)
    if args.prompt:
        models.text_embed = models.encode_prompt(args.prompt)
    pipe = GenPerceptPipeline(
        models,
        PipelineConfig(
            mode=args.mode, arch=args.archs,
            processing_res=args.processing_res,
            denoising_steps=args.denoise_steps,
            ensemble_size=args.ensemble_size,
            fix_timesteps=args.fix_timesteps,
            resample_method=args.resample_method, dtype=dtype,
        ),
        device=args.device,
    )

    os.makedirs(args.output_dir, exist_ok=True)
    for i in range(len(dataset)):
        item = dataset[i]
        rgb01 = (np.asarray(item["rgb_norm"]) + 1.0) / 2.0
        # a fresh generator per image: each image gets the draw that the JAX
        # CLI's one key gives it
        generator = (None if args.seed is None
                     else torch.Generator(pipe.device).manual_seed(args.seed))
        out = pipe((rgb01 * 255).astype(np.uint8), color_map=None, generator=generator)
        # Preserve the dirname of the relative rgb path — KITTI eigen has
        # duplicate basenames across drives (reference infer.py:435-447).
        rgb_rel = item["rgb_relative_path"]
        pred_name = get_pred_name(osp.basename(rgb_rel), dataset.name_mode, ".npy")
        scene_dir = osp.join(args.output_dir, osp.dirname(rgb_rel))
        os.makedirs(scene_dir, exist_ok=True)
        np.save(osp.join(scene_dir, pred_name), out.pred_np)
        if (i + 1) % 25 == 0:
            logging.info(f"{i+1}/{len(dataset)}")
    logging.info(f"predictions saved to {args.output_dir}")


if __name__ == "__main__":
    main()
