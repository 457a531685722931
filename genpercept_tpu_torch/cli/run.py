"""Folder-of-images inference CLI on PyTorch.

    python -m genpercept_tpu_torch.cli.run \
        --checkpoint /path/to/ckpt --input_rgb_dir imgs/ --output_dir out/ \
        --mode depth [--device cuda]

Counterpart of ``genpercept_tpu/cli/run.py``, with the same flags and
outputs. Saves, per image: <name>_pred.npy, <name>_pred.png (16-bit for
depth, 8-bit otherwise), <name>_pred_colored.png where the task has a
color map and <name>_pred_uncert.npy when an ensemble ran. The marigold
arch draws each image's initial noise from a generator seeded with
``--seed`` (0 by default), the same draw for every image. Runs on the card
unless ``--device cpu`` is given; ``--data_parallel`` (batched mode only,
as in the JAX package) splits every batch between all visible GPUs, one
replica of the models on each.
"""

from __future__ import annotations

import argparse
import logging
import os
import os.path as osp
from glob import glob

import numpy as np

EXTENSIONS = (".jpg", ".jpeg", ".png", ".webp", ".bmp")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GenPercept folder inference (PyTorch)")
    p.add_argument("--checkpoint", required=True, help="checkpoint directory")
    p.add_argument("--base_ckpt_dir", default=None,
                   help="SD2.1 base checkpoint supplying vae/text_encoder for "
                        "unet-only checkpoints (default: $BASE_CKPT_DIR)")
    p.add_argument("--input_rgb_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--mode", default="depth",
                   choices=["depth", "normal", "matting", "dis", "seg",
                            "disparity", "disparity_dpt_head"])
    p.add_argument("--archs", default="genpercept",
                   choices=["genpercept", "rgb_blending", "marigold"])
    p.add_argument("--denoise_steps", type=int, default=1)
    p.add_argument("--ensemble_size", type=int, default=1)
    p.add_argument("--processing_res", type=int, default=768)
    p.add_argument("--output_processing_res", action="store_true",
                   help="do not resize back to input resolution")
    p.add_argument("--resample_method", default="bilinear",
                   choices=["bilinear", "bicubic", "nearest_exact"])
    p.add_argument("--half_precision", "--bf16", action="store_true",
                   help="bfloat16 compute")
    p.add_argument("--fix_timesteps", type=int, default=None)
    p.add_argument("--seed", type=int, default=None,
                   help="seed of the marigold arch's initial noise (default 0)")
    p.add_argument("--batch_size", type=int, default=0,
                   help="0 = single-image loop; >0 = batches of that size; -1 = "
                        "the largest measured to fit one H100 80GB")
    p.add_argument("--data_parallel", action="store_true",
                   help="every batch split between all visible GPUs (needs --batch_size != 0)")
    p.add_argument("--int8_vae", action="store_true",
                   help="W8A8 int8 VAE convs, calibrated on the first batch")
    p.add_argument("--int8_unet", action="store_true",
                   help="with --int8_vae: also the UNet's resnet/down/up convs")
    p.add_argument("--int8_no_refine", action="store_true",
                   help="plain absmax scales, without MSE clip search and bias "
                        "correction")
    p.add_argument("--int8_exclude", default=None, metavar="SUBSTR[,..]",
                   help="layers whose path contains any of these stay full "
                        "precision ('none' quantizes everything)")
    p.add_argument("--int8_calibration", default=None, metavar="NPZ",
                   help="calibration cache: load the int8 tree from this file if "
                        "it exists, else calibrate on the first batch and save it")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    return p


def _devices(args) -> list:
    """Every visible GPU with --data_parallel on the card (an unindexed
    --device cuda), else --device alone."""
    import torch

    device = torch.device(args.device)
    if args.data_parallel and args.batch_size == 0:
        raise ValueError("--data_parallel needs batched mode (--batch_size != 0)")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("cli/run.py runs on the card by default and no CUDA device is "
                           "available; pass --device cpu")
    if args.data_parallel and device.type == "cuda" and device.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def main(argv=None):
    import torch
    from PIL import Image

    from genpercept_tpu_torch.io.checkpoints import load_genpercept_checkpoint
    from genpercept_tpu_torch.pipeline import GenPerceptPipeline, PipelineConfig

    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    devices = _devices(args)
    if args.archs == "genpercept":
        # genpercept forces one step, no ensemble (reference run.py:209-211)
        args.denoise_steps, args.ensemble_size = 1, 1

    dtype = torch.bfloat16 if args.half_precision else torch.float32
    models = load_genpercept_checkpoint(args.checkpoint, dtype=dtype,
                                        base_ckpt_dir=args.base_ckpt_dir,
                                        device=devices[0])
    cfg = PipelineConfig(
        mode=args.mode,
        arch=args.archs,
        processing_res=args.processing_res,
        match_input_res=not args.output_processing_res,
        denoising_steps=args.denoise_steps,
        ensemble_size=args.ensemble_size,
        fix_timesteps=args.fix_timesteps,
        resample_method=args.resample_method,
        dtype=dtype,
        int8_vae=args.int8_vae,
        int8_unet=args.int8_unet,
        int8_refine=not args.int8_no_refine,
        **({} if args.int8_exclude is None else {
            "int8_exclude": () if args.int8_exclude == "none"
            else tuple(s for s in args.int8_exclude.split(",") if s)}),
    )
    pipe = (GenPerceptPipeline(models, cfg, devices=devices) if args.data_parallel
            else GenPerceptPipeline(models, cfg, device=devices[0]))
    if args.int8_calibration and osp.exists(args.int8_calibration):
        pipe.load_calibration(args.int8_calibration)
        logging.info(f"loaded int8 calibration from {args.int8_calibration}")

    rgb_paths = sorted(
        p for p in glob(osp.join(args.input_rgb_dir, "**", "*"), recursive=True)
        if p.lower().endswith(EXTENSIONS))
    if not rgb_paths:
        raise FileNotFoundError(f"no images under {args.input_rgb_dir}")
    logging.info(f"inference on {len(rgb_paths)} images, mode={args.mode}")
    os.makedirs(args.output_dir, exist_ok=True)

    def save_one(path, out):
        rel_dir = osp.dirname(osp.relpath(path, args.input_rgb_dir))
        out_dir = osp.join(args.output_dir, rel_dir)
        os.makedirs(out_dir, exist_ok=True)
        base = osp.splitext(osp.basename(path))[0] + "_pred"
        np.save(osp.join(out_dir, base + ".npy"), out.pred_np)
        if args.mode == "depth":  # 16-bit png (run.py:451-456)
            png = (out.pred_np * 65535.0).astype(np.uint16)
            Image.fromarray(png).save(osp.join(out_dir, base + ".png"), mode="I;16")
        else:
            png = (out.pred_np * 255.0).astype(np.uint8)
            Image.fromarray(png).save(osp.join(out_dir, base + ".png"))
        if out.pred_colored is not None:
            Image.fromarray(out.pred_colored).save(osp.join(out_dir, base + "_colored.png"))
        if out.uncertainty is not None:  # the ensemble's disagreement map
            np.save(osp.join(out_dir, base + "_uncert.npy"), out.uncertainty)
        logging.info(f"saved {base} -> {out_dir}")

    def read(path):
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))

    if args.batch_size != 0 and args.archs == "genpercept":
        outs = pipe.batch([read(p) for p in rgb_paths], batch_size=max(args.batch_size, 0))
        for path, out in zip(rgb_paths, outs):
            save_one(path, out)
    else:
        seed = 0 if args.seed is None else args.seed
        for path in rgb_paths:
            # a fresh generator per image: each image gets the same draw
            generator = torch.Generator(pipe.device).manual_seed(seed)
            save_one(path, pipe(read(path), generator=generator))

    if (args.int8_calibration and args.int8_vae and pipe.calibrated
            and not osp.exists(args.int8_calibration)):
        pipe.save_calibration(args.int8_calibration)
        logging.info(f"saved int8 calibration to {args.int8_calibration}")


if __name__ == "__main__":
    main()
