"""Offline metric CLI on PyTorch (rebuild of reference `eval.py`).

    python -m genpercept_tpu_torch.cli.eval --dataset_config Y \
        --base_data_dir DATA --prediction_dir P --output_dir O \
        [--alignment least_square|least_square_disparity|none] [--device cuda]

Counterpart of ``genpercept_tpu/cli/eval.py``, with the same flags and
``--device``: reads each eval sample's GT through the dataset (EVAL mode)
and its saved .npy prediction (``cli/infer.py``'s layout: the rgb path's
directory, the dataset's prediction name), aligns it by least squares in
numpy (optionally in disparity space), clips it to the dataset's depth
range, computes the 10 metrics in torch on the device, and writes
per_sample_metrics.csv and eval_metrics.txt. Runs on the card unless
``--device cpu`` or ``--no_cuda`` is given.
"""

from __future__ import annotations

import argparse
import csv
import logging
import os
import os.path as osp

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="GenPercept evaluation (PyTorch)")
    p.add_argument("--dataset_config", required=True)
    p.add_argument("--base_data_dir", default=os.environ.get("BASE_DATA_DIR", ""))
    p.add_argument("--prediction_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--alignment", default="least_square",
                   choices=["least_square", "least_square_disparity", "none"])
    p.add_argument("--alignment_max_res", type=int, default=None)
    p.add_argument("--no_cuda", action="store_true", help="compute on the CPU")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    return p


def main(argv=None):
    import torch

    from genpercept_tpu_torch.data import DatasetMode, get_dataset, get_pred_name
    from genpercept_tpu_torch.eval import (
        METRIC_FUNCS,
        MetricTracker,
        align_depth_least_square,
        compute_metrics,
        depth2disparity,
        disparity2depth,
    )
    from genpercept_tpu_torch.utils.config import recursive_load_config
    from genpercept_tpu_torch.utils.logging_util import eval_dic_to_text

    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = torch.device("cpu" if args.no_cuda else args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("cli/eval.py runs on the card by default and no CUDA device is "
                           "available; pass --device cpu or --no_cuda")

    cfg_data = recursive_load_config(args.dataset_config)
    dataset_cfg = cfg_data.get("dataset", cfg_data)
    dataset = get_dataset(dataset_cfg, args.base_data_dir, DatasetMode.EVAL)

    tracker = MetricTracker(*METRIC_FUNCS.keys())
    per_sample_rows = []

    def on_device(x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=device)[None]

    for i in range(len(dataset)):
        item = dataset[i]
        gt = np.asarray(item["depth_raw_linear"], np.float64)
        valid = np.asarray(item["valid_mask_raw"]).astype(bool)
        # cli/infer.py's layout: dirname(rgb)/pred_name (reference
        # eval.py:156-162), so KITTI's repeated basenames do not collide
        rgb_rel = item["rgb_relative_path"]
        pred_base = get_pred_name(osp.basename(rgb_rel), dataset.name_mode, ".npy")
        pred_name = osp.join(osp.dirname(rgb_rel), pred_base)
        pred_path = osp.join(args.prediction_dir, pred_name)
        if not osp.exists(pred_path):
            logging.warning(f"missing prediction: {pred_path}")
            continue
        pred = np.load(pred_path)
        if pred.shape != gt.shape:
            raise ValueError(f"shape mismatch {pred.shape} vs {gt.shape} for {pred_name}")

        # alignment (reference eval.py:169-197)
        if args.alignment == "least_square":
            pred, _, _ = align_depth_least_square(
                gt, pred, valid, max_resolution=args.alignment_max_res)
        elif args.alignment == "least_square_disparity":
            # the mask takes pred > 0 too and the aligned disparity clips at 1e-3
            gt_disp, nonneg = depth2disparity(gt, return_mask=True)
            pred_disp, _, _ = align_depth_least_square(
                gt_disp, pred, valid & nonneg & (pred > 0),
                max_resolution=args.alignment_max_res)
            pred = disparity2depth(np.clip(pred_disp, 1e-3, None))

        # clip to the dataset's range (eval.py:199-205)
        pred = np.clip(pred, dataset.min_depth, dataset.max_depth)
        pred = np.clip(pred, 1e-6, None)

        m = compute_metrics(on_device(pred), on_device(gt), on_device(valid, torch.bool))
        m = {k: float(v) for k, v in m.items()}
        for k, v in m.items():
            tracker.update(k, v)
        per_sample_rows.append({"sample": pred_name, **m})

    os.makedirs(args.output_dir, exist_ok=True)
    if per_sample_rows:
        with open(osp.join(args.output_dir, "per_sample_metrics.csv"), "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(per_sample_rows[0]))
            writer.writeheader()
            writer.writerows(per_sample_rows)

    summary = tracker.result()
    text = eval_dic_to_text(summary, dataset.disp_name or "dataset", dataset.filename_ls_path)
    with open(osp.join(args.output_dir, "eval_metrics.txt"), "w") as f:
        f.write(text + "\n")
    print(text)
    return summary


if __name__ == "__main__":
    main()
