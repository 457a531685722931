"""Training orchestration around ``build_train_step``.

Counterpart of ``genpercept_tpu/train/trainer.py``: epoch and batch
bookkeeping with batch-exact resume (``skip_first_batches`` plus the
per-iteration seed-sequence replay of the timestep draws), an exit-after
time budget, checkpoint save and resume, metrics in ``metrics.jsonl``, and
periodic validation and visualization. Both run the inference pipeline on
the trainer's own modules, whose parameters the step trains in place (and
stores in bf16 where the config says so): validation scores least-squares
aligned depth (masked L1 in the other modes), visualization writes colorized
PNGs.

In a data-parallel run (``parallel/``; the loader yields this data
index's slice of each global batch) every rank starts from the same
trainable parameters (checked), the step sums the gradients over the data
group, ``zero1`` shards the Adam moments over it, and rank 0 alone writes
the metrics and the checkpoints (every rank reads them on resume).

Under tensor parallelism (``--model_parallel`` M > 1) the Trainer puts
each rank's share of the UNet's attention and GEGLU layers in place
(``parallel/tensor.py``; the frozen base of a LoRA run too) and checks the
replicated parameters over the world and a shard over its data group.
Validation and visualization run the split forward on every rank of rank
0's model group while rank 0 writes and the others wait, so nothing is
gathered for them. A checkpoint is written whole, in the one-process
layout: rank 0's model group gathers the shards and their Adam moments; a
resume slices them again, so one process resumes a tensor-parallel run's
checkpoint and ``cli/export.py`` reads it unchanged.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import os.path as osp
import time
from typing import Dict, Optional

import numpy as np
import torch

from genpercept_tpu_torch import parallel
from genpercept_tpu_torch.data.sampler import skip_first_batches
from genpercept_tpu_torch.eval import MetricTracker, align_depth_least_square, compute_metrics
from genpercept_tpu_torch.io.checkpoints import load_train_checkpoint, save_train_checkpoint
from genpercept_tpu_torch.parallel import tensor as TP
from genpercept_tpu_torch.train.train_step import (
    TrainConfig,
    build_train_step,
    init_train_state,
)
from genpercept_tpu_torch.utils.logging_util import MetricsLogger, eval_dic_to_text
from genpercept_tpu_torch.utils.seeding import generate_seed_sequence

logger = logging.getLogger(__name__)

GT_KEYS = {
    "depth": ("depth_raw_norm", "valid_mask_raw"),
    "normal": ("normal_raw_norm", "valid_mask_raw_normal"),
    "matting": ("matting_raw_norm", "valid_mask_raw_matting"),
    "dis": ("dis_raw_norm", "valid_mask_raw_dis"),
    "seg": ("seg_raw_norm", "valid_mask_raw_seg"),
    "disparity": ("depth_raw_norm", "valid_mask_raw"),
    "disparity_dpt_head": ("depth_raw_norm", "valid_mask_raw"),
}


class _NullMetricsLogger:
    """The metrics logger of the ranks other than 0."""

    def log_scalar(self, tag, value, step):
        pass

    def log_dict(self, d, step, prefix=""):
        pass

    def close(self):
        pass


class Trainer:
    def __init__(
        self,
        cfg: TrainConfig,
        models,  # pipeline.GenPerceptModels, on the training device
        train_loader,
        out_dir: str,
        val_loaders: Optional[Dict[str, object]] = None,
        max_iter: int = 30000,
        save_period: int = 50,
        val_period: int = 0,
        vis_period: int = 0,
        vis_loaders: Optional[Dict[str, object]] = None,
        main_seed: Optional[int] = 0,
        zero1: bool = False,
    ):
        self.cfg = cfg
        self.models = models
        self.train_loader = train_loader
        self.val_loaders = val_loaders or {}
        self.out_dir = out_dir
        self.max_iter = max_iter
        self.save_period = save_period
        self.val_period = val_period
        self.vis_period = vis_period
        self.vis_loaders = vis_loaders or {}
        self.device = models.device

        self.trainable, self.frozen, self.optimizer = init_train_state(
            models, cfg, torch.Generator().manual_seed(main_seed or 0))
        if cfg.compute_dtype == torch.bfloat16:
            # frozen parts carry no optimizer state and every op casts weights
            # to the activation dtype anyway: store them in bf16, as JAX does.
            # That includes a LoRA run's base UNet, so each merge is
            # W_bf16 + delta rounded to bf16, JAX's rounding
            for x in self.frozen.values():
                if x.dtype == torch.float32:
                    x.data = x.data.to(torch.bfloat16)
        if parallel.model_world() > 1:
            TP.shard_unet_(models.unet)
            TP.check_carried(models.vae, "vae")
            if models.dpt_head is not None:
                TP.check_carried(models.dpt_head, "dpt_head")
        # every rank starts from the same parameters (each loaded or drew
        # them from the same seed); a shard is held by its data group
        splits = self.splits
        parallel.check_replicated([p for k, p in self.trainable.items() if k not in splits],
                                  "trainable parameters")
        if splits:
            parallel.check_replicated(
                [p for k, p in self.trainable.items() if k in splits], "trainable shards",
                group="data")
        self.zero1 = zero1 and parallel.data_world() > 1  # one replica: nothing to shard
        if self.zero1:
            self.optimizer = parallel.Zero1(self.optimizer)
        self.step_fn = build_train_step(cfg, models, self.optimizer)

        self.effective_iter = 0
        self.epoch = 0
        self.n_batch_in_epoch = 0
        # one seed per iteration, replayed on resume
        self.seed_sequence = generate_seed_sequence(main_seed, max_iter + 1)
        self.is_main = parallel.rank() == 0
        self.in_main_group = parallel.data_rank() == 0  # rank 0's model group
        self.metrics_logger = MetricsLogger(out_dir) if self.is_main else _NullMetricsLogger()

    @property
    def splits(self) -> Dict[str, TP.Split]:
        """{trainable name: split} of the tensor-parallel shards this rank
        holds (empty with M = 1), read from the parameters themselves."""
        return {k: s for k, p in self.trainable.items() if (s := TP.split_of(p)) is not None}

    # ------------------------------------------------------------- batching

    def _device_batch(self, raw: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        gt_key, mask_key = GT_KEYS[self.cfg.mode]
        gt = raw[gt_key]
        if gt.ndim == 3:  # (B, H, W) single channel -> 3 channels
            gt = np.repeat(gt[..., None], 3, axis=-1)
        mask = raw[mask_key]
        if mask.ndim == 4:
            mask = mask[..., 0]

        def put(x, dtype=np.float32):
            return torch.as_tensor(np.asarray(x, dtype), device=self.device)

        batch = {"rgb_norm": put(raw["rgb_norm"]), "gt_norm": put(gt),
                 "valid_mask": put(mask, bool)}
        if "intrinsic" in raw:  # camera K for the vnl loss
            batch["intrinsic"] = put(raw["intrinsic"])
        a = self.cfg.grad_accum_steps
        if a > 1:  # the loader yields (accum * micro, ...)
            batch = {k: v.reshape((a, v.shape[0] // a) + v.shape[1:])
                     for k, v in batch.items()}
        return batch

    # --------------------------------------------------------------- train

    def train(self, t_end: Optional[float] = None) -> None:
        logger.info("Training started")
        start = time.time()
        while self.effective_iter < self.max_iter:
            self.epoch += 1
            loader = (skip_first_batches(self.train_loader, self.n_batch_in_epoch)
                      if self.n_batch_in_epoch > 0 else iter(self.train_loader))
            for raw in loader:
                batch = self._device_batch(raw)
                seed = self.seed_sequence[self.effective_iter]
                gen = torch.Generator().manual_seed((seed or 0) % (2**63))
                metrics = self.step_fn(batch, gen)
                self.effective_iter += 1
                self.n_batch_in_epoch += 1

                values = {k: float(v) for k, v in metrics.items()}
                if not np.isfinite(values["loss"]):
                    raise RuntimeError(f"non-finite loss at iter {self.effective_iter}")
                self.metrics_logger.log_dict(values, self.effective_iter, prefix="train/")
                if self.effective_iter % 50 == 0:
                    logger.info(f"iter {self.effective_iter}: loss={values['loss']:.4f}")
                self._periodic_callbacks()
                if self.effective_iter >= self.max_iter:
                    break
                # the ranks stop together: rank 0's clock decides
                if t_end is not None and parallel.from_rank0(time.time() > t_end):
                    logger.info("time budget reached; saving and exiting")
                    self.save_checkpoint("latest")
                    return
            self.n_batch_in_epoch = 0
        self.save_checkpoint("final")
        logger.info(f"Training finished in {time.time() - start:.0f}s")

    def _periodic_callbacks(self) -> None:
        if self.save_period and self.effective_iter % self.save_period == 0:
            self.save_checkpoint("latest")
        do_val = self.val_period and self.effective_iter % self.val_period == 0
        do_vis = self.vis_period and self.effective_iter % self.vis_period == 0
        # rank 0 alone validates and visualizes (reference
        # genpercept_trainer.py:1001-1063) while the others wait; a split
        # model runs its forward on all of rank 0's model group
        if self.in_main_group and do_val:
            self.validate()
        if self.in_main_group and do_vis:
            self.visualize()
        if do_val or do_vis:
            parallel.barrier()

    # ------------------------------------------------- validate, visualize

    def _infer(self):
        """The inference pipeline's forward on the live modules, in
        PipelineConfig's default dtype: each op casts the weights, stored in
        f32 or bf16, to the activations' dtype, as the JAX ops do. Nothing is
        copied or recast in place."""
        from genpercept_tpu_torch.pipeline import PipelineConfig, build_single_infer

        infer = build_single_infer(self.models, PipelineConfig(mode=self.cfg.mode))

        def run(raw) -> torch.Tensor:
            rgb01 = (np.asarray(raw["rgb_norm"]) + 1.0) / 2.0
            return infer(torch.as_tensor(rgb01, dtype=torch.float32, device=self.device))

        return run

    @torch.no_grad()
    def visualize(self) -> None:
        """Colorized predictions on the vis splits, at most 4 a split, as
        visualization/iter_NNNNNN/<split>_NNN.png."""
        from PIL import Image

        from genpercept_tpu_torch.ops.colorize import colorize_depth

        infer = self._infer()
        vis_dir = osp.join(self.out_dir, "visualization", f"iter_{self.effective_iter:06d}")
        if self.is_main:
            os.makedirs(vis_dir, exist_ok=True)
        for name, loader in self.vis_loaders.items():
            for j, raw in enumerate(loader):
                pred = infer(raw)
                img = colorize_depth(pred[0]) if pred.ndim == 3 else pred[0]  # (H, W, 3)
                img = (img * 255).to(torch.uint8).cpu().numpy()
                if self.is_main:
                    Image.fromarray(img).save(osp.join(vis_dir, f"{name}_{j:03d}.png"))
                if j >= 3:
                    break

    @torch.no_grad()
    def validate(self) -> Dict[str, Dict[str, float]]:
        """The inference pipeline over each val split. Depth mode: the
        least-squares aligned (numpy lstsq per image) abs_relative_difference
        and delta1_acc; other modes: masked L1 against the normalized GT.
        Logged under val/<split>/."""
        infer = self._infer()
        gt_key, mask_key = GT_KEYS[self.cfg.mode]
        results = {}
        for name, loader in self.val_loaders.items():
            tracker = MetricTracker()
            for raw in loader:
                pred = infer(raw).cpu().numpy()
                if self.cfg.mode != "depth":
                    gt01 = (np.asarray(raw[gt_key]) + 1.0) / 2.0
                    mask = np.asarray(raw[mask_key]).astype(bool)
                    if pred.ndim == 4 and gt01.ndim == 3:
                        gt01 = gt01[..., None]
                    diff = np.abs(pred - gt01)
                    if diff.ndim == 4:
                        diff = diff.mean(-1)
                    tracker.update("masked_l1", float(diff[mask].mean()) if mask.any() else 0.0)
                    continue
                gt = np.asarray(raw["depth_raw_linear"])
                valid = np.asarray(raw["valid_mask_raw"]).astype(bool)
                for i in range(pred.shape[0]):
                    if not valid[i].any():
                        continue
                    aligned, _, _ = align_depth_least_square(gt[i], pred[i], valid[i])
                    aligned = np.clip(aligned, 1e-6, None)
                    m = compute_metrics(
                        *(torch.as_tensor(a, device=self.device)[None]
                          for a in (aligned, gt[i], valid[i])),
                        names=["abs_relative_difference", "delta1_acc"])
                    for k, v in m.items():
                        tracker.update(k, float(v))
            results[name] = tracker.result()
            self.metrics_logger.log_dict(results[name], self.effective_iter,
                                         prefix=f"val/{name}/")
            logger.info("\n" + eval_dic_to_text(results[name], name, "val"))
        return results

    # ----------------------------------------------------------- checkpoint

    def _counters(self) -> Dict[str, int]:
        return {"effective_iter": self.effective_iter, "epoch": self.epoch,
                "n_batch_in_epoch": self.n_batch_in_epoch}

    def one_process_state(self, opt_state: dict) -> tuple:
        """(trainable, opt_state) in the one-process layout: each shard and
        its moments gathered over the model group (a collective of it; the
        moments where they lie, ZeRO-1's on the CPU)."""
        splits = list(map(TP.split_of, self.trainable.values()))
        trainable = {k: TP.gather_over_model(p.detach(), TP.split_of(p))
                     for k, p in self.trainable.items()}
        state = {i: {m: TP.gather_over_model(t.to(self.device), splits[i])
                     .to(t.device) for m, t in st.items()}
                 for i, st in opt_state["state"].items()}
        return trainable, {**opt_state, "state": state}

    def save_checkpoint(self, name: str = "latest") -> str:
        """Rank 0 writes; every rank returns the path once it is written."""
        # ZeRO-1's state_dict gathers each data index's share: every rank
        # calls it; rank 0's model group gathers the tensor-parallel shards
        opt_state = (self.optimizer.state_dict() if self.zero1 or self.in_main_group
                     else None)
        trainable = {k: p.detach() for k, p in self.trainable.items()}
        if self.splits and self.in_main_group:
            trainable, opt_state = self.one_process_state(opt_state)
        path = osp.abspath(osp.join(self.out_dir, "checkpoint", name))
        if self.is_main:
            state = {"trainable": trainable, "opt_state": opt_state,
                     "counters": self._counters()}
            if self.models.dpt_head is not None:  # which head cli/export.py writes
                state["dpt_head_cfg"] = dataclasses.asdict(self.models.dpt_head.cfg)
            path = save_train_checkpoint(osp.join(self.out_dir, "checkpoint"), state, name)
            logger.info(f"checkpoint saved: {path}")
        parallel.barrier()
        return path

    def load_checkpoint(self, name: str = "latest") -> None:
        state = load_train_checkpoint(osp.join(self.out_dir, "checkpoint"), name,
                                      map_location=self.device)
        if set(state["trainable"]) != set(self.trainable):
            raise ValueError("checkpoint holds other trainable parameters than this run")
        with torch.no_grad():
            for k, p in self.trainable.items():
                p.copy_(TP.local_share(state["trainable"][k], TP.split_of(p)))
        opt_state = state["opt_state"]
        splits = list(map(TP.split_of, self.trainable.values()))
        if any(x is not None for x in splits):  # this rank's share of each split parameter's moments
            opt_state = {**opt_state, "state": {
                i: {m: TP.local_share(t, splits[i]) for m, t in st.items()}
                for i, st in opt_state["state"].items()}}
        self.optimizer.load_state_dict(opt_state)
        c = state["counters"]
        self.effective_iter = int(c["effective_iter"])
        self.epoch = int(c["epoch"])
        self.n_batch_in_epoch = int(c["n_batch_in_epoch"])
        logger.info(f"resumed at iter {self.effective_iter}")
