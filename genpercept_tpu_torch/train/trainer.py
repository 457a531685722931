"""Training orchestration around ``build_train_step``.

Counterpart of ``genpercept_tpu/train/trainer.py``: epoch and batch
bookkeeping with batch-exact resume (``skip_first_batches`` plus the
per-iteration seed-sequence replay of the timestep draws), an exit-after
time budget, checkpoint save and resume, and metrics in ``metrics.jsonl``.
Validation and visualization run the inference pipeline and the eval
metrics, which are not ported yet: their periods must stay 0.
"""

from __future__ import annotations

import logging
import os.path as osp
import time
from typing import Dict, Optional

import numpy as np
import torch

from genpercept_tpu_torch.data.sampler import skip_first_batches
from genpercept_tpu_torch.io.checkpoints import load_train_checkpoint, save_train_checkpoint
from genpercept_tpu_torch.train.train_step import (
    TrainConfig,
    build_train_step,
    init_train_state,
)
from genpercept_tpu_torch.utils.logging_util import MetricsLogger
from genpercept_tpu_torch.utils.seeding import generate_seed_sequence

logger = logging.getLogger(__name__)

GT_KEY, MASK_KEY = "depth_raw_norm", "valid_mask_raw"  # depth mode's


class Trainer:
    def __init__(
        self,
        cfg: TrainConfig,
        models,  # pipeline.GenPerceptModels, on the training device
        train_loader,
        out_dir: str,
        max_iter: int = 30000,
        save_period: int = 50,
        val_period: int = 0,
        vis_period: int = 0,
        main_seed: Optional[int] = 0,
    ):
        if val_period or vis_period:
            raise NotImplementedError(
                "validation and visualization need the eval package, not ported yet")
        self.cfg = cfg
        self.models = models
        self.train_loader = train_loader
        self.out_dir = out_dir
        self.max_iter = max_iter
        self.save_period = save_period
        self.device = models.device

        self.trainable, self.frozen, self.optimizer = init_train_state(models, cfg)
        if cfg.compute_dtype == torch.bfloat16:
            # frozen parts carry no optimizer state and every op casts weights
            # to the activation dtype anyway: store them in bf16
            for x in self.frozen.values():
                if x.dtype == torch.float32:
                    x.data = x.data.to(torch.bfloat16)
        self.step_fn = build_train_step(cfg, models, self.optimizer)

        self.effective_iter = 0
        self.epoch = 0
        self.n_batch_in_epoch = 0
        # one seed per iteration, replayed on resume
        self.seed_sequence = generate_seed_sequence(main_seed, max_iter + 1)
        self.metrics_logger = MetricsLogger(out_dir)

    # ------------------------------------------------------------- batching

    def _device_batch(self, raw: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        gt = raw[GT_KEY]
        if gt.ndim == 3:  # (B, H, W) single channel -> 3 channels
            gt = np.repeat(gt[..., None], 3, axis=-1)
        mask = raw[MASK_KEY]
        if mask.ndim == 4:
            mask = mask[..., 0]

        def put(x, dtype=np.float32):
            return torch.as_tensor(np.asarray(x, dtype), device=self.device)

        batch = {"rgb_norm": put(raw["rgb_norm"]), "gt_norm": put(gt),
                 "valid_mask": put(mask, bool)}
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
                if self.save_period and self.effective_iter % self.save_period == 0:
                    self.save_checkpoint("latest")
                if self.effective_iter >= self.max_iter:
                    break
                if t_end is not None and time.time() > t_end:
                    logger.info("time budget reached; saving and exiting")
                    self.save_checkpoint("latest")
                    return
            self.n_batch_in_epoch = 0
        self.save_checkpoint("final")
        logger.info(f"Training finished in {time.time() - start:.0f}s")

    # ----------------------------------------------------------- checkpoint

    def _counters(self) -> Dict[str, int]:
        return {"effective_iter": self.effective_iter, "epoch": self.epoch,
                "n_batch_in_epoch": self.n_batch_in_epoch}

    def save_checkpoint(self, name: str = "latest") -> str:
        state = {"trainable": {k: p.detach() for k, p in self.trainable.items()},
                 "opt_state": self.optimizer.state_dict(),
                 "counters": self._counters()}
        path = save_train_checkpoint(osp.join(self.out_dir, "checkpoint"), state, name)
        logger.info(f"checkpoint saved: {path}")
        return path

    def load_checkpoint(self, name: str = "latest") -> None:
        state = load_train_checkpoint(osp.join(self.out_dir, "checkpoint"), name,
                                      map_location=self.device)
        if set(state["trainable"]) != set(self.trainable):
            raise ValueError("checkpoint holds other trainable parameters than this run")
        with torch.no_grad():
            for k, p in self.trainable.items():
                p.copy_(state["trainable"][k])
        self.optimizer.load_state_dict(state["opt_state"])
        c = state["counters"]
        self.effective_iter = int(c["effective_iter"])
        self.epoch = int(c["epoch"])
        self.n_batch_in_epoch = int(c["n_batch_in_epoch"])
        logger.info(f"resumed at iter {self.effective_iter}")
