"""Logging: file and console handlers, the metrics logger, the wandb
helpers and the eval summary table.

Counterpart of ``genpercept_tpu/utils/logging_util.py``. Scalars go to
``metrics.jsonl`` in the run directory, and to tensorboard when
``torch.utils.tensorboard`` imports. wandb is optional: every wandb helper
degrades to a no-op returning None when the package is missing, so the
JSONL (and tensorboard) stream stays the default.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional


def config_logging(cfg_logging=None, out_dir: Optional[str] = None) -> None:
    """Console logging, and ``out_dir/logging.log`` when out_dir is given, at
    the level ``cfg_logging["level"]`` (INFO by default); replaces any
    handlers already on the root logger."""
    level = logging.INFO
    if cfg_logging is not None:
        level = getattr(logging, str(cfg_logging.get("level", "INFO")).upper(), logging.INFO)
    fmt = "%(asctime)s - %(levelname)s - %(name)s - %(message)s"
    handlers = [logging.StreamHandler()]
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        handlers.append(logging.FileHandler(os.path.join(out_dir, "logging.log")))
    logging.basicConfig(level=level, format=fmt, handlers=handlers, force=True)


class MetricsLogger:
    """Appends one JSON line per scalar to ``out_dir/metrics.jsonl``, and
    mirrors it to ``out_dir/tensorboard`` when tensorboard is importable."""

    def __init__(self, out_dir: str, enable_tensorboard: bool = True):
        os.makedirs(out_dir, exist_ok=True)
        self._jsonl = open(os.path.join(out_dir, "metrics.jsonl"), "a")
        self._tb = None
        if enable_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                logging.getLogger(__name__).info("tensorboard not installed: metrics.jsonl only")
            else:
                self._tb = SummaryWriter(os.path.join(out_dir, "tensorboard"))

    def log_scalar(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(json.dumps({"t": time.time(), "step": step, tag: float(value)}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def log_dict(self, scalars: Dict[str, float], step: int, prefix: str = "") -> None:
        for k, v in scalars.items():
            self.log_scalar(f"{prefix}{k}", v, step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


# wandb (the reference force-disables it in accelerate_train.py:139-140 but
# ships these helpers for runs that turn it back on)

def init_wandb(enable: bool, **kwargs):
    """A wandb run syncing the tensorboard scalars, or a disabled one; None
    when wandb is not installed."""
    try:
        import wandb
    except ImportError:
        if enable:
            logging.warning("wandb requested but not installed; disabled")
        return None
    if enable:
        return wandb.init(sync_tensorboard=True, **kwargs)
    return wandb.init(mode="disabled")


def save_wandb_job_id(run, out_dir: str) -> None:
    """Persist the run id so a resumed run reattaches to the same wandb run."""
    if run is None:
        return
    with open(os.path.join(out_dir, "WANDB_ID"), "w") as f:
        f.write(run.id)


def load_wandb_job_id(out_dir: str) -> Optional[str]:
    """The persisted run id, or None when there is no WANDB_ID file."""
    path = os.path.join(out_dir, "WANDB_ID")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return f.read().strip()


def log_slurm_job_id(metrics: MetricsLogger, step: int) -> None:
    """Record the SLURM job id as a scalar (-1 outside SLURM), so a resumed
    run's metric stream shows which job produced which steps."""
    jobid = int(os.getenv("SLURM_JOB_ID", -1))
    metrics.log_scalar("job_id", jobid, step)
    logging.debug("Slurm job_id: %s", jobid)


def eval_dic_to_text(val_metrics: Dict[str, float], dataset_name: str,
                     sample_list_path: str, diff: Optional[str] = None) -> str:
    """Tabulated eval summary."""
    header = f"Eval metrics: dataset {dataset_name}, split {sample_list_path}"
    if diff:
        header += f", diff {diff}"
    keys = list(val_metrics)
    widths = [max(len(k), 10) for k in keys]
    row1 = " | ".join(k.ljust(w) for k, w in zip(keys, widths))
    row2 = " | ".join(f"{val_metrics[k]:.6f}".ljust(w) for k, w in zip(keys, widths))
    return "\n".join([header, row1, row2])
