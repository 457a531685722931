"""Training-metrics logging and the eval summary table.

Counterpart of part of ``genpercept_tpu/utils/logging_util.py``: scalars go
to ``metrics.jsonl`` in the run directory (tensorboard is not ported).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    """Appends one JSON line per scalar to ``out_dir/metrics.jsonl``."""

    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self._jsonl = open(os.path.join(out_dir, "metrics.jsonl"), "a")

    def log_scalar(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(json.dumps({"t": time.time(), "step": step, tag: float(value)}) + "\n")
        self._jsonl.flush()

    def log_dict(self, scalars: Dict[str, float], step: int, prefix: str = "") -> None:
        for k, v in scalars.items():
            self.log_scalar(f"{prefix}{k}", v, step)

    def close(self) -> None:
        self._jsonl.close()


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
