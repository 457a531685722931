"""LR schedule: IterExponential, as ``genpercept_tpu/train/lr.py``.

Linear warmup 0 -> 1 over warmup_steps, then exponential decay reaching
final_ratio at total_iter_length, constant afterwards. The schedule maps an
optimizer count to the learning rate, computed in f32 as the JAX schedule.
"""

from __future__ import annotations

import numpy as np


def iter_exponential_schedule(base_lr: float, total_iter_length: int,
                              final_ratio: float = 0.01, warmup_steps: int = 100):
    decay_steps = max(total_iter_length - warmup_steps, 1)
    f32 = np.float32
    log_final = np.log(f32(final_ratio))

    def schedule(step: int) -> float:
        step = f32(step)
        if step < warmup_steps:
            mult = step / f32(max(warmup_steps, 1))
        else:
            progress = np.clip((step - f32(warmup_steps)) / f32(decay_steps), f32(0), f32(1))
            mult = np.exp(progress * log_final)
        return float(f32(base_lr) * mult)

    return schedule
