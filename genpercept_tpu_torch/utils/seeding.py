"""Seeding and the reproducible per-iteration seed stream.

Copy of ``genpercept_tpu/utils/seeding.py``: ``generate_seed_sequence``
draws one seed per training iteration from Python's ``random`` so that the
timestep draws replay identically across a checkpoint resume.
"""

from __future__ import annotations

import random
from typing import List, Optional

import numpy as np


def seed_all(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed % (2**32))


def generate_seed_sequence(
    initial_seed: Optional[int], length: int, min_val=-0x8000_0000_0000_0000,
    max_val=0xFFFF_FFFF_FFFF_FFFF,
) -> List[int]:
    if initial_seed is None:
        return [None] * length  # type: ignore[list-item]
    rng = random.Random(initial_seed)
    return [rng.randint(min_val, max_val) for _ in range(length)]
