"""Inference batch sizes for one NVIDIA H100 80GB.

Counterpart of ``genpercept_tpu/utils/batchsize.py``, whose table is for a
16 GB TPU v5e: here each row is the largest batch that
``GenPerceptPipeline.batch`` ran for square images of that side on one
H100 80GB HBM3 (700 W), with UNet, VAE and CLIP text tower resident,
measured by ``scripts/measure_batch_table.py``.
"""

from __future__ import annotations

import bisect

# {dtype: {processing resolution (long side): largest batch}}
_H100_TABLE = {
    "bfloat16": {512: 85, 768: 38, 1024: 21, 1536: 9},
    "float32": {512: 83, 768: 37, 1024: 20, 1536: 9},
}


def find_batch_size(ensemble_size: int, input_res: int, dtype: str = "bfloat16") -> int:
    """Largest batch of one pipeline call at ``input_res`` on one card:
    the row of the smallest measured resolution at or above it, 1 above
    the table, at most ``ensemble_size`` when ensembling."""
    table = _H100_TABLE.get(str(dtype).replace("torch.", ""), _H100_TABLE["float32"])
    keys = sorted(table)
    idx = bisect.bisect_left(keys, input_res)
    if idx >= len(keys):
        return 1
    bs = table[keys[idx]]
    return max(min(bs, ensemble_size) if ensemble_size > 1 else bs, 1)
