"""JAX param tree -> this package's state dict.

The JAX package's param trees mirror the diffusers module paths key for key,
so the conversion is a flatten with ``.`` and a layout transform
(the logic of ``genpercept_tpu/io/weights.py::to_torch_state_dict``):
  conv weights   HWIO -> OIHW        (ndim == 4)
  linear weights (in, out) -> (out, in)   (ndim == 2, except embeddings)
  norms, biases, embeddings unchanged
Values may be numpy arrays or anything ``np.asarray`` accepts.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_EMBEDDING = re.compile(r"embeddings?\.weight$")


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key))
        else:
            flat[key] = v
    return flat


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested JAX param tree -> flat state dict in PyTorch layouts."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in _flatten(params).items():
        arr = np.asarray(value)
        if arr.ndim == 4:
            arr = np.transpose(arr, (3, 2, 0, 1))
        elif arr.ndim == 2 and key.endswith("weight") and not _EMBEDDING.search(key):
            arr = arr.T
        if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: no numpy bridge
            out[key] = torch.from_numpy(
                np.ascontiguousarray(arr.astype(np.float32))).to(torch.bfloat16)
        else:
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out
