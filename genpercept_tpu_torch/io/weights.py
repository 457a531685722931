"""JAX param tree -> this package's state dict, and safetensors files.

The JAX package's param trees mirror the diffusers module paths key for key,
so the conversion is a flatten with ``.`` and a layout transform
(the logic of ``genpercept_tpu/io/weights.py::to_torch_state_dict``):
  conv weights   HWIO -> OIHW        (ndim == 4)
  linear weights (in, out) -> (out, in)   (ndim == 2, except embeddings)
  norms, biases, embeddings unchanged
Values may be numpy arrays or anything ``np.asarray`` accepts.

Published checkpoints are safetensors files already in PyTorch layouts:
``load_safetensors`` and ``save_safetensors`` read and write them
(counterparts of the JAX package's, which import ``safetensors``).
"""

from __future__ import annotations

import json
import re
import struct
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


# ------------------------------------------------------------- safetensors
#
# The file format, read and written here without the ``safetensors``
# package: an 8-byte little-endian header length N, N bytes of JSON
# ({name: {"dtype", "shape", "data_offsets": [begin, end]}}, optional
# "__metadata__" of strings; offsets relative to the end of the header),
# then the raw little-endian buffers. numpy has no bfloat16, so BF16 moves
# through int16 bits.

_ST_DTYPES = {  # the dtypes of published checkpoints
    "F32": (np.float32, torch.float32), "F16": (np.float16, torch.float16),
    "BF16": (np.int16, torch.bfloat16), "I64": (np.int64, torch.int64),
}
_ST_NAMES = {tdt: name for name, (_, tdt) in _ST_DTYPES.items()}

# buffers that published checkpoints carry and no module here holds
# (genpercept_tpu/io/weights.py _DROP_PATTERNS)
_DROP = re.compile(r"(position_ids|num_batches_tracked)$")


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A safetensors file as a flat dict of CPU tensors that view one
    copy-on-write memory map of the file: nothing is read until a tensor is
    used, and loading the dict into a module copies each tensor once.
    Drops ``position_ids`` and ``num_batches_tracked`` buffers."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    data = np.memmap(path, dtype=np.uint8, mode="c")
    base = 8 + n
    out: Dict[str, torch.Tensor] = {}
    for key, info in header.items():
        if key == "__metadata__" or _DROP.search(key):
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: {key} has dtype {info['dtype']}, which is not read here")
        np_dt, t_dt = _ST_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        arr = data[base + begin:base + end].view(np_dt).reshape(info["shape"])
        t = torch.from_numpy(arr)
        out[key] = t.view(t_dt) if t_dt == torch.bfloat16 else t
    return out


def save_safetensors(state: Mapping[str, Any], path: str) -> None:
    """Write tensors or numpy arrays as a safetensors file (the layout the
    ``safetensors`` package writes: the header padded with spaces to 8
    bytes, buffers in the header's order), with the metadata
    {"format": "pt"} that diffusers and transformers write and check."""
    arrays = {}
    for key, value in state.items():
        t = torch.as_tensor(value).detach().cpu().contiguous()
        if t.dtype not in _ST_NAMES:
            raise ValueError(f"{key}: no safetensors dtype for {t.dtype}")
        arrays[key] = t
    header: Dict[str, Any] = {"__metadata__": {"format": "pt"}}
    offset = 0
    for key, t in arrays.items():
        nbytes = t.numel() * t.element_size()
        header[key] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                       "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in arrays.values():
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            f.write(t.numpy().tobytes())
