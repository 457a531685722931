"""Training checkpoints with ``torch.save``.

Counterpart of ``genpercept_tpu/io/checkpoints.py::save_train_checkpoint``
and ``load_train_checkpoint``, which write orbax directories: here
``out_dir/name/state.pt`` holds the state dict (trainable parameters,
optimizer state, counters), with the reference's ``_old_`` backup rotation.
"""

from __future__ import annotations

import os
import os.path as osp
import shutil
from typing import Any, Dict

import torch

_FILE = "state.pt"


def save_train_checkpoint(out_dir: str, state: Dict[str, Any], name: str = "latest") -> str:
    """Save ``state`` under out_dir/name; an existing checkpoint of that name
    is kept as ``_old_<name>`` until the new one is on disk."""
    os.makedirs(out_dir, exist_ok=True)
    path = osp.abspath(osp.join(out_dir, name))
    backup = osp.join(out_dir, f"_old_{name}")
    if osp.exists(path):
        if osp.exists(backup):
            shutil.rmtree(backup)
        os.rename(path, backup)
    os.makedirs(path)
    torch.save(state, osp.join(path, _FILE))
    if osp.exists(backup):
        shutil.rmtree(backup)
    return path


def load_train_checkpoint(out_dir: str, name: str = "latest", map_location=None):
    """The state dict saved by ``save_train_checkpoint`` (tensors only, so
    it loads with ``weights_only=True``)."""
    return torch.load(osp.join(out_dir, name, _FILE), map_location=map_location,
                      weights_only=True)
