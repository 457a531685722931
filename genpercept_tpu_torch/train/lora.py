"""LoRA adapters for the UNet attention projections.

Counterpart of ``genpercept_tpu/train/lora.py``: rank-r adapters on every
``to_q`` / ``to_k`` / ``to_v`` / ``to_out.0`` weight of the UNet, alpha ==
rank (scale 1), A ~ N(0, 1) / r and B = 0, so the adapted UNet starts as the
base. The adapters keep the JAX layout, A (din, r) and B (r, dout), keyed
``<weight name>.lora_A`` / ``.lora_B``; a torch weight is (dout, din), so
its delta is (A @ B)^T, rounded to the weight's dtype before the add, as
JAX rounds it.

``apply_lora`` returns the adapted weights as tensors that depend on A and
B; the training step hands them to ``unet_apply(attn_weights=...)`` and
never writes them into the module. On a rank of a tensor-parallel model
group (``parallel/tensor.py``) a split weight holds the rank's share: the
adapters stay whole on every rank, as JAX's name rules leave them, and the
merge is sliced to the share, each adapter entering through f so that its
gradient sums the ranks' shares. ``merge_lora`` is the same sum without
gradients, for export. The adapters are drawn from a ``torch.Generator``
(the JAX package seeds each subtree with Python's salted ``hash``, so its
init differs between processes).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from genpercept_tpu_torch.parallel import tensor as TP

TARGET_LEAVES = ("to_q", "to_k", "to_v")
TARGET_OUT = "to_out"


def is_target(name: str) -> bool:
    """A UNet parameter name that takes an adapter (JAX ``_is_target``)."""
    path = name.split(".")
    if path[-1] != "weight":
        return False
    mods = path[:-1]
    if mods and mods[-1] in TARGET_LEAVES:
        return True
    return len(mods) >= 2 and mods[-2] == TARGET_OUT and mods[-1] == "0"


def init_lora(generator: Optional[torch.Generator], unet: nn.Module,
              rank: int) -> Dict[str, torch.Tensor]:
    """{"<weight>.lora_A": (din, r), "<weight>.lora_B": (r, dout)} for every
    target weight, in the weight's dtype and on its device; A is drawn from
    ``generator`` (on its device) in f32 and scaled by 1 / r."""
    gdev = generator.device if generator is not None else None
    out: Dict[str, torch.Tensor] = {}
    for name, w in unet.named_parameters():
        if not is_target(name):
            continue
        dout, din = w.shape
        a = torch.randn((din, rank), generator=generator, device=gdev) * (1.0 / rank)
        out[f"{name}.lora_A"] = a.to(device=w.device, dtype=w.dtype)
        out[f"{name}.lora_B"] = torch.zeros((rank, dout), device=w.device, dtype=w.dtype)
    return out


def lora_pairs(lora: Dict[str, torch.Tensor]) -> Dict[str, tuple]:
    """{weight name: (A, B)}."""
    names = sorted({k.rsplit(".", 1)[0] for k in lora})
    return {n: (lora[f"{n}.lora_A"], lora[f"{n}.lora_B"]) for n in names}


def apply_lora(unet: nn.Module, lora: Dict[str, torch.Tensor],
               scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """{weight name: W + scale * (A @ B)^T} for every adapted weight, each
    delta rounded to W's dtype before the add; differentiable in A and B.
    A weight split over the model group takes its share of the delta."""
    params = dict(unet.named_parameters())
    out = {}
    for name, (a, b) in lora_pairs(lora).items():
        if name not in params:
            raise KeyError(f"{name}: no such UNet weight for a LoRA adapter")
        w = params[name]
        split = TP.split_of(w)
        if split is not None:
            a, b = TP.copy_to_model(a), TP.copy_to_model(b)
        delta = TP.local_share((a @ b).t(), split)
        if delta.shape != w.shape:
            raise ValueError(f"{name}: adapter delta {tuple(delta.shape)} for a weight "
                             f"{tuple(w.shape)}")
        out[name] = w + scale * delta.to(device=w.device, dtype=w.dtype)
        if split is not None:  # the merge stands in for the share in the split layer
            out[name].tp_split = split
    return out


@torch.no_grad()
def merge_lora(unet: nn.Module, lora: Dict[str, torch.Tensor],
               scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """The UNet's state dict with every adapter merged (export)."""
    state = {k: v.detach() for k, v in unet.state_dict().items()}
    state.update(apply_lora(unet, lora, scale))
    return state


def count_lora_params(lora: Dict[str, torch.Tensor]) -> int:
    return sum(v.numel() for v in lora.values())
