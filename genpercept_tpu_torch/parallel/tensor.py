"""Tensor parallelism: Megatron's column and row splits of the UNet's
attention and GEGLU layers over a model group (``parallel.set_model_parallel``).

Counterpart of ``genpercept_tpu/parallel/mesh.py::_tp_spec_for`` and
``shard_params_tp``. The JAX package only annotates shardings and XLA
places the collectives; here they are written out:

  * ``to_q``, ``to_k``, ``to_v`` and ``net.0.proj`` (and CLIP's ``q_proj``,
    ``k_proj``, ``v_proj``, ``fc1``) are column-parallel: a rank holds a
    share of their output rows (and of their biases); ``to_out.0`` and
    ``net.2`` (``out_proj``, ``fc2``) are row-parallel: a rank holds the
    matching share of their input columns, their biases whole.
  * The split unit of an attention layer is a head, so that a rank runs
    flash attention on its own heads; of ``net.0.proj`` a hidden row with
    its gate row, so that a rank's share is ``[hidden rows r; gate rows r]``
    in the layout the fused GEGLU kernel takes. A layer whose unit count
    the model group does not divide stays whole on every rank (JAX's "the
    axis does not divide" rule taken in units): SD2.1's level-0 attention
    (5 heads at M = 2) and the VAE's single-head attention.
  * ``copy_to_model`` (Megatron's f) is the identity forward whose backward
    sums the input's gradient over the model group; ``reduce_from_model``
    (g) sums the ranks' partial products forward, in f32, adds the bias
    once and rounds to the activations' dtype once; its backward is the
    identity. A recompute (``remat``) repeats g in the backward, in the
    same order on every rank.

``emulated(M)`` runs the same splits in one process on whole weights: each
split layer computes the M shares one after the other and sums their
partial products in the ranks' order, as M ranks do. It is the witness of
the splits' own rounding (``chip_smoke.py``'s ``tp_split_witness``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.nn as nn

from genpercept_tpu_torch import parallel

_COLUMN = ("to_q", "to_k", "to_v", "net.0.proj", "q_proj", "k_proj", "v_proj", "fc1")
_ROW = ("to_out.0", "net.2", "out_proj", "fc2")
_FF = ("net.0.proj", "net.2", "fc1", "fc2")


class Split(NamedTuple):
    """How a parameter is split: ``dim`` 0 splits the output rows (a
    column-parallel weight or its bias), 1 the input columns (a
    row-parallel weight); ``pairs``: the rows are a hidden half then a gate
    half (``net.0.proj``), each split alike."""

    dim: int
    pairs: bool = False


def _layer_is(layer: str, names: Sequence[str]) -> bool:
    return any(layer == m or layer.endswith("." + m) for m in names)


def tp_spec_for(name: str, shape: Sequence[int]) -> Optional[Split]:
    """The split of a parameter by JAX's name rules (``_tp_spec_for``), in
    the PyTorch layout, whether or not its units divide; None: replicated."""
    layer, _, leaf = name.rpartition(".")
    column = _layer_is(layer, _COLUMN)
    if leaf == "weight" and len(shape) == 2:
        if column:
            return Split(0, layer.endswith("net.0.proj"))
        if _layer_is(layer, _ROW):
            return Split(1)
    if leaf == "bias" and len(shape) == 1 and column:
        return Split(0, layer.endswith("net.0.proj"))
    return None


def units(name: str, split: Split, shape: Sequence[int], heads: int) -> int:
    """The split units of a split parameter's layer: its heads for an
    attention projection, its inner width (hidden/gate pairs) for a
    feed-forward."""
    if not _layer_is(name.rpartition(".")[0], _FF):
        return heads
    return shape[split.dim] // 2 if split.pairs else shape[split.dim]


def unet_heads(attention_heads: Sequence[int], name: str) -> int:
    """The heads of the UNet transformer a parameter name lies in."""
    parts = name.split(".")
    if parts[0] == "mid_block":
        return attention_heads[-1]
    if parts[0] == "down_blocks":
        return attention_heads[int(parts[1])]
    if parts[0] == "up_blocks":
        return tuple(reversed(attention_heads))[int(parts[1])]
    return 1


def plan(shapes: Dict[str, Sequence[int]], heads_of: Callable[[str], int],
         m: int) -> Dict[str, Split]:
    """{name: Split} of the parameters that are split over m ranks: those
    the name rules split whose layer's units m divides."""
    out = {}
    for name, shape in shapes.items():
        split = tp_spec_for(name, shape)
        if split is not None and units(name, split, shape, heads_of(name)) % m == 0:
            out[name] = split
    return out


def unet_plan(unet: nn.Module, m: int) -> Dict[str, Split]:
    heads = unet.cfg.attention_heads
    return plan({k: tuple(p.shape) for k, p in unet.named_parameters()},
                lambda name: unet_heads(heads, name), m)


def share(t: torch.Tensor, split: Split, m: int, r: int) -> torch.Tensor:
    """Rank r's share of t (a view)."""
    if split.pairs:
        hidden, gate = t.chunk(2, dim=0)
        return torch.cat([hidden.chunk(m, dim=0)[r], gate.chunk(m, dim=0)[r]])
    return t.chunk(m, dim=split.dim)[r]


def join(shares: Sequence[torch.Tensor], split: Split) -> torch.Tensor:
    """The whole tensor from the ranks' shares, in model order."""
    if split.pairs:
        halves = [s.chunk(2, dim=0) for s in shares]
        return torch.cat([h for h, _ in halves] + [g for _, g in halves])
    return torch.cat(list(shares), dim=split.dim)


def shard_state(state: Dict[str, torch.Tensor], splits: Dict[str, Split], m: int,
                r: int) -> Dict[str, torch.Tensor]:
    """Rank r's state from the one-process layout: each split tensor's share
    (contiguous), the others as they are."""
    return {k: share(v, splits[k], m, r).contiguous() if k in splits else v
            for k, v in state.items()}


def gather_state(states: Sequence[Dict[str, torch.Tensor]],
                 splits: Dict[str, Split]) -> Dict[str, torch.Tensor]:
    """The one-process layout from the M ranks' states (rank 0's for the
    tensors that are not split)."""
    return {k: join([s[k] for s in states], splits[k]) if k in splits else v
            for k, v in states[0].items()}


def local_share(t: torch.Tensor, split: Optional[Split]) -> torch.Tensor:
    """This rank's share of a whole tensor (t itself where ``split`` is
    None)."""
    if split is None:
        return t
    return share(t, split, parallel.model_world(), parallel.model_rank())


def gather_over_model(t: torch.Tensor, split: Optional[Split]) -> torch.Tensor:
    """The whole tensor from the model group's shares (a collective of the
    group; t itself where ``split`` is None)."""
    if split is None:
        return t
    return join(parallel.model_all_gather(t), split)


# ---------------------------------------------------------- the module


def split_of(t: torch.Tensor) -> Optional[Split]:
    """The split a tensor of a rank carries (``shard_unet_``; a LoRA merge
    of a split weight carries its weight's): the one record of the plan on
    a rank, which the split layers, the step, the merges and the Trainer
    read. None: the tensor is whole."""
    return getattr(t, "tp_split", None)


@torch.no_grad()
def shard_unet_(unet: nn.Module) -> Dict[str, Split]:
    """Replace the UNet's split parameters by this rank's shares, in place
    (the Parameter objects stay, so optimizers and name maps that hold them
    stay valid); each split parameter carries its ``tp_split``. Returns the
    plan."""
    m, r = parallel.model_world(), parallel.model_rank()
    splits = unet_plan(unet, m)
    params = dict(unet.named_parameters())
    for name, split in splits.items():
        p = params[name]
        p.data = share(p.data, split, m, r).contiguous()
        p.tp_split = split
    return splits


def check_carried(module: nn.Module, what: str) -> None:
    """Raise where a module other than the UNet holds a parameter that the
    name rules would split over the model group (its attention taken as
    one head, as the VAE's is): tensor parallelism does not carry it."""
    left = plan({k: tuple(p.shape) for k, p in module.named_parameters()},
                lambda name: 1, parallel.model_world())
    if left:
        raise NotImplementedError(f"{what}: tensor parallelism splits the UNet's attention "
                                  f"and GEGLU layers only, not {sorted(left)[:3]}")


# ------------------------------------------------------ emulation


_emulated = 1  # M of emulated(M), 1 outside it


@contextlib.contextmanager
def emulated(m: int):
    """Inside the block, a process holding the whole model computes each
    layer that m ranks would split as the m ranks do: the shares one after
    the other, their partial products summed in the ranks' order."""
    global _emulated
    if parallel.model_world() > 1:
        raise RuntimeError("emulated() runs in a process that holds the whole model")
    saved, _emulated = _emulated, m
    try:
        yield
    finally:
        _emulated = saved


def attention_shares(p: nn.Module, heads: int) -> Optional[List[tuple]]:
    """The (w_q, w_k, w_v, w_out) of a split attention layer (q/k/v bias
    free, as the UNet's): this rank's one share, or under ``emulated`` the
    M shares of the whole weights; None where the layer runs whole."""
    ws = (p.to_q.weight, p.to_k.weight, p.to_v.weight, p.to_out[0].weight)
    if split_of(ws[0]) is not None:
        return [ws]
    m = _emulated
    if m == 1 or heads % m:
        return None
    # contiguous, as a rank's shares are, so that each product rounds as a rank's
    return [tuple(w.chunk(m, dim=1 if i == 3 else 0)[r].contiguous() for i, w in enumerate(ws))
            for r in range(m)]


def ff_shares(p: nn.Module) -> Optional[List[tuple]]:
    """The (w1, b1, w2) of a split GEGLU feed-forward: w1 (2 inner/M, C)
    holds the share's hidden rows then its gate rows, as the fused kernel
    takes them; this rank's one share or, under ``emulated``, M of them;
    None where the layer runs whole."""
    proj, down = p.net["0"].proj, p.net["2"]
    if split_of(proj.weight) is not None:
        return [(proj.weight, proj.bias, down.weight)]
    m = _emulated
    if m == 1 or (proj.weight.shape[0] // 2) % m:
        return None
    pairs = Split(0, True)
    return [(share(proj.weight, pairs, m, r),
             None if proj.bias is None else share(proj.bias, pairs, m, r),
             down.weight.chunk(m, dim=1)[r].contiguous()) for r in range(m)]


# ------------------------------------------------------------ f and g


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, the gradient summed over the model
    group backward."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return parallel.model_sum_(g.contiguous().clone())


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the sum over the model group forward, identity
    backward."""

    @staticmethod
    def forward(ctx, x):
        return parallel.model_sum_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """f on a rank of a model group, taken once a share. In one process (the
    emulated shares) a view of x: each share's input gradients are summed at
    its own view first, then the shares' sums at x, in the order a rank's f
    and the group's sum take them."""
    return _CopyToModel.apply(x) if parallel.model_world() > 1 else x.view_as(x)


def reduce_from_model(parts: List[torch.Tensor],
                      bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The row-parallel layer's output from its partial products (this
    rank's one, or the emulated shares' in order): summed in f32 over the
    model group, the bias added once, rounded once to the parts' dtype."""
    dt = parts[0].dtype
    if parallel.model_world() > 1:
        y = _ReduceFromModel.apply(parts[0].float())
    else:
        y = parts[0].float()
        for part in parts[1:]:
            y = y + part.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dt)


__all__ = [
    "Split", "attention_shares", "check_carried", "copy_to_model", "emulated", "ff_shares",
    "gather_over_model", "gather_state", "join", "local_share", "plan", "reduce_from_model",
    "shard_state", "shard_unet_", "share", "split_of", "tp_spec_for", "unet_heads", "unet_plan", "units",
]
