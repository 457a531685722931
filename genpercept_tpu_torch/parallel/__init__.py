"""Data parallelism across processes on ``torch.distributed``.

Counterpart of the data axis of ``genpercept_tpu/parallel/mesh.py`` (and
of the reference's Accelerate DDP over NCCL): one process per device, each
holding a replica of the parameters and its slice of every global batch
(``data/sampler.py::shard_batch_indices``). Where the JAX step reduces a
loss over the sharded global batch, the port's losses divide each rank's
masked sum by the count summed over the ranks (``global_sum``), so the
ranks' losses add up to the global batch's loss and their gradients,
summed (``all_reduce_sum_``), to its gradient. Every rank draws the global
batch's random numbers from the shared per-iteration seed and keeps its
slice (``batch_slice``). ``Zero1`` shards the optimizer state (ZeRO-1,
the reference's DeepSpeed hook).
Tensor parallelism (``--model_parallel > 1``) is not ported.

Nothing here starts a process group unasked: ``init_distributed`` takes the
CLI's explicit flags, and every helper is the identity in a single process.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist

# how long a collective waits for the other ranks before failing
DEFAULT_TIMEOUT_S = 1800
# the gradients are summed in flat buckets of at most this many bytes: one
# collective (and on gloo one host round trip) a bucket, not a tensor
BUCKET_BYTES = 256 << 20


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    """The number of ranks, 1 without a process group."""
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if is_distributed() else 0


def local_rank() -> int:
    """This process's index among the processes of its host: torchrun's
    LOCAL_RANK or SLURM's SLURM_LOCALID, else the rank (one host)."""
    for key in ("LOCAL_RANK", "SLURM_LOCALID"):
        if key in os.environ:
            return int(os.environ[key])
    return rank()


def _env_rendezvous() -> Tuple[str, int, int]:
    """(init_method, world, rank) from torchrun's or SLURM's environment."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if "SLURM_PROCID" in os.environ and "SLURM_NTASKS" in os.environ:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if not (addr and port):
            raise RuntimeError("--multihost under SLURM needs MASTER_ADDR and MASTER_PORT")
        return (f"tcp://{addr}:{port}", int(os.environ["SLURM_NTASKS"]),
                int(os.environ["SLURM_PROCID"]))
    raise RuntimeError("--multihost found no torchrun (RANK, WORLD_SIZE) or SLURM "
                       "(SLURM_PROCID, SLURM_NTASKS) environment")


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, multihost: bool = False,
                     backend: Optional[str] = None, device_type: str = "cuda",
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Start the process group when asked: ``coordinator_address`` (host:port
    of rank 0) with ``num_processes`` and ``process_id``, or ``multihost``
    from torchrun's / SLURM's environment. The backend is NCCL on the card
    and gloo on the CPU unless ``backend`` names one (gloo also shares one
    card between ranks, which NCCL refuses). Returns whether a group was
    started; call it before any CUDA work. A group the caller started
    already is used as it is (and left to the caller to end)."""
    if is_distributed():
        return False
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator_address needs --num_processes and --process_id")
        init_method, n, r = f"tcp://{coordinator_address}", num_processes, process_id
    elif multihost:
        init_method, n, r = _env_rendezvous()
    else:
        return False
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, world_size=n, rank=r,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def shutdown() -> None:
    if is_distributed():
        dist.destroy_process_group()


def barrier() -> None:
    if world() > 1:
        dist.barrier()


def _on_host() -> bool:
    """Whether collectives take host memory (gloo): a card's tensor then
    goes there and back by copies ordered on the current stream, rather
    than by gloo's own copies."""
    return dist.get_backend() == "gloo"


def _reduce_(t: torch.Tensor) -> None:
    """Sum t over the ranks, in place."""
    if t.is_cuda and _on_host():
        buf = t.cpu()
        dist.all_reduce(buf)
        t.copy_(buf)
    else:
        dist.all_reduce(t)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the ranks (a new tensor, outside autograd): the
    denominators of the losses' batch means."""
    if world() == 1:
        return x
    y = x.detach().clone()
    _reduce_(y)
    return y


def all_reduce_sum_(tensors: Iterable[torch.Tensor]) -> None:
    """Sum each tensor over the ranks, in place (the gradients): the tensors
    are packed in order into flat buckets of one dtype and device, up to
    BUCKET_BYTES each (a larger tensor goes alone), and each bucket is
    reduced by one collective. The sums are element-wise, so they equal a
    collective a tensor."""
    if world() == 1:
        return
    bucket: list = []
    size = 0

    def flush() -> None:
        if bucket:
            flat = torch.cat([t.reshape(-1) for t in bucket])
            _reduce_(flat)
            offset = 0
            for t in bucket:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()

    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (t.dtype != bucket[0].dtype or t.device != bucket[0].device
                       or size + nbytes > BUCKET_BYTES):
            flush()
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    flush()


def check_replicated(tensors: Iterable[torch.Tensor], what: str = "parameters") -> None:
    """Raise unless every rank holds the same ``tensors``: their float64 sum
    and their sum weighted by position agree on every rank (one small
    collective, where a broadcast would move every parameter)."""
    if world() == 1:
        return
    total = weighted = 0.0
    for i, t in enumerate(tensors):
        s = float(t.detach().double().sum())
        total, weighted = total + s, weighted + (i + 1) * s
    seen = [None] * world()
    dist.all_gather_object(seen, (total, weighted))
    if any(x != seen[0] for x in seen):
        raise RuntimeError(f"the ranks' {what} differ: {seen}")


def from_rank0(flag: bool) -> bool:
    """Rank 0's value of a host-side flag, on every rank."""
    if world() == 1:
        return flag
    out = [flag]
    dist.broadcast_object_list(out, src=0)
    return bool(out[0])


def all_gather_batch(x: torch.Tensor) -> torch.Tensor:
    """Concatenate every rank's x (equal shapes) along dim 0, in rank order."""
    if world() == 1:
        return x
    src = x.to(torch.uint8) if x.dtype == torch.bool else x
    if src.is_cuda and _on_host():
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(world())]
    dist.all_gather(parts, src.contiguous())
    out = torch.cat(parts).to(x.device)
    return out.bool() if x.dtype == torch.bool else out


def batch_slice(n_local: int) -> slice:
    """This rank's rows of a global batch of n_local rows a rank."""
    r = rank()
    return slice(r * n_local, (r + 1) * n_local)


def sum_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each 0-dim metric summed over the ranks, in one collective."""
    if world() == 1 or not metrics:
        return metrics
    keys = sorted(metrics)
    v = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    _reduce_(v)
    return {k: v[i] for i, k in enumerate(keys)}


class Zero1:
    """ZeRO-1 (the reference's DeepSpeed hook): each rank keeps the Adam
    moments of its share of the parameters in an ``OptaxAdam`` of its own,
    steps that share and broadcasts it to the others, so every rank ends
    the step with the same parameters as one ``OptaxAdam`` would give. The
    shares are taken greedily by size, in the groups' order. ``step``,
    ``state_dict`` and ``load_state_dict`` take and give what a plain
    ``OptaxAdam``'s do; ``state_dict`` is a collective (every rank calls
    it; rank 0 gets the whole state, the others None). Broadcasts and
    sends go through host memory on gloo, which one card can share."""

    def __init__(self, optimizer):
        self.param_groups = optimizer.param_groups
        self.params = [p for g in self.param_groups for p in g["params"]]
        load = [0] * world()
        self.owner = {}
        for p in self.params:
            r = min(range(world()), key=lambda i: load[i])
            self.owner[p] = r
            load[r] += p.numel()
        me = rank()
        groups = [{**{k: v for k, v in g.items() if k != "params"},
                   "params": [p for p in g["params"] if self.owner[p] == me]}
                  for g in self.param_groups]
        self.local = type(optimizer)(groups, optimizer.schedule, optimizer.b1, optimizer.b2,
                                     optimizer.eps, mu_dtype=optimizer.mu_dtype)
        self.mu_dtype = optimizer.mu_dtype
        self._host = dist.get_backend() == "gloo"

    def _move(self, t: torch.Tensor, src: int, dst: Optional[int] = None) -> None:
        """Broadcast t from src (to rank dst alone when given), in place."""
        buf = t.detach().cpu() if self._host else t.detach()
        if dst is None:
            dist.broadcast(buf, src)
        elif rank() == src:
            dist.send(buf.contiguous(), dst)
        elif rank() == dst:
            dist.recv(buf, src)
        if self._host and buf is not t and rank() != src:
            with torch.no_grad():
                t.copy_(buf)

    @torch.no_grad()
    def step(self, grads) -> None:
        """grads: in the groups' parameter order, as ``OptaxAdam.step``."""
        mine = {p: g for p, g in zip(self.params, grads) if self.owner[p] == rank()}
        self.local.step([mine[p] for g in self.local.param_groups for p in g["params"]])
        for g in self.param_groups:  # the count every group advanced by
            g["count"] += 1
        for p in self.params:
            self._move(p.data, self.owner[p])

    def state_dict(self) -> Optional[dict]:
        """The whole state on rank 0, in ``OptaxAdam.state_dict``'s layout,
        the moments on the CPU; every rank must call it."""
        me = rank()
        state = {}
        for idx, p in enumerate(self.params):
            owner = self.owner[p]
            if owner == me:
                st = self.local._state(p)  # zeros before the first step
                moments = {k: st[k] for k in ("mu", "nu")}
            else:
                moments = {"mu": torch.empty_like(p, dtype=self.mu_dtype or p.dtype),
                           "nu": torch.empty_like(p)}
            if owner != 0:
                for t in moments.values():
                    self._move(t, owner, dst=0)
            if me == 0:
                state[idx] = {k: t.detach().cpu().clone() for k, t in moments.items()}
        if me != 0:
            return None
        groups, start = [], 0
        for g in self.param_groups:
            n = len(g["params"])
            groups.append({**{k: v for k, v in g.items() if k != "params"},
                           "params": list(range(start, start + n))})
            start += n
        return {"state": state, "param_groups": groups}

    def load_state_dict(self, state_dict: dict) -> None:
        """A plain ``OptaxAdam``'s state (every rank reads the whole file):
        this rank keeps its share's moments and every group's count."""
        for g, saved in zip(self.param_groups, state_dict["param_groups"]):
            g["count"] = saved["count"]
        for g, saved in zip(self.local.param_groups, state_dict["param_groups"]):
            g["count"] = saved["count"]
        for idx, p in enumerate(self.params):
            st = state_dict["state"].get(idx)
            if self.owner[p] == rank() and st is not None:
                self.local.state[p] = {"mu": st["mu"].to(p.device, self.mu_dtype or p.dtype),
                                       "nu": st["nu"].to(p.device, p.dtype)}


__all__ = [
    "DEFAULT_TIMEOUT_S", "all_gather_batch", "all_reduce_sum_", "barrier", "batch_slice",
    "check_replicated", "from_rank0", "global_sum", "init_distributed", "is_distributed",
    "local_rank", "rank", "shutdown", "sum_metrics", "world", "Zero1",
]
