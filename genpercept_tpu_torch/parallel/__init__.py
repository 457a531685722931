"""Data and tensor parallelism across processes on ``torch.distributed``.

Counterpart of ``genpercept_tpu/parallel/mesh.py``'s ('data', 'model')
mesh (and of the reference's Accelerate DDP over NCCL): one process per
device. ``set_model_parallel(M)`` lays the world out as make_mesh's
``reshape(data, model)`` does: rank r has data index r // M and model index
r % M, the M consecutive ranks of one data index form a model group, and
the ranks of one model index a data group. A model group holds one replica
of the model, its attention and GEGLU layers split over the group's ranks
(``parallel/tensor.py``); the data groups hold the replicas.

Each model group loads its slice of every global batch
(``data/sampler.py::shard_batch_indices`` by data index). Where the JAX
step reduces a loss over the sharded global batch, the port's losses divide
each rank's masked sum by the count summed over the data group
(``global_sum``), so the groups' losses add up to the global batch's loss
and their gradients, summed (``reduce_gradients_``), to its gradient. Every
rank draws the global batch's random numbers from the shared per-iteration
seed and keeps its data index's slice (``batch_slice``). ``Zero1`` shards
the optimizer state over the data group (ZeRO-1, the reference's DeepSpeed
hook). With M = 1 the data group is the world and every helper does what
it did before tensor parallelism.

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


_model = 1  # ranks a model group (set_model_parallel)
_groups: Dict[str, object] = {"data": None, "model": None}  # None: the world / no group


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    """The number of ranks, 1 without a process group."""
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if is_distributed() else 0


def set_model_parallel(m: int) -> None:
    """Lay the world out as (world / m data indices) x (m model indices) and
    build this rank's model and data groups (every rank calls it with the
    same m, and builds every group in one order, as ``dist.new_group``
    asks). m = 1 leaves one data group, the world. Raises where m does not
    divide the world (one process takes only m = 1)."""
    global _model
    n = world()
    if m < 1 or n % m:
        raise ValueError(f"--model_parallel {m} does not divide the {n} process(es): "
                         f"start a multiple of {m} processes")
    _model = m
    _groups.update(data=None, model=None)
    if m == 1:
        return
    r = rank()
    for d in range(n // m):
        group = dist.new_group(list(range(d * m, (d + 1) * m)))
        if r // m == d:
            _groups["model"] = group
    for j in range(m):
        group = dist.new_group(list(range(j, n, m)))
        if r % m == j:
            _groups["data"] = group


def model_world() -> int:
    """The ranks of a model group (the tensor-parallel degree)."""
    return _model


def model_rank() -> int:
    """This rank's index in its model group."""
    return rank() % _model


def data_world() -> int:
    """The model groups: the replicas of the model, each a slice of the
    global batch."""
    return world() // _model


def data_rank() -> int:
    """This rank's data index: which slice of the global batch it loads."""
    return rank() // _model


def _data_peer(d: int) -> int:
    """The global rank of data index d in this rank's data group."""
    return d * _model + model_rank()


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
    global _model
    if is_distributed():
        dist.destroy_process_group()
    _model = 1
    _groups.update(data=None, model=None)


def barrier() -> None:
    if world() > 1:
        dist.barrier()


def _on_host() -> bool:
    """Whether collectives take host memory (gloo): a card's tensor then
    goes there and back by copies ordered on the current stream, rather
    than by gloo's own copies."""
    return dist.get_backend() == "gloo"


def _reduce_(t: torch.Tensor, group=None) -> None:
    """Sum t over ``group``'s ranks (None: the world), in place."""
    if t.is_cuda and _on_host():
        buf = t.cpu()
        dist.all_reduce(buf, group=group)
        t.copy_(buf)
    else:
        dist.all_reduce(t, group=group)


def _size(group: str) -> int:
    return {"data": data_world, "model": model_world, "world": world}[group]()


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the data group (a new tensor, outside autograd): the
    denominators of the losses' batch means."""
    if data_world() == 1:
        return x
    y = x.detach().clone()
    _reduce_(y, _groups["data"])
    return y


def model_sum_(t: torch.Tensor) -> torch.Tensor:
    """Sum t over the model group, in place (tensor parallelism's
    collective); returns t."""
    if _model > 1:
        _reduce_(t, _groups["model"])
    return t


def model_all_gather(t: torch.Tensor) -> list:
    """Every rank of the model group's t (equal shapes), in model order, on
    t's device."""
    if _model == 1:
        return [t]
    src = t.detach().contiguous()
    if src.is_cuda and _on_host():
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(_model)]
    dist.all_gather(parts, src, group=_groups["model"])
    return [p.to(t.device) for p in parts]


def all_reduce_sum_(tensors: Iterable[torch.Tensor], group: str = "data") -> None:
    """Sum each tensor over the data group (``group`` "world": over every
    rank), in place (the gradients): the tensors are packed in order
    into flat buckets of one dtype and device, up to BUCKET_BYTES each (a
    larger tensor goes alone), and each bucket is reduced by one
    collective. The sums are element-wise, so they equal a collective a
    tensor."""
    if _size(group) == 1:
        return
    handle = None if group == "world" else _groups[group]
    bucket: list = []
    size = 0

    def flush() -> None:
        if bucket:
            flat = torch.cat([t.reshape(-1) for t in bucket])
            _reduce_(flat, handle)
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


def reduce_gradients_(grads: Iterable[torch.Tensor], sharded: Iterable[bool]) -> None:
    """Sum the gradients over the data group, in place. Under tensor
    parallelism a replicated parameter's gradient is summed over the world
    and divided by M, the data group's sum averaged over the model group:
    f and g (``parallel/tensor.py``) give every rank of the group the whole
    gradient, but the card's backward is not bit for bit (atomics), and the
    average keeps the group's replicas equal."""
    grads, sharded = list(grads), list(sharded)
    if _model == 1:
        all_reduce_sum_(grads)
        return
    all_reduce_sum_([g for g, s in zip(grads, sharded) if s])
    replicated = [g for g, s in zip(grads, sharded) if not s]
    all_reduce_sum_(replicated, "world")
    for g in replicated:
        g.div_(_model)


def check_replicated(tensors: Iterable[torch.Tensor], what: str = "parameters",
                     group: str = "world") -> None:
    """Raise unless every rank of ``group`` ("world", or "data" for a
    model shard) holds the same ``tensors``: their float64 sum and their
    sum weighted by position agree on every rank (one small collective,
    where a broadcast would move every parameter)."""
    if _size(group) == 1:
        return
    total = weighted = 0.0
    for i, t in enumerate(tensors):
        s = float(t.detach().double().sum())
        total, weighted = total + s, weighted + (i + 1) * s
    seen = [None] * _size(group)
    dist.all_gather_object(seen, (total, weighted),
                           group=None if group == "world" else _groups[group])
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
    """Concatenate the data group's x (equal shapes) along dim 0, in data
    order: the global batch's rows."""
    if data_world() == 1:
        return x
    src = x.to(torch.uint8) if x.dtype == torch.bool else x
    if src.is_cuda and _on_host():
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(data_world())]
    dist.all_gather(parts, src.contiguous(), group=_groups["data"])
    out = torch.cat(parts).to(x.device)
    return out.bool() if x.dtype == torch.bool else out


def batch_slice(n_local: int) -> slice:
    """This rank's rows of a global batch of n_local rows a data index."""
    r = data_rank()
    return slice(r * n_local, (r + 1) * n_local)


def sum_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each 0-dim metric summed over the data group, in one collective."""
    if data_world() == 1 or not metrics:
        return metrics
    keys = sorted(metrics)
    v = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    _reduce_(v, _groups["data"])
    return {k: v[i] for i, k in enumerate(keys)}


class Zero1:
    """ZeRO-1 (the reference's DeepSpeed hook) over the data group: each
    rank keeps the Adam moments of its share of the parameters (of its
    model shard, under tensor parallelism) in an ``OptaxAdam`` of its own,
    steps that share and broadcasts it to the data group, so every rank
    ends the step with the same parameters as one ``OptaxAdam`` would give.
    The shares are taken greedily by size, in the groups' order. ``step``,
    ``state_dict`` and ``load_state_dict`` take and give what a plain
    ``OptaxAdam``'s do; ``state_dict`` is a collective (every rank calls
    it; data index 0 gets the whole state, the others None). Broadcasts and
    sends go through host memory on gloo, which one card can share."""

    def __init__(self, optimizer):
        self.param_groups = optimizer.param_groups
        self.params = [p for g in self.param_groups for p in g["params"]]
        n = data_world()
        load = [0] * n
        self.owner = {}  # parameter -> the data index that steps it
        for p in self.params:
            r = min(range(n), key=lambda i: load[i])
            self.owner[p] = r
            load[r] += p.numel()
        me = data_rank()
        groups = [{**{k: v for k, v in g.items() if k != "params"},
                   "params": [p for p in g["params"] if self.owner[p] == me]}
                  for g in self.param_groups]
        self.local = type(optimizer)(groups, optimizer.schedule, optimizer.b1, optimizer.b2,
                                     optimizer.eps, mu_dtype=optimizer.mu_dtype)
        self.mu_dtype = optimizer.mu_dtype
        self._host = dist.get_backend() == "gloo"
        self._group = _groups["data"]

    def _broadcast(self, t: torch.Tensor, src: int) -> None:
        """Broadcast t from data index src over the data group, in place; a
        card's tensor goes through host memory on gloo (the others receive
        into an empty host buffer)."""
        me = data_rank()
        staged = self._host and t.is_cuda
        if not staged:
            buf = t.detach()
        elif me == src:
            buf = t.detach().cpu()
        else:
            buf = torch.empty(t.shape, dtype=t.dtype)
        dist.broadcast(buf, _data_peer(src), group=self._group)
        if staged and me != src:
            with torch.no_grad():
                t.copy_(buf)

    @torch.no_grad()
    def step(self, grads) -> None:
        """grads: in the groups' parameter order, as ``OptaxAdam.step``."""
        mine = {p: g for p, g in zip(self.params, grads) if self.owner[p] == data_rank()}
        self.local.step([mine[p] for g in self.local.param_groups for p in g["params"]])
        for g in self.param_groups:  # the count every group advanced by
            g["count"] += 1
        for p in self.params:
            self._broadcast(p.data, self.owner[p])

    def state_dict(self) -> Optional[dict]:
        """The whole state on data index 0, in ``OptaxAdam.state_dict``'s
        layout, the moments on the CPU; every rank must call it. Each owner
        sends its moments to data index 0, which keeps what it receives
        (into host memory on gloo) and copies its own once."""
        me = data_rank()
        state = {}
        for idx, p in enumerate(self.params):
            owner = self.owner[p]
            if owner == me:
                st = self.local._state(p)  # zeros before the first step
                if me == 0:
                    state[idx] = {k: st[k].detach().to("cpu", copy=True) for k in ("mu", "nu")}
                    continue
                for k in ("mu", "nu"):
                    t = st[k].detach()
                    dist.send((t.cpu() if self._host else t).contiguous(), _data_peer(0))
            elif me == 0:
                state[idx] = {}
                for k, dt in (("mu", self.mu_dtype or p.dtype), ("nu", p.dtype)):
                    buf = torch.empty(p.shape, dtype=dt,
                                      device="cpu" if self._host else p.device)
                    dist.recv(buf, _data_peer(owner))
                    state[idx][k] = buf.cpu()
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
            if self.owner[p] == data_rank() and st is not None:
                self.local.state[p] = {"mu": st["mu"].to(p.device, self.mu_dtype or p.dtype),
                                       "nu": st["nu"].to(p.device, p.dtype)}


__all__ = [
    "DEFAULT_TIMEOUT_S", "all_gather_batch", "all_reduce_sum_", "barrier", "batch_slice",
    "check_replicated", "data_rank", "data_world", "from_rank0", "global_sum",
    "init_distributed", "is_distributed", "local_rank", "model_all_gather", "model_rank",
    "model_sum_", "model_world", "rank", "reduce_gradients_", "set_model_parallel",
    "shutdown", "sum_metrics", "world", "Zero1",
]
