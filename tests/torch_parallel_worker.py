"""One rank of tests/test_torch_parallel.py's data-parallel runs.

Imports torch and the port only, so that a spawned rank starts in seconds.
``run`` goes through the training CLI once per job, each job on its own
coordinator port, and writes the rank's trainable parameters after job j
to <output_dir>/rank<r>_job<j>.pt, so that the test can compare the ranks.
``reduce_tensors`` then sums ``rank_tensors(rank)`` over the ranks in
small buckets and writes the result to <out>.rank<r>.pt.
"""

import datetime

import torch


def rank_tensors(rank: int) -> list:
    """Tensors of mixed dtypes and sizes whose values depend on the rank."""
    base = [torch.arange(3.0), torch.arange(4.0).reshape(2, 2), torch.arange(5.0),
            torch.arange(40.0), torch.arange(5, dtype=torch.float64),
            torch.arange(7, dtype=torch.bfloat16), torch.arange(3, dtype=torch.bfloat16),
            torch.arange(6.0)]
    return [t * (rank + 1) + rank for t in base]


def reduce_tensors(rank: int, world: int, port: int, out: str) -> None:
    from genpercept_tpu_torch import parallel

    torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                         world_size=world, rank=rank,
                                         timeout=datetime.timedelta(seconds=120))
    tensors = rank_tensors(rank)
    parallel.BUCKET_BYTES = 64  # several buckets of these small tensors
    parallel.all_reduce_sum_(tensors)
    torch.save(tensors, f"{out}.rank{rank}.pt")
    parallel.shutdown()


def run(rank: int, world: int, jobs: list, reduce: tuple = None) -> None:
    """jobs: [(argv, port), ...] run in order on gloo over the CPU; then,
    with ``reduce`` = (port, out), reduce_tensors."""
    from genpercept_tpu_torch.cli import train

    torch.set_num_threads(1)
    for j, (argv, port) in enumerate(jobs):
        trainer = train.main([*argv, "--device", "cpu", "--coordinator_address",
                              f"localhost:{port}", "--num_processes", str(world),
                              "--process_id", str(rank)])
        out = argv[argv.index("--output_dir") + 1]
        torch.save({k: p.detach().clone() for k, p in trainer.trainable.items()},
                   f"{out}/rank{rank}_job{j}.pt")
    if reduce is not None:
        reduce_tensors(rank, world, *reduce)
