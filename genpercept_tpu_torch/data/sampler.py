"""Mixed-probability batch sampling and host data loading (numpy only).

Copy of ``genpercept_tpu/data/sampler.py``. ``MixedBatchSampler``: every
batch is drawn from one source dataset, the source chosen by multinomial
probabilities (e.g. hypersim 0.9 / vkitti 0.1); exhausted sources regenerate
their shuffled batch lists. ``DataLoader`` is a prefetching iterator that
collates dict samples into stacked numpy batches; with ``shard`` it loads
only a data-parallel rank's slice of each global batch
(``shard_batch_indices``).
"""

from __future__ import annotations

import threading
import queue as queue_mod
from typing import Dict, List, Optional, Sequence

import numpy as np


class ConcatDataset:
    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def _locate(self, idx):
        src = int(np.searchsorted(self.offsets, idx, side="right") - 1)
        return self.datasets[src], idx - int(self.offsets[src])

    def __getitem__(self, idx):
        ds, i = self._locate(idx)
        return ds[i]

    def skip(self, idx) -> None:
        """The source dataset's skip (its random draws for idx, no load)."""
        ds, i = self._locate(idx)
        ds.skip(i)


class MixedBatchSampler:
    """Yields lists of global indices into a ConcatDataset; each batch comes
    from a single source picked by `prob` (mixed_sampler.py:25-105)."""

    def __init__(
        self,
        src_dataset_ls: Sequence,
        batch_size: int,
        drop_last: bool = True,
        shuffle: bool = True,
        prob: Optional[Sequence[float]] = None,
        generator: Optional[np.random.Generator] = None,
    ):
        if not drop_last:
            raise ValueError("only drop_last=True is supported (as in training)")
        self.src_dataset_ls = list(src_dataset_ls)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = generator or np.random.default_rng(0)
        sizes = [len(d) for d in self.src_dataset_ls]
        self.offsets = np.cumsum([0] + sizes)[:-1]
        if prob is None:
            total = sum(sizes)
            prob = [s / total for s in sizes]
        self.prob = np.asarray(prob, np.float64) / np.sum(prob)
        self.n_batches = sum(s // batch_size for s in sizes)

    def _batches_for(self, src: int) -> List[List[int]]:
        n = len(self.src_dataset_ls[src])
        idx = np.arange(n)
        if self.shuffle:
            idx = self.rng.permutation(n)
        idx = idx + self.offsets[src]
        n_full = n // self.batch_size
        return [
            idx[i * self.batch_size : (i + 1) * self.batch_size].tolist()
            for i in range(n_full)
        ]

    def __len__(self):
        return self.n_batches

    def __iter__(self):
        pools = [self._batches_for(i) for i in range(len(self.src_dataset_ls))]
        for _ in range(self.n_batches):
            src = int(self.rng.choice(len(pools), p=self.prob))
            if not pools[src]:  # regenerate exhausted source (ref :82-101)
                pools[src] = self._batches_for(src)
            yield pools[src].pop()


def collate(samples: List[Dict]) -> Dict[str, np.ndarray]:
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], np.ndarray):
            if any(v.shape != vals[0].shape for v in vals[1:]):
                raise ValueError(
                    f"collate: mixed raster shapes for '{k}' "
                    f"({sorted({v.shape for v in vals})}); use batch_size=1 "
                    "for variable-size datasets"
                )
            out[k] = np.stack(vals)
        elif isinstance(vals[0], (int, float, bool, np.integer, np.floating)):
            out[k] = np.asarray(vals)
        else:
            out[k] = vals  # strings etc.
    return out


def _shard_positions(n: int, accum: int, world: int, rank: int) -> List[int]:
    """The positions in a global flat batch of n that shard_batch_indices
    keeps for ``rank``."""
    micro_g = n // accum
    assert micro_g * accum == n and micro_g % world == 0, (n, accum, world)
    per = micro_g // world
    return [a * micro_g + rank * per + j for a in range(accum) for j in range(per)]


def shard_batch_indices(
    idx: List[int], accum: int, world: int, rank: int
) -> List[int]:
    """Per-process slice of one GLOBAL flat batch (data parallelism). The
    flat batch has length accum * micro_global and is read as (accum,
    micro_global, ...), so each process holds, within every accum chunk,
    its contiguous micro-slice. All processes iterate the SAME seeded
    sampler stream, so the global index sequence is identical everywhere
    and slicing is deterministic."""
    return [idx[p] for p in _shard_positions(len(idx), accum, world, rank)]


class DataLoader:
    """Background-thread prefetching loader over (dataset, batch_sampler).

    ``shard=(rank, world, accum)`` makes this a data-parallel loader: the
    sampler yields GLOBAL batches (the same stream on every process), and
    only this process's slice is loaded, decoded and collated (see
    shard_batch_indices). Under tensor parallelism ``rank`` and ``world``
    are the data index and the data world (``parallel.data_rank`` and
    ``data_world``): the ranks of a model group load the same slice. The dataset's ``skip`` is called for every other
    sample of the global batch, in the batch's order, so that a dataset
    which draws a random flip per sample gives each rank's samples the
    flips one process draws for them. The reference's equivalent is
    Accelerate's per-rank DataLoader sharding
    (accelerate_train.py:186-196)."""

    def __init__(self, dataset, batch_sampler, prefetch: int = 2,
                 shard: Optional[tuple] = None):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.prefetch = prefetch
        self.shard = shard

    def __len__(self):
        return len(self.batch_sampler)

    def __iter__(self):
        return self.iter_skipping(0)

    def iter_skipping(self, skip_n: int):
        """Iterate, dropping the first `skip_n` batches at the INDEX level:
        the sampler stream is consumed (keeping seed-replay consistency) but
        the dataset is never touched for skipped batches — no IO, no decode,
        no collate (the reference's SkipBatchSampler semantics,
        src/util/data_loader.py:24-68)."""
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        stop = object()

        def worker():
            # exceptions (decode errors, collate shape mismatches, shard
            # asserts) must reach the CONSUMER — a silently dead worker
            # would end iteration cleanly and turn a data bug into an
            # infinite zero-batch training loop
            try:
                for bi, batch_idx in enumerate(self.batch_sampler):
                    if bi < skip_n:
                        continue
                    if self.shard is None:
                        q.put(collate([self.dataset[i] for i in batch_idx]))
                        continue
                    rank, world, accum = self.shard
                    mine = set(_shard_positions(len(batch_idx), accum, world, rank))
                    samples = []
                    for p, i in enumerate(batch_idx):
                        if p in mine:
                            samples.append(self.dataset[i])
                        else:
                            self.dataset.skip(i)
                    q.put(collate(samples))
            except BaseException as e:  # noqa: BLE001 — re-raised in consumer
                q.put(e)
            finally:
                q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, BaseException):
                raise item
            yield item


def skip_first_batches(loader, n: int):
    """Batch-exact resume (reference src/util/data_loader.py:70-114).
    Index-level skip when the loader supports it; falls back to consuming
    batches for plain iterables."""
    if hasattr(loader, "iter_skipping"):
        return loader.iter_skipping(n)
    it = iter(loader)
    for _ in range(n):
        next(it, None)
    return it
