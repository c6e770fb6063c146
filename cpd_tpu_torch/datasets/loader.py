"""Dataloader: threaded prefetching host pipeline feeding device batches
(port of cpd_tpu/datasets/loader.py).

Parity with the reference ``build_dataloader`` (cpd/datasets/__init__.py:49:
torch DataLoader + BackgroundGenerator prefetch + DistributedSampler): a
thread pool prepares the samples of a batch and a background thread keeps
``prefetch`` collated NumPy batches ahead of the consumer; the index space is
sharded across processes like the reference's padded round-robin
DistributedSampler (datasets/__init__.py:26-46). Batches stay NumPy until
``tools.train.device_batch`` moves them to the device.

Across ``world_size`` ranks: in training (``drop_last``) rank r takes every
world-th index of the epoch's order from r, so that its batch i of
``batch_size`` and the other ranks' batch i together hold the samples of
batch i of ``batch_size * world_size`` read by one process, and every rank
has the same number of batches. In evaluation rank r reads the shard of
``EvalDistributedSampler``, padded so that every rank has as many frames;
``parallel.comm.merge_results_dist`` interleaves the ranks' results back into
dataset order and drops the padding.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from .dataset import collate_batch


_END = object()


class _WorkerError:
    def __init__(self, error: Exception):
        self.error = error


class EvalDistributedSampler:
    """Padded, strided sharding of eval indices across processes: the
    indices, padded from their start (cyclically, where there are fewer
    indices than ranks) to a multiple of ``world_size``; rank r takes every
    world-th from r."""

    def __init__(self, n: int, world_size: int, rank: int):
        self.total = int(np.ceil(n / world_size)) * world_size
        self.indices = list(range(n)) + [i % n for i in range(self.total - n)]
        self.shard = self.indices[rank::world_size]

    def __iter__(self):
        return iter(self.shard)

    def __len__(self):
        return len(self.shard)


class DataLoader:
    """Minimal deterministic loader with background prefetch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 666, drop_last: bool = True, world_size: int = 1,
                 rank: int = 0, prefetch: int = 2, num_threads: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.world_size = world_size
        self.rank = rank
        self.prefetch = prefetch
        self.num_threads = num_threads
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _index_batches(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        # shard across processes (data-parallel ranks)
        if self.drop_last:
            # whole global batches only, so that every rank has len(self)
            idx = idx[: len(self) * self.batch_size * self.world_size][self.rank :: self.world_size]
        else:
            idx = idx[EvalDistributedSampler(n, self.world_size, self.rank).shard]
        nb = len(idx) // self.batch_size
        if not self.drop_last and len(idx) % self.batch_size:
            nb += 1
        for i in range(nb):
            yield idx[i * self.batch_size : (i + 1) * self.batch_size]

    def __len__(self):
        if self.drop_last:
            return len(self.dataset) // self.world_size // self.batch_size
        shard = int(np.ceil(len(self.dataset) / self.world_size))
        return int(np.ceil(shard / self.batch_size))

    def __iter__(self) -> Iterator[dict]:
        """Collated batches in index order. A worker's exception is raised
        here, in the consumer; leaving the loop early (``break``) stops the
        background thread."""
        batches = list(self._index_batches())
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        left = threading.Event()

        def put(item) -> bool:
            while not left.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            from concurrent.futures import ThreadPoolExecutor

            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    for b in batches:
                        samples = list(pool.map(self.dataset.__getitem__, b.tolist()))
                        if not put(collate_batch(samples)):
                            return
            except Exception as e:  # noqa: BLE001 - handed to the consumer, which raises it
                put(_WorkerError(e))
                return
            put(_END)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                if isinstance(item, _WorkerError):
                    raise item.error
                yield item
        finally:
            left.set()
            t.join()


def build_dataloader(dataset_cfg, class_names, batch_size, dist=False,
                     root_path=None, workers=4, logger=None, training=True,
                     seed=666, world_size=1, rank=0, total_epochs=0,
                     dataset=None):
    """Factory with the reference signature (datasets/__init__.py:49).

    ``dataset`` may be passed directly (tests / synthetic data); otherwise it
    is built from the registry by DATASET name.
    """
    if dataset is None:
        from .registry import build_dataset

        dataset = build_dataset(dataset_cfg, class_names, training, root_path, logger)
    loader = DataLoader(
        dataset, batch_size, shuffle=training, seed=seed,
        drop_last=training, world_size=world_size, rank=rank,
        num_threads=workers,
    )
    return dataset, loader, None
