"""Threaded prefetching data loader.

Port of ``animatablegaussians_tpu/data/loader.py``: the dataset's items are
read on a thread pool (no worker processes) while the card runs the
previous step, stacked into a batch of numpy arrays, put in pinned memory
and copied to the device with ``non_blocking=True``, up to ``prefetch``
batches ahead. The batch order is the JAX loader's:
``np.random.default_rng(seed + epoch)`` shuffles the item indices, epochs
count from 1, and an incomplete last batch is dropped by default.

For data parallelism each rank makes a loader with its ``rank`` and the
``world_size``: every rank shuffles alike, a global batch holds
``world_size * batch_size`` items, and a rank reads only its own block of
``batch_size`` of them (the JAX loader's global batch reshaped to
(n_devices, n_scan), driver.py:282-325).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence

import numpy as np
import torch


def stack_items(items: Sequence[dict]) -> dict:
    """Items -> one dict of (B, ...) numpy arrays (scalars to (B,))."""
    out = {}
    for k in items[0].keys():
        vals = [np.asarray(it[k]) for it in items]
        out[k] = np.stack(vals) if vals[0].shape != () else np.asarray(vals)
    return out


class PrefetchLoader:
    """Iterates the (shuffled) dataset indices in batches; yields dicts of
    tensors on ``device``. Non-array item fields (``data_idx``) are left
    out unless ``select_keys`` names the keys to keep. ``waits`` holds the
    seconds each batch of the current epoch kept the caller waiting."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = True,
                 drop_last: bool = True, num_threads: int = 8,
                 prefetch: int = 2, seed: int = 0, device="cuda",
                 select_keys: Optional[Sequence[str]] = None,
                 rank: int = 0, world_size: int = 1):
        if world_size > 1 and not drop_last:
            raise ValueError("a rank's block of an incomplete global batch "
                             "would differ in size: drop_last must be on")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.seed = seed
        self.device = torch.device(device)
        self.select_keys = select_keys
        self.rank, self.world_size = rank, world_size
        self.waits: list = []
        self._epoch = 0

    def __len__(self):
        n, per = len(self.dataset), self.batch_size * self.world_size
        return n // per if self.drop_last else -(-n // per)

    def index_batches(self, epoch: int):
        """The item indices of each of this rank's batches of ``epoch``
        (1 = the first)."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        per = self.batch_size * self.world_size
        lo = self.rank * self.batch_size
        return [order[b * per + lo:b * per + lo + self.batch_size]
                for b in range(len(self))]

    def _load_batch(self, idxs) -> dict:
        items = [self.dataset[int(i)] for i in idxs]
        if self.select_keys is not None:
            items = [{k: it[k] for k in self.select_keys} for it in items]
        else:
            items = [{k: v for k, v in it.items()
                      if isinstance(v, (np.ndarray, np.floating, np.integer,
                                        float, int))} for it in items]
        batch = {}
        for k, v in stack_items(items).items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory()
            batch[k] = t.to(self.device, non_blocking=True)
        return batch

    def __iter__(self) -> Iterator[dict]:
        self._epoch += 1
        self.waits = []
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        batches = self.index_batches(self._epoch)

        def producer():
            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    futures = []
                    for idxs in batches:
                        if stop.is_set():
                            return
                        futures.append(pool.submit(self._load_batch, idxs))
                        # a bounded window of reads in flight
                        while len(futures) > self.num_threads:
                            q.put(futures.pop(0).result())
                    for f in futures:
                        if stop.is_set():
                            return
                        q.put(f.result())
                q.put(None)
            except Exception as exc:     # raised in the consumer
                q.put(exc)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                batch = q.get()
                self.waits.append(time.perf_counter() - t0)
                if batch is None:
                    self.waits.pop()
                    break
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
