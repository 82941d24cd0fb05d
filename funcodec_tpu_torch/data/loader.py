"""Background-threaded batch loader (port of funcodec_tpu/data/loader.py).

A thread pool decodes audio on the host while the card runs the previous
step, in place of torch DataLoader worker processes (abs_task.py
num_workers): the batches stay numpy, as in the JAX package, and the trainer
moves each to the card through pinned memory. A loader error is raised in
the consumer.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Sequence, Tuple

import numpy as np


class PrefetchLoader:
    """Iterate (keys, batch) with `num_workers` loader threads and a bounded
    prefetch queue."""

    def __init__(
        self,
        dataset,
        batches: Sequence[Sequence[str]],
        collate: Callable,
        num_workers: int = 4,
        prefetch: int = 4,
    ):
        self.dataset = dataset
        self.batches = batches
        self.collate = collate
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch

    def _load_batch(self, uttids: Sequence[str]):
        items = [self.dataset[u] for u in uttids]
        return self.collate(items)

    def __len__(self):
        return len(self.batches)

    def __iter__(self) -> Iterator[Tuple[List[str], Dict[str, np.ndarray]]]:
        if not self.batches:
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            with ThreadPoolExecutor(self.num_workers) as pool:
                futures = [
                    pool.submit(self._load_batch, b) for b in self.batches
                ]
                for fut in futures:
                    if stop.is_set():
                        break
                    try:
                        q.put(("ok", fut.result()))
                    except Exception as e:  # surface loader errors in consumer
                        q.put(("err", e))
                        break
            q.put(("done", None))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                kind, item = q.get()
                if kind == "done":
                    break
                if kind == "err":
                    raise item
                yield item
        finally:
            stop.set()


class MultipleSplitLoader:
    """Lazy split cycling (iterators/multiple_iter_factory.py:12-37): a list
    of zero-arg factories, each building a loader for one data split; splits
    are built one at a time (so only one split's index is resident) and,
    optionally, visited in an epoch-seeded random order."""

    def __init__(self, build_funcs, seed: int = 0, shuffle: bool = False):
        self.build_funcs = list(build_funcs)
        self.seed = seed
        self.shuffle = shuffle

    def build_iter(self, epoch: int, shuffle=None):
        if shuffle is None:
            shuffle = self.shuffle
        funcs = list(self.build_funcs)
        if shuffle:
            np.random.RandomState(epoch + self.seed).shuffle(funcs)
        for fn in funcs:
            loader = fn()
            it = loader.build_iter(epoch, shuffle) if hasattr(loader, "build_iter") else iter(loader)
            yield from it
