"""Host-side batch loader: the numpy path of ``mirror_tpu/data/loader.py``.

Per-epoch deterministic shuffling from the seed (``set_epoch``), fixed-size
batches (train drops the trailing partial batch), and one token-draw seed
per epoch position, so an item's patch subsample is a pure function of the
seed, the epoch and its position: the same draws as the JAX loader's numpy
path. Items are read by a small thread pool (``workers``); the C++ gather,
the prefetch thread and the multi-process blocks of the JAX loader are not
ported (ROADMAP item 10).
"""

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np


class Loader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 42, workers: int = 4) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.workers = max(int(workers), 1)
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed + self.epoch * 1000003)
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng.shuffle(indices)
        item_seeds = rng.integers(0, 2**63, size=n, dtype=np.int64)
        stop = n - (n % self.batch_size) if self.drop_last else n

        def item(pos):
            return self.dataset.__getitem__(int(indices[pos]),
                                            rng=np.random.default_rng(int(item_seeds[pos])))

        with ThreadPoolExecutor(self.workers) as pool:
            for start in range(0, stop, self.batch_size):
                items = list(pool.map(item, range(start, min(start + self.batch_size, stop))))
                yield {k: np.stack([it[k] for it in items]) for k in items[0]}
