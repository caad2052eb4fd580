"""Host-side batch loader: the numpy path of ``mirror_tpu/data/loader.py``.

Per-epoch deterministic order from the seed (``set_epoch``): a shuffle, or
with ``weighted`` a class-balanced draw with replacement (weight
1 / class count over the live split, ``len(dataset)`` draws); fixed-size
batches, where train drops the trailing partial batch and ``pad_last``
pads it by repeating its last item; a ``valid`` mask (1 real, 0 padding)
in every batch; and one token-draw seed per epoch position, so an item's
patch subsample is a pure function of the seed, the epoch and its position:
the same draws as the JAX loader's numpy path. Items are read by a small
thread pool (``workers``); the C++ gather, the prefetch thread and the
multi-process blocks of the JAX loader are not ported (ROADMAP item 10).
"""

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np


def class_balanced_weights(dataset) -> np.ndarray:
    """1 / class count of each item, over the live split, index-aligned
    with ``dataset.get_label``."""
    labels = np.asarray([dataset.get_label(i) for i in range(len(dataset))])
    return 1.0 / np.bincount(labels)[labels]


class Loader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, pad_last: bool = False, weighted: bool = False,
                 seed: int = 42, workers: int = 4) -> None:
        if drop_last and pad_last:
            raise ValueError("drop_last and pad_last exclude each other")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.weighted = weighted
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

    def _indices(self, rng: np.random.Generator) -> np.ndarray:
        n = len(self.dataset)
        if self.weighted:
            weights = class_balanced_weights(self.dataset)
            return rng.choice(n, size=n, replace=True, p=weights / weights.sum())
        indices = np.arange(n)
        if self.shuffle:
            rng.shuffle(indices)
        return indices

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed + self.epoch * 1000003)
        indices = self._indices(rng)
        n = len(indices)
        item_seeds = rng.integers(0, 2**63, size=n, dtype=np.int64)
        stop = n - (n % self.batch_size) if self.drop_last else n

        def item(pos):
            return self.dataset.__getitem__(int(indices[pos]),
                                            rng=np.random.default_rng(int(item_seeds[pos])))

        with ThreadPoolExecutor(self.workers) as pool:
            for start in range(0, stop, self.batch_size):
                positions = list(range(start, min(start + self.batch_size, stop)))
                n_valid = len(positions)
                if self.pad_last:
                    positions += positions[-1:] * (self.batch_size - n_valid)
                items = list(pool.map(item, positions))
                batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
                batch["valid"] = (np.arange(len(positions)) < n_valid).astype(np.float32)
                yield batch
