"""Host-side batch loader: the port of ``mirror_tpu/data/loader.py``.

Per-epoch deterministic order from the seed (``set_epoch``): a shuffle, or
with ``weighted`` a class-balanced draw with replacement (weight
1 / class count over the live split, ``len(dataset)`` draws); fixed-size
batches, where train drops the trailing partial batch and ``pad_last``
pads it by repeating its last item; a ``valid`` mask (1 real, 0 padding)
in every batch; and one token-draw seed per epoch position, so an item's
patch subsample is a pure function of the seed, the epoch and its position.

Two paths assemble a batch, as in the JAX loader. On a cohort of ``.npy``
files (``dataset.wsi_npy_path``) the C++ gather
(:mod:`.native_loader`, ``workers`` threads) draws the tokens: the JAX
CLI's default, so the same seed gives the JAX CLI's batches. Elsewhere, or
with ``use_native=False``, the numpy path (``dataset.__getitem__`` with a
generator from the item's seed, ``workers`` items at a time), the JAX
loader's ``use_native=False`` batches. Where the gather turns a cohort
down (a mixed cohort, a dtype or order it does not read), the loader takes
the numpy path for the rest of its life and says so once; a library that
does not build or load raises instead. A producer thread keeps
``prefetch`` batches ready and stops when iteration ends or is abandoned.

Under a process group (``parallel/distributed.py``) ``batch_size`` is the
GLOBAL batch, as in the JAX CLIs: every rank draws the same epoch order
and item seeds from the shared seed and assembles only its block of each
global batch (``local_block``: rank p owns rows [p * b / R, (p + 1) * b /
R)), so the blocks in rank order are the one-process batch, ``valid``
included; a padded eval tail is padded as a whole, then cut.
"""

import logging
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from ..parallel.distributed import local_block, process_info

_logger = logging.getLogger(__name__)
_said = set()  # the fallback reasons already logged


def class_balanced_weights(dataset) -> np.ndarray:
    """1 / class count of each item, over the live split, index-aligned
    with ``dataset.get_label``."""
    labels = np.asarray([dataset.get_label(i) for i in range(len(dataset))])
    return 1.0 / np.bincount(labels)[labels]


def _say_once(reason: str) -> None:
    if reason not in _said:
        _said.add(reason)
        _logger.warning("native loader: %s; the numpy path assembles these batches", reason)


class Loader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, pad_last: bool = False, weighted: bool = False,
                 seed: int = 42, workers: int = 4, prefetch: int = 2,
                 use_native: bool = True, process_index: Optional[int] = None,
                 process_count: Optional[int] = None) -> None:
        if drop_last and pad_last:
            raise ValueError("drop_last and pad_last exclude each other")
        self.process_index, self.process_count = process_info(process_index, process_count)
        if batch_size % self.process_count or not 0 <= self.process_index < self.process_count:
            raise ValueError(f"batch {batch_size} over {self.process_count} processes "
                             f"(process {self.process_index})")
        self.dataset = dataset
        self.batch_size = batch_size  # GLOBAL: every process's block together
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.weighted = weighted
        self.seed = seed
        self.workers = max(int(workers), 1)
        self.prefetch = prefetch
        self.epoch = 0
        # the JAX loader's eligibility: a .npy-backed cohort (the first item
        # tells; a mixed cohort turns the gather off at its first other file)
        self.native = bool(use_native and len(dataset) and hasattr(dataset, "wsi_npy_path")
                           and dataset.wsi_npy_path(0) is not None)
        if self.native:
            from . import native_loader

            native_loader.library()  # a build or load failure raises here

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

    def _native_batch(self, indices, seeds) -> Optional[Dict[str, np.ndarray]]:
        """The batch through the C++ gather, or None (and the numpy path
        from here on) where it turns the cohort down."""
        from . import native_loader

        paths = [self.dataset.wsi_npy_path(int(i)) for i in indices]
        if any(p is None for p in paths):
            self.native = False
            _say_once("a cohort of mixed formats")
            return None
        try:
            wsi = native_loader.gather_batch(paths, self.dataset.num_wsi_feature_tokens,
                                             [int(s) for s in seeds], num_threads=self.workers)
        except ValueError as e:
            self.native = False
            _say_once(f"it rejected this cohort ({e})")
            return None
        metas = [self.dataset.get_meta(int(i)) for i in indices]
        batch = {k: np.stack([m[k] for m in metas]) for k in metas[0]}
        batch["wsi"] = wsi
        return batch

    def _make_batch(self, pool, indices, seeds, valid) -> Dict[str, np.ndarray]:
        batch = self._native_batch(indices, seeds) if self.native else None
        if batch is None:
            def item(pos):
                return self.dataset.__getitem__(int(indices[pos]),
                                                rng=np.random.default_rng(int(seeds[pos])))

            items = list(pool.map(item, range(len(indices))))
            batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
        batch["valid"] = valid
        return batch

    def _chunks(self):
        rng = np.random.default_rng(self.seed + self.epoch * 1000003)
        indices = self._indices(rng)
        n = len(indices)
        item_seeds = rng.integers(0, 2**63, size=n, dtype=np.int64)
        stop = n - (n % self.batch_size) if self.drop_last else n
        p, pc = self.process_index, self.process_count
        for start in range(0, stop, self.batch_size):
            idx = indices[start:start + self.batch_size]
            seeds = item_seeds[start:start + self.batch_size]
            n_valid = len(idx)
            if self.pad_last and n_valid < self.batch_size:
                pad = self.batch_size - n_valid
                idx = np.concatenate([idx, np.repeat(idx[-1:], pad)])
                seeds = np.concatenate([seeds, np.repeat(seeds[-1:], pad)])
            elif pc > 1 and n_valid % pc:
                raise ValueError("a multi-process loader's tail batch needs drop_last or "
                                 f"pad_last ({n_valid} rows over {pc} processes)")
            valid = (np.arange(len(idx)) < n_valid).astype(np.float32)
            yield tuple(local_block(a, p, pc) for a in (idx, seeds, valid))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        chunks = list(self._chunks())
        with ThreadPoolExecutor(self.workers) as pool:
            if self.prefetch <= 0:
                for chunk in chunks:
                    yield self._make_batch(pool, *chunk)
                return
            yield from self._prefetched(pool, chunks)

    def _prefetched(self, pool, chunks) -> Iterator[Dict[str, np.ndarray]]:
        """The JAX loader's producer thread and queue of ``prefetch``
        batches: a stop event set when the consumer ends or abandons the
        iteration, the sentinel delivered whenever the consumer still
        listens, the queue drained and the thread joined on the way out, a
        producer's error raised in the consumer."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error = []
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for chunk in chunks:
                    if not put(self._make_batch(pool, *chunk)):
                        return
            except Exception as e:  # raised in the consumer
                error.append(e)
            finally:
                put(sentinel)

        thread = threading.Thread(target=producer, daemon=True, name="mirror-loader")
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=10.0)
        if error:
            raise error[0]
