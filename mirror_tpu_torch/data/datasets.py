"""The pretraining dataset (host side, numpy).

The port's own copy of ``mirror_tpu/data/datasets.py``'s ``_read_split``,
``_BaseDataset`` and ``PretrainDataset`` (the reference's
datasets/dataset_pretrain.py): 15-char sample ids intersected between the
WSI feature directory and the RNA CSV (duplicate RNA rows dropped,
keep="first"); fold membership by the 12-char patient id against the split
CSV's train/val columns; ``__getitem__`` draws exactly
``num_wsi_feature_tokens`` patch rows, with replacement iff the slide has
fewer, from the numpy generator it is given.
"""

import logging
import os
from typing import Dict, List, Optional

import numpy as np
import pandas as pd

from .formats import find_feature_file, list_feature_files, load_feature_file

_logger = logging.getLogger(__name__)


def _read_split(splits_dir: str, fold_nb: int):
    fold_csv = pd.read_csv(
        os.path.join(splits_dir, f"splits_{fold_nb}.csv"), header=0, index_col=0
    )
    return fold_csv["train"].dropna().tolist(), fold_csv["val"].dropna().tolist()


class _BaseDataset:
    """Common id-intersection / fold / sampling machinery."""

    def __init__(self, num_wsi_feature_tokens: int, cache: bool) -> None:
        self.num_wsi_feature_tokens = num_wsi_feature_tokens
        self.cache = cache
        self.fold_nb = 0
        self.train_feature_ids: List[str] = []
        self.val_feature_ids: List[str] = []
        self.used_feature_ids: List[str] = []
        self._cache_store: Dict[str, np.ndarray] = {}
        self._mode = "train"

    def update_fold_nb(self, fold_nb: int):
        self.fold_nb = fold_nb
        if self.splits is None:
            return self  # no split: the whole cohort trains
        train_patients, val_patients = _read_split(self.splits, fold_nb)
        ids = [f.split(".")[0] for f in self.wsi_feature_files]
        self.train_feature_ids = [i for i in ids if i[:12] in train_patients]
        self.val_feature_ids = [i for i in ids if i[:12] in val_patients]
        return self

    def train(self):
        self._mode = "train"
        if self.splits is not None:
            self.used_feature_ids = self.train_feature_ids
        if self.cache:
            self._cache_data()
        return self

    def val(self):
        self._mode = "val"
        if self.splits is not None:
            self.used_feature_ids = self.val_feature_ids
        if self.cache:
            self._cache_data()
        return self

    def _feature_path(self, slide: str) -> str:
        raise NotImplementedError

    def _cache_data(self) -> None:
        for slide in self.used_feature_ids:
            if slide not in self._cache_store:
                # a copy: load_feature_file memory-maps .npy files
                self._cache_store[slide] = np.array(
                    load_feature_file(self._feature_path(slide)), copy=True)

    def _build_rna_cache(self) -> None:
        """RNA rows as float32 numpy up front (per-sample pandas .loc is
        slow)."""
        mat = self.rna_feature_df.to_numpy(dtype=np.float32)
        self._rna_cache = {sid: mat[i] for i, sid in enumerate(self.rna_feature_df.index)}

    def _load_wsi(self, slide: str, rng: Optional[np.random.Generator]) -> np.ndarray:
        if self.cache and slide in self._cache_store:
            feats = self._cache_store[slide]
        else:
            feats = load_feature_file(self._feature_path(slide))
        n, t = feats.shape[0], self.num_wsi_feature_tokens
        gen = rng if rng is not None else np.random
        idx = gen.choice(n, t, replace=not n >= t)
        return np.asarray(feats[idx], dtype=np.float32)

    def __len__(self) -> int:
        return len(self.used_feature_ids)


class PretrainDataset(_BaseDataset):
    def __init__(self, wsi_feature_dir: str, rna_feature_csv: str,
                 num_wsi_feature_tokens: int, splits: Optional[str] = None, k: int = 5,
                 cache: bool = False) -> None:
        super().__init__(num_wsi_feature_tokens, cache)
        self.wsi_feature_dir = wsi_feature_dir
        self.splits = splits
        self.k = k
        self.wsi_feature_files = list_feature_files(wsi_feature_dir)
        self.rna_feature_df = pd.read_csv(
            rna_feature_csv, header=0, index_col=0, sep=",").fillna(0)
        self._filter_data()
        self._build_rna_cache()
        if splits is not None:
            self.update_fold_nb(0)
        else:
            self.used_feature_ids = [f.split(".")[0] for f in self.wsi_feature_files]
        self.train()

    def _filter_data(self) -> None:
        self.rna_feature_df = self.rna_feature_df.loc[
            ~self.rna_feature_df.index.duplicated(keep="first")]
        wsi_ids = {f.split(".")[0][:15] for f in self.wsi_feature_files}
        common = wsi_ids & set(self.rna_feature_df.index.tolist())
        dropped = len(self.wsi_feature_files)
        self.wsi_feature_files = [
            f for f in self.wsi_feature_files if f.split(".")[0][:15] in common]
        dropped -= len(self.wsi_feature_files)
        if dropped:
            _logger.warning("WSI features for %d slides are missing RNA", dropped)
        self.rna_feature_df = self.rna_feature_df.loc[list(common)]

    def _feature_path(self, slide: str) -> str:
        return find_feature_file(self.wsi_feature_dir, slide)

    @property
    def rna_dim(self) -> int:
        return self.rna_feature_df.shape[1]

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None):
        slide = self.used_feature_ids[idx]
        return {"wsi": self._load_wsi(slide, rng), "rna": self._rna_cache[slide[:15]]}
