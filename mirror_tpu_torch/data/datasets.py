"""The pretraining and downstream datasets (host side, numpy).

The port's own copy of ``mirror_tpu/data/datasets.py``'s ``_read_split``,
``_BaseDataset``, ``PretrainDataset``, ``SubtypingDataset`` and
``SurvivalDataset`` (the reference's datasets/dataset_{pretrain,subtyping,
survival}.py): 15-char sample ids intersected between the WSI feature
directory and the RNA CSV (duplicate RNA rows dropped, keep="first"); fold
membership by the 12-char patient id against the split CSV's train/val
columns; ``__getitem__`` draws exactly ``num_wsi_feature_tokens`` patch
rows, with replacement iff the slide has fewer, from the numpy generator it
is given. Subtyping labels are the class folder's index; survival labels
are the reference's discretisation (pd.qcut over the uncensored times, the
outer edges widened by +-eps, pd.cut over everyone) with censorship =
int(status[0]), so "1:DECEASED" -> 1 == the event.
"""

import logging
import os
from typing import Dict, List, Optional, Sequence

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

    def _rna(self, slide: str) -> np.ndarray:
        return self._rna_cache[slide[:15]]

    def _meta(self, slide: str) -> dict:
        return {"rna": self._rna(slide)}

    def _filter_rna(self) -> None:
        """Keep the slides whose 15-char sample id has an RNA row (duplicate
        rows dropped, the first kept), and those rows."""
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

    def _select_fold(self) -> None:
        if self.splits is not None:
            self.update_fold_nb(0)
        else:
            self.used_feature_ids = [f.split(".")[0] for f in self.wsi_feature_files]
        self.train()

    def _feature_path(self, slide: str) -> str:
        return find_feature_file(self.wsi_feature_dir, slide)

    def wsi_npy_path(self, idx: int) -> Optional[str]:
        """The item's ``.npy`` feature file, or None where the cohort is
        cached or the file is another format (the C++ gather's
        eligibility)."""
        if self.cache:
            return None
        try:
            path = self._feature_path(self.used_feature_ids[idx])
        except FileNotFoundError:
            return None
        return path if path.endswith(".npy") else None

    def get_meta(self, idx: int) -> dict:
        """What ``__getitem__`` returns but the ``wsi`` tokens (the gather
        draws those)."""
        return self._meta(self.used_feature_ids[idx])

    @property
    def rna_dim(self) -> int:
        return self.rna_feature_df.shape[1]

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

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None):
        slide = self.used_feature_ids[idx]
        return {"wsi": self._load_wsi(slide, rng), **self._meta(slide)}


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
        self._filter_rna()
        self._build_rna_cache()
        self._select_fold()


class SubtypingDataset(_BaseDataset):
    """Slides under ``{wsi_feature_dir}/{class}/``, labelled by the index of
    their class in ``classes``."""

    def __init__(self, wsi_feature_dir: str, rna_feature_csv: str, classes: Sequence[str],
                 num_wsi_feature_tokens: int, splits: Optional[str] = None, k: int = 5,
                 wsi_feature_only: bool = False, cache: bool = False) -> None:
        super().__init__(num_wsi_feature_tokens, cache)
        self.wsi_feature_dir = wsi_feature_dir
        self.classes = list(classes)
        self.splits = splits
        self.k = k
        self.wsi_feature_only = wsi_feature_only
        self.class_dict: Dict[str, int] = {}
        for label, c in enumerate(self.classes):
            for f in list_feature_files(os.path.join(wsi_feature_dir, c)):
                self.class_dict[f.split(".")[0]] = label
        self.wsi_feature_files = list(self.class_dict)
        self.rna_feature_df = pd.read_csv(
            rna_feature_csv, header=0, index_col=0, sep=",").fillna(0)
        self._filter_rna()
        self._build_rna_cache()
        self._select_fold()

    def _feature_path(self, slide: str) -> str:
        return find_feature_file(
            os.path.join(self.wsi_feature_dir, self.classes[self.class_dict[slide]]), slide)

    def get_label(self, idx: int) -> int:
        return self.class_dict[self.used_feature_ids[idx]]

    def _meta(self, slide: str) -> dict:
        out = {"label": np.int32(self.class_dict[slide])}
        if not self.wsi_feature_only:
            out["rna"] = self._rna(slide)
        return out


class SurvivalDataset(_BaseDataset):
    """Slides of ``wsi_feature_dir`` with a row in the survival CSV (the
    cBioPortal columns by default) and in the RNA CSV."""

    def __init__(self, wsi_feature_dir: str, rna_feature_csv: str, survival_csv: str,
                 num_wsi_feature_tokens: int, splits: Optional[str] = None, k: int = 5,
                 num_bins: int = 4, case_id_column: str = "Patient ID",
                 slide_id_column: str = "Sample ID",
                 label_column: str = "Overall Survival (Months)",
                 censor_column: str = "Overall Survival Status",
                 wsi_feature_only: bool = False, cache: bool = False) -> None:
        super().__init__(num_wsi_feature_tokens, cache)
        self.wsi_feature_dir = wsi_feature_dir
        self.splits = splits
        self.k = k
        self.num_bins = num_bins
        self.case_id_column = case_id_column
        self.slide_id_column = slide_id_column
        self.label_column = label_column
        self.censor_column = censor_column
        self.wsi_feature_only = wsi_feature_only
        self.eps = 1e-6
        self.wsi_feature_files = list_feature_files(wsi_feature_dir)
        self.rna_feature_df = pd.read_csv(
            rna_feature_csv, header=0, index_col=0, sep=",").fillna(0)
        self.survival_data = pd.read_csv(survival_csv, sep=",").fillna(0)
        self._filter_data()
        self._build_rna_cache()
        self.num_classes: Optional[int] = None
        self._gen_disc_label()
        self._select_fold()

    def _sample_ids(self, width: Optional[int] = None) -> pd.Series:
        """The survival CSV's sample ids, extension stripped, cut to
        ``width`` characters."""
        return self.survival_data[self.slide_id_column].apply(
            lambda x: x.split(".")[0][:width])

    def _filter_data(self) -> None:
        """The reference's order (dataset_survival.py:95-147), which decides
        the duplicates kept. The first intersection cuts the WSI ids to 15
        characters and not the survival ids, as there."""
        self.rna_feature_df = self.rna_feature_df.loc[
            ~self.rna_feature_df.index.duplicated(keep="first")]
        self.survival_data = self.survival_data.loc[
            ~self._sample_ids().duplicated(keep="first")]
        self.survival_data = self.survival_data.drop_duplicates(
            subset=self.case_id_column, keep="first")
        wsi_ids = {f.split(".")[0][:15] for f in self.wsi_feature_files}
        common = wsi_ids & set(self._sample_ids())
        self.wsi_feature_files = [
            f for f in self.wsi_feature_files if f.split(".")[0][:15] in common]
        self.survival_data = self.survival_data[self._sample_ids().isin(common)]
        wsi_ids = {f.split(".")[0][:15] for f in self.wsi_feature_files}
        common = wsi_ids & set(self.rna_feature_df.index.tolist()) & set(self._sample_ids(15))
        self.wsi_feature_files = [
            f for f in self.wsi_feature_files if f.split(".")[0][:15] in common]
        self.rna_feature_df = self.rna_feature_df.loc[list(common)]
        self.survival_data = self.survival_data[self._sample_ids(15).isin(common)]

    def _gen_disc_label(self) -> None:
        """The reference's discretisation (dataset_survival.py:167-224):
        num_bins quantile bins of the uncensored times, the outer edges at
        min - eps and max + eps (equal-width bins when there is no event),
        then one label per (bin, censorship) pair."""
        patients_df = self.survival_data.copy()
        times = self.survival_data[self.label_column]
        events = self.survival_data[self.survival_data[self.censor_column] == "1:DECEASED"]
        bins = self.num_bins
        if len(events) > 0:
            _, bins = pd.qcut(events[self.label_column], q=self.num_bins, retbins=True,
                              labels=False)
            bins = np.asarray(bins, dtype=np.float64)
            bins[-1] = times.max() + self.eps
            bins[0] = times.min() - self.eps
        disc_labels, bins = pd.cut(patients_df[self.label_column], bins=bins, retbins=True,
                                   labels=False, right=False, include_lowest=True)
        patients_df.insert(len(patients_df.columns), "disc_label",
                           disc_labels.values.astype(int))
        label_dict = {(i, c): 2 * i + c for i in range(len(bins) - 1) for c in (0, 1)}
        self.survival_data = self.survival_data.merge(
            patients_df[[self.case_id_column, "disc_label"]], on=self.case_id_column,
            how="left")
        status = self.survival_data[self.censor_column].astype(str)
        self.survival_data[self.censor_column] = status
        self.survival_data["censorship"] = status.str[0].astype(int)
        self.survival_data["label"] = self.survival_data.apply(
            lambda row: label_dict[(row["disc_label"], row["censorship"])], axis=1)
        self.num_classes = len(label_dict)
        self._surv_cache: Dict[str, List[dict]] = {}
        for _, row in self.survival_data.iterrows():
            key = str(row[self.slide_id_column]).split(".")[0]
            self._surv_cache.setdefault(key, []).append(
                {"label": int(row["label"]), "disc_label": int(row["disc_label"]),
                 "event_time": float(row[self.label_column]),
                 "censorship": int(row["censorship"])})

    def _surv_row(self, slide: str) -> dict:
        rows = self._surv_cache.get(slide[:15], [])
        if len(rows) != 1:
            raise ValueError(
                f"{'Multiple' if rows else 'No'} survival records for slide {slide} "
                f"(matched on the 15-char Sample ID prefix {slide[:15]!r})")
        return rows[0]

    def get_label(self, idx: int) -> int:
        return self._surv_row(self.used_feature_ids[idx])["label"]

    def _meta(self, slide: str) -> dict:
        row = self._surv_row(slide)
        out = {"label": np.int32(row["disc_label"]),
               "event_time": np.float32(row["event_time"]),
               "censorship": np.int32(row["censorship"])}
        if not self.wsi_feature_only:
            out["rna"] = self._rna(slide)
        return out
