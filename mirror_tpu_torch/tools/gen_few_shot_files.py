#!/usr/bin/env python
"""Generate k-shot (few-shot) split files.

Counterpart of ``mirror_tpu/tools/gen_few_shot_files.py`` (the reference's
tools/gen_few_shot_files.py:100-190), with its flags:

    python -m mirror_tpu_torch.tools.gen_few_shot_files --tasks subtyping \\
        --rna-feature-csv rna.csv --split-dir splits/ \\
        --subtyping-wsi-feature-dir feats/ --subtyping-classes LUAD LUSC \\
        --class-name tcga_nsclc --output-dir few_shot/ --shots 4 8

For each fold and shot count it groups the fold's training slides by label
(the subtyping class or the survival bin), draws a k-shot support set per
label with replacement (``random.choices`` seeded by ``--seed``, as the
reference does) among the slides that have at least
``--num-wsi-feature-tokens`` patches, and writes
``{output}/{task}/{k}foldcv/{shot}-shot/{class_name}/splits_{fold}.csv``
with 12-char patient ids (train = the support set, val = the fold's
validation slides). The same seed writes the same files as the JAX tool.
"""

import argparse
import logging
import os
import random

import pandas as pd

from mirror_tpu_torch.data.datasets import SubtypingDataset, SurvivalDataset
from mirror_tpu_torch.data.formats import load_feature_file

_logger = logging.getLogger("gen_few_shot")


def _group_by_label(dataset, task):
    groups = {}
    for slide in dataset.train_feature_ids:
        label = (dataset._surv_row(slide)["disc_label"] if task == "survival"
                 else dataset.class_dict[slide])
        groups.setdefault(label, []).append(slide)
    return groups


def gen_few_shot(dataset, task, output_dir, shots, k, num_tokens, class_name):
    n_patches = {}  # read each slide's patch count once

    def patches(slide):
        if slide not in n_patches:
            n_patches[slide] = len(load_feature_file(dataset._feature_path(slide)))
        return n_patches[slide]

    for fold in range(k):
        dataset.update_fold_nb(fold)
        groups = _group_by_label(dataset, task)
        for shot in shots:
            _logger.info("Generating %d-shot files for %s fold %d", shot, task, fold)
            support = []
            for label, slides in groups.items():
                eligible = [s for s in slides if patches(s) >= num_tokens]
                if not eligible:
                    raise SystemExit(
                        f"label {label} (fold {fold}) has no slide with >= {num_tokens} "
                        f"patches: no {shot}-shot support set can be drawn")
                support.extend(random.choices(eligible, k=shot))
            df = pd.DataFrame({"train": pd.Series([s[:12] for s in support]),
                               "val": pd.Series([s[:12] for s in dataset.val_feature_ids])})
            out = os.path.join(output_dir, task, f"{k}foldcv", f"{shot}-shot", class_name,
                               f"splits_{fold}.csv")
            os.makedirs(os.path.dirname(out), exist_ok=True)
            df.to_csv(out)


def main(argv=None):
    p = argparse.ArgumentParser(description="Generate k-shot split files (PyTorch port)")
    p.add_argument("--tasks", nargs="+", default=["subtyping", "survival"])
    p.add_argument("--shots", type=int, nargs="+", default=[10])
    p.add_argument("--k", type=int, default=5)
    p.add_argument("--num-wsi-feature-tokens", type=int, default=2048)
    p.add_argument("--num-bins", type=int, default=4)
    p.add_argument("--rna-feature-csv", required=True)
    p.add_argument("--split-dir", required=True)
    p.add_argument("--survival-wsi-feature-dir")
    p.add_argument("--survival-csv")
    p.add_argument("--subtyping-wsi-feature-dir")
    p.add_argument("--subtyping-classes", nargs="+")
    p.add_argument("--class-name", required=True, help="cohort name, e.g. tcga_brca")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    random.seed(args.seed)
    for task in args.tasks:
        if task == "survival":
            ds = SurvivalDataset(args.survival_wsi_feature_dir, args.rna_feature_csv,
                                 args.survival_csv,
                                 num_wsi_feature_tokens=args.num_wsi_feature_tokens,
                                 splits=args.split_dir, k=args.k, num_bins=args.num_bins)
        elif task == "subtyping":
            ds = SubtypingDataset(args.subtyping_wsi_feature_dir, args.rna_feature_csv,
                                  args.subtyping_classes,
                                  num_wsi_feature_tokens=args.num_wsi_feature_tokens,
                                  splits=args.split_dir, k=args.k)
        else:
            raise SystemExit(f"Invalid task: {task}")
        gen_few_shot(ds, task, args.output_dir, args.shots, args.k,
                     args.num_wsi_feature_tokens, args.class_name)
    _logger.info("Done")


if __name__ == "__main__":
    main()
