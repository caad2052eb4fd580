#!/usr/bin/env python
"""Evaluate downstream tasks (subtyping and survival, fine-tuning or the
linear probe) across folds, warm-started from the pretrain run of each
fold.

Counterpart of ``mirror_tpu/tools/downstream_tasks_evaluator.py``, with its
flags (the reference's tools/downstream_tasks_evaluator.py:140-263): for
each task config and fold, the newest run directory under
``--pretrain-root`` whose name ends in ``fold_<k>`` gives its
``model_best.pth.tar`` (else ``last.pth.tar``), and ``python -m
mirror_tpu_torch.train_{subtyping,survival} --config C --fold-nb k
--initial-checkpoint <it>`` runs on a slot of the pool
(``tools/launcher.py``).

    python -m mirror_tpu_torch.tools.downstream_tasks_evaluator \\
        --pretrain-root runs/pretrain --task-configs subtyping:sub.yaml \\
        survival:surv.yaml --k 5 --slots 0 1
"""

import argparse
import glob
import logging
import os
import sys
from typing import Optional

from mirror_tpu_torch.tools.launcher import run_jobs

_logger = logging.getLogger("downstream_evaluator")

BEST = ("model_best.pth.tar", "last.pth.tar")
TASK_MODULES = {
    "subtyping": "mirror_tpu_torch.train_subtyping",
    "survival": "mirror_tpu_torch.train_survival",
}


def find_fold_checkpoint(pretrain_root: str, fold: int) -> Optional[str]:
    """The newest run directory whose name ends in ``fold_{fold}``: its best
    checkpoint, else its last."""
    run_dirs = sorted(
        d for d in glob.glob(os.path.join(pretrain_root, "*"))
        # an exact suffix: a "fold_1" substring would also match fold_10+ and
        # take ANOTHER fold's checkpoint
        if os.path.isdir(d) and os.path.basename(d).endswith(f"fold_{fold}")
    )
    for d in reversed(run_dirs):
        for name in BEST:
            path = os.path.join(d, name)
            if os.path.exists(path):
                return path
    return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pretrain-root", required=True,
                   help="dir containing per-fold pretrain run dirs")
    p.add_argument("--task-configs", nargs="+", required=True,
                   help="entries of the form task:config.yaml (task in "
                        "subtyping|survival)")
    p.add_argument("--k", type=int, default=5)
    p.add_argument("--slots", nargs="+", default=["0"])
    p.add_argument("--virtual-factor", type=int, default=1)
    p.add_argument("extra", nargs=argparse.REMAINDER)
    a = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    commands = []
    for entry in a.task_configs:
        task, _, config = entry.partition(":")
        if task not in TASK_MODULES or not config:
            raise SystemExit(f"bad --task-configs entry: {entry}")
        for fold in range(a.k):
            ckpt = find_fold_checkpoint(a.pretrain_root, fold)
            if ckpt is None:
                _logger.warning("no pretrain checkpoint for fold %d; skipping", fold)
                continue
            commands.append([sys.executable, "-m", TASK_MODULES[task], "--config", config,
                             "--fold-nb", str(fold), "--initial-checkpoint", ckpt]
                            + list(a.extra))
    _logger.info("%d jobs queued", len(commands))
    codes = run_jobs(commands, slots=a.slots, virtual_factor=a.virtual_factor)
    failed = [i for i, c in enumerate(codes) if c != 0]
    if failed:
        _logger.error("jobs failed: %s", failed)
        return 1
    _logger.info("all jobs finished")
    return 0


if __name__ == "__main__":
    sys.exit(main())
