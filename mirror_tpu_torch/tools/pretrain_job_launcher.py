#!/usr/bin/env python
"""Fan k-fold pretraining jobs over the host's cards, with restart on
failure.

Counterpart of ``mirror_tpu/tools/pretrain_job_launcher.py``, with its
flags: one ``python -m mirror_tpu_torch.train_mirror --config C --fold-nb k``
job a fold (the reference's tools/pretrain_job_launcher.py:104-147), drained
through the slot pool (``tools/launcher.py``), and torchrun-elastic's
retry (the reference's scripts/run_train_mirror.sh:62-68): a failed fold
is run again up to ``--max-retries`` times, with ``--resume`` from its
newest ``recovery.pth.tar`` or ``last.pth.tar`` where one exists. Run
directories are the training harness's ``<output>/pretrain/<run>``, a
run's name ending in ``fold_<k>`` (``train/harness.py::output_dir``).

    python -m mirror_tpu_torch.tools.pretrain_job_launcher \\
        --config configs/pretrain/mirror.template.yaml --k 5 --slots 0 1 2 3 \\
        --output-root runs --max-retries 1

``--script`` names a module run with ``python -m`` or a ``.py`` file.
"""

import argparse
import glob
import logging
import os
import sys

from mirror_tpu_torch.tools.launcher import run_jobs

_logger = logging.getLogger("pretrain_launcher")

RESUMABLE = ("recovery.pth.tar", "last.pth.tar")


def newest_resumable(output_root: str, fold: int):
    """The fold's newest recovery or last checkpoint, if any."""
    if not output_root:
        return None
    candidates = []
    for name in RESUMABLE:
        # *fold_{fold}, no trailing wildcard: *fold_1* would also match the
        # fold_10+ run directories and resume from another fold
        for path in glob.glob(os.path.join(output_root, "pretrain", f"*fold_{fold}", name)):
            candidates.append((os.path.getmtime(path), path))
    return max(candidates)[1] if candidates else None


def script_command(script: str) -> list:
    """``python -m <module>``, or ``python <file.py>``."""
    if script.endswith(".py"):
        return [sys.executable, script]
    return [sys.executable, "-m", script]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--k", type=int, default=5)
    p.add_argument("--script", default="mirror_tpu_torch.train_mirror")
    p.add_argument("--slots", nargs="+", default=["0"])
    p.add_argument("--virtual-factor", type=int, default=1)
    p.add_argument("--max-retries", type=int, default=0,
                   help="retry failed folds, resuming from their newest "
                        "recovery/last checkpoint")
    p.add_argument("--output-root", default="",
                   help="the config's `output` dir (for resume discovery)")
    p.add_argument("extra", nargs=argparse.REMAINDER,
                   help="extra flags forwarded to the train script")
    a = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    def command(fold, resume=None):
        cmd = script_command(a.script) + ["--config", a.config, "--fold-nb", str(fold)]
        if resume:
            cmd += ["--resume", resume]
        return cmd + list(a.extra)

    pending = list(range(a.k))
    for attempt in range(a.max_retries + 1):
        commands = [command(f, newest_resumable(a.output_root, f) if attempt else None)
                    for f in pending]
        codes = run_jobs(commands, slots=a.slots, virtual_factor=a.virtual_factor)
        pending = [f for f, c in zip(pending, codes) if c != 0]
        if not pending:
            break
        if attempt < a.max_retries:
            _logger.warning("folds %s failed (attempt %d); retrying with resume", pending,
                            attempt + 1)
    if pending:
        _logger.error("folds failed after retries: %s", pending)
        return 1
    _logger.info("all %d folds finished", a.k)
    return 0


if __name__ == "__main__":
    sys.exit(main())
