"""The port's pretrain entry point, ``mirror_tpu_torch.train_mirror``, on the
CPU: it trains a tiny MIRROR end to end on a synthetic cohort from the
pretrain template, refuses what the port does not implement, refuses the
card when there is none, and imports no JAX.
"""

import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from mirror_tpu_torch import train_mirror
from mirror_tpu_torch.registry import create_model
from mirror_tpu_torch.train.checkpoint import load_checkpoint_file, run_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEMPLATE = os.path.join(REPO, "configs", "pretrain", "mirror.template.yaml")
FEAT, RNA, N_SLIDES, N_TOK = 40, 50, 8, 30
TINY = ["wsi_embed_dim=40", "embed_dim=24", "wsi_num_tokens=30", "rna_encoder_depth=1",
        "style_mlp_hidden_dim=32", "style_mlp_out_dim=20", "style_latent_dim=16",
        "num_prototypes=37"]


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """8 slides of 10-60 fp16 patches (fewer and more than the 30 tokens
    drawn), an RNA CSV keyed by the 15-char sample id, and a fold-0 split
    with 6 train and 2 val patients."""
    root = tmp_path_factory.mktemp("pretrain_cohort")
    rng = np.random.default_rng(5)
    feat_dir = root / "feats"
    feat_dir.mkdir()
    ids = [f"TCGA-PT-{i:04d}-01Z-00-DX1" for i in range(N_SLIDES)]
    for sid in ids:
        n = int(rng.integers(10, 61))
        np.save(feat_dir / f"{sid}.npy", rng.standard_normal((n, FEAT)).astype(np.float16))
    pd.DataFrame(rng.standard_normal((N_SLIDES, RNA)).astype(np.float32),
                 index=[s[:15] for s in ids],
                 columns=[f"gene_{j}" for j in range(RNA)]).to_csv(root / "rna.csv")
    split_dir = root / "splits"
    split_dir.mkdir()
    patients = [s[:12] for s in ids]
    pd.DataFrame({"train": patients[:6], "val": patients[6:] + [np.nan] * 4}).to_csv(
        split_dir / "splits_0.csv")
    return root


def _argv(cohort, *extra):
    return ["--config", TEMPLATE, "--wsi-feature-dir", str(cohort / "feats"),
            "--rna-feature-csv", str(cohort / "rna.csv"), "--split-dir",
            str(cohort / "splits"), "--output", str(cohort / "runs"), "--experiment",
            "tiny", "--epochs", "1", "--batch-size", "2", "--num-wsi-feature-tokens",
            str(N_TOK), "--workers", "2", "--model-kwargs", *TINY, *extra]


@pytest.mark.parametrize("epoch", [0, 1])
def test_loader_draws_the_jax_loaders_batches(cohort, epoch):
    """The port's PretrainDataset + Loader against the JAX package's numpy
    path: the same fold, shuffle, drop_last and per-slide token draws."""
    from mirror_tpu.data.datasets import PretrainDataset as JaxDataset
    from mirror_tpu.data.loader import Loader as JaxLoader
    from mirror_tpu_torch.data.datasets import PretrainDataset
    from mirror_tpu_torch.data.loader import Loader

    args = (str(cohort / "feats"), str(cohort / "rna.csv"), N_TOK)
    ours = Loader(PretrainDataset(*args, splits=str(cohort / "splits")), 4, seed=3,
                  workers=2)
    theirs = JaxLoader(JaxDataset(*args, splits=str(cohort / "splits")), 4, seed=3,
                       use_native=False, process_index=0, process_count=1)
    ours.set_epoch(epoch)
    theirs.set_epoch(epoch)
    got, want = list(ours), list(theirs)
    assert len(got) == len(want) == len(ours) == 1  # 6 train slides, drop_last
    for a, b in zip(got, want):
        for key in ("wsi", "rna"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_create_model_defaults_to_the_card():
    assert inspect.signature(create_model).parameters["device"].default == "cuda"


def test_train_mirror_trains_on_the_cpu_and_its_checkpoint_reloads(cohort, capsys):
    results = train_mirror.main(_argv(cohort, "--device", "cpu"))
    out = capsys.readouterr().out
    printed = json.loads(out.split("--result\n", 1)[1])
    assert printed == results and results["metric_name"] == "loss"
    assert np.isfinite(results["best_metric"]) and results["best_epoch"] == 0

    run_dir = cohort / "runs" / "pretrain" / "tiny"
    summary = pd.read_csv(run_dir / "summary.csv")
    loss_cols = ["loss", "alignment_loss", "wsi_retention_loss", "rna_retention_loss",
                 "style_loss", "cluster_loss"]
    for split in ("train", "eval"):
        assert np.isfinite(summary[[f"{split}_{c}" for c in loss_cols]].to_numpy()).all()

    payload = load_checkpoint_file(str(run_dir / "last.pth.tar"))
    args = run_args(payload)
    assert payload["arch"] == "mirror" and args["model_kwargs"]["rna_embed_dim"] == RNA
    model = create_model("mirror", device="cpu", **args["model_kwargs"])
    model.load_state_dict(payload["state_dict"])
    # the train step left the prototypes renormed and logit_scale clamped
    assert 0.0 <= model.logit_scale.item() <= np.log(100.0)
    assert os.path.exists(run_dir / "model_best.pth.tar")


@pytest.mark.parametrize("flag", [
    ["--resume", "x.pth.tar"], ["--recovery-interval", "5"], ["--checkpoint-hist", "3"],
    ["--log-wandb"], ["--grad-accum-steps", "2"], ["--model-parallel", "2"],
    ["--distributed"], ["--opt", "sgd"], ["--use-sched"], ["--clip-grad", "1.0"],
    ["--layer-decay", "0.7"], ["--model-ema"],
])
def test_train_mirror_refuses_unported_flags(cohort, flag):
    name = flag[0]
    with pytest.raises(SystemExit, match=name):
        train_mirror.main(_argv(cohort, "--device", "cpu", *flag))


def test_train_mirror_refuses_exact_pinv_grad_on_the_card(cohort):
    with pytest.raises(SystemExit, match="--pinv-grad exact.*2b"):
        train_mirror.main(_argv(cohort, "--pinv-grad", "exact"))


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without a card")
def test_train_mirror_needs_a_card_unless_told_cpu(cohort):
    with pytest.raises(SystemExit, match="--device cpu"):
        train_mirror.main(_argv(cohort))


def test_train_mirror_imports_with_jax_blocked():
    """jax, flax, optax and the JAX package made unimportable: the entry
    point and everything it imports still load."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'mirror_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import mirror_tpu_torch.train_mirror, mirror_tpu_torch.tools.predict\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'mirror_tpu') and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
