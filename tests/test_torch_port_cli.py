"""The port's pretrain entry point, ``mirror_tpu_torch.train_mirror``, on the
CPU: it trains a tiny MIRROR end to end on a synthetic cohort from the
pretrain template, refuses what the port does not implement, refuses the
card when there is none, and imports no JAX.
"""

import inspect
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from mirror_tpu_torch import config, train_mirror
from mirror_tpu_torch.registry import create_model
from mirror_tpu_torch.train.checkpoint import load_checkpoint_file, run_args
from test_torch_port_runctl import one_intra_op_thread  # noqa: F401 (the fixture)

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
    """The port's PretrainDataset + Loader against the JAX package's, both
    at their default (the C++ gather, which turns these float16 files down,
    so both assemble them on the numpy path): the same fold, shuffle,
    drop_last and per-slide token draws."""
    from mirror_tpu.data.datasets import PretrainDataset as JaxDataset
    from mirror_tpu.data.loader import Loader as JaxLoader
    from mirror_tpu_torch.data.datasets import PretrainDataset
    from mirror_tpu_torch.data.loader import Loader

    args = (str(cohort / "feats"), str(cohort / "rna.csv"), N_TOK)
    ours = Loader(PretrainDataset(*args, splits=str(cohort / "splits")), 4, seed=3,
                  workers=2)
    theirs = JaxLoader(JaxDataset(*args, splits=str(cohort / "splits")), 4, seed=3,
                       process_index=0, process_count=1)
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
    ["--model-parallel", "2"], ["--distributed"], ["--loss", "info_nce_loss"],
    ["--ckpt-format", "orbax"],
])
def test_train_mirror_refuses_unported_flags(cohort, flag):
    """``--ckpt-format orbax`` (a departure on purpose: the port writes the
    reference's .pth.tar), a loss the port has not, ``--distributed`` with
    no rendezvous in the env (torchrun's or ``MIRROR_COORDINATOR``), and
    ``--model-parallel 2`` in one process (it needs a world size that
    divides by 2), each refused at start naming the flag."""
    name = flag[0]
    if name == "--model-parallel":
        name = r"--model-parallel 2: tensor parallelism needs a world size that is a multiple of 2 \(this run has 1 process\)"
    if name == "--ckpt-format":
        name = r"--ckpt-format orbax: the port writes the reference's \.pth\.tar only"
    with pytest.raises(SystemExit, match=name):
        train_mirror.main(_argv(cohort, "--device", "cpu", *flag))


@pytest.mark.parametrize("flag", [
    ["--grad-accum-steps", "2"], ["--opt", "sgd"], ["--use-sched"], ["--clip-grad", "1.0"],
    ["--layer-decay", "0.7"], ["--model-ema"],
])
def test_train_mirror_runs_the_optimizer_flags(cohort, flag):
    """The optimizer-side flags the port once refused now train: one epoch
    on the CPU, a finite result, and the EMA weights in the checkpoint
    under --model-ema."""
    experiment = "opt_" + flag[0].strip("-")
    results = train_mirror.main(_argv(cohort, "--device", "cpu", "--experiment", experiment,
                                      *flag))
    assert np.isfinite(results["best_metric"])
    payload = load_checkpoint_file(str(cohort / "runs" / "pretrain" / experiment
                                       / "last.pth.tar"))
    assert ("state_dict_ema" in payload) == (flag[0] == "--model-ema")
    summary = pd.read_csv(cohort / "runs" / "pretrain" / experiment / "summary.csv")
    assert np.isfinite(summary["train_lr"]).all()


@pytest.mark.parametrize("flag", [["--model", "mirror_dual"], ["--loss", "info_nce"]])
def test_train_mirror_leaves_the_clip_baseline_to_train_pretrain(cohort, flag):
    with pytest.raises(SystemExit, match="train_pretrain"):
        train_mirror.main(_argv(cohort, "--device", "cpu", *flag))


def test_an_eval_metric_the_epochs_do_not_emit_is_warned_and_unranked(cohort, caplog):
    """The JAX behaviour (the epoch unranked, no best checkpoint), now with a
    warning that names the metric and the metrics the epoch emitted."""
    with caplog.at_level(logging.WARNING, logger="train"):
        results = train_mirror.main(_argv(cohort, "--device", "cpu", "--eval-metric", "auc",
                                          "--experiment", "tiny_no_metric"))
    assert results["best_metric"] is None and results["best_epoch"] is None
    warned = [r.getMessage() for r in caplog.records if "auc" in r.getMessage()]
    assert warned and "not ranked" in warned[0] and "alignment_loss" in warned[0]
    run_dir = cohort / "runs" / "pretrain" / "tiny_no_metric"
    assert sorted(p.name for p in run_dir.glob("*.pth.tar")) == ["last.pth.tar"]


def test_a_train_mirror_ema_checkpoint_warm_starts_from_its_ema_weights(cohort):
    """train_mirror --model-ema saves state_dict_ema beside the live
    weights; load_pretrained(use_ema=True) reads it."""
    from mirror_tpu_torch.train.checkpoint import load_pretrained

    train_mirror.main(_argv(cohort, "--device", "cpu", "--model-ema", "--experiment",
                            "tiny_ema"))
    path = str(cohort / "runs" / "pretrain" / "tiny_ema" / "last.pth.tar")
    payload = load_checkpoint_file(path)
    model = create_model("mirror", device="cpu", **run_args(payload)["model_kwargs"])
    load_pretrained(model, path, use_ema=True)
    key = "wsi_encoder.layer1.attn.to_qkv.weight"
    assert torch.equal(model.state_dict()[key], payload["state_dict_ema"][key])
    assert not torch.equal(payload["state_dict_ema"][key], payload["state_dict"][key])


# each refused flag set away from its default, on the command line
UNPORTED_ARGV = {
    "model_parallel": ["--model-parallel", "2"], "ckpt_format": ["--ckpt-format", "orbax"],
}


@pytest.mark.parametrize("dest,item", [("model_parallel", 16), ("ckpt_format", 17)])
def test_refusal_names_the_flag_and_its_roadmap_item(dest, item):
    """``--ckpt-format orbax`` (item 17, ported but for Orbax) is refused as
    a departure on purpose, naming the JAX package's tool that makes an
    Orbax directory; ``--model-parallel`` (item 16, ported) passes that
    check and is refused in one process, where the world size does not
    divide by 2, by the process group's setup."""
    args, _ = config.parse_args(UNPORTED_ARGV[dest], task="pretrain")
    if dest == "model_parallel":
        from mirror_tpu_torch.parallel import distributed

        config.refuse_unported(args)
        with pytest.raises(SystemExit, match=r"--model-parallel 2: tensor parallelism needs a world size that is a multiple of 2 \(this run has 1 process\)"):
            with distributed.session(args, torch.device("cpu")):
                pass
        return
    with pytest.raises(SystemExit) as refusal:
        config.refuse_unported(args)
    message = str(refusal.value)
    assert message == config.ORBAX_REFUSAL and item == 17
    assert message.startswith(f"--{dest.replace('_', '-')} orbax: "), message
    assert "mirror_tpu.tools.import_torch_checkpoint" in message and "--format orbax" in message


def test_train_mirror_refuses_exact_pinv_grad_on_the_card(cohort, capsys):
    """--pinv-grad exact is no longer refused for itself: with --device cpu
    it trains and saves (the exact backward's plain version), and on a
    machine without a card the default --device cuda run ends on the
    --device cpu message, as every run there does."""
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            train_mirror.main(_argv(cohort, "--pinv-grad", "exact"))
    results = train_mirror.main(_argv(cohort, "--device", "cpu", "--pinv-grad", "exact",
                                      "--experiment", "tiny_exact"))
    assert np.isfinite(results["best_metric"]) and "--result" in capsys.readouterr().out
    payload = load_checkpoint_file(str(cohort / "runs" / "pretrain" / "tiny_exact"
                                       / "last.pth.tar"))
    assert run_args(payload)["model_kwargs"]["pinv_grad"] == "exact"
    model = create_model("mirror", device="cpu", **run_args(payload)["model_kwargs"])
    model.load_state_dict(payload["state_dict"])


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


@pytest.mark.parametrize("flags,why", [
    (["--model-kwargs", "embed_dim=792"], "dh = 99, m = 396: the landmark softmax's backward "
                                          "kernel (1b)"),
    (["--model-kwargs", "embed_dim=1536"], "dh = 192: the softmax attention's backward kernels "
                                           "(3c, 4b)"),
])
def test_train_mirror_refuses_what_the_kernels_do_not_take(cohort, monkeypatch, flags, why):
    """On the card (the device check passed), a width beyond the backward
    kernels stops training at start, before the cohort is read, naming
    them and --no-use-pallas (the forward kernels take it: predict serves
    it)."""
    from mirror_tpu_torch.train import harness

    monkeypatch.setattr(harness, "device_from_arg", lambda name: torch.device("cuda"))
    argv = ["--config", TEMPLATE, "--wsi-feature-dir", str(cohort / "missing"), *flags]
    with pytest.raises(ValueError, match="--no-use-pallas") as err:
        train_mirror.main(argv)
    assert why in str(err.value)
    assert "training: the backward kernels (1b, 3c, 4b, 9b) do not take" in str(err.value)


def test_predict_refuses_a_float32_checkpoint_on_the_card(tmp_path, monkeypatch):
    """A checkpoint whose args say amp: false is taken by predict on the
    card: its model keeps the kernel path in float32 (the kernels take it
    since they take float32), and so is a head-dim-192 one (embed 1536: the
    forward kernels take every width). A float64 checkpoint is refused
    before any slide is read; --no-use-pallas is the way through. The
    card's model is built on the CPU, checked as create_model checks it."""
    from mirror_tpu_torch import registry
    from mirror_tpu_torch.tools import predict as predict_mod
    from mirror_tpu_torch.tools.predict import _rebuild_model, predict
    from mirror_tpu_torch.train.checkpoint import save_checkpoint_file

    def create_on_cpu(name, device="cuda", **kwargs):
        model = registry.create_model(name, device="cpu", **kwargs)
        registry._refuse_kernel_path(model)
        return model

    path = str(tmp_path / "fp32.pth.tar")
    save_checkpoint_file(path, {}, {"amp": False, "model": "mirror_classifier", "model_kwargs": {
        "wsi_embed_dim": 48, "rna_embed_dim": 16, "embed_dim": 384, "rna_encoder_depth": 1}})
    with monkeypatch.context() as mp:
        mp.setattr(predict_mod, "create_model", create_on_cpu)
        model, _, _ = _rebuild_model(load_checkpoint_file(path), None, "subtyping", "cuda")
    attn = model.wsi_encoder.layer1.attn
    assert attn.use_pallas is True and attn.dtype in (None, torch.float32)

    path = str(tmp_path / "dh192.pth.tar")
    save_checkpoint_file(path, {}, {"amp": False, "model": "mirror_classifier",
                                    "model_kwargs": {"wsi_embed_dim": 768, "embed_dim": 1536}})
    with monkeypatch.context() as mp:
        mp.setattr(predict_mod, "create_model", create_on_cpu)
        model, _, _ = _rebuild_model(load_checkpoint_file(path), None, "subtyping", "cuda")
    attn = model.wsi_encoder.layer1.attn
    assert attn.use_pallas is True and (attn.dim_head, attn.num_landmarks) == (192, 768)

    path = str(tmp_path / "f64.pth.tar")
    save_checkpoint_file(path, {}, {"amp": False, "model": "mirror_classifier",
                                    "model_kwargs": {"wsi_embed_dim": 768, "embed_dim": 1536,
                                                     "dtype": "float64"}})
    with pytest.raises(ValueError, match="--no-use-pallas") as err:
        predict(path, "subtyping", str(tmp_path / "none"), str(tmp_path / "out.csv"),
                device="cuda")
    assert "compute dtype torch.float64" in str(err.value)


def test_predict_keeps_the_checkpoints_use_pallas(tmp_path, monkeypatch):
    """A checkpoint trained with --no-use-pallas --no-amp keeps the plain
    path by default (as the JAX tool's setdefault does); --use-pallas, given,
    overrides it and passes for the float32 checkpoint, whose type the
    kernels take. The card's check is made as create_model makes it; the
    model is built on the CPU."""
    from mirror_tpu_torch import registry
    from mirror_tpu_torch.tools import predict as predict_mod
    from mirror_tpu_torch.tools.predict import _rebuild_model
    from mirror_tpu_torch.train.checkpoint import save_checkpoint_file

    def create_on_cpu(name, device="cuda", **kwargs):
        model = registry.create_model(name, device="cpu", **kwargs)
        registry._refuse_kernel_path(model)
        return model
    monkeypatch.setattr(predict_mod, "create_model", create_on_cpu)

    path = str(tmp_path / "plain.pth.tar")
    save_checkpoint_file(path, {}, {"amp": False, "model": "mirror_classifier", "model_kwargs": {
        "wsi_embed_dim": 48, "rna_embed_dim": 16, "embed_dim": 384, "rna_encoder_depth": 1,
        "use_pallas": False}})  # embed 384: 8 heads of 48, 192 landmarks
    payload = load_checkpoint_file(path)
    model, _, _ = _rebuild_model(payload, None, "subtyping", "cuda")
    assert model.wsi_encoder.layer1.attn.use_pallas is False
    model, _, _ = _rebuild_model(payload, None, "subtyping", "cuda", use_pallas=True)
    assert model.wsi_encoder.layer1.attn.use_pallas is True


def test_train_mirror_no_use_pallas_runs_the_plain_path(cohort, monkeypatch):
    """--no-use-pallas reaches the model (and its saved args), and the run
    calls no kernel wrapper of the Nystrom attention or PPEG."""
    from mirror_tpu_torch.models import nystrom, transmil

    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called on the plain path")
    for mod, attr in ((nystrom, "moore_penrose_pinv"), (transmil, "ppeg_fused")):
        monkeypatch.setattr(mod, attr, refuse)
    results = train_mirror.main(_argv(cohort, "--device", "cpu", "--no-use-pallas",
                                      "--pinv-grad", "exact", "--experiment", "tiny_plain"))
    assert np.isfinite(results["best_metric"])
    payload = load_checkpoint_file(str(cohort / "runs" / "pretrain" / "tiny_plain"
                                       / "last.pth.tar"))
    assert run_args(payload)["model_kwargs"]["use_pallas"] is False


def test_train_mirror_keeps_the_best_checkpoints(cohort):
    """--checkpoint-hist 2 over 4 epochs: checkpoint-<epoch> for the two
    lowest eval losses (the JAX saver's rule), beside last and model_best."""
    train_mirror.main(_argv(cohort, "--device", "cpu", "--epochs", "4", "--checkpoint-hist",
                            "2", "--experiment", "tiny_hist"))
    run_dir = cohort / "runs" / "pretrain" / "tiny_hist"
    losses = pd.read_csv(run_dir / "summary.csv")["eval_loss"].tolist()
    best = sorted(range(4), key=lambda e: losses[e])[:2]
    names = sorted(p.name for p in run_dir.glob("*.pth.tar"))
    assert names == sorted([f"checkpoint-{e}.pth.tar" for e in best]
                           + ["last.pth.tar", "model_best.pth.tar"])
    assert load_checkpoint_file(str(run_dir / "model_best.pth.tar"))["epoch"] == best[0]
