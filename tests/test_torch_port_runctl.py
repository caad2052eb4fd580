"""The port's run control (ROADMAP item 10) on the CPU, against the JAX
package where it has a counterpart: the parsers, each run-control flag in
the four entry points, the SIGTERM stop and the recovery file,
``--grad-checkpointing`` (its generator replay, and against the JAX
``nn.remat`` step), the C++ gather and the prefetching loader, ``--profile``,
wandb and ``--wandb-watch``.
"""

import logging
import os
import signal
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from mirror_tpu_torch import config, train_mirror, train_pretrain, train_subtyping, train_survival
from mirror_tpu_torch.registry import create_model
from mirror_tpu_torch.train.checkpoint import load_checkpoint_file, run_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRETRAIN_YAML = os.path.join(REPO, "configs", "pretrain", "mirror.template.yaml")
SUBTYPING_YAML = os.path.join(REPO, "configs", "subtyping", "mirror.template.yaml")
SURVIVAL_YAML = os.path.join(REPO, "configs", "survival", "mirror.template.yaml")
FEAT, RNA, N_TOK = 40, 50, 30
TINY = ["wsi_embed_dim=40", "embed_dim=24", "wsi_num_tokens=30", "rna_encoder_depth=1",
        "style_mlp_hidden_dim=32", "style_mlp_out_dim=20", "style_latent_dim=16",
        "num_prototypes=37"]
CLASSES = ("A", "B")
CLIS = {"train_mirror": train_mirror.main, "train_pretrain": train_pretrain.main,
        "subtyping": train_subtyping.main, "survival": train_survival.main}


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The tiny runs here gain nothing from intra-op threads, and beside the
    suite's other workers those threads' barriers slow them many times
    over: one thread for the module (its comparisons run under it alike)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_slides(feat_dir, ids, rng, dtype=np.float16):
    feat_dir.mkdir(parents=True, exist_ok=True)
    for sid in ids:
        n = int(rng.integers(10, 61))
        np.save(feat_dir / f"{sid}.npy", rng.standard_normal((n, FEAT)).astype(dtype))


def _write_rna(path, ids, rng):
    pd.DataFrame(rng.standard_normal((len(ids), RNA)).astype(np.float32),
                 index=[s[:15] for s in ids],
                 columns=[f"gene_{j}" for j in range(RNA)]).to_csv(path)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """Pretrain: 8 slides of 10-60 fp16 patches, 6 train (3 batches of 2)
    and 2 val patients. Downstream: 12 slides, in class folders and flat,
    a survival CSV, 8 train and 4 val patients (2 batches of 4)."""
    root = tmp_path_factory.mktemp("runctl_cohort")
    rng = np.random.default_rng(11)
    ids = [f"TCGA-RC-{i:04d}-01Z-00-DX1" for i in range(8)]
    _write_slides(root / "feats", ids, rng)
    _write_rna(root / "rna.csv", ids, rng)
    (root / "splits").mkdir()
    patients = [s[:12] for s in ids]
    pd.DataFrame({"train": patients[:6], "val": patients[6:] + [np.nan] * 4}).to_csv(
        root / "splits" / "splits_0.csv")

    down = [f"TCGA-DR-{i:04d}-01Z-00-DX1" for i in range(12)]
    for i, sid in enumerate(down):
        feats = rng.standard_normal((int(rng.integers(10, 61)), FEAT)).astype(np.float16)
        for d in (root / "classes" / CLASSES[i % 2], root / "flat"):
            d.mkdir(parents=True, exist_ok=True)
            np.save(d / f"{sid}.npy", feats)
    _write_rna(root / "down_rna.csv", down, rng)
    pd.DataFrame({
        "Patient ID": [s[:12] for s in down], "Sample ID": [s[:15] for s in down],
        "Overall Survival (Months)": np.round(rng.uniform(1, 100, len(down)), 2),
        "Overall Survival Status": ["0:LIVING" if i % 3 == 1 else "1:DECEASED"
                                    for i in range(len(down))],
    }).to_csv(root / "survival.csv", index=False)
    (root / "down_splits").mkdir()
    dp = [s[:12] for s in down]
    pd.DataFrame({"train": pd.Series(dp[:8]), "val": pd.Series(dp[8:])}).to_csv(
        root / "down_splits" / "splits_0.csv")
    return root


def cli_argv(cohort, cli, experiment, *extra):
    """A tiny 2-epoch run of ``cli`` on the CPU."""
    common = ["--output", str(cohort / "runs"), "--experiment", experiment, "--epochs", "2",
              "--num-wsi-feature-tokens", str(N_TOK), "--workers", "2", "--device", "cpu",
              "--model-kwargs", *TINY]
    if cli in ("train_mirror", "train_pretrain"):
        return ["--config", PRETRAIN_YAML, "--wsi-feature-dir", str(cohort / "feats"),
                "--rna-feature-csv", str(cohort / "rna.csv"), "--split-dir",
                str(cohort / "splits"), "--batch-size", "2", *common, *extra]
    down = ["--rna-feature-csv", str(cohort / "down_rna.csv"), "--split-dir",
            str(cohort / "down_splits"), "--batch-size", "4", *common]
    if cli == "subtyping":
        return ["--config", SUBTYPING_YAML, "--wsi-feature-dir", str(cohort / "classes"),
                "--classes", *CLASSES, *down, *extra]
    return ["--config", SURVIVAL_YAML, "--wsi-feature-dir", str(cohort / "flat"),
            "--survival-csv", str(cohort / "survival.csv"), *down, *extra]


def run_dir(cohort, cli, experiment):
    task = {"train_mirror": "pretrain", "train_pretrain": "pretrain_clip"}.get(cli, cli)
    return cohort / "runs" / task / experiment


# --------------------------------------------------------------------------
# the parsers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("task,n_options", [("pretrain", 103), ("subtyping", 112),
                                            ("survival", 112)])
def test_the_port_parsers_match_the_jax_parsers(task, n_options):
    """build_parser of the port against the JAX package's: the same option
    strings, and the same default for every destination but --device
    (cuda for tpu)."""
    from mirror_tpu.config import build_parser as jax_build_parser

    ours, theirs = config.build_parser(task), jax_build_parser(task)
    strings = {s for a in ours._actions for s in a.option_strings}
    assert strings == {s for a in theirs._actions for s in a.option_strings}
    assert len(strings) == n_options  # -h and --help among them
    ours_d, theirs_d = vars(ours.parse_args([])), vars(theirs.parse_args([]))
    assert set(ours_d) == set(theirs_d)
    differ = {k for k in ours_d if ours_d[k] != theirs_d[k]}
    assert differ == {"device"} and (ours_d["device"], theirs_d["device"]) == ("cuda", "tpu")


def test_only_the_multi_device_and_tool_flags_stay_refused():
    """No flag is left to port: ``--ckpt-format`` (item 17) takes its
    default, msgpack, and refuses orbax as a departure on purpose;
    ``--model-parallel`` (item 16) is ported, and one process refuses N > 1
    by the world size."""
    from mirror_tpu_torch.parallel import distributed

    assert not hasattr(config, "_UNPORTED")
    for task in config.TASKS:
        args, _ = config.parse_args(["--ckpt-format", "msgpack"], task=task)
        config.refuse_unported(args)
        args, _ = config.parse_args(["--ckpt-format", "orbax"], task=task)
        with pytest.raises(SystemExit) as refusal:
            config.refuse_unported(args)
        assert str(refusal.value) == config.ORBAX_REFUSAL
    with pytest.raises(SystemExit, match=r"--model-parallel 2: tensor parallelism needs a world size that is a multiple of 2 \(this run has 1 process\)"):
        distributed.refuse_model_parallel(2, 1)


# --------------------------------------------------------------------------
# each flag in each entry point
# --------------------------------------------------------------------------

FLAGS = {"grad_ckpt": ["--grad-checkpointing"], "profile": ["--profile"],
         "recovery": ["--recovery-interval", "1"], "wandb": ["--log-wandb"],
         "watch": ["--wandb-watch"]}


@pytest.mark.parametrize("flag", sorted(FLAGS))
@pytest.mark.parametrize("cli", sorted(CLIS))
def test_the_run_control_flags_run_in_every_entry_point(cohort, cli, flag, caplog):
    """Each flag, once refused, trains: --grad-checkpointing reaches the
    model and its saved kwargs, --profile traces the second of 2 epochs,
    --recovery-interval 1 leaves recovery.pth.tar, --log-wandb without wandb
    warns and trains, --wandb-watch keeps its stats out of summary.csv."""
    experiment = f"flag_{flag}"
    epochs = 2 if flag == "profile" else 1
    with caplog.at_level(logging.WARNING):
        results = CLIS[cli](cli_argv(cohort, cli, experiment, *FLAGS[flag], "--epochs",
                                     str(epochs)))
    assert results["metric_name"] and "preempted" not in results
    out = run_dir(cohort, cli, experiment)
    summary = pd.read_csv(out / "summary.csv")
    assert len(summary) == epochs and np.isfinite(summary["train_loss"]).all()
    assert not any(c.startswith("train_watch") for c in summary.columns)
    payload = load_checkpoint_file(str(out / "last.pth.tar"))
    kwargs = run_args(payload)["model_kwargs"]
    assert kwargs["grad_checkpointing"] is (flag == "grad_ckpt")
    assert (out / "profile" / "epoch_1.pt.trace.json").exists() is (flag == "profile")
    assert (out / "recovery.pth.tar").exists() is (flag == "recovery")
    if flag == "wandb":
        assert any("wandb requested but not installed" in r.getMessage()
                   for r in caplog.records)


@pytest.mark.parametrize("cli", ["train_mirror", "train_pretrain"])
def test_pretraining_warm_starts_from_an_initial_checkpoint(cohort, cli):
    """--initial-checkpoint in the pretrain entry points: the non-strict
    load_pretrained before the first step, so a run of 0 updates' worth
    (--lr 0) saves the checkpoint's weights."""
    source = create_model("mirror" if cli == "train_mirror" else "mirror_dual", device="cpu",
                          generator=torch.Generator().manual_seed(99),
                          **dict(wsi_embed_dim=FEAT, rna_embed_dim=RNA, embed_dim=24,
                                 wsi_num_tokens=N_TOK, rna_encoder_depth=1,
                                 style_mlp_hidden_dim=32, style_mlp_out_dim=20,
                                 style_latent_dim=16, num_prototypes=37))
    path = str(cohort / f"warm_{cli}.pth.tar")
    torch.save({"state_dict": source.state_dict()}, path)
    CLIS[cli](cli_argv(cohort, cli, "warm", "--initial-checkpoint", path, "--lr", "0",
                       "--epochs", "1"))
    saved = load_checkpoint_file(str(run_dir(cohort, cli, "warm") / "last.pth.tar"))
    key = "wsi_encoder.layer1.attn.to_qkv.weight"
    assert torch.equal(saved["state_dict"][key], source.state_dict()[key])


# --------------------------------------------------------------------------
# SIGTERM and the recovery file
# --------------------------------------------------------------------------

def _sigterm_at(module, name, call_no):
    """Wrap ``module.name`` (a train-step factory) so that its step sends
    the process a SIGTERM from within its ``call_no``-th call."""
    real = getattr(module, name)
    calls = [0]

    def factory(*a, **k):
        step = real(*a, **k)

        def wrapped(*sa, **sk):
            calls[0] += 1
            out = step(*sa, **sk)
            if calls[0] == call_no:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return wrapped
    return factory, calls


@pytest.mark.parametrize("cli,factory", [("train_mirror", "make_mirror_train_step"),
                                         ("survival", "make_survival_train_step")])
def test_sigterm_writes_a_recovery_file_and_resume_continues_at_the_next_epoch(
        cohort, cli, factory, monkeypatch, capsys):
    """A SIGTERM from within the second step: the run finishes that step,
    writes recovery.pth.tar (epoch 0, the two steps' optimizer state),
    skips eval and the summary, prints and returns "preempted": true, and
    puts the old handler back; --resume recovery.pth.tar then trains epoch
    1 only."""
    module = sys.modules[CLIS[cli].__module__]
    wrapped, calls = _sigterm_at(module, factory, 2)
    monkeypatch.setattr(module, factory, wrapped)
    before = signal.getsignal(signal.SIGTERM)
    results = CLIS[cli](cli_argv(cohort, cli, "preempted"))
    assert signal.getsignal(signal.SIGTERM) is before
    assert results["preempted"] is True and results["best_epoch"] is None
    assert '"preempted": true' in capsys.readouterr().out
    assert calls[0] == 2
    out = run_dir(cohort, cli, "preempted")
    assert not (out / "summary.csv").exists() and not (out / "last.pth.tar").exists()
    recovery = load_checkpoint_file(str(out / "recovery.pth.tar"))
    assert recovery["epoch"] == 0 and recovery["step"] == recovery["optimizer"]["count"] == 2
    monkeypatch.undo()
    results = CLIS[cli](cli_argv(cohort, cli, "preempted", "--resume",
                                 str(out / "recovery.pth.tar")))
    assert "preempted" not in results
    assert pd.read_csv(out / "summary.csv")["epoch"].tolist() == [1]


def test_a_run_off_the_main_thread_trains_without_a_handler(cohort):
    """signal.signal refuses a non-main thread: the run then sets no SIGTERM
    handler, leaves the process's alone and trains to its end."""
    before = signal.getsignal(signal.SIGTERM)
    out = {}
    thread = threading.Thread(target=lambda: out.update(CLIS["train_mirror"](cli_argv(
        cohort, "train_mirror", "in_thread", "--epochs", "1"))))
    thread.start()
    thread.join()
    assert out["best_epoch"] == 0 and signal.getsignal(signal.SIGTERM) is before


def test_recovery_interval_writes_the_file_every_batch(cohort, monkeypatch):
    """--recovery-interval 1: a recovery save after each of the epoch's 3
    batches, each with the epoch and the optimizer's count so far."""
    from mirror_tpu_torch.train import harness

    saved = []
    real = harness.save_epoch

    def spy(paths, model, ema, args, epoch, metric, optimizer=None, generator=None):
        if any(p.endswith("recovery.pth.tar") for p in paths):
            saved.append((epoch, optimizer.count))
        return real(paths, model, ema, args, epoch, metric, optimizer, generator)

    monkeypatch.setattr(harness, "save_epoch", spy)
    train_mirror.main(cli_argv(cohort, "train_mirror", "every_batch", "--recovery-interval", "1"))
    assert saved == [(0, 1), (0, 2), (0, 3), (1, 4), (1, 5), (1, 6)]


# --------------------------------------------------------------------------
# --grad-checkpointing
# --------------------------------------------------------------------------

GC_KW = dict(wsi_embed_dim=FEAT, rna_embed_dim=RNA, embed_dim=24, rna_encoder_depth=1)


def _gc_model(name, grad_checkpointing):
    kw = dict(GC_KW, grad_checkpointing=grad_checkpointing)
    if name == "mirror":
        kw.update(wsi_num_tokens=N_TOK, style_mlp_hidden_dim=32, style_mlp_out_dim=20,
                  style_latent_dim=16, num_prototypes=37)
    elif name == "mirror_classifier":
        kw.update(num_classes=3)
    return create_model(name, device="cpu", generator=torch.Generator().manual_seed(3), **kw)


def _gc_loss(name, model, wsi, rna, generator):
    from mirror_tpu_torch.losses import mirror_loss

    if name == "mirror":
        return mirror_loss(*model(wsi, rna, 0.75, 0.75, generator=generator))[0]
    if name == "mirror_dual":
        a, b = model(wsi, rna)
        return (a.float() * b.float()).sum()
    return model(wsi, rna).float().logsumexp(-1).sum()


def _gc_grads(name, grad_checkpointing, naive=False):
    """One forward and backward in train mode, dropout 0.1 drawn from the
    step generator (seed 5); returns (loss, grads, the generator's state
    after the step)."""
    from mirror_tpu_torch.models import transmil
    from mirror_tpu_torch.models.layers import set_generator

    model = _gc_model(name, grad_checkpointing).train()
    generator = torch.Generator().manual_seed(5)
    set_generator(model, generator)
    rng = np.random.default_rng(1)
    wsi = torch.from_numpy(rng.standard_normal((2, N_TOK, FEAT), dtype=np.float32))
    rna = torch.from_numpy(rng.standard_normal((2, RNA), dtype=np.float32))
    if naive:
        real = transmil.checkpoint_replaying_generators
        transmil.checkpoint_replaying_generators = lambda mod, fn, x: \
            torch.utils.checkpoint.checkpoint(fn, x, use_reentrant=False)
    try:
        loss = _gc_loss(name, model, wsi, rna, generator)
        loss.backward()
    finally:
        if naive:
            transmil.checkpoint_replaying_generators = real
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return loss.detach(), grads, generator.get_state()


@pytest.mark.parametrize("name", ["mirror", "mirror_dual", "mirror_classifier"])
def test_grad_checkpointing_gives_the_plain_gradients_with_dropout_on(name):
    """Checkpointed against plain, train mode, the Nystrom dropout drawn
    from the step generator: the same loss and the same gradients bit for
    bit. A naive ``checkpoint(layer, x)`` fails this: torch restores only
    its default generators, so the recompute draws a second dropout mask
    from the explicit one and the gradients come out wrong without an
    error (shown here too)."""
    loss, grads, _ = _gc_grads(name, False)
    loss_c, grads_c, _ = _gc_grads(name, True)
    assert torch.equal(loss, loss_c)
    assert set(grads) == set(grads_c)
    for key in grads:
        assert torch.equal(grads[key], grads_c[key]), key
    _, grads_naive, _ = _gc_grads(name, True, naive=True)
    assert any(not torch.equal(grads[k], grads_naive[k]) for k in grads)


def test_grad_checkpointing_leaves_the_generator_where_the_plain_step_does():
    """The generator after a checkpointed step is where it is after the
    plain step: the recompute's draws are replayed, not taken anew."""
    _, _, plain = _gc_grads("mirror", False)
    _, _, checkpointed = _gc_grads("mirror", True)
    assert torch.equal(plain, checkpointed)


def test_grad_checkpointing_recomputes_each_translayer_in_the_backward(monkeypatch):
    """Each of MIRROR's three TransLayers runs its block twice a step
    with --grad-checkpointing (once in eval or without grad), PPEG once."""
    from mirror_tpu_torch.models import transmil

    counts = {"block": 0, "ppeg": 0}
    real_block, real_ppeg = transmil.TransLayer._block, transmil.PPEG.forward

    def block(self, x):
        counts["block"] += 1
        return real_block(self, x)

    def ppeg(self, *a):
        counts["ppeg"] += 1
        return real_ppeg(self, *a)

    monkeypatch.setattr(transmil.TransLayer, "_block", block)
    monkeypatch.setattr(transmil.PPEG, "forward", ppeg)
    _gc_grads("mirror", True)
    assert counts == {"block": 6, "ppeg": 1}
    model = _gc_model("mirror", True).eval()
    counts.update(block=0, ppeg=0)
    with torch.no_grad():
        model(torch.zeros(1, N_TOK, FEAT), torch.zeros(1, RNA))
    assert counts == {"block": 3, "ppeg": 1}


def _drawn_params(model, d, seed):
    """Flax params of ``model``'s shapes (``jax.eval_shape`` of its init,
    no compile) drawn with numpy: LayerNorm scales 1, biases 0, the rest
    N(0, 1 / fan_in)."""
    rngs = dict(zip(["params", "dropout", "masking", "style"],
                    jax.random.split(jax.random.PRNGKey(0), 4)))
    shapes = jax.eval_shape(model.init, rngs, jnp.asarray(d["wsi"]),
                            jnp.asarray(d["rna"]))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            return np.ones(leaf.shape, np.float32)
        if name == "bias":
            return np.zeros(leaf.shape, np.float32)
        fan_in = leaf.shape[-2] if len(leaf.shape) >= 2 else 1
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def test_grad_checkpointing_matches_the_jax_remat_step(monkeypatch):
    """The checkpointed MIRROR (train mode, dropout 0) against the JAX
    MIRROR with grad_checkpointing=True (nn.remat TransLayers,
    deterministic=False, dropout patched to 0), same weights and injected
    masking / VAE draws (the suite's parity recipe): the loss terms within
    1e-5 relative, per-leaf gradient cosine >= 0.9999."""
    import test_torch_port_train as tp
    from mirror_tpu.losses.mirror_loss import mirror_loss as jax_mirror_loss
    from mirror_tpu_torch.convert import state_dict_from_jax
    from mirror_tpu_torch.losses import mirror_loss

    d = tp._draws(13)
    model = tp._flax_model(grad_checkpointing=True, rna_proj_drop_rate=0.0)
    tp._patch_flax(monkeypatch, no_dropout=True)
    tp._inject(d)
    params = _drawn_params(model, d, seed=13)
    rngs = dict(zip(["dropout", "masking", "style"], jax.random.split(jax.random.PRNGKey(2), 3)))

    def loss_fn(p):
        tp._INJECT["i"] = 0
        out = model.apply({"params": p}, jnp.asarray(d["wsi"]), jnp.asarray(d["rna"]),
                          tp.WSI_RATIO, tp.RNA_RATIO, False, rngs=rngs)
        losses = jax_mirror_loss(*out)
        return losses[0], losses

    (_, losses_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    grads_j = state_dict_from_jax(jax.device_get(grads_j))

    port = tp._port_model(params, grad_checkpointing=True, wsi_dropout=0.0,
                          rna_proj_drop_rate=0.0).train()
    out = port(torch.from_numpy(d["wsi"]), torch.from_numpy(d["rna"]), tp.WSI_RATIO,
               tp.RNA_RATIO, noise=tp._noise(d))
    losses_t = mirror_loss(*out)
    losses_t[0].backward()
    for a, b in zip(losses_j, losses_t):
        assert float(b.detach()) == pytest.approx(float(a), rel=1e-5, abs=1e-7)
    for key, p in port.named_parameters():
        a = np.asarray(grads_j[key], np.float64).ravel()
        b = p.grad.numpy().astype(np.float64).ravel()
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if na < 1e-12 and nb < 1e-12:
            continue
        assert float(a @ b / (na * nb)) >= 0.9999, key


# --------------------------------------------------------------------------
# the C++ gather and the loader
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def npy32(tmp_path_factory):
    """6 slides of 10-60 float32 patches (the gather's format), an RNA CSV
    and a split with 4 train and 2 val patients; and a copy of the cohort
    with one slide as .npz (a mixed cohort)."""
    root = tmp_path_factory.mktemp("npy32")
    rng = np.random.default_rng(21)
    ids = [f"TCGA-NV-{i:04d}-01Z-00-DX1" for i in range(6)]
    _write_slides(root / "feats", ids, rng, np.float32)
    _write_rna(root / "rna.csv", ids, rng)
    (root / "splits").mkdir()
    patients = [s[:12] for s in ids]
    pd.DataFrame({"train": patients[:4], "val": patients[4:] + [np.nan] * 2}).to_csv(
        root / "splits" / "splits_0.csv")
    (root / "mixed").mkdir()
    for i, sid in enumerate(ids):
        feats = np.load(root / "feats" / f"{sid}.npy")
        if i == 2:
            np.savez(root / "mixed" / f"{sid}.npz", features=feats)
        else:
            np.save(root / "mixed" / f"{sid}.npy", feats)
    return root


def test_the_native_gather_is_the_jax_gather(npy32):
    from mirror_tpu.data import native_loader as jax_native
    from mirror_tpu_torch.data import native_loader

    paths = sorted(str(p) for p in (npy32 / "feats").glob("*.npy"))
    seeds = [3, 2**62 + 5, 0, 77, 123456789, 2**63 - 1]
    for n_tokens in (8, 45):  # fewer and more rows than some slides hold
        got = native_loader.gather_batch(paths, n_tokens, seeds, num_threads=3)
        want = jax_native.gather_batch(paths, n_tokens, seeds, num_threads=2)
        np.testing.assert_array_equal(got, want)
    assert native_loader.LIBRARY.parent.name == "native"
    assert native_loader.LIBRARY.parent.parent.name == "build"


@pytest.mark.parametrize("which", ["pretrain", "mixed"])
def test_the_loader_gives_the_jax_loaders_batches(npy32, which, caplog):
    """The port's Loader against the JAX Loader with use_native=True (the
    JAX CLI's default) over two epochs: on the .npy cohort both take the
    C++ gather; on the mixed cohort both step back to the numpy path, the
    port saying so once."""
    from mirror_tpu.data.datasets import PretrainDataset as JaxDataset
    from mirror_tpu.data.loader import Loader as JaxLoader
    from mirror_tpu_torch.data import loader as loader_mod
    from mirror_tpu_torch.data.datasets import PretrainDataset

    feats = str(npy32 / ("feats" if which == "pretrain" else "mixed"))
    args = (feats, str(npy32 / "rna.csv"), N_TOK)
    ours = loader_mod.Loader(PretrainDataset(*args, splits=str(npy32 / "splits")), 2, seed=4,
                             workers=2)
    theirs = JaxLoader(JaxDataset(*args, splits=str(npy32 / "splits")), 2, seed=4,
                       use_native=True, process_index=0, process_count=1)
    loader_mod._said.clear()
    with caplog.at_level(logging.WARNING, logger=loader_mod.__name__):
        for epoch in (0, 1):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            got, want = list(ours), list(theirs)
            assert len(got) == len(want) == 2
            for a, b in zip(got, want):
                assert sorted(a) == sorted(b)
                for key in a:
                    np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    said = [r for r in caplog.records if r.name == loader_mod.__name__]
    assert ours.native is (which == "pretrain") and len(said) == (which == "mixed")


def test_an_abandoned_iteration_stops_the_prefetch_thread(npy32):
    from mirror_tpu_torch.data.datasets import PretrainDataset
    from mirror_tpu_torch.data.loader import Loader

    dataset = PretrainDataset(str(npy32 / "feats"), str(npy32 / "rna.csv"), N_TOK)
    loader = Loader(dataset, 1, seed=0, workers=1, prefetch=2)
    it = iter(loader)
    next(it)
    assert any(t.name == "mirror-loader" for t in threading.enumerate())
    it.close()
    assert not any(t.name == "mirror-loader" for t in threading.enumerate())
    assert len(list(loader)) == 6  # a new iteration runs to its end


def test_a_native_build_failure_is_an_error(npy32, monkeypatch, tmp_path):
    """A library that does not build raises on a .npy cohort, where the
    numpy path would draw other tokens; use_native=False takes that path."""
    from mirror_tpu_torch.data import native_loader
    from mirror_tpu_torch.data.datasets import PretrainDataset
    from mirror_tpu_torch.data.loader import Loader

    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "SOURCE", tmp_path / "broken.cpp")
    monkeypatch.setattr(native_loader, "LIBRARY", tmp_path / "build" / "lib.so")
    (tmp_path / "broken.cpp").write_text("not c++\n")
    dataset = PretrainDataset(str(npy32 / "feats"), str(npy32 / "rna.csv"), N_TOK)
    with pytest.raises(RuntimeError, match="building the native loader failed"):
        Loader(dataset, 2)
    assert Loader(dataset, 2, use_native=False).native is False


# --------------------------------------------------------------------------
# wandb and --wandb-watch
# --------------------------------------------------------------------------

def test_watch_stats_are_the_jax_watch_stats():
    """steps.watch_stats against the JAX package's watch_stats on the same
    MIRROR parameters and gradients (the flax trees carried over by the
    converter): every leaf's norm, mean and std within 1e-5, under the
    torch key of its flax path."""
    import test_torch_port_train as tp
    from mirror_tpu.train.steps import watch_stats as jax_watch_stats
    from mirror_tpu_torch.convert import state_dict_from_jax
    from mirror_tpu_torch.train.steps import watch_stats

    d = tp._draws(3)
    params = _drawn_params(tp._flax_model(), d, seed=3)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    grads = jax.tree_util.tree_unflatten(treedef, [
        np.random.default_rng(i).standard_normal(np.shape(x)).astype(np.float32)
        for i, x in enumerate(leaves)])
    want = {k: float(v) for k, v in jax.jit(jax_watch_stats)(params, grads).items()}
    # the converter's key of each flax path: a tree of leaf indices carried over
    index = jax.tree_util.tree_unflatten(treedef, [np.full(np.shape(x), i, np.float32)
                                                   for i, x in enumerate(leaves)])
    paths = ["/".join(str(getattr(k, "key", k)) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    torch_key = {paths[int(np.asarray(v).ravel()[0])]: k
                 for k, v in state_dict_from_jax(index).items()}

    port = tp._port_model(params)
    g = state_dict_from_jax(grads)
    for name, p in port.named_parameters():
        p.grad = torch.from_numpy(np.ascontiguousarray(g[name])).reshape(p.shape)
    got = {k: float(v) for k, v in watch_stats(port.named_parameters()).items()}
    assert len(got) == len(want) == 6 * len(leaves)
    assert len(torch_key) == len(leaves)
    for key, value in want.items():
        _, kind, rest = key.split("/", 2)
        path, stat = rest.rsplit("/", 1)
        ours = got[f"watch/{kind}/{torch_key[path]}/{stat}"]
        assert ours == pytest.approx(value, rel=1e-5, abs=1e-5), key


def test_watch_stats_reach_wandb_only(cohort, monkeypatch):
    """--log-wandb --wandb-watch with wandb stubbed (as the JAX package's
    test does): each epoch's payload carries train_* and the watch/* means,
    summary.csv and the log line none of them; the run's summary gets the
    result."""
    logged, summaries = [], []

    class _Run:
        summary = types.SimpleNamespace(update=lambda r: summaries.append(dict(r)))

        def log(self, payload, step=None):
            logged.append((step, payload))

        def finish(self):
            pass

    stub = types.ModuleType("wandb")
    stub.init = lambda **kw: _Run()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    results = train_mirror.main(cli_argv(cohort, "train_mirror", "wandb_stub", "--log-wandb",
                                         "--wandb-watch"))
    assert [step for step, _ in logged] == [0, 1] and summaries == [results]
    payload = logged[0][1]
    key = "watch/gradients/wsi_encoder.layer1.attn.to_qkv.weight/norm"
    assert np.isfinite(payload[key]) and "train_loss" in payload and "eval_loss" in payload
    summary = pd.read_csv(run_dir(cohort, "train_mirror", "wandb_stub") / "summary.csv")
    assert not any("watch" in c for c in summary.columns)
