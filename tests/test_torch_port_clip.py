"""The port's CLIP baseline (``losses.info_nce``, ``models.MIRRORDual``, the
CLIP train and eval steps, ``train_pretrain``) against the JAX package's,
fp32 on the CPU.

Inputs are made from seeds with numpy and fed to both sides; the flax
weights are carried over by ``state_dict_from_jax``. The JAX side runs its
dense path (``use_pallas=False``), the port its CPU path (the kernels'
plain versions). Bars, with their reasons:

- InfoNCE in its three negative modes, symmetric or not, with and without
  the ``valid`` mask: value and every input's gradient within 1e-6
  relative (the same fp32 operations);
- the dual encoder's two embeddings within 1e-5, its InfoNCE loss within
  2e-5 relative and each parameter's gradient at cosine >= 0.9999 with its
  norm within 1e-3 (fp32 sums in another order through two Nystrom
  layers; the bars of tests/test_torch_port_models.py);
- a 3-step trajectory of the CLIP train step (dropout 0 on both sides;
  lamb, AGC, a cosine schedule on updates with warmup and the EMA with its
  warmup ramp) within 2e-5 relative per step, the bar of the other
  trajectories, with the logged lr within 1e-6;
- ``train_pretrain`` end to end on a tiny cohort with ``--device cpu``.
"""

import json
import logging
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from mirror_tpu.losses.info_nce import info_nce as jax_info_nce
from mirror_tpu.models import transmil as jax_transmil
from mirror_tpu.models.dual import MIRRORDual as JaxDual
from mirror_tpu.train import optim as jax_optim
from mirror_tpu.train.state import create_train_state
from mirror_tpu.train.steps import make_clip_eval_step as jax_clip_eval_step
from mirror_tpu.train.steps import make_clip_train_step as jax_clip_train_step
from mirror_tpu_torch import config, train_pretrain
from mirror_tpu_torch.convert import state_dict_from_jax
from mirror_tpu_torch.losses import info_nce
from mirror_tpu_torch.models import MIRRORDual
from mirror_tpu_torch.registry import check_kernel_config, create_model
from mirror_tpu_torch.train.checkpoint import load_checkpoint_file, run_args, to_tensors
from mirror_tpu_torch.train.optim import make_optimizer
from mirror_tpu_torch.train.steps import ModelEma, make_clip_eval_step, make_clip_train_step
from test_torch_port_runctl import one_intra_op_thread  # noqa: F401 (the fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEMPLATE = os.path.join(REPO, "configs", "pretrain", "mirror.template.yaml")
WSI_IN, RNA_IN, E, N_TOK = 40, 50, 24, 30  # side 6, 37 rows, pad 11
N_SLIDES = 8
KW = dict(wsi_embed_dim=WSI_IN, rna_embed_dim=RNA_IN, embed_dim=E, rna_encoder_depth=1,
          rna_mlp_ratio=2.0, rna_proj_drop_rate=0.0)
TINY = [f"wsi_embed_dim={WSI_IN}", f"embed_dim={E}", "rna_encoder_depth=1"]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _cosine(a, b) -> float:
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


# --------------------------------------------------------------------------
# InfoNCE
# --------------------------------------------------------------------------

# (negative mode, symmetric, valid mask, reduction)
INFO_NCE = [("in-batch", False, False, "mean"), ("in-batch", True, False, "mean"),
            ("in-batch", False, True, "mean"), ("in-batch", True, True, "mean"),
            ("in-batch", False, True, "sum"), ("in-batch", True, True, "none"),
            ("unpaired", False, False, "mean"), ("unpaired", False, False, "sum"),
            ("paired", False, False, "mean"), ("paired", False, False, "none")]


@pytest.mark.parametrize("mode,symmetric,masked,reduction", INFO_NCE)
def test_info_nce_matches_jax(mode, symmetric, masked, reduction):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((5, 8)).astype(np.float32)
    k = rng.standard_normal((5, 8)).astype(np.float32)
    neg = {"unpaired": rng.standard_normal((7, 8)), "paired": rng.standard_normal((5, 7, 8)),
           "in-batch": None}[mode]
    neg = None if neg is None else neg.astype(np.float32)
    valid = np.array([1, 1, 1, 0, 0], np.float32) if masked else None
    kw = dict(temperature=0.07, reduction=reduction,
              negative_mode="paired" if mode == "paired" else "unpaired", symmetric=symmetric)

    def jax_loss(q, k, n):
        out = jax_info_nce(q, k, n, valid=None if valid is None else jnp.asarray(valid), **kw)
        return jnp.sum(out * jnp.arange(1, out.size + 1)) if out.ndim else out

    args = [jnp.asarray(q), jnp.asarray(k), None if neg is None else jnp.asarray(neg)]
    argnums = (0, 1) if neg is None else (0, 1, 2)
    want, want_grads = jax.value_and_grad(jax_loss, argnums=argnums)(*args)

    ours = [torch.tensor(a, requires_grad=True) for a in (q, k, neg) if a is not None]
    out = info_nce(ours[0], ours[1], ours[2] if neg is not None else None,
                   valid=None if valid is None else torch.from_numpy(valid), **kw)
    loss = (out * torch.arange(1, out.numel() + 1)).sum() if out.ndim else out
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-6)
    for t, g in zip(ours, want_grads):
        assert _rel(t.grad.numpy(), g) <= 1e-6


def test_info_nce_refuses_a_mask_with_explicit_negatives():
    q = torch.randn(3, 4)
    with pytest.raises(ValueError, match="in-batch"):
        info_nce(q, q, torch.randn(5, 4), valid=torch.ones(3))
    with pytest.raises(ValueError, match="2 dimensions"):
        info_nce(q[None], q)


def test_info_nce_keeps_fp32_logits_on_bf16_embeddings():
    """bf16 embeddings (the card's compute dtype): the similarity product
    in bf16, the logits and the loss in fp32, within bf16's rounding of
    the fp32 loss."""
    rng = np.random.default_rng(4)
    q, k = (torch.from_numpy(rng.standard_normal((6, 32)).astype(np.float32)) for _ in range(2))
    loss = info_nce(q.bfloat16(), k.bfloat16(), symmetric=True)
    assert loss.dtype == torch.float32
    assert float(loss) == pytest.approx(float(info_nce(q, k, symmetric=True)), rel=2e-2)


# --------------------------------------------------------------------------
# the dual encoder
# --------------------------------------------------------------------------

def _no_dropout(mp):
    real = jax_transmil.NystromAttention
    mp.setattr(jax_transmil, "NystromAttention", lambda **kw: real(**{**kw, "dropout": 0.0}))


def _flax_dual(**extra):
    return JaxDual(**KW, **extra)


def _flax_init(model, wsi, rna):
    return jax.device_get(jax.jit(model.init, static_argnums=3)(
        jax.random.PRNGKey(0), jnp.asarray(wsi), jnp.asarray(rna), True)["params"])


def _port_dual(params, **extra) -> MIRRORDual:
    model = MIRRORDual(**KW, wsi_dropout=0.0, **extra)
    model.load_state_dict(to_tensors(state_dict_from_jax(params)))
    return model


@pytest.mark.parametrize("pinv_grad,projection_dim", [("exact", None), ("implicit", 16)])
def test_dual_encoder_matches_flax(pinv_grad, projection_dim):
    """The two embeddings, the symmetric InfoNCE loss and every parameter's
    gradient of the dual encoder against the flax MIRRORDual's, dropout
    off; the state-dict keys are exactly the converter's."""
    rng = np.random.default_rng(11)
    wsi = rng.standard_normal((3, N_TOK, WSI_IN)).astype(np.float32)
    rna = rng.standard_normal((3, RNA_IN)).astype(np.float32)
    jm = _flax_dual(pinv_grad=pinv_grad, projection_dim=projection_dim)
    params = _flax_init(jm, wsi, rna)

    def loss_fn(p):
        w, r = jm.apply({"params": p}, jnp.asarray(wsi), jnp.asarray(rna), True)
        return jax_info_nce(w, r, temperature=0.1, symmetric=True), (w, r)

    (loss_j, (w_j, r_j)), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    port = _port_dual(params, pinv_grad=pinv_grad, projection_dim=projection_dim).eval()
    assert set(port.state_dict()) == set(state_dict_from_jax(params))
    w_t, r_t = port(torch.from_numpy(wsi), torch.from_numpy(rna))
    assert w_t.shape == (3, projection_dim or E) and r_t.shape == w_t.shape
    np.testing.assert_allclose(w_t.detach().numpy(), np.asarray(w_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(r_t.detach().numpy(), np.asarray(r_j), rtol=0, atol=1e-5)
    loss_t = info_nce(w_t, r_t, temperature=0.1, symmetric=True)
    loss_t.backward()
    assert float(loss_t) == pytest.approx(float(loss_j), rel=2e-5)
    grads_j = state_dict_from_jax(jax.device_get(grads_j))
    for name, p in port.named_parameters():
        a, b = np.asarray(grads_j[name]), p.grad.numpy()
        if np.linalg.norm(a) < 1e-12 and np.linalg.norm(b) < 1e-12:
            continue
        assert _cosine(a, b) >= 0.9999, f"{name}: cosine {_cosine(a, b)}"
        assert np.linalg.norm(b) == pytest.approx(np.linalg.norm(a), rel=1e-3), name


def test_registry_builds_mirror_dual(caplog):
    """mirror_dual: the JAX registry's kwargs (the MIRROR-only ones of the
    pretrain template filtered with a warning), its init from a generator,
    and the card's kernel refusal as for mirror."""
    with caplog.at_level(logging.WARNING):
        model = create_model("mirror_dual", device="cpu", generator=torch.Generator()
                             .manual_seed(0), **KW, num_prototypes=3000, dtype="bfloat16")
    assert "num_prototypes" in caplog.text
    assert model.wsi_projection.out_features == E and model.rna_projection.in_features == E
    assert model.wsi_encoder.layer1.attn.pinv_grad == "exact"  # the JAX default
    assert torch.isfinite(model.wsi_encoder.cls_token).all()
    with pytest.raises(ValueError, match="--no-use-pallas"):
        check_kernel_config("mirror_dual", "cuda", **dict(KW, embed_dim=1536),
                            dtype="bfloat16")
    check_kernel_config("mirror_dual", "cuda", **dict(KW, embed_dim=768), dtype="bfloat16")


# --------------------------------------------------------------------------
# the CLIP steps
# --------------------------------------------------------------------------

CLIP_ARGS = dict(opt="lamb", opt_eps=None, opt_betas=None, opt_kwargs={}, momentum=0.9,
                 weight_decay=0.05, clip_grad=0.01, clip_mode="agc", layer_decay=None,
                 use_sched=True, sched="cosine", sched_on_updates=True, grad_accum_steps=1,
                 epochs=2, warmup_epochs=1, decay_epochs=3, decay_milestones=(3, 6),
                 warmup_lr=1e-5, min_lr=1e-6, decay_rate=0.5, warmup_prefix=False,
                 lr_cycle_mul=1.0, lr_cycle_decay=0.5, lr_cycle_limit=1, lr_k_decay=1.0,
                 cooldown_epochs=0, lr_noise=None, seed=42)


def test_three_step_clip_trajectory_matches_jax_step():
    """make_clip_train_step + the optimizer side of the port against the JAX
    package's make_clip_train_step + make_optimizer: three steps of fresh
    batches, dropout 0 on both sides, lamb with AGC, a cosine schedule on
    updates (3 an epoch) with a warmup epoch, and the EMA with its ramp."""
    args = SimpleNamespace(**CLIP_ARGS)
    lr = 2e-3
    rng = np.random.default_rng(41)
    batches = [{"wsi": rng.standard_normal((3, N_TOK, WSI_IN)).astype(np.float32),
                "rna": rng.standard_normal((3, RNA_IN)).astype(np.float32)} for _ in range(3)]
    jm = _flax_dual(pinv_grad="implicit")
    mp = pytest.MonkeyPatch()
    losses_j, lrs_j = [], []
    try:
        _no_dropout(mp)
        params = _flax_init(jm, batches[0]["wsi"], batches[0]["rna"])
        schedule = jax_optim.make_schedule(args, 3, lr)
        tx = jax_optim.make_optimizer(args, schedule)
        step = jax.jit(jax_clip_train_step(jm, tx, temperature=0.1, ema_decay=0.99,
                                           ema_warmup=True, schedule=schedule))
        state = create_train_state(params, tx, model_ema=True)
        for t, b in enumerate(batches):
            state, m = step(state, jax.tree.map(jnp.asarray, b), jax.random.PRNGKey(t))
            losses_j.append(float(m["loss"]))
            lrs_j.append(float(m["lr"]))
    finally:
        mp.undo()

    port = _port_dual(params, pinv_grad="implicit")
    ema = ModelEma(port, 0.99, warmup=True)
    train_step = make_clip_train_step(port, make_optimizer(args, port, lr, steps_per_epoch=3),
                                      temperature=0.1, ema=ema)
    for t, b in enumerate(batches):
        out = train_step({k: torch.from_numpy(v) for k, v in b.items()})
        assert set(out) == {"loss", "grad_norm", "param_norm", "lr"}
        assert float(out["loss"]) == pytest.approx(losses_j[t], rel=2e-5), f"step {t}"
        assert out["lr"] == pytest.approx(lrs_j[t], rel=1e-6), f"step {t}"
    # the weights moved alike, the live ones and the EMA's
    ema_j = state_dict_from_jax(jax.device_get(state.ema_params))
    live_j = state_dict_from_jax(jax.device_get(state.params))
    for key in ("wsi_projection.weight", "rna_projection.bias", "wsi_encoder.cls_token"):
        np.testing.assert_allclose(dict(port.named_parameters())[key].detach().numpy(),
                                   live_j[key], rtol=0, atol=1e-5, err_msg=key)
        np.testing.assert_allclose(dict(ema.module.named_parameters())[key].numpy(),
                                   ema_j[key], rtol=0, atol=1e-5, err_msg=key)


def test_clip_eval_step_masks_padded_rows_as_jax():
    rng = np.random.default_rng(5)
    batch = {"wsi": rng.standard_normal((3, N_TOK, WSI_IN)).astype(np.float32),
             "rna": rng.standard_normal((3, RNA_IN)).astype(np.float32),
             "valid": np.array([1, 1, 0], np.float32)}
    jm = _flax_dual(pinv_grad="implicit")
    params = _flax_init(jm, batch["wsi"], batch["rna"])
    want = jax.jit(jax_clip_eval_step(jm, temperature=0.1))(
        params, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))["loss"]
    port = _port_dual(params, pinv_grad="implicit")
    got = make_clip_eval_step(port, temperature=0.1)(
        {k: torch.from_numpy(v) for k, v in batch.items()})["loss"]
    assert float(got) == pytest.approx(float(want), rel=2e-5)


# --------------------------------------------------------------------------
# train_pretrain
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """8 slides of 10-60 fp16 patches, an RNA CSV, a fold-0 split with 6
    train and 2 val patients."""
    root = tmp_path_factory.mktemp("clip_cohort")
    rng = np.random.default_rng(9)
    feat_dir = root / "feats"
    feat_dir.mkdir()
    ids = [f"TCGA-CL-{i:04d}-01Z-00-DX1" for i in range(N_SLIDES)]
    for sid in ids:
        n = int(rng.integers(10, 61))
        np.save(feat_dir / f"{sid}.npy", rng.standard_normal((n, WSI_IN)).astype(np.float16))
    pd.DataFrame(rng.standard_normal((N_SLIDES, RNA_IN)).astype(np.float32),
                 index=[s[:15] for s in ids],
                 columns=[f"gene_{j}" for j in range(RNA_IN)]).to_csv(root / "rna.csv")
    split_dir = root / "splits"
    split_dir.mkdir()
    patients = [s[:12] for s in ids]
    pd.DataFrame({"train": patients[:6], "val": patients[6:] + [np.nan] * 4}).to_csv(
        split_dir / "splits_0.csv")
    return root


def _argv(cohort, experiment, *extra):
    return ["--config", TEMPLATE, "--wsi-feature-dir", str(cohort / "feats"),
            "--rna-feature-csv", str(cohort / "rna.csv"), "--split-dir", str(cohort / "splits"),
            "--output", str(cohort / "runs"), "--experiment", experiment, "--epochs", "2",
            "--batch-size", "2", "--validation-batch-size", "3", "--num-wsi-feature-tokens",
            str(N_TOK), "--workers", "2", "--model-kwargs", *TINY, *extra]


def test_train_pretrain_trains_on_the_cpu_with_the_optimizer_side(cohort, capsys):
    """The chip run's flags at a tiny width: lamb, a cosine schedule on
    updates with a warmup epoch, AGC, the EMA with its ramp and gradient
    accumulation 2 (3 micro-batches an epoch: updates carried across the
    epoch boundary). The --result JSON, summary.csv with the train lr and
    the EMA's eval loss (which ranks the epochs), and a checkpoint with the
    EMA weights that reloads into mirror_dual."""
    flags = ["--opt", "lamb", "--use-sched", "--sched", "cosine", "--sched-on-updates",
             "--warmup-epochs", "1", "--clip-grad", "0.01", "--clip-mode", "agc",
             "--model-ema", "--model-ema-warmup", "--grad-accum-steps", "2",
             "--temperature", "0.07", "--device", "cpu"]
    results = train_pretrain.main(_argv(cohort, "clip", *flags))
    printed = json.loads(capsys.readouterr().out.split("--result\n", 1)[1])
    assert printed == results and results["metric_name"] == "loss"
    run_dir = cohort / "runs" / "pretrain_clip" / "clip"
    summary = pd.read_csv(run_dir / "summary.csv")
    assert len(summary) == 2
    cols = ["train_loss", "train_grad_norm", "train_param_norm", "train_lr", "eval_loss",
            "eval_ema_loss"]
    assert np.isfinite(summary[cols].to_numpy()).all()
    assert results["best_metric"] == pytest.approx(summary["eval_ema_loss"].min())
    assert (summary["train_lr"] > 0).all()

    payload = load_checkpoint_file(str(run_dir / "last.pth.tar"))
    args = run_args(payload)
    assert payload["arch"] == "mirror_dual" and args["temperature"] == 0.07
    assert set(payload["state_dict_ema"]) == set(payload["state_dict"])
    model = create_model("mirror_dual", device="cpu", **args["model_kwargs"])
    model.load_state_dict(payload["state_dict_ema"])
    model.load_state_dict(payload["state_dict"])
    assert (run_dir / "model_best.pth.tar").exists()


def test_train_pretrain_default_run_matches_its_eval(cohort):
    """The template's own optimizer (adam, constant lr) and --model
    mirror mapped to mirror_dual; the best epoch's eval loss is what the
    checkpoint records."""
    results = train_pretrain.main(_argv(cohort, "clip_plain", "--device", "cpu"))
    run_dir = cohort / "runs" / "pretrain_clip" / "clip_plain"
    payload = load_checkpoint_file(str(run_dir / "model_best.pth.tar"))
    assert payload["arch"] == "mirror_dual" and "state_dict_ema" not in payload
    assert payload["metric"] == pytest.approx(results["best_metric"])
    summary = pd.read_csv(run_dir / "summary.csv")
    assert summary["train_lr"].tolist() == pytest.approx([2e-5, 2e-5])


@pytest.mark.parametrize("flag,item", [(["--model-parallel", "2"], 16),
                                       (["--ckpt-format", "orbax"], 17)])
def test_train_pretrain_refuses_unported_flags_with_their_item(cohort, flag, item):
    """``--ckpt-format orbax`` (item 17) is refused as a departure on purpose,
    naming the JAX package's tool that makes an Orbax directory;
    ``--model-parallel 2`` (item 16, ported) is refused in one process,
    naming the world size it needs."""
    message = r"--ckpt-format orbax: .*import_torch_checkpoint .*--format orbax" if item == 17 \
        else r"--model-parallel 2: tensor parallelism needs a world size that is a multiple of 2 \(this run has 1 process\)"
    with pytest.raises(SystemExit, match=message):
        train_pretrain.main(_argv(cohort, "refused", "--device", "cpu", *flag))


def test_train_pretrain_refuses_other_models(cohort):
    with pytest.raises(SystemExit, match="--model='mirror_classifier'"):
        train_pretrain.main(_argv(cohort, "refused", "--device", "cpu", "--model",
                                  "mirror_classifier"))
    args, _ = config.parse_args(["--model", "mirror_dual", "--loss", "info_nce"])
    config.refuse_unported(args)  # the pretrain task runs both


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without a card")
def test_train_pretrain_needs_a_card_unless_told_cpu(cohort):
    with pytest.raises(SystemExit, match="--device cpu"):
        train_pretrain.main(_argv(cohort, "nocard"))
