"""The port's downstream slice (subtyping and survival fine-tuning) against
the JAX package's, fp32 on the CPU.

Inputs and draws are made from seeds with numpy and fed to both sides; the
flax weights are carried over by ``state_dict_from_jax``. The JAX side runs
its dense path (``use_pallas=False``), the port its CPU path (the kernels'
plain versions). Bars, with their reasons:

- the classifier's logits within 1e-5 (the bar of
  tests/test_torch_port_models.py), its loss within 2e-5 relative, and
  each parameter's gradient at cosine >= 0.9999 with its norm within 1e-3
  (fp32 sums in another order through two Nystrom layers);
- the losses within 1e-6 relative, the metrics exactly or within 1e-12;
- a 3-step trajectory of the train steps (dropout 0 on both sides, Adam at
  the templates' learning rates) within 2e-5 relative per step, the bar of
  the pretrain trajectory in tests/test_torch_port_train.py;
- the loaders' batches, the survival labels and the few-shot files equal.
"""

import inspect
import json
import os
import random
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from mirror_tpu.losses import ce_surv_loss as jax_ce_surv, nll_surv_loss as jax_nll_surv
from mirror_tpu.models import transmil as jax_transmil
from mirror_tpu.models.classifier import MIRRORClassifier as JaxClassifier
from mirror_tpu.train import metrics as jax_metrics
from mirror_tpu.train.optim import make_optimizer as jax_make_optimizer
from mirror_tpu.train.optim import make_schedule
from mirror_tpu.train.state import create_train_state
from mirror_tpu.train.steps import (
    make_classifier_train_step as jax_classifier_step,
    make_survival_train_step as jax_survival_step,
    smoothed_xent as jax_smoothed_xent,
    survival_risk as jax_survival_risk,
)
from mirror_tpu_torch import train_subtyping, train_survival
from mirror_tpu_torch.convert import state_dict_from_jax
from mirror_tpu_torch.losses import ce_surv_loss, nll_surv_loss
from mirror_tpu_torch.models import MIRRORClassifier
from mirror_tpu_torch.registry import create_model
from mirror_tpu_torch.train import metrics
from mirror_tpu_torch.train.checkpoint import (
    load_checkpoint_file,
    load_pretrained,
    run_args,
    save_checkpoint_file,
    to_tensors,
)
from mirror_tpu_torch.train.optim import make_optimizer, reinit_head
from mirror_tpu_torch.train.steps import (
    make_classifier_train_step,
    make_survival_train_step,
    smoothed_xent,
    survival_risk,
)
from test_torch_port_runctl import one_intra_op_thread  # noqa: F401 (the fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBTYPING_YAML = os.path.join(REPO, "configs", "subtyping", "mirror.template.yaml")
SURVIVAL_YAML = os.path.join(REPO, "configs", "survival", "mirror.template.yaml")
WSI_IN, RNA_IN, E, N_TOK = 40, 50, 24, 30  # side 6, 37 rows, 12 landmarks, pad 11
N_SLIDES, K_FOLDS = 16, 3
CLASSES = ["LUAD", "LUSC"]
TINY = [f"wsi_embed_dim={WSI_IN}", f"embed_dim={E}", "rna_encoder_depth=1"]


# --------------------------------------------------------------------------
# the classifier and its gradients
# --------------------------------------------------------------------------

def _kw(fusion, num_classes=3):
    return dict(wsi_embed_dim=WSI_IN, rna_embed_dim=RNA_IN, embed_dim=E,
                num_classes=num_classes, rna_encoder_depth=1, rna_mlp_ratio=2.0,
                rna_proj_drop_rate=0.0, fusion=fusion)


def _no_dropout(mp):
    """The flax TransLayers' attention dropout (0.1, fixed) set to 0."""
    real = jax_transmil.NystromAttention
    mp.setattr(jax_transmil, "NystromAttention", lambda **kw: real(**{**kw, "dropout": 0.0}))


def _flax_init(model, wsi, rna):
    return jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(wsi),
                                              jnp.asarray(rna))["params"])


def _port_classifier(params, fusion, pinv_grad, num_classes=3) -> MIRRORClassifier:
    model = MIRRORClassifier(**_kw(fusion, num_classes), pinv_grad=pinv_grad, wsi_dropout=0.0)
    model.load_state_dict(to_tensors(state_dict_from_jax(params)))
    return model


def _cosine(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("fusion,with_rna,pinv_grad", [
    ("concat", True, "exact"), ("add", True, "implicit"), ("add", False, "exact")])
def test_classifier_training_mode_matches_flax(fusion, with_rna, pinv_grad):
    """Logits, smoothed cross-entropy and every parameter's gradient of the
    classifier in training mode (dropout 0), concat and add fusion and
    WSI-only, against the flax classifier's."""
    rng = np.random.default_rng(21)
    wsi = rng.standard_normal((2, N_TOK, WSI_IN)).astype(np.float32)
    rna = rng.standard_normal((2, RNA_IN)).astype(np.float32) if with_rna else None
    labels = np.array([0, 2], np.int32)
    jm = JaxClassifier(**_kw(fusion), pinv_grad=pinv_grad)
    mp = pytest.MonkeyPatch()
    try:
        _no_dropout(mp)
        params = _flax_init(jm, wsi, np.zeros((2, RNA_IN), np.float32))

        def loss_fn(p):
            logits = jm.apply({"params": p}, jnp.asarray(wsi),
                              None if rna is None else jnp.asarray(rna), False)
            return jax_smoothed_xent(logits, jnp.asarray(labels), 0.1), logits

        (loss_j, logits_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    finally:
        mp.undo()
    port = _port_classifier(params, fusion, pinv_grad).train()
    logits_t = port(torch.from_numpy(wsi), None if rna is None else torch.from_numpy(rna))
    loss_t = smoothed_xent(logits_t, torch.from_numpy(labels), 0.1)
    loss_t.backward()
    np.testing.assert_allclose(logits_t.detach().numpy(), np.asarray(logits_j), rtol=0, atol=1e-5)
    assert float(loss_t.detach()) == pytest.approx(float(loss_j), rel=2e-5)
    grads_j = state_dict_from_jax(jax.device_get(grads_j))
    for name, p in port.named_parameters():
        if not with_rna and name.startswith("rna_encoder."):
            assert p.grad is None, name
            continue
        a, b = np.asarray(grads_j[name]), p.grad.numpy()
        if np.linalg.norm(a) < 1e-12 and np.linalg.norm(b) < 1e-12:
            continue
        assert _cosine(a, b) >= 0.9999, f"{name}: cosine {_cosine(a, b)}"
        assert np.linalg.norm(b) == pytest.approx(np.linalg.norm(a), rel=1e-3), name


def test_registry_builds_the_classifier_for_training():
    model = create_model("mirror_classifier", device="cpu",
                         generator=torch.Generator().manual_seed(0), **_kw("concat", 4),
                         pinv_grad="implicit", dtype="bfloat16")
    assert model.head.out_features == 4 and model.head.in_features == 2 * E
    layer = model.wsi_encoder.layer1.attn
    assert layer.pinv_grad == "implicit" and model.dtype == torch.bfloat16
    # the JAX classifier's default gradient is the exact one
    assert create_model("mirror_classifier", device="cpu", **_kw("add")) \
        .wsi_encoder.layer2.attn.pinv_grad == "exact"


# --------------------------------------------------------------------------
# losses and metrics
# --------------------------------------------------------------------------

def _loss_inputs(seed=3, n=9, m=4):
    rng = np.random.default_rng(seed)
    logits = (2 * rng.standard_normal((n, m))).astype(np.float32)
    times = rng.integers(0, m, n).astype(np.int32)
    censor = rng.integers(0, 2, n).astype(np.int32)
    valid = (np.arange(n) < n - 3).astype(np.float32)
    return logits, times, censor, valid


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("masked", [False, True])
def test_smoothed_xent_matches_jax(smoothing, masked):
    logits, labels, _, valid = _loss_inputs()
    v = valid if masked else None
    want = jax_smoothed_xent(jnp.asarray(logits), jnp.asarray(labels), smoothing,
                             valid=None if v is None else jnp.asarray(v))
    got = smoothed_xent(torch.from_numpy(logits), torch.from_numpy(labels), smoothing,
                        valid=None if v is None else torch.from_numpy(v))
    assert float(got) == pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize("alpha", [0.0, 0.4])
@pytest.mark.parametrize("masked", [False, True])
def test_nll_surv_loss_matches_jax(alpha, masked):
    logits, times, censor, valid = _loss_inputs()
    v = valid if masked else None
    want = jax_nll_surv(jnp.asarray(logits), jnp.asarray(times), jnp.asarray(censor),
                        alpha=alpha, valid=None if v is None else jnp.asarray(v))
    got = nll_surv_loss(torch.from_numpy(logits), torch.from_numpy(times),
                        torch.from_numpy(censor), alpha=alpha,
                        valid=None if v is None else torch.from_numpy(v))
    assert float(got) == pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_ce_surv_loss_matches_jax(masked):
    logits, times, censor, valid = _loss_inputs(4)
    v = valid if masked else None
    want = jax_ce_surv(jnp.asarray(logits), jnp.asarray(times), jnp.asarray(censor),
                       valid=None if v is None else jnp.asarray(v))
    got = ce_surv_loss(torch.from_numpy(logits), torch.from_numpy(times),
                       torch.from_numpy(censor), valid=None if v is None else torch.from_numpy(v))
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    risk = survival_risk(torch.from_numpy(logits)).numpy()
    np.testing.assert_allclose(risk, np.asarray(jax_survival_risk(logits)), rtol=1e-6)


def test_metrics_match_jax():
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((40, 3)).astype(np.float32)
    logits[5:9] = logits[0]  # tied scores
    labels = rng.integers(0, 3, 40)
    assert metrics.accuracy(logits, labels) == jax_metrics.accuracy(logits, labels)
    for avg in ("macro", "weighted"):
        assert metrics.multiclass_auroc(logits, labels, avg) == pytest.approx(
            jax_metrics.multiclass_auroc(logits, labels, avg), abs=1e-12)
    for avg in ("macro", "weighted", "micro"):
        assert metrics.multiclass_f1(logits, labels, avg) == pytest.approx(
            jax_metrics.multiclass_f1(logits, labels, avg), abs=1e-12)
    # a class with no positive sample: skipped by the AUROC, as in JAX
    assert metrics.multiclass_auroc(logits, labels % 2) == pytest.approx(
        jax_metrics.multiclass_auroc(logits, labels % 2), abs=1e-12)
    events = rng.integers(0, 2, 40).astype(bool)
    times = rng.integers(1, 12, 40).astype(np.float64)  # tied times
    risk = np.round(rng.standard_normal(40), 1)  # tied risks
    assert metrics.concordance_index_censored(events, times, risk) == \
        jax_metrics.concordance_index_censored(events, times, risk)
    with pytest.raises(ValueError, match="censored"):
        metrics.concordance_index_censored(np.zeros(4, bool), times[:4], risk[:4])


# --------------------------------------------------------------------------
# 3-step trajectories of the train steps
# --------------------------------------------------------------------------

class _AdamArgs:
    """The downstream templates' optimizer: adam, constant lr."""

    opt = "adam"
    opt_eps = None
    opt_betas = None
    opt_kwargs = {}
    momentum = 0.9
    weight_decay = 0.0
    clip_grad = None
    clip_mode = "norm"
    layer_decay = None
    use_sched = False
    model_ema = False
    grad_accum_steps = 1


# (task, loss, pinv_grad, linear probe, fusion, learning rate of the template)
TRAJECTORIES = [
    ("subtyping", "ce_loss", "implicit", False, "concat", 2e-3),
    ("survival", "nll_surv", "exact", False, "add", 3e-3),
    ("survival", "ce_surv", "implicit", True, "concat", 3e-3),
]


@pytest.mark.parametrize("task,loss,pinv_grad,probe,fusion,lr", TRAJECTORIES)
def test_three_step_trajectory_matches_jax_step(task, loss, pinv_grad, probe, fusion, lr):
    """The port's classifier / survival train step + Adam against the JAX
    step + its optimizer for three steps of fresh batches (the third with a
    padded row, valid 0), dropout 0 on both sides."""
    num_classes = 2 if task == "subtyping" else 4
    rng = np.random.default_rng(31)
    batches = []
    for t in range(3):
        b = {"wsi": rng.standard_normal((3, N_TOK, WSI_IN)).astype(np.float32),
             "rna": rng.standard_normal((3, RNA_IN)).astype(np.float32),
             "label": rng.integers(0, num_classes, 3).astype(np.int32),
             "censorship": np.array([1, 0, 1], np.int32),
             "valid": np.array([1, 1, 0 if t == 2 else 1], np.float32)}
        batches.append(b)
    jm = JaxClassifier(**_kw(fusion, num_classes), pinv_grad=pinv_grad)
    schedule = make_schedule(_AdamArgs, steps_per_epoch=3, base_lr=lr)
    mp = pytest.MonkeyPatch()
    losses_j = []
    try:
        _no_dropout(mp)
        params = _flax_init(jm, batches[0]["wsi"], batches[0]["rna"])
        mask = ({k: jax.tree.map(lambda _, k=k: k == "head", v) for k, v in params.items()}
                if probe else None)
        tx = jax_make_optimizer(_AdamArgs, schedule, trainable_mask=mask)
        if task == "subtyping":
            step = jax_classifier_step(jm, tx, smoothing=0.1)
        else:
            step = jax_survival_step(jm, tx, loss_name=loss, loss_alpha=0.4)
        state = create_train_state(params, tx)
        jitted = jax.jit(step)
        for t, b in enumerate(batches):
            state, m = jitted(state, jax.tree.map(jnp.asarray, b), jax.random.PRNGKey(t))
            losses_j.append(float(m["loss"]))
    finally:
        mp.undo()

    port = _port_classifier(params, fusion, pinv_grad, num_classes)
    opt = make_optimizer(_AdamArgs, port, lr, head_only=probe)
    if task == "subtyping":
        train_step = make_classifier_train_step(port, opt, smoothing=0.1)
    else:
        train_step = make_survival_train_step(port, opt, loss_name=loss, loss_alpha=0.4)
    head_before = port.head.weight.detach().clone()
    trunk_before = port.wsi_encoder.layer1.attn.to_qkv.weight.detach().clone()
    for t, b in enumerate(batches):
        out = train_step({k: torch.from_numpy(v) for k, v in b.items()})
        assert set(out) == {"loss", "grad_norm", "param_norm", "lr"}
        assert out["lr"] == pytest.approx(lr, rel=1e-7)
        assert float(out["loss"]) == pytest.approx(losses_j[t], rel=2e-5), \
            f"step {t}: port {float(out['loss'])} vs jax {losses_j[t]}"
    # the parameters moved alike: the head after three updates, and the
    # trunk frozen under the probe
    np.testing.assert_allclose(port.head.weight.detach().numpy(),
                               np.asarray(state.params["head"]["kernel"]).T, rtol=0, atol=1e-5)
    assert not torch.equal(port.head.weight.detach(), head_before)
    trunk = port.wsi_encoder.layer1.attn.to_qkv.weight.detach()
    assert torch.equal(trunk, trunk_before) == probe


def test_linear_probe_keeps_the_whole_models_grad_norm():
    """Under the probe the whole model is still differentiated (the JAX
    step's grad_norm is over every leaf), while Adam holds the head only."""
    torch.manual_seed(0)
    model = create_model("mirror_classifier", device="cpu",
                         generator=torch.Generator().manual_seed(1), **_kw("concat", 2),
                         pinv_grad="implicit", wsi_dropout=0.0)
    opt = make_optimizer(_AdamArgs, model, 1e-3, head_only=True)
    assert len(opt.params) == 2
    step = make_classifier_train_step(model, opt)
    batch = {"wsi": torch.randn(2, N_TOK, WSI_IN), "rna": torch.randn(2, RNA_IN),
             "label": torch.tensor([0, 1])}
    out = step(batch)
    head_norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(p.grad) for p in model.head.parameters()]))
    assert float(out["grad_norm"]) > 1.01 * float(head_norm)
    assert model.wsi_encoder._fc1[0].weight.grad is not None


def test_reinit_head():
    model = create_model("mirror_classifier", device="cpu",
                         generator=torch.Generator().manual_seed(1), **_kw("concat", 2))
    reinit_head(model, torch.Generator().manual_seed(2))
    w = model.head.weight.detach().clone()
    assert float(w.std()) == pytest.approx(0.01, rel=0.15) and not model.head.bias.any()
    reinit_head(model, torch.Generator(), scale=0.5, bias=0.25, std=None)
    assert torch.equal(model.head.weight.detach(), 0.5 * w)
    assert torch.equal(model.head.bias.detach(), torch.full((2,), 0.25))


# --------------------------------------------------------------------------
# datasets, loader, checkpoints and the entry points on a tiny cohort
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """16 slides of 10-60 fp16 patches, in class folders (subtyping) and
    flat (survival); an RNA CSV keyed by the 15-char sample id; a survival
    CSV in the cBioPortal columns; 3 folds of train/val patients."""
    root = tmp_path_factory.mktemp("downstream_cohort")
    rng = np.random.default_rng(9)
    ids = [f"TCGA-DS-{i:04d}-01Z-00-DX1" for i in range(N_SLIDES)]
    (root / "flat").mkdir()
    for i, sid in enumerate(ids):
        n = int(rng.integers(10, 61)) if i % 4 else 45  # every class has a long slide
        feats = rng.standard_normal((n, WSI_IN)).astype(np.float16)
        cls_dir = root / "classes" / CLASSES[i % 2]
        cls_dir.mkdir(parents=True, exist_ok=True)
        np.save(cls_dir / f"{sid}.npy", feats)
        np.save(root / "flat" / f"{sid}.npy", feats)
    pd.DataFrame(rng.standard_normal((N_SLIDES, RNA_IN)).astype(np.float32),
                 index=[s[:15] for s in ids],
                 columns=[f"gene_{j}" for j in range(RNA_IN)]).to_csv(root / "rna.csv")
    pd.DataFrame({
        "Patient ID": [s[:12] for s in ids], "Sample ID": [s[:15] for s in ids],
        "Overall Survival (Months)": np.round(rng.uniform(1, 100, N_SLIDES), 2),
        "Overall Survival Status": ["0:LIVING" if i % 4 == 1 else "1:DECEASED"
                                    for i in range(N_SLIDES)],
    }).to_csv(root / "survival.csv", index=False)
    (root / "splits").mkdir()
    patients = [s[:12] for s in ids]
    for fold in range(K_FOLDS):
        val = patients[fold::K_FOLDS]
        train = [p for p in patients if p not in val]
        pd.DataFrame({"train": pd.Series(train), "val": pd.Series(val)}).to_csv(
            root / "splits" / f"splits_{fold}.csv")
    return root


def _datasets(cohort, jax_side: bool):
    if jax_side:
        from mirror_tpu.data.datasets import SubtypingDataset, SurvivalDataset
    else:
        from mirror_tpu_torch.data.datasets import SubtypingDataset, SurvivalDataset
    splits = str(cohort / "splits")
    sub = SubtypingDataset(str(cohort / "classes"), str(cohort / "rna.csv"), CLASSES, N_TOK,
                           splits=splits, k=K_FOLDS)
    surv = SurvivalDataset(str(cohort / "flat"), str(cohort / "rna.csv"),
                           str(cohort / "survival.csv"), N_TOK, splits=splits, k=K_FOLDS)
    return sub, surv


# (dataset, split, batch, shuffle, drop_last, pad_last, weighted)
LOADERS = [
    ("sub", "train", 4, True, True, False, False),
    ("sub", "train", 4, False, False, True, True),
    ("sub", "val", 4, False, False, True, False),
    ("surv", "train", 3, True, False, True, False),
    ("surv", "train", 4, False, True, False, True),
]


@pytest.mark.parametrize("which,split,bs,shuffle,drop_last,pad_last,weighted", LOADERS)
def test_loader_draws_the_jax_loaders_batches(cohort, which, split, bs, shuffle, drop_last,
                                              pad_last, weighted):
    """The port's datasets + Loader against the JAX package's numpy path:
    fold, order, class-balanced draws, padding and ``valid``, per-slide
    token draws, labels, event times and censorship, on epochs 0 and 1."""
    from mirror_tpu.data.loader import Loader as JaxLoader
    from mirror_tpu_torch.data.loader import Loader

    ours = dict(zip(("sub", "surv"), _datasets(cohort, False)))[which]
    theirs = dict(zip(("sub", "surv"), _datasets(cohort, True)))[which]
    for ds in (ours, theirs):
        ds.update_fold_nb(1)
        getattr(ds, split)()
    assert ours.used_feature_ids == theirs.used_feature_ids
    kw = dict(shuffle=shuffle, drop_last=drop_last, pad_last=pad_last, weighted=weighted,
              seed=5)
    a_loader = Loader(ours, bs, workers=2, **kw)
    b_loader = JaxLoader(theirs, bs, prefetch=0, use_native=False, process_index=0,
                         process_count=1, **kw)
    for epoch in (0, 1):
        a_loader.set_epoch(epoch)
        b_loader.set_epoch(epoch)
        got, want = list(a_loader), list(b_loader)
        assert len(got) == len(want) == len(a_loader)
        for a, b in zip(got, want):
            assert sorted(a) == sorted(b)
            for key in b:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    if pad_last:
        assert want[-1]["valid"].min() == 0.0  # the tail was padded


def test_survival_labels_match_jax(cohort):
    _, ours = _datasets(cohort, False)
    _, theirs = _datasets(cohort, True)
    assert ours.num_classes == theirs.num_classes == 8
    cols = ["Sample ID", "disc_label", "censorship", "label"]
    pd.testing.assert_frame_equal(ours.survival_data[cols].reset_index(drop=True),
                                  theirs.survival_data[cols].reset_index(drop=True))
    assert [ours.get_label(i) for i in range(len(ours))] == \
        [theirs.get_label(i) for i in range(len(theirs))]


def test_load_pretrained_from_a_port_mirror_checkpoint(tmp_path):
    """A port MIRROR ``.pth.tar`` into a classifier: every WSI and RNA
    encoder tensor whose name and shape match is copied, the head and the
    rest keep their init, the EMA weights are read when asked."""
    mk = dict(wsi_embed_dim=WSI_IN, rna_embed_dim=RNA_IN, embed_dim=E, wsi_num_tokens=N_TOK,
              rna_encoder_depth=1, style_mlp_hidden_dim=32, style_mlp_out_dim=20,
              style_latent_dim=16, num_prototypes=37)
    mirror = create_model("mirror", device="cpu", generator=torch.Generator().manual_seed(3),
                          **mk)
    path = str(tmp_path / "pretrain.pth.tar")
    save_checkpoint_file(path, mirror.state_dict(), {"model_kwargs": mk}, arch="mirror")
    clf = create_model("mirror_classifier", device="cpu",
                       generator=torch.Generator().manual_seed(4), **_kw("concat", 2))
    head = clf.head.weight.detach().clone()
    loaded, skipped = load_pretrained(clf, path)
    target = clf.state_dict()
    source = mirror.state_dict()
    shared = [k for k in target if k in source and source[k].shape == target[k].shape]
    assert loaded == sorted(shared) and len(loaded) + len(skipped) == len(target)
    assert "wsi_encoder.layer1.attn.to_qkv.weight" in loaded
    assert "rna_encoder.embedding.fc1.weight" in loaded
    assert {"head.weight", "head.bias"} <= set(skipped)
    for k in loaded:
        assert torch.equal(target[k], source[k]), k
    assert torch.equal(clf.head.weight.detach(), head)
    # a shape mismatch is skipped, not raised on
    small = {k: (v[..., :1] if k == "wsi_encoder.cls_token" else v) for k, v in source.items()}
    torch.save({"state_dict": small, "state_dict_ema": dict(source)}, str(tmp_path / "b.pth"))
    loaded2, _ = load_pretrained(clf, str(tmp_path / "b.pth"))
    assert "wsi_encoder.cls_token" not in loaded2
    assert "wsi_encoder.cls_token" in load_pretrained(clf, str(tmp_path / "b.pth"),
                                                      use_ema=True)[0]


def _downstream_argv(cohort, task, *extra):
    common = ["--rna-feature-csv", str(cohort / "rna.csv"), "--split-dir",
              str(cohort / "splits"), "--output", str(cohort / "runs"), "--experiment",
              f"tiny_{task}", "--epochs", "2", "--batch-size", "4", "--num-wsi-feature-tokens",
              str(N_TOK), "--workers", "2", "--model-kwargs", *TINY]
    if task == "subtyping":
        return ["--config", SUBTYPING_YAML, "--wsi-feature-dir", str(cohort / "classes"),
                "--classes", *CLASSES, *common, *extra]
    return ["--config", SURVIVAL_YAML, "--wsi-feature-dir", str(cohort / "flat"),
            "--survival-csv", str(cohort / "survival.csv"), *common, *extra]


def test_train_subtyping_on_the_cpu_probe_warm_start_and_predict(cohort, capsys):
    """Linear probe (the template's) warm-started from a pretrain
    checkpoint, 2 epochs on the CPU: the --result JSON, acc/auc/f1 in
    range, a checkpoint that reloads and that predict scores with."""
    from mirror_tpu_torch.tools.predict import predict

    mk = dict(wsi_embed_dim=WSI_IN, rna_embed_dim=RNA_IN, embed_dim=E, wsi_num_tokens=N_TOK,
              rna_encoder_depth=1)
    mirror = create_model("mirror", device="cpu", generator=torch.Generator().manual_seed(3),
                          **mk)
    pretrain = str(cohort / "pretrain.pth.tar")
    save_checkpoint_file(pretrain, mirror.state_dict(), {"model_kwargs": mk}, arch="mirror")
    results = train_subtyping.main(_downstream_argv(
        cohort, "subtyping", "--device", "cpu", "--initial-checkpoint", pretrain,
        "--no-drop-last", "--weighted-sampler"))
    printed = json.loads(capsys.readouterr().out.split("--result\n", 1)[1])
    assert printed == results and results["metric_name"] == "acc"
    run_dir = cohort / "runs" / "subtyping" / "tiny_subtyping"
    summary = pd.read_csv(run_dir / "summary.csv")
    assert len(summary) == 2
    assert ((summary["eval_acc"] >= 0) & (summary["eval_acc"] <= 100)).all()
    assert ((summary["eval_auc"] >= 0) & (summary["eval_auc"] <= 1)).all()
    assert ((summary["eval_f1"] >= 0) & (summary["eval_f1"] <= 1)).all()
    assert np.isfinite(summary[["train_loss", "train_grad_norm", "eval_loss"]].to_numpy()).all()

    payload = load_checkpoint_file(str(run_dir / "last.pth.tar"))
    args = run_args(payload)
    assert payload["arch"] == "mirror_classifier" and args["linear_probe"]
    model = create_model("mirror_classifier", device="cpu", **args["model_kwargs"])
    model.load_state_dict(payload["state_dict"])
    # the probe trained the head only: the trunk is the warm start's
    assert torch.equal(payload["state_dict"]["wsi_encoder.layer1.attn.to_qkv.weight"],
                       mirror.state_dict()["wsi_encoder.layer1.attn.to_qkv.weight"])
    out = cohort / "pred.csv"
    predict(str(run_dir / "last.pth.tar"), "subtyping", str(cohort / "classes"), str(out),
            rna_feature_csv=str(cohort / "rna.csv"), batch_size=8, device="cpu")
    df = pd.read_csv(out)
    assert len(df) == N_SLIDES and np.allclose(df[["prob_0", "prob_1"]].sum(axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("loss", ["nll_surv", "ce_surv"])
def test_train_survival_on_the_cpu_fine_tunes_with_the_exact_pinv(cohort, capsys, tmp_path,
                                                                  loss):
    """Fine-tuning (a YAML with linear_probe false) with --pinv-grad exact,
    2 epochs on the CPU: the --result JSON, a c-index in [0, 1], a
    reloadable checkpoint whose trunk moved."""
    yaml_path = tmp_path / "survival.yaml"
    with open(SURVIVAL_YAML) as f:
        text = f.read().replace("linear_probe: true", "linear_probe: false")
    yaml_path.write_text(text)
    argv = _downstream_argv(cohort, "survival", "--device", "cpu", "--pinv-grad", "exact",
                            "--loss", loss, "--loss-alpha", "0.4", "--experiment",
                            f"tiny_survival_{loss}")
    argv[1] = str(yaml_path)
    results = train_survival.main(argv)
    printed = json.loads(capsys.readouterr().out.split("--result\n", 1)[1])
    assert printed == results and results["metric_name"] == "c-index"
    run_dir = cohort / "runs" / "survival" / f"tiny_survival_{loss}"
    summary = pd.read_csv(run_dir / "summary.csv")
    assert ((summary["eval_c-index"] >= 0) & (summary["eval_c-index"] <= 1)).all()
    assert np.isfinite(summary[["train_loss", "eval_loss"]].to_numpy()).all()
    payload = load_checkpoint_file(str(run_dir / "last.pth.tar"))
    args = run_args(payload)
    assert args["model_kwargs"]["pinv_grad"] == "exact" and not args["linear_probe"]
    assert args["loss"] == loss
    model = create_model("mirror_classifier", device="cpu", **args["model_kwargs"])
    model.load_state_dict(payload["state_dict"])
    assert model.head.out_features == 4


def test_gen_few_shot_files_writes_the_jax_tools_files(cohort, tmp_path, monkeypatch):
    from mirror_tpu.tools import gen_few_shot_files as jax_tool
    from mirror_tpu_torch.tools import gen_few_shot_files

    argv = ["--tasks", "subtyping", "survival", "--shots", "2", "3", "--k", str(K_FOLDS),
            "--num-wsi-feature-tokens", "14", "--rna-feature-csv", str(cohort / "rna.csv"),
            "--split-dir", str(cohort / "splits"), "--survival-wsi-feature-dir",
            str(cohort / "flat"), "--survival-csv", str(cohort / "survival.csv"),
            "--subtyping-wsi-feature-dir", str(cohort / "classes"), "--subtyping-classes",
            *CLASSES, "--class-name", "tiny", "--seed", "7"]
    gen_few_shot_files.main(argv + ["--output-dir", str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["gen_few_shot_files"] + argv
                        + ["--output-dir", str(tmp_path / "jax")])
    jax_tool.main()
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.csv"))
    assert len(files) == 2 * 2 * K_FOLDS
    for rel in files:
        assert (tmp_path / "port" / rel).read_text() == (tmp_path / "jax" / rel).read_text(), rel
    random.seed()


@pytest.mark.parametrize("flag", [
    ["--ckpt-format", "orbax"], ["--loss", "focal"], ["--model", "mirror_clip"],
])
@pytest.mark.parametrize("task", ["subtyping", "survival"])
def test_downstream_entry_points_refuse_unported_flags(cohort, task, flag):
    """``--ckpt-format orbax``, a departure on purpose, names the JAX
    package's tool that makes an Orbax directory; the others name the flag."""
    main = train_subtyping.main if task == "subtyping" else train_survival.main
    message = flag[0]
    if message == "--ckpt-format":
        message = r"--ckpt-format orbax: .*import_torch_checkpoint .*--format orbax"
    with pytest.raises(SystemExit, match=message):
        main(_downstream_argv(cohort, task, "--device", "cpu", *flag))


@pytest.mark.parametrize("flag", [
    ["--grad-accum-steps", "2"],
    ["--opt", "sgd", "--use-sched", "--sched", "plateau", "--clip-grad", "1.0",
     "--warmup-epochs", "1", "--warmup-lr", "1e-4"],
    ["--model-ema", "--model-ema-warmup"],
])
@pytest.mark.parametrize("task", ["subtyping", "survival"])
def test_downstream_entry_points_run_the_optimizer_flags(cohort, task, flag):
    """The flags the downstream entry points once refused now train, 2
    epochs on the CPU: the lr in summary.csv, the plateau's lr written at
    the epoch boundary, the EMA evaluated beside the live weights and saved
    with them."""
    main = train_subtyping.main if task == "subtyping" else train_survival.main
    experiment = f"opt_{task}_{flag[0].strip('-')}"
    results = main(_downstream_argv(cohort, task, "--device", "cpu", "--experiment",
                                    experiment, *flag))
    run_dir = cohort / "runs" / task / experiment
    summary = pd.read_csv(run_dir / "summary.csv")
    assert len(summary) == 2 and np.isfinite(summary["train_lr"]).all()
    payload = load_checkpoint_file(str(run_dir / "last.pth.tar"))
    ema = "--model-ema" in flag
    assert ("state_dict_ema" in payload) == ema and ("eval_ema_loss" in summary) == ema
    if "plateau" in flag:
        # one warmup epoch at --warmup-lr, then the template's lr
        base = 2e-3 if task == "subtyping" else 3e-3
        assert summary["train_lr"].tolist() == pytest.approx([1e-4, base], rel=1e-6)
    assert results["metric_name"] == ("acc" if task == "subtyping" else "c-index")


def test_predict_use_ema_scores_the_ema_weights(cohort, tmp_path):
    """A train_subtyping --model-ema checkpoint: predict --use-ema scores
    its state_dict_ema (the same rows as a checkpoint holding those weights
    alone), not the live weights."""
    from mirror_tpu_torch.tools.predict import predict

    train_subtyping.main(_downstream_argv(cohort, "subtyping", "--device", "cpu",
                                          "--experiment", "ema_predict", "--model-ema"))
    ckpt = str(cohort / "runs" / "subtyping" / "ema_predict" / "last.pth.tar")
    payload = load_checkpoint_file(ckpt)
    ema_only = str(tmp_path / "ema_only.pth.tar")
    save_checkpoint_file(ema_only, payload["state_dict_ema"], run_args(payload),
                         arch=payload["arch"])
    kw = dict(rna_feature_csv=str(cohort / "rna.csv"), batch_size=8, device="cpu")
    rows = {}
    for name, path, use_ema in (("ema", ckpt, True), ("ema_only", ema_only, False),
                                ("live", ckpt, False)):
        out = tmp_path / f"{name}.csv"
        predict(path, "subtyping", str(cohort / "classes"), str(out), use_ema=use_ema, **kw)
        rows[name] = pd.read_csv(out)
    pd.testing.assert_frame_equal(rows["ema"], rows["ema_only"])
    assert not np.allclose(rows["ema"]["prob_0"], rows["live"]["prob_0"])


@pytest.mark.parametrize("task", ["subtyping", "survival"])
def test_downstream_entry_points_need_a_card_unless_told_cpu(cohort, task):
    assert inspect.signature(train_subtyping.main).parameters["argv"].default is None
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    main = train_subtyping.main if task == "subtyping" else train_survival.main
    with pytest.raises(SystemExit, match="--device cpu"):
        main(_downstream_argv(cohort, task))


def test_downstream_entry_points_import_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'mirror_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import mirror_tpu_torch.train_subtyping, mirror_tpu_torch.train_survival\n"
        "import mirror_tpu_torch.tools.gen_few_shot_files\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'mirror_tpu') and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
