"""The port's data parallelism (``torch.distributed``, one process a rank) on
the CPU, against the JAX package's data mesh.

- the blocked loader: the port's ``Loader`` blocks (2 and 4 processes,
  plain and weighted, an eval tail padded) against the JAX ``Loader``'s,
  index for index, and together the one-process batch;
- the MIRROR train step in 2 gloo ranks against the JAX step on a
  2-device CPU mesh (``create_mesh(num_devices=2)``): the same weights,
  the global masking noise and VAE eps injected (each rank its block),
  dropout 0, Adam, 3 steps, local negatives (``local_clip_loss``) and
  global ones, each with the implicit and the exact pinv gradient; the
  CLIP step with local negatives against ``local_info_nce``'s. Bars: the
  per-step loss within 2e-5 relative, the weights after the steps at the
  trajectory tests' bars (cosine >= 0.9999 a leaf, norms within 1e-4), the
  ranks' weights the same bits before and after every step;
- the CLIs end to end on a tiny ``--device cpu`` cohort in fp32, 2 ranks
  against one process at the same global batch (global negatives, dropout
  0): one
  run directory and one ``--result``, ``summary.csv`` at the bars above,
  the survival c-index equal; a SIGTERM to one rank stops both at the same
  batch with one recovery file; the refusals; a one-rank group and
  ``--optimizer-sharding`` in one process bit for bit the plain run.

Each multi-process case spawns its ranks with ``parallel/worker.py``'s
launcher: rendezvous by ``file://`` in ``tmp_path`` (no port to collide
on), a timeout on the group and on the launch, one intra-op thread a rank.
"""

import os
import re
import signal
import subprocess
import sys
import time
from functools import partial

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from mirror_tpu.data.loader import Loader as JaxLoader
from mirror_tpu.losses import local_clip_loss, local_info_nce
from mirror_tpu.losses.mirror_loss import MirrorLossWeights as JaxWeights
from mirror_tpu.models import mirror as jax_mirror
from mirror_tpu.models import transmil as jax_transmil
from mirror_tpu.models.dual import MIRRORDual as JaxDual
from mirror_tpu.parallel.mesh import create_mesh, replicate, shard_batch
from mirror_tpu.tools.import_torch_checkpoint import convert_state_dict
from mirror_tpu.train.optim import make_optimizer as jax_make_optimizer
from mirror_tpu.train.optim import make_schedule
from mirror_tpu.train.state import create_train_state
from mirror_tpu.train.steps import make_clip_train_step as jax_clip_step
from mirror_tpu.train.steps import make_mirror_train_step as jax_mirror_step
from mirror_tpu_torch import config, train_mirror, train_pretrain, train_subtyping
from mirror_tpu_torch import train_survival
from mirror_tpu_torch.convert import state_dict_from_jax
from mirror_tpu_torch.data.loader import Loader
from mirror_tpu_torch.parallel import worker
from mirror_tpu_torch.registry import create_model
from mirror_tpu_torch.train.checkpoint import load_checkpoint_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRETRAIN_YAML = os.path.join(REPO, "configs", "pretrain", "mirror.template.yaml")
SURVIVAL_YAML = os.path.join(REPO, "configs", "survival", "mirror.template.yaml")
LAUNCH_S = 120.0


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The suite's workers share the cores: torch on one thread here, as
    each spawned rank is."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# --------------------------------------------------------------------------
# the blocked loader
# --------------------------------------------------------------------------

class _ArangeDS:
    """Items carry their index and a draw from their seed."""

    def __init__(self, n=19):
        self.n = n

    def __len__(self):
        return self.n

    def get_label(self, i):
        return int(i % 3 == 0)

    def __getitem__(self, i, rng=None):
        return {"x": np.full((3,), float(i), np.float32),
                "draw": np.float32(rng.uniform() if rng is not None else 0.0)}


def _epoch(loader, epoch):
    loader.set_epoch(epoch)
    return list(loader)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("pc", [2, 4])
def test_blocked_loader_matches_the_jax_loaders_blocks(pc, weighted):
    ds = _ArangeDS(19)
    kw = dict(batch_size=8, shuffle=True, drop_last=True, seed=11, weighted=weighted,
              prefetch=0, use_native=False)
    for epoch in (0, 1):
        one = _epoch(Loader(ds, workers=1, process_index=0, process_count=1, **kw), epoch)
        ours = [_epoch(Loader(ds, workers=1, process_index=p, process_count=pc, **kw), epoch)
                for p in range(pc)]
        theirs = [_epoch(JaxLoader(ds, process_index=p, process_count=pc, **kw), epoch)
                  for p in range(pc)]
        assert len(one) == 2 and all(len(b) == 2 for b in ours + theirs)
        for b in range(2):
            for p in range(pc):
                for key in ("x", "draw", "valid"):
                    np.testing.assert_array_equal(ours[p][b][key], theirs[p][b][key],
                                                  err_msg=f"{key} p{p} b{b}")
            for key in ("x", "draw", "valid"):
                np.testing.assert_array_equal(
                    np.concatenate([ours[p][b][key] for p in range(pc)]), one[b][key])


@pytest.mark.parametrize("pc", [2, 4])
def test_blocked_eval_tail_is_padded_then_cut_as_jax(pc):
    ds = _ArangeDS(10)
    kw = dict(batch_size=8, shuffle=False, drop_last=False, pad_last=True, seed=0, prefetch=0,
              use_native=False)
    one = _epoch(Loader(ds, workers=1, process_index=0, process_count=1, **kw), 0)
    ours = [_epoch(Loader(ds, workers=1, process_index=p, process_count=pc, **kw), 0)
            for p in range(pc)]
    theirs = [_epoch(JaxLoader(ds, process_index=p, process_count=pc, **kw), 0)
              for p in range(pc)]
    for b in range(2):
        for p in range(pc):
            for key in ("x", "draw", "valid"):
                np.testing.assert_array_equal(ours[p][b][key], theirs[p][b][key])
        got = np.concatenate([ours[p][b]["valid"] for p in range(pc)])
        np.testing.assert_array_equal(got, one[b]["valid"])
    # the tail: 2 real rows then padding, each block with its own valid
    assert one[1]["valid"].tolist() == [1, 1, 0, 0, 0, 0, 0, 0]
    assert ours[-1][1]["valid"].sum() == 0


def test_blocked_loader_refuses_what_does_not_divide():
    with pytest.raises(ValueError, match="batch 6 over 4 processes"):
        Loader(_ArangeDS(), 6, process_index=0, process_count=4)
    loader = Loader(_ArangeDS(10), 4, shuffle=False, drop_last=False, prefetch=0,
                    use_native=False, process_index=0, process_count=4, workers=1)
    with pytest.raises(ValueError, match="needs drop_last or pad_last"):
        list(loader)


# --------------------------------------------------------------------------
# the MIRROR and CLIP steps in 2 ranks against the JAX steps on a 2-device mesh
# --------------------------------------------------------------------------

B, WSI_IN, RNA_IN, E, N_TOK = 4, 40, 100, 24, 30
STYLE_HID, STYLE_OUT, LATENT, PROTO = 32, 20, 16, 37
WSI_RATIO, RNA_RATIO = 0.75, 0.5
WEIGHTS = (0.5, 0.15, 0.15, 0.1, 0.1)
LR = 1e-3
MIRROR_KW = dict(wsi_embed_dim=WSI_IN, rna_embed_dim=RNA_IN, embed_dim=E, wsi_num_tokens=N_TOK,
                 style_mlp_hidden_dim=STYLE_HID, style_mlp_out_dim=STYLE_OUT,
                 style_latent_dim=LATENT, num_prototypes=PROTO, rna_proj_drop_rate=0.0)
NOISE_KEYS = ("wsi_noise", "rna_noise", "wsi_eps", "rna_eps")
_INJECT: dict = {}


class _AdamArgs:
    opt, opt_eps, opt_betas, opt_kwargs, momentum = "adam", None, None, {}, 0.9
    weight_decay, clip_grad, clip_mode, layer_decay = 0.0, None, "norm", None
    use_sched, model_ema, grad_accum_steps = False, False, 1


def _rank_mask(noise, ratio):
    keep = int(noise.shape[1] * (1 - ratio))
    return (np.argsort(np.argsort(noise, axis=1), axis=1) >= keep).astype(np.float32)


def _steps(seed, n=3):
    rng = np.random.default_rng(seed)
    return [dict(wsi=rng.standard_normal((B, N_TOK, WSI_IN)).astype(np.float32),
                 rna=rng.standard_normal((B, RNA_IN)).astype(np.float32),
                 wsi_noise=rng.random((B, N_TOK)).astype(np.float32),
                 rna_noise=rng.random((B, E)).astype(np.float32),
                 wsi_eps=rng.standard_normal((B, LATENT)).astype(np.float32),
                 rna_eps=rng.standard_normal((B, LATENT)).astype(np.float32)) for _ in range(n)]


def _patch_flax(mp):
    """The flax model's masks and eps from the batch (injected while the
    step traces), and its TransLayers' dropout at 0."""
    mp.setattr(jax_transmil, "random_token_masking",
               lambda key, batch, num_tokens, ratio: _INJECT["masks"][num_tokens])

    def fixed_reparam(self, mu, logstd, rng):
        eps = _INJECT["eps"][_INJECT["i"] % 2]
        _INJECT["i"] += 1
        return mu + jnp.exp(0.5 * logstd) * eps.astype(mu.dtype)

    mp.setattr(jax_mirror.MIRROR, "reparameterize", fixed_reparam)
    real = jax_transmil.NystromAttention
    mp.setattr(jax_transmil, "NystromAttention", lambda **kw: real(**{**kw, "dropout": 0.0}))


def _leaf_close(got, want, what):
    """The trajectory tests' bars: cosine >= 0.9999 a leaf, norms within
    1e-4 relative."""
    for key in sorted(want):
        a = np.asarray(want[key], np.float64).ravel()
        b = got[key].detach().double().numpy().ravel()
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        assert nb == pytest.approx(na, rel=1e-4, abs=1e-9), f"{what} {key}: |w| {nb} vs {na}"
        if na > 1e-12:
            assert float(a @ b / (na * nb)) >= 0.9999, f"{what} {key}"


@pytest.mark.parametrize("gather", [False, True])
def test_mirror_loss_over_valid_rows_matches_jax(gather):
    """The loss that a padded eval batch takes across ranks: the port's
    ``mirror_loss(valid=...)`` (a one-process ``gather`` is the identity)
    against the JAX ``mirror_loss(valid=...)`` on the same 15 outputs, each
    term within 1e-5 relative."""
    from mirror_tpu.losses.mirror_loss import mirror_loss as jax_mirror_loss
    from mirror_tpu_torch.losses import MirrorLossWeights, mirror_loss

    model = create_model("mirror", device="cpu", generator=torch.Generator().manual_seed(1),
                         **MIRROR_KW)
    d = _steps(3, n=1)[0]
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(d["wsi"]), torch.from_numpy(d["rna"]), WSI_RATIO,
                           RNA_RATIO, noise={k: torch.from_numpy(d[k]) for k in NOISE_KEYS})
    valid = torch.tensor([1.0, 1.0, 1.0, 0.0])
    got = mirror_loss(*out, weights=MirrorLossWeights(*WEIGHTS),
                      negatives="global" if gather else "local", valid=valid)
    want = jax_mirror_loss(*(jnp.asarray(t.numpy()) for t in out),
                           weights=JaxWeights(*WEIGHTS), valid=jnp.asarray(valid.numpy()))
    for a, b in zip(got, want):
        assert float(a) == pytest.approx(float(b), rel=1e-5)


def _start(tmp_path, name, **spec):
    """Start 2 ranks of the worker on ``spec``; returns their wait."""
    path = tmp_path / f"{name}.spec.pt"
    torch.save(spec, path)
    return worker.start(path, tmp_path / name, 2, tmp_path / f"{name}.rdv", LAUNCH_S)


def _seeded(name, **kw):
    """A port model's weights from seed 0 (what each rank builds), and the
    flax param tree of them."""
    model = create_model(name, device="cpu", generator=torch.Generator().manual_seed(0), **kw)
    params, unmapped = convert_state_dict(model.state_dict())
    assert not unmapped, unmapped
    return jax.tree.map(jnp.asarray, params)


def _same_bits_on_every_rank(outs):
    assert len({o["init_digest"] for o in outs}) == 1  # the same weights from the seed
    for t in range(len(outs[0]["digests"])):
        assert len({o["digests"][t] for o in outs}) == 1, f"ranks' weights differ at step {t}"


@pytest.mark.parametrize("pinv_grad", ["implicit", "exact"])
@pytest.mark.parametrize("negatives", ["local", "global"])
def test_mirror_step_in_two_ranks_matches_the_jax_step_on_a_two_device_mesh(
        tmp_path, negatives, pinv_grad):
    steps = _steps(100)
    port_kw = dict(MIRROR_KW, wsi_dropout=0.0, pinv_grad=pinv_grad)
    ranks = _start(tmp_path, "mirror", model="mirror", model_kwargs=port_kw, device="cpu",
                   seed=0, step="mirror", negatives=negatives, lr=LR, loss_weights=WEIGHTS,
                   mask_ratios=(WSI_RATIO, RNA_RATIO), dump=("weights",),
                   batches=[{k: torch.from_numpy(d[k]) for k in ("wsi", "rna")} for d in steps],
                   noise=[{k: torch.from_numpy(d[k]) for k in NOISE_KEYS} for d in steps])
    params = _seeded("mirror", **port_kw)
    mesh = create_mesh(num_devices=2)
    model = jax_mirror.MIRROR(**MIRROR_KW, pinv_grad=pinv_grad)
    tx = jax_make_optimizer(_AdamArgs, make_schedule(_AdamArgs, steps_per_epoch=3, base_lr=LR))
    align = partial(local_clip_loss, mesh=mesh) if negatives == "local" else None
    base = jax_mirror_step(model, tx, JaxWeights(*WEIGHTS), WSI_RATIO, RNA_RATIO,
                           alignment_loss_fn=align)

    def step(state, batch, rng):
        _INJECT.update(masks={N_TOK: batch["wsi_mask"], E: batch["rna_mask"]},
                       eps=[batch["wsi_eps"], batch["rna_eps"]], i=0)
        return base(state, {"wsi": batch["wsi"], "rna": batch["rna"]}, rng)

    mp = pytest.MonkeyPatch()
    losses_j = []
    try:
        _patch_flax(mp)
        state = replicate(mesh, create_train_state(params, tx))
        jitted = jax.jit(step)
        for t, d in enumerate(steps):
            batch = {"wsi": d["wsi"], "rna": d["rna"], "wsi_eps": d["wsi_eps"],
                     "rna_eps": d["rna_eps"], "wsi_mask": _rank_mask(d["wsi_noise"], WSI_RATIO),
                     "rna_mask": _rank_mask(d["rna_noise"], RNA_RATIO)}
            state, metrics = jitted(state, shard_batch(mesh, batch), jax.random.PRNGKey(t))
            losses_j.append(float(metrics["loss"]))
    finally:
        mp.undo()

    outs = ranks()
    _same_bits_on_every_rank(outs)
    for t, want in enumerate(losses_j):
        for out in outs:
            assert out["metrics"][t]["loss"] == pytest.approx(want, rel=2e-5), f"step {t}"
    want = state_dict_from_jax(jax.device_get(state.params))
    _leaf_close(outs[0]["weights"], want, "weights")


def test_clip_step_in_two_ranks_matches_local_info_nce_on_a_two_device_mesh(tmp_path):
    kw = dict(wsi_embed_dim=WSI_IN, rna_embed_dim=RNA_IN, embed_dim=E, rna_encoder_depth=1,
              rna_mlp_ratio=2.0, rna_proj_drop_rate=0.0, pinv_grad="implicit")
    rng = np.random.default_rng(41)
    batches = [{"wsi": rng.standard_normal((B, N_TOK, WSI_IN)).astype(np.float32),
                "rna": rng.standard_normal((B, RNA_IN)).astype(np.float32)} for _ in range(3)]
    ranks = _start(tmp_path, "clip", model="mirror_dual", model_kwargs=dict(kw, wsi_dropout=0.0),
                   device="cpu", seed=0, step="clip", negatives="local", lr=LR,
                   temperature=0.1, dump=("weights",),
                   batches=[{k: torch.from_numpy(v) for k, v in b.items()} for b in batches])
    params = _seeded("mirror_dual", **kw, wsi_dropout=0.0)
    mesh = create_mesh(num_devices=2)
    model = JaxDual(**kw)
    tx = jax_make_optimizer(_AdamArgs, make_schedule(_AdamArgs, steps_per_epoch=3, base_lr=LR))
    mp = pytest.MonkeyPatch()
    losses_j = []
    try:
        real = jax_transmil.NystromAttention
        mp.setattr(jax_transmil, "NystromAttention", lambda **k: real(**{**k, "dropout": 0.0}))
        step = jax.jit(jax_clip_step(model, tx, temperature=0.1, contrastive_loss_fn=partial(
            local_info_nce, mesh=mesh, temperature=0.1)))
        state = replicate(mesh, create_train_state(params, tx))
        for t, b in enumerate(batches):
            state, m = step(state, shard_batch(mesh, b), jax.random.PRNGKey(t))
            losses_j.append(float(m["loss"]))
    finally:
        mp.undo()
    outs = ranks()
    _same_bits_on_every_rank(outs)
    for t, want in enumerate(losses_j):
        assert outs[1]["metrics"][t]["loss"] == pytest.approx(want, rel=2e-5), f"step {t}"
    _leaf_close(outs[1]["weights"], state_dict_from_jax(jax.device_get(state.params)),
                "weights")


def _mirror_spec(steps, **extra):
    spec = dict(model="mirror", model_kwargs=dict(MIRROR_KW, wsi_dropout=0.0), device="cpu",
                seed=0, step="mirror", negatives="global", lr=LR, loss_weights=WEIGHTS,
                mask_ratios=(WSI_RATIO, RNA_RATIO),
                batches=[{k: torch.from_numpy(d[k]) for k in ("wsi", "rna")} for d in steps],
                noise=[{k: torch.from_numpy(d[k]) for k in NOISE_KEYS} for d in steps])
    spec.update(extra)
    return spec


def test_grad_checkpointing_under_ddp_repeats_the_plain_step(tmp_path):
    """2 ranks, the exact pinv gradient (the scale's collective in the
    forward and the backward) and a live dropout from the step generator
    (each rank's own stream): ``grad_checkpointing`` replays the forward,
    collective and dropout included, and the weights after 3 steps are the
    plain run's bits."""
    steps = _steps(7)
    kw = dict(MIRROR_KW, wsi_dropout=0.1, rna_proj_drop_rate=0.1, pinv_grad="exact")
    starts = {ckpt: _start(tmp_path, f"ckpt_{ckpt}", **_mirror_spec(
        steps, model_kwargs=dict(kw, grad_checkpointing=ckpt), generator_seed=5, noise=None))
        for ckpt in (False, True)}
    plain, ckpt = starts[False](), starts[True]()
    _same_bits_on_every_rank(plain)
    assert [o["digests"] for o in ckpt] == [o["digests"] for o in plain]


def test_grad_accumulation_in_two_ranks_matches_one_process(tmp_path):
    """``--grad-accum-steps 2``: each micro-step's gradient averaged over the
    ranks once, then the two micro-steps' mean, as one process takes it
    (global negatives, 4 micro-steps: 2 updates)."""
    steps = _steps(11, n=4)
    path = tmp_path / "accum.spec.pt"
    torch.save(_mirror_spec(steps, argv=["--grad-accum-steps", "2"], dump=("weights",)), path)
    two = worker.start(path, tmp_path / "two", 2, tmp_path / "two.rdv", LAUNCH_S)
    one = worker.launch(path, tmp_path / "one", 1, tmp_path / "one.rdv", LAUNCH_S)[0]
    two = two()
    _same_bits_on_every_rank(two)
    for t in range(4):
        assert two[0]["metrics"][t]["loss"] == pytest.approx(one["metrics"][t]["loss"], rel=2e-5)
    _leaf_close(two[0]["weights"], {k: v.numpy() for k, v in one["weights"].items()},
                "weights")


def test_rank_draws_seed_each_rank_apart_from_the_shared_stream(monkeypatch):
    """Across ranks a live dropout draws from the rank's own generator,
    seeded from one draw of the shared one and the rank: the ranks' masks
    differ, the shared stream advances alike on every rank, and the same
    shared state gives the same seeds again (a resume)."""
    from mirror_tpu_torch.parallel import distributed
    from mirror_tpu_torch.train.steps import RankDraws

    model = create_model("mirror", device="cpu", **dict(MIRROR_KW, wsi_dropout=0.1))
    monkeypatch.setattr(distributed, "multi", lambda: True)
    draws, shared = [], []
    for rank in (0, 1, 0):
        monkeypatch.setattr(distributed, "rank", lambda r=rank: r)
        gen = torch.Generator().manual_seed(3)
        d = RankDraws(model, gen)
        d.step()
        draws.append(torch.rand(4, generator=d.own))
        shared.append(gen.get_state())
    assert not torch.equal(draws[0], draws[1]) and torch.equal(draws[0], draws[2])
    assert torch.equal(shared[0], shared[1])
    one = torch.Generator().manual_seed(3)
    RankDraws(create_model("mirror", device="cpu", **dict(MIRROR_KW, wsi_dropout=0.0,
                                                           rna_proj_drop_rate=0.0)), one).step()
    assert torch.equal(one.get_state(), torch.Generator().manual_seed(3).get_state())


# --------------------------------------------------------------------------
# the CLIs: 2 ranks against one process
# --------------------------------------------------------------------------

N_SLIDES = 16  # 8 train and 4 val patients in the pretrain split; 3 folds downstream
FEAT, RNA_COLS = 40, 50
TINY = ["wsi_embed_dim=40", "embed_dim=24", "rna_encoder_depth=1", "wsi_dropout=0.0",
        "rna_proj_drop_rate=0.0"]
TINY_MIRROR = ["wsi_num_tokens=30", "style_mlp_hidden_dim=32", "style_mlp_out_dim=20",
               "style_latent_dim=16", "num_prototypes=37"]


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """16 slides of 10-60 fp16 patches, an RNA CSV, a survival CSV, a
    pretrain split (8 train, 4 val) and 3 downstream folds."""
    root = tmp_path_factory.mktemp("ddp_cohort")
    rng = np.random.default_rng(19)
    ids = [f"TCGA-DD-{i:04d}-01Z-00-DX1" for i in range(N_SLIDES)]
    (root / "feats").mkdir()
    for sid in ids:
        n = int(rng.integers(10, 61))
        np.save(root / "feats" / f"{sid}.npy", rng.standard_normal((n, FEAT)).astype(np.float16))
    pd.DataFrame(rng.standard_normal((N_SLIDES, RNA_COLS)).astype(np.float32),
                 index=[s[:15] for s in ids],
                 columns=[f"gene_{j}" for j in range(RNA_COLS)]).to_csv(root / "rna.csv")
    patients = [s[:12] for s in ids]
    (root / "splits").mkdir()
    pd.DataFrame({"train": pd.Series(patients[:8]), "val": pd.Series(patients[8:12])}).to_csv(
        root / "splits" / "splits_0.csv")
    pd.DataFrame({
        "Patient ID": patients, "Sample ID": [s[:15] for s in ids],
        "Overall Survival (Months)": np.round(rng.uniform(1, 100, N_SLIDES), 2),
        "Overall Survival Status": ["0:LIVING" if i % 4 == 1 else "1:DECEASED"
                                    for i in range(N_SLIDES)],
    }).to_csv(root / "survival.csv", index=False)
    (root / "folds").mkdir()
    for fold in range(3):
        val = patients[fold::3]
        pd.DataFrame({"train": pd.Series([p for p in patients if p not in val]),
                      "val": pd.Series(val)}).to_csv(root / "folds" / f"splits_{fold}.csv")
    return root


def _pretrain_argv(cohort, experiment, *extra):
    return ["--config", PRETRAIN_YAML, "--wsi-feature-dir", str(cohort / "feats"),
            "--rna-feature-csv", str(cohort / "rna.csv"), "--split-dir", str(cohort / "splits"),
            "--output", str(cohort / "runs"), "--experiment", experiment, "--epochs", "2",
            "--batch-size", "4", "--num-wsi-feature-tokens", "30", "--workers", "1",
            "--log-interval", "1", "--device", "cpu", "--contrastive-negatives", "global",
            "--no-amp", "--model-kwargs", *TINY, *extra]


def _survival_argv(cohort, experiment, *extra):
    return ["--config", SURVIVAL_YAML, "--wsi-feature-dir", str(cohort / "feats"),
            "--rna-feature-csv", str(cohort / "rna.csv"), "--split-dir", str(cohort / "folds"),
            "--survival-csv", str(cohort / "survival.csv"), "--output", str(cohort / "runs"),
            "--experiment", experiment, "--epochs", "2", "--batch-size", "4",
            "--num-wsi-feature-tokens", "30", "--workers", "1", "--log-interval", "1",
            "--device", "cpu", "--no-amp", "--model-kwargs", *TINY, *extra]


CLIS = {
    "train_mirror": (train_mirror, "pretrain", lambda c, e: _pretrain_argv(c, e, *TINY_MIRROR)),
    "train_pretrain": (train_pretrain, "pretrain_clip", _pretrain_argv),
    "train_survival": (train_survival, "survival", _survival_argv),
}


def _two_ranks_started(tmp_path, module, argv, name):
    return worker.start_ranks([sys.executable, "-m", module.__name__, *argv], 2,
                              tmp_path / f"{name}.rdv", tmp_path / name, LAUNCH_S)


def _two_ranks(tmp_path, module, argv, name):
    return _two_ranks_started(tmp_path, module, argv, name)()


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_cli_in_two_ranks_matches_one_process(cohort, tmp_path, cli):
    module, task, argv_of = CLIS[cli]
    two_ranks = _two_ranks_started(tmp_path, module, argv_of(cohort, f"{cli}_two"), cli)
    one = module.main(argv_of(cohort, f"{cli}_one"))
    logs = two_ranks()
    # rank 0 alone owns the run directory and prints the result
    assert "--result" in logs[0] and "--result" not in logs[1]
    assert all(f"rank {r}/2" in logs[r] for r in range(2))
    runs = cohort / "runs" / task
    assert sorted(p.name for p in runs.iterdir() if p.name.startswith(f"{cli}_")) == [
        f"{cli}_one", f"{cli}_two"]
    a = pd.read_csv(runs / f"{cli}_one" / "summary.csv")
    b = pd.read_csv(runs / f"{cli}_two" / "summary.csv")
    assert list(a.columns) == list(b.columns) and len(a) == len(b) == 2
    for col in a.columns:
        if "loss" in col or col == "train_lr":
            np.testing.assert_allclose(b[col], a[col], rtol=2e-5, err_msg=col)
    if cli == "train_survival":
        np.testing.assert_array_equal(b["eval_c-index"], a["eval_c-index"])
        assert np.isfinite(one["best_metric"])
    two = load_checkpoint_file(str(runs / f"{cli}_two" / "last.pth.tar"))
    ref = load_checkpoint_file(str(runs / f"{cli}_one" / "last.pth.tar"))
    assert set(two["optimizer"]["state"]["mu"]) == set(ref["optimizer"]["state"]["mu"])


def test_sigterm_to_one_rank_stops_both_at_the_same_batch(cohort, tmp_path):
    argv = _pretrain_argv(cohort, "preempted", *TINY_MIRROR, "--epochs", "200", "--no-val")
    procs, logs = [], [tmp_path / f"rank{r}.log" for r in range(2)]
    for r in range(2):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "mirror_tpu_torch.train_mirror", *argv],
                env=worker.rank_env(r, 2, tmp_path / "rdv", LAUNCH_S), stdout=log,
                stderr=subprocess.STDOUT))
    try:
        deadline = time.monotonic() + LAUNCH_S
        while "Train:" not in logs[1].read_text():
            assert time.monotonic() < deadline and procs[1].poll() is None, logs[1].read_text()
            time.sleep(0.02)
        procs[1].send_signal(signal.SIGTERM)
        codes = [p.wait(timeout=LAUNCH_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    texts = [p.read_text() for p in logs]
    assert codes == [0, 0], texts
    stops = [[ln.split("WARNING ")[-1] for ln in t.splitlines() if "preemption:" in ln]
             for t in texts]
    assert stops[0] == stops[1] and stops[0], stops
    assert '"preempted": true' in texts[0]
    run_dir = cohort / "runs" / "pretrain" / "preempted"
    assert sorted(p.name for p in run_dir.glob("*.pth.tar")) == ["recovery.pth.tar"]


def test_resume_in_two_ranks_with_zero1_and_dropout_is_bit_for_bit(cohort, tmp_path):
    """2 ranks, ZeRO-1 on and dropout live: 2 epochs straight against 1 epoch
    and ``--resume`` from its ``last.pth.tar`` (the optimizer's state
    re-partitioned, the step generator's state restored on every rank): the
    same weights, moments and generator state."""
    common = ["--optimizer-sharding", "--model-kwargs", *TINY_MIRROR, "wsi_dropout=0.1",
              "rna_proj_drop_rate=0.1"]
    straight = _two_ranks_started(tmp_path, train_mirror,
                                  _pretrain_argv(cohort, "zero_straight", *common), "straight")
    first = _two_ranks(tmp_path, train_mirror, _pretrain_argv(
        cohort, "zero_resumed", *common, "--epochs", "1"), "first")
    assert first and straight()
    runs = cohort / "runs" / "pretrain"
    _two_ranks(tmp_path, train_mirror, _pretrain_argv(
        cohort, "zero_resumed", *common, "--resume",
        str(runs / "zero_resumed" / "last.pth.tar")), "second")
    a = load_checkpoint_file(str(runs / "zero_straight" / "last.pth.tar"))
    b = load_checkpoint_file(str(runs / "zero_resumed" / "last.pth.tar"))
    assert a["epoch"] == b["epoch"] == 1 and a["step"] == b["step"] == 4
    for key, value in a["state_dict"].items():
        assert torch.equal(b["state_dict"][key], value), key
    for name, bufs in a["optimizer"]["state"].items():
        for key, value in bufs.items():
            assert torch.equal(b["optimizer"]["state"][name][key], value), (name, key)
    assert torch.equal(a["rng_state"], b["rng_state"])


@pytest.mark.parametrize("cli,message", [
    ("train_mirror", r"batch_size 3 must divide over the data axis \(2 shards\)"),
    ("train_survival", r"batch_size 3 must divide over the data axis \(2\) \(cannot shrink"),
])
def test_a_batch_that_does_not_divide_over_the_ranks_is_refused(cohort, tmp_path, cli,
                                                                message):
    module, _, argv_of = CLIS[cli]
    with pytest.raises(RuntimeError) as failed:
        _two_ranks(tmp_path, module, argv_of(cohort, "indivisible") + ["--batch-size", "3"],
                   cli)
    assert len(re.findall(message, str(failed.value))) == 2


@pytest.mark.parametrize("flag,item", [(["--model-parallel", "2"], 16),
                                       (["--ckpt-format", "orbax"], 17)])
@pytest.mark.parametrize("cli", ["train_mirror", "train_pretrain", "train_subtyping",
                                 "train_survival"])
def test_the_still_unported_flags_are_refused_in_every_cli(cohort, cli, flag, item):
    """``--ckpt-format orbax`` (item 17) is refused as a departure on
    purpose, naming the JAX package's tool that makes an Orbax directory;
    ``--model-parallel 2`` (item 16, ported) is refused in one process,
    naming the world size it needs."""
    module = {"train_subtyping": train_subtyping}.get(cli) or CLIS[cli][0]
    argv = _survival_argv(cohort, "refused", *flag)
    if cli == "train_subtyping":  # the survival YAML's loss is not subtyping's
        argv = argv[:argv.index("--survival-csv")] + ["--classes", "A", "B", "--loss",
                                                      "ce_loss"] + \
            argv[argv.index("--survival-csv") + 2:]
    elif cli != "train_survival":
        argv = _pretrain_argv(cohort, "refused", *flag)
    message = r"--ckpt-format orbax: .*import_torch_checkpoint .*--format orbax" if item == 17 \
        else r"--model-parallel 2: tensor parallelism needs a world size that is a multiple of 2 \(this run has 1 process\)"
    with pytest.raises(SystemExit, match=message):
        module.main(argv)


def test_distributed_and_optimizer_sharding_are_accepted(cohort, tmp_path, monkeypatch):
    """``--distributed`` with a one-rank group (DDP, the group's collectives)
    and ``--optimizer-sharding`` in one process train, bit for bit the
    plain run."""
    argv = partial(_pretrain_argv, cohort)
    train_mirror.main(argv("plain", *TINY_MIRROR))
    train_mirror.main(argv("sharded", *TINY_MIRROR, "--optimizer-sharding"))
    monkeypatch.setenv("MIRROR_COORDINATOR", f"file://{tmp_path / 'rdv'}")
    monkeypatch.setenv("MIRROR_NUM_PROCESSES", "1")
    monkeypatch.setenv("MIRROR_PROCESS_ID", "0")
    monkeypatch.setenv("MIRROR_DIST_TIMEOUT", "60")
    train_mirror.main(argv("one_rank", *TINY_MIRROR, "--distributed"))
    assert not torch.distributed.is_initialized()  # the run's group is gone with it
    runs = cohort / "runs" / "pretrain"
    ref = load_checkpoint_file(str(runs / "plain" / "last.pth.tar"))
    summary = pd.read_csv(runs / "plain" / "summary.csv")
    for name in ("sharded", "one_rank"):
        got = load_checkpoint_file(str(runs / name / "last.pth.tar"))
        for key, value in ref["state_dict"].items():
            assert torch.equal(got["state_dict"][key], value), f"{name} {key}"
        pd.testing.assert_frame_equal(pd.read_csv(runs / name / "summary.csv"), summary)


def test_distributed_without_a_rendezvous_names_the_env_contracts(cohort):
    with pytest.raises(SystemExit, match="MIRROR_COORDINATOR"):
        train_mirror.main(_pretrain_argv(cohort, "no_env", *TINY_MIRROR, "--distributed"))
    args, _ = config.parse_args(["--distributed", "--optimizer-sharding"])
    config.refuse_unported(args)  # both flags are the port's now


def test_the_parallel_modules_and_chip_smoke_import_no_jax():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'mirror_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import mirror_tpu_torch.parallel.distributed, mirror_tpu_torch.parallel.worker\n"
        "import mirror_tpu_torch.parallel.tensor_parallel\n"
        "import mirror_tpu_torch.train_mirror, mirror_tpu_torch.train_pretrain\n"
        "import mirror_tpu_torch.train_subtyping, mirror_tpu_torch.train_survival\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        lines = [ln.strip() for ln in f]
    assert not [ln for ln in lines if ln.startswith(("import jax", "from jax", "import mirror_tpu ",
                                                      "from mirror_tpu ", "from mirror_tpu."))]
