"""The port's tensor parallelism (``--model-parallel N``,
``parallel/tensor_parallel.py``) on the CPU, against the JAX package's on a
(data, model) CPU mesh; and the plain path's conv weight gradient.

Without a spawn:

- the plain conv (``ops/conv1d.py::depthwise_conv_seq_plain``, the CPU
  ``res_conv`` of ``NystromAttention`` and of the context-parallel core):
  dkern at v [1, 4, 256, 8] and [1, 8, 256, 96], K 33, against a float64
  sum (relative 1e-6) and the JAX package's conv gradient;
- the port's ``param_spec`` against ``mirror_tpu.parallel.tensor_parallel.
  param_spec`` on every leaf of ``mirror``, ``mirror_dual`` and
  ``mirror_classifier`` at mp 2, 3 and 4 (the flax leaves mapped to the
  torch keys through ``to_torch_state_dict``), fallbacks included, and
  ``shard_model``'s swapped leaves equal to that set.

In ONE spawn of 4 gloo ranks for the module (``parallel/worker.py``'s
``cases``, started when the module starts, while the JAX side compiles):

- data 2 x model 2 against the JAX ``make_mirror_train_step`` on
  ``create_mesh(num_devices=4, model_parallel=2)`` with ``shard_state``
  (the recipe of ``test_torch_port_ddp.py``: dropout 0, the masking noise
  and eps injected, 3 steps; the per-step loss within 2e-5 relative, the
  last step's gradients at cosine >= 0.9999 a leaf, the weights at the
  trajectory bars) plain, with ``--clip-grad 0.5 --clip-mode norm``, with
  lamb + AGC, and the CLIP step;
- ZeRO-1 composed with mp 2, bit for bit mp 2 without it;
- data 1 x model 4 (the prototypes fall back: 38 rows) against one process
  (run in the test process, with no group);
- a live dropout at data 1 x model 4 against one process, which draws the
  same masks, within 2e-5;
- the four CLIs at ``--model-parallel 2``: their checkpoints at the one-rank
  keys and shapes, loaded by a one-rank model, train_mirror's 2 epochs
  straight against 1 + ``--resume`` bit for bit; ``--model-parallel 3`` in
  4 ranks refused by name.
"""

import os
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from mirror_tpu.losses import local_clip_loss, local_info_nce
from mirror_tpu.losses.mirror_loss import MirrorLossWeights as JaxWeights
from mirror_tpu.models import mirror as jax_mirror
from mirror_tpu.models import transmil as jax_transmil
from mirror_tpu.models.dual import MIRRORDual as JaxDual
from mirror_tpu.ops.conv1d_pallas import depthwise_conv1d_seq as jax_conv
from mirror_tpu.parallel.mesh import create_mesh, shard_batch
from mirror_tpu.parallel.tensor_parallel import param_spec as jax_param_spec
from mirror_tpu.parallel.tensor_parallel import shard_state as jax_shard_state
from mirror_tpu.tools.import_torch_checkpoint import convert_state_dict, to_torch_state_dict
from mirror_tpu.train.optim import make_optimizer as jax_make_optimizer
from mirror_tpu.train.optim import make_schedule
from mirror_tpu.train.state import create_train_state
from mirror_tpu.train.steps import make_clip_train_step as jax_clip_step
from mirror_tpu.train.steps import _apply_updates as jax_apply_updates
from mirror_tpu.train.steps import make_mirror_train_step as jax_mirror_step
from mirror_tpu_torch.convert import state_dict_from_jax
from mirror_tpu_torch.ops.conv1d import depthwise_conv_seq_plain
from mirror_tpu_torch.parallel import distributed, tensor_parallel, worker
from mirror_tpu_torch.registry import create_model
from mirror_tpu_torch.train.checkpoint import load_checkpoint_file, run_args
from test_torch_port_runctl import one_intra_op_thread  # noqa: F401 (the fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRETRAIN_YAML = os.path.join(REPO, "configs", "pretrain", "mirror.template.yaml")
SUBTYPING_YAML = os.path.join(REPO, "configs", "subtyping", "mirror.template.yaml")
SURVIVAL_YAML = os.path.join(REPO, "configs", "survival", "mirror.template.yaml")
LAUNCH_S = 240.0
WORLD = 4

# --------------------------------------------------------------------------
# the plain conv's weight gradient
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 4, 256, 8), (1, 8, 256, 96)])
def test_plain_conv_weight_gradient_matches_a_float64_sum_and_jax(shape):
    """The shapes at which autograd through torch's CPU depthwise conv2d is
    4e-2 off: the explicit backward is within 1e-6 of the float64 sum, and
    of the JAX package's conv gradient (Pallas in interpret mode)."""
    b, h, n, d = shape
    ksize = 33
    rng = np.random.default_rng(5)
    v = rng.standard_normal(shape).astype(np.float32)
    kern = (0.1 * rng.standard_normal((h, ksize))).astype(np.float32)
    t = rng.standard_normal(shape).astype(np.float32)
    vt = torch.from_numpy(v).requires_grad_()
    kt = torch.from_numpy(kern).requires_grad_()
    (depthwise_conv_seq_plain(vt, kt) * torch.from_numpy(t)).sum().backward()
    vp = np.pad(v.astype(np.float64), ((0, 0), (0, 0), (ksize // 2, ksize // 2), (0, 0)))
    want = np.stack([(t * vp[:, :, j:j + n]).sum((0, 2, 3)) for j in range(ksize)], 1)
    got = kt.grad.double().numpy()
    assert np.linalg.norm(got - want) <= 1e-6 * np.linalg.norm(want)
    _, dk = jax.grad(lambda vv, kk: jnp.sum(jax_conv(vv, kk) * t), argnums=(0, 1))(
        jnp.asarray(v), jnp.asarray(kern))
    dk = np.asarray(dk, np.float64)
    assert np.linalg.norm(got - dk) <= 1e-6 * np.linalg.norm(dk)


# --------------------------------------------------------------------------
# the rules against the JAX param_spec
# --------------------------------------------------------------------------

# widths that make some rules fall back: E 24 (divides by 2, 3, 4), the
# embedding's hidden 48, the block MLPs' int(24 * 2.572) = 61 (none), 38
# prototypes (by 2 only)
RULE_KW = dict(wsi_embed_dim=40, rna_embed_dim=100, embed_dim=24, rna_encoder_depth=2)
RULE_MODELS = {
    "mirror": dict(RULE_KW, wsi_num_tokens=30, style_mlp_hidden_dim=32, style_mlp_out_dim=20,
                   style_latent_dim=16, num_prototypes=38),
    "mirror_dual": dict(RULE_KW, rna_mlp_ratio=2.0),
    "mirror_classifier": dict(RULE_KW, num_classes=3, rna_mlp_ratio=4.0),
}


def _jax_sharded(state_dict, mp):
    """{torch key: split dim} of the JAX ``param_spec`` on the flax leaves of
    ``state_dict``, each leaf found again among ``to_torch_state_dict``'s
    keys by a marker value."""
    params, unmapped = convert_state_dict(state_dict)
    assert not unmapped, unmapped
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    markers = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(leaf), i, np.float64) for i, (_, leaf) in enumerate(flat)])
    key_of = {int(np.asarray(v).flat[0]): k for k, v in to_torch_state_dict(markers).items()}
    out = {}
    for i, (path, leaf) in enumerate(flat):
        spec = tuple(jax_param_spec(path, np.asarray(leaf), mp))
        if "model" in spec:
            axis = spec.index("model")
            out[key_of[i]] = 1 - axis if np.ndim(leaf) == 2 else axis  # [in, out] -> [out, in]
    return out


@pytest.mark.parametrize("mp", [2, 3, 4])
@pytest.mark.parametrize("name", sorted(RULE_MODELS))
def test_param_spec_matches_the_jax_rules_on_every_leaf(name, mp, monkeypatch):
    model = create_model(name, device="cpu", generator=torch.Generator().manual_seed(0),
                         **RULE_MODELS[name])
    state = model.state_dict()
    want = _jax_sharded(state, mp)
    got = {k: d for k, v in state.items()
           if (d := tensor_parallel.param_spec(k, tuple(v.shape), mp)) is not None}
    assert got == want
    if name == "mirror":
        assert "wsi_encoder.retention_head.weight" in got  # the rule, not the docstring
        assert ("prototypes.weight" in got) == (mp == 2)
    # the layers shard_model swaps hold exactly those leaves, cut to 1 / mp
    monkeypatch.setattr(distributed, "model_parallel", lambda: mp)
    monkeypatch.setattr(distributed, "model_rank", lambda: mp - 1)
    tensor_parallel.shard_model(model)
    assert tensor_parallel.sharded_dims(model) == want
    local = model.state_dict()
    for key, dim in want.items():
        assert local[key].shape[dim] * mp == state[key].shape[dim]
        assert torch.equal(local[key], state[key].chunk(mp, dim)[mp - 1])
    assert set(local) == set(state)


def test_without_a_model_axis_every_helper_is_the_identity():
    model = create_model("mirror", device="cpu", generator=torch.Generator().manual_seed(0),
                         **RULE_MODELS["mirror"])
    state = model.state_dict()
    assert tensor_parallel.shard_model(model) is model
    assert tensor_parallel.sharded_dims(model) == {}
    assert tensor_parallel.full_state_dict(model).keys() == state.keys()
    dims = {"prototypes.weight": 0}
    assert tensor_parallel.gather_state(tensor_parallel.shard_state(state, dims), dims)[
        "prototypes.weight"].shape == state["prototypes.weight"].shape
    with pytest.raises(SystemExit, match="multiple of 2 .this run has 1 process"):
        distributed.set_model_parallel(2)


# --------------------------------------------------------------------------
# the spawn: every case in 4 gloo ranks
# --------------------------------------------------------------------------

B, WSI_IN, RNA_IN, E, N_TOK = 4, 40, 100, 24, 30
LATENT, PROTO = 16, 38
WSI_RATIO, RNA_RATIO = 0.75, 0.5
WEIGHTS = (0.5, 0.15, 0.15, 0.1, 0.1)
LR = 1e-3
MIRROR_KW = dict(wsi_embed_dim=WSI_IN, rna_embed_dim=RNA_IN, embed_dim=E, wsi_num_tokens=N_TOK,
                 style_mlp_hidden_dim=32, style_mlp_out_dim=20, style_latent_dim=LATENT,
                 num_prototypes=PROTO, rna_proj_drop_rate=0.0, rna_mlp_ratio=2.0,
                 pinv_grad="implicit")
DUAL_KW = dict(wsi_embed_dim=WSI_IN, rna_embed_dim=RNA_IN, embed_dim=E, rna_encoder_depth=1,
               rna_mlp_ratio=2.0, rna_proj_drop_rate=0.0, pinv_grad="implicit")
NOISE_KEYS = ("wsi_noise", "rna_noise", "wsi_eps", "rna_eps")
JAX_ARGS = dict(opt="adam", opt_eps=None, opt_betas=None, opt_kwargs={}, momentum=0.9,
                weight_decay=0.0, clip_grad=None, clip_mode="norm", layer_decay=None,
                use_sched=False, model_ema=False, grad_accum_steps=1)
# each mirror variant: (the port's optimizer flags, the JAX args)
VARIANTS = {
    "plain": ([], {}),
    "clip": (["--clip-grad", "0.5", "--clip-mode", "norm"], dict(clip_grad=0.5)),
    "lamb_agc": (["--opt", "lamb", "--clip-grad", "0.01", "--clip-mode", "agc",
                  "--weight-decay", "0.05"],
                 dict(opt="lamb", clip_grad=0.01, clip_mode="agc", weight_decay=0.05)),
}
_INJECT: dict = {}

N_SLIDES, FEAT, RNA_COLS = 16, 40, 50
TINY = ["wsi_embed_dim=40", "embed_dim=24", "rna_encoder_depth=1", "wsi_dropout=0.0",
        "rna_proj_drop_rate=0.0", "rna_mlp_ratio=2.0"]
TINY_MIRROR = ["wsi_num_tokens=30", "style_mlp_hidden_dim=32", "style_mlp_out_dim=20",
               "style_latent_dim=16", "num_prototypes=38"]


def _steps(seed, n=3):
    rng = np.random.default_rng(seed)
    return [dict(wsi=rng.standard_normal((B, N_TOK, WSI_IN)).astype(np.float32),
                 rna=rng.standard_normal((B, RNA_IN)).astype(np.float32),
                 wsi_noise=rng.random((B, N_TOK)).astype(np.float32),
                 rna_noise=rng.random((B, E)).astype(np.float32),
                 wsi_eps=rng.standard_normal((B, LATENT)).astype(np.float32),
                 rna_eps=rng.standard_normal((B, LATENT)).astype(np.float32)) for _ in range(n)]


def _mirror_case(steps, model_parallel=2, **extra):
    case = dict(model="mirror", model_kwargs=dict(MIRROR_KW, wsi_dropout=0.0), device="cpu",
                seed=0, step="mirror", negatives="local", lr=LR, loss_weights=WEIGHTS,
                mask_ratios=(WSI_RATIO, RNA_RATIO), model_parallel=model_parallel,
                dump=("weights", "grads"),
                batches=[{k: torch.from_numpy(d[k]) for k in ("wsi", "rna")} for d in steps],
                noise=[{k: torch.from_numpy(d[k]) for k in NOISE_KEYS} for d in steps])
    case.update(extra)
    return case


def _clip_batches():
    rng = np.random.default_rng(41)
    return [{"wsi": rng.standard_normal((B, N_TOK, WSI_IN)).astype(np.float32),
             "rna": rng.standard_normal((B, RNA_IN)).astype(np.float32)} for _ in range(3)]


def _cohort(root):
    """16 slides of 10-60 fp16 patches (flat, and in two class folders), an
    RNA CSV, a survival CSV, a pretrain split and 3 downstream folds."""
    rng = np.random.default_rng(19)
    ids = [f"TCGA-TP-{i:04d}-01Z-00-DX1" for i in range(N_SLIDES)]
    for sub in ("feats", "classes/A", "classes/B", "splits", "folds"):
        (root / sub).mkdir(parents=True)
    for i, sid in enumerate(ids):
        feats = rng.standard_normal((int(rng.integers(10, 61)), FEAT)).astype(np.float16)
        np.save(root / "feats" / f"{sid}.npy", feats)
        np.save(root / "classes" / "AB"[i % 2] / f"{sid}.npy", feats)
    pd.DataFrame(rng.standard_normal((N_SLIDES, RNA_COLS)).astype(np.float32),
                 index=[s[:15] for s in ids],
                 columns=[f"gene_{j}" for j in range(RNA_COLS)]).to_csv(root / "rna.csv")
    patients = [s[:12] for s in ids]
    pd.DataFrame({"train": pd.Series(patients[:8]), "val": pd.Series(patients[8:12])}).to_csv(
        root / "splits" / "splits_0.csv")
    pd.DataFrame({
        "Patient ID": patients, "Sample ID": [s[:15] for s in ids],
        "Overall Survival (Months)": np.round(rng.uniform(1, 100, N_SLIDES), 2),
        "Overall Survival Status": ["0:LIVING" if i % 4 == 1 else "1:DECEASED"
                                    for i in range(N_SLIDES)],
    }).to_csv(root / "survival.csv", index=False)
    for fold in range(3):
        val = patients[fold::3]
        pd.DataFrame({"train": pd.Series([p for p in patients if p not in val]),
                      "val": pd.Series(val)}).to_csv(root / "folds" / f"splits_{fold}.csv")


def _cli_argv(root, cli, experiment, *extra):
    common = ["--rna-feature-csv", str(root / "rna.csv"), "--output", str(root / "runs"),
              "--experiment", experiment, "--epochs", "1", "--batch-size", "4",
              "--num-wsi-feature-tokens", "30", "--workers", "1", "--log-interval", "1",
              "--device", "cpu", "--no-amp", "--model-parallel", "2"]
    if cli in ("train_mirror", "train_pretrain"):
        argv = ["--config", PRETRAIN_YAML, "--wsi-feature-dir", str(root / "feats"),
                "--split-dir", str(root / "splits"), "--contrastive-negatives", "global",
                *common, "--model-kwargs", *TINY]
        argv += TINY_MIRROR if cli == "train_mirror" else []
    elif cli == "train_subtyping":
        argv = ["--config", SUBTYPING_YAML, "--wsi-feature-dir", str(root / "classes"),
                "--classes", "A", "B", "--split-dir", str(root / "folds"), *common,
                "--model-kwargs", *TINY]
    else:
        argv = ["--config", SURVIVAL_YAML, "--wsi-feature-dir", str(root / "feats"),
                "--survival-csv", str(root / "survival.csv"), "--split-dir",
                str(root / "folds"), *common, "--model-kwargs", *TINY]
    return argv + list(extra)


CLIS = ("train_mirror", "train_pretrain", "train_subtyping", "train_survival")
CLI_TASK = {"train_mirror": "pretrain", "train_pretrain": "pretrain_clip",
            "train_subtyping": "subtyping", "train_survival": "survival"}


@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    """The cases, their spec, and the one spawn of 4 ranks, started."""
    root = tmp_path_factory.mktemp("tp")
    _cohort(root)
    steps, drop_steps = _steps(100), _steps(7)
    names, cases = [], []

    def add(name, case):
        names.append(name)
        cases.append(case)

    for variant, (argv, _) in VARIANTS.items():
        add(variant, _mirror_case(steps, argv=argv))
    add("clip_step", dict(model="mirror_dual", model_kwargs=dict(DUAL_KW, wsi_dropout=0.0),
                          device="cpu", seed=0, step="clip", negatives="local", lr=LR,
                          temperature=0.1, model_parallel=2, dump=("weights", "grads"),
                          batches=[{k: torch.from_numpy(v) for k, v in b.items()}
                                   for b in _clip_batches()]))
    add("zero1", _mirror_case(steps, argv=["--optimizer-sharding"]))
    add("mp4", _mirror_case(steps, model_parallel=4))
    live = dict(model_kwargs=dict(MIRROR_KW, wsi_dropout=0.1, rna_proj_drop_rate=0.1),
                generator_seed=5, noise=None)
    add("dropout_mp4", _mirror_case(drop_steps, model_parallel=4, **live))
    for cli in CLIS:
        add(cli, dict(cli=f"mirror_tpu_torch.{cli}", argv=_cli_argv(root, cli, f"{cli}_tp")))
    add("straight", dict(cli="mirror_tpu_torch.train_mirror", argv=_cli_argv(
        root, "train_mirror", "straight", "--epochs", "2", "--no-val")))
    add("first", dict(cli="mirror_tpu_torch.train_mirror", argv=_cli_argv(
        root, "train_mirror", "resumed", "--no-val")))
    add("second", dict(cli="mirror_tpu_torch.train_mirror", argv=_cli_argv(
        root, "train_mirror", "resumed", "--epochs", "2", "--no-val", "--resume",
        str(root / "runs" / "pretrain" / "resumed" / "last.pth.tar"))))
    add("refused", dict(cli="mirror_tpu_torch.train_mirror", argv=_cli_argv(
        root, "train_mirror", "refused", "--model-parallel", "3")))
    spec = root / "spec.pt"
    torch.save(dict(device="cpu", cases=cases), spec)
    wait = worker.start(spec, root / "out", WORLD, root / "rdv", LAUNCH_S)
    outputs = {}

    def ranks():
        """Every rank's {case name: output}, the spawn awaited once."""
        if not outputs:
            outputs["ranks"] = [dict(zip(names, o["cases"])) for o in wait()]
        return outputs["ranks"]

    alone = {}

    def one_process(name):
        """A case's output in the test process, with no group: one process
        holding the whole model."""
        if name not in alone:
            alone[name] = worker.run(cases[names.index(name)], torch.device("cpu"))
        return alone[name]

    yield SimpleNamespace(root=root, steps=steps, ranks=ranks, one_process=one_process)
    ranks()  # the spawn ends before the module's tmp dir goes


# --------------------------------------------------------------------------
# the JAX side on the (data 2, model 2) mesh
# --------------------------------------------------------------------------

def _capturing():
    """A transformation that leaves the weights where they are and keeps
    the raw gradient of its last update in its state."""
    def init(params):
        return jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree.map(jnp.zeros_like, grads), grads

    return optax.GradientTransformation(init, update)


def _rank_mask(noise, ratio):
    keep = int(noise.shape[1] * (1 - ratio))
    return (np.argsort(np.argsort(noise, axis=1), axis=1) >= keep).astype(np.float32)


def _seeded_params(name, **kw):
    model = create_model(name, device="cpu", generator=torch.Generator().manual_seed(0), **kw)
    params, unmapped = convert_state_dict(model.state_dict())
    assert not unmapped, unmapped
    return jax.tree.map(jnp.asarray, params)


def _no_dropout(mp):
    real = jax_transmil.NystromAttention
    mp.setattr(jax_transmil, "NystromAttention", lambda **kw: real(**{**kw, "dropout": 0.0}))


def jax_trajectories(steps, mesh, variants=tuple(VARIANTS), clip_step=True):
    """{variant: (per-step losses, final weights, last step's gradients)} of
    the JAX steps on ``mesh`` for the mirror ``variants`` and the CLIP
    step. The mirror step compiles once for every variant: it runs with
    :func:`_capturing` as its optimizer, and each variant's chain then
    updates the weights it renormed by the JAX step's own ``_apply_updates``
    (a program of a few elementwise ops)."""
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax_transmil, "random_token_masking",
                   lambda key, batch, num_tokens, ratio: _INJECT["masks"][num_tokens])

        def fixed_reparam(self, mu, logstd, rng):
            eps = _INJECT["eps"][_INJECT["i"] % 2]
            _INJECT["i"] += 1
            return mu + jnp.exp(0.5 * logstd) * eps.astype(mu.dtype)

        mp.setattr(jax_mirror.MIRROR, "reparameterize", fixed_reparam)
        _no_dropout(mp)
        params = _seeded_params("mirror", **dict(MIRROR_KW, wsi_dropout=0.0))
        capture = _capturing()
        base = jax_mirror_step(jax_mirror.MIRROR(**MIRROR_KW), capture, JaxWeights(*WEIGHTS),
                               WSI_RATIO, RNA_RATIO,
                               alignment_loss_fn=partial(local_clip_loss, mesh=mesh))

        def grad_step(state, batch, rng):
            _INJECT.update(masks={N_TOK: batch["wsi_mask"], E: batch["rna_mask"]},
                           eps=[batch["wsi_eps"], batch["rna_eps"]], i=0)
            return base(state, {"wsi": batch["wsi"], "rna": batch["rna"]}, rng)

        grad_step = jax.jit(grad_step)
        batches = [shard_batch(mesh, {
            "wsi": d["wsi"], "rna": d["rna"], "wsi_eps": d["wsi_eps"], "rna_eps": d["rna_eps"],
            "wsi_mask": _rank_mask(d["wsi_noise"], WSI_RATIO),
            "rna_mask": _rank_mask(d["rna_noise"], RNA_RATIO)}) for d in steps]
        for variant in variants:
            args = SimpleNamespace(**dict(JAX_ARGS, **VARIANTS[variant][1]))
            tx = jax_make_optimizer(args, make_schedule(args, 3, LR))
            update = jax.jit(partial(jax_apply_updates, tx=tx, ema_decay=None))
            state = jax_shard_state(mesh, create_train_state(params, tx))
            losses = []
            for t, batch in enumerate(batches):
                probe = jax_shard_state(mesh, create_train_state(state.params, capture))
                probe, metrics = grad_step(probe, batch, jax.random.PRNGKey(t))
                losses.append(float(metrics["loss"]))
                state = update(state.replace(params=probe.params), probe.opt_state)
            out[variant] = (losses, state_dict_from_jax(jax.device_get(state.params)),
                            state_dict_from_jax(jax.device_get(probe.opt_state)))
        if clip_step:
            args = SimpleNamespace(**JAX_ARGS)
            tx = _recording(jax_make_optimizer(args, make_schedule(args, 3, LR)))
            step = jax.jit(jax_clip_step(JaxDual(**DUAL_KW), tx, temperature=0.1,
                                         contrastive_loss_fn=partial(
                                             local_info_nce, mesh=mesh, temperature=0.1)))
            state = jax_shard_state(mesh, create_train_state(
                _seeded_params("mirror_dual", **dict(DUAL_KW, wsi_dropout=0.0)), tx))
            losses = []
            for t, b in enumerate(_clip_batches()):
                state, m = step(state, shard_batch(mesh, b), jax.random.PRNGKey(t))
                losses.append(float(m["loss"]))
            out["clip_step"] = (losses, state_dict_from_jax(jax.device_get(state.params)),
                                state_dict_from_jax(jax.device_get(state.opt_state[0])))
    finally:
        mp.undo()
    return out


def _recording(tx):
    """``tx`` with the raw gradient of its last update kept in its state."""
    def init(params):
        return (jax.tree.map(jnp.zeros_like, params), tx.init(params))

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[1], params)
        return updates, (grads, inner)

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def jax_runs(spawn):
    mesh = create_mesh(num_devices=4, model_parallel=2)
    assert dict(zip(mesh.axis_names, mesh.devices.shape)) == {"data": 2, "model": 2}
    return jax_trajectories(spawn.steps, mesh)


def _cosines_and_norms(got, want, what, cos=0.9999, rel=1e-4):
    """The trajectory tests' bars: cosine >= ``cos`` a leaf, norms within
    ``rel``."""
    assert set(got) >= set(want), sorted(set(want) - set(got))
    for key in sorted(want):
        a = np.asarray(want[key], np.float64).ravel()
        b = got[key].detach().double().numpy().ravel()
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        assert nb == pytest.approx(na, rel=rel, abs=1e-9), f"{what} {key}: |x| {nb} vs {na}"
        if na > 1e-12:
            assert float(a @ b / (na * nb)) >= cos, f"{what} {key}"


def _same_bits_on_every_rank(outs, case):
    assert len({o[case]["init_digest"] for o in outs}) == 1
    for t in range(len(outs[0][case]["digests"])):
        assert len({o[case]["digests"][t] for o in outs}) == 1, f"{case}: ranks differ at {t}"


@pytest.mark.parametrize("variant", sorted(VARIANTS) + ["clip_step"])
def test_data2_model2_matches_the_jax_step_on_a_2x2_mesh(spawn, jax_runs, variant):
    losses_j, weights_j, grads_j = jax_runs[variant]
    outs = spawn.ranks()
    _same_bits_on_every_rank(outs, variant)
    for t, want in enumerate(losses_j):
        for out in outs:
            assert out[variant]["metrics"][t]["loss"] == pytest.approx(want, rel=2e-5), \
                f"step {t}"
    got = outs[0][variant]
    _cosines_and_norms(got["grads"], grads_j, "gradient", rel=1e-3)
    _cosines_and_norms(got["weights"], weights_j, "weights")
    # each rank held a half of the sharded leaves only
    whole = sum(np.asarray(v).size * 4 for v in weights_j.values())
    assert got["param_bytes"] < whole


def test_zero1_composed_with_model_parallel_is_bit_for_bit(spawn):
    outs = spawn.ranks()
    for out in outs:
        assert out["zero1"]["digests"] == out["plain"]["digests"]
        assert out["zero1"]["optimizer_bytes"] < out["plain"]["optimizer_bytes"]


def test_model_parallel_4_with_a_fallback_matches_one_rank(spawn):
    outs = spawn.ranks()
    _same_bits_on_every_rank(outs, "mp4")
    one = spawn.one_process("mp4")
    for t, m in enumerate(outs[0]["mp4"]["metrics"]):
        assert m["loss"] == pytest.approx(one["metrics"][t]["loss"], rel=2e-5), f"step {t}"
    _cosines_and_norms(outs[0]["mp4"]["weights"], {k: v.numpy()
                                                   for k, v in one["weights"].items()}, "mp4")
    assert PROTO % 4 and tensor_parallel.param_spec("prototypes.weight", (PROTO, E), 4) is None


def test_live_dropout_at_model_parallel_4_draws_what_one_process_draws(spawn):
    """Each model rank draws the whole width's mask from the data rank's
    stream and keeps its slice: one process, holding the whole width, draws
    the same masks."""
    outs = spawn.ranks()
    _same_bits_on_every_rank(outs, "dropout_mp4")
    one = spawn.one_process("dropout_mp4")
    for t, m in enumerate(outs[0]["dropout_mp4"]["metrics"]):
        assert m["loss"] == pytest.approx(one["metrics"][t]["loss"], rel=2e-5), f"step {t}"
    _cosines_and_norms(outs[0]["dropout_mp4"]["weights"],
                       {k: v.numpy() for k, v in one["weights"].items()}, "dropout")


@pytest.mark.parametrize("cli", CLIS)
def test_model_parallel_2_runs_in_every_cli(spawn, cli):
    """4 ranks at data 2 x model 2: one result, and a checkpoint at the
    one-rank keys and shapes that a one-rank model loads as it is."""
    outs = spawn.ranks()
    result = outs[0][cli]["result"]
    assert result["best_metric"] is not None and np.isfinite(result["best_metric"])
    payload = load_checkpoint_file(str(spawn.root / "runs" / CLI_TASK[cli] / f"{cli}_tp" /
                                       "last.pth.tar"))
    one = create_model(payload["arch"], device="cpu", **run_args(payload)["model_kwargs"])
    want = {k: tuple(v.shape) for k, v in one.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in payload["state_dict"].items()} == want
    one.load_state_dict(payload["state_dict"])
    if "optimizer" in payload:
        for name, buf in payload["optimizer"]["state"]["mu"].items():
            assert tuple(buf.shape) == want[name], name


def test_resume_at_model_parallel_2_is_bit_for_bit(spawn):
    spawn.ranks()
    runs = spawn.root / "runs" / "pretrain"
    a = load_checkpoint_file(str(runs / "straight" / "last.pth.tar"))
    b = load_checkpoint_file(str(runs / "resumed" / "last.pth.tar"))
    assert a["epoch"] == b["epoch"] == 1 and a["step"] == b["step"]
    for key, value in a["state_dict"].items():
        assert torch.equal(b["state_dict"][key], value), key
    for name, bufs in a["optimizer"]["state"].items():
        for key, value in bufs.items():
            assert torch.equal(b["optimizer"]["state"][name][key], value), (name, key)
    assert torch.equal(a["rng_state"], b["rng_state"])


def test_model_parallel_that_does_not_divide_the_ranks_is_refused(spawn):
    for out in spawn.ranks():
        assert "--model-parallel 3" in out["refused"]["refused"]
        assert "multiple of 3 (this run has 4 processes)" in out["refused"]["refused"]
