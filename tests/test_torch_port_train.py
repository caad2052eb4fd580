"""The port's MIRROR, loss and train step against the JAX package's, fp32 on
the CPU.

Same weights (the flax params carried over by ``state_dict_from_jax``), the
same inputs, and the same stochastic draws: the token / scalar masking
noise and the VAE eps are made with numpy and injected into both (flax:
the recipe of tests/test_torch_parity.py, patching ``random_token_masking``
with the rank mask of the noise and ``MIRROR.reparameterize`` with the eps;
the port: its ``noise`` argument). The flax side runs the dense path
(``use_pallas=False``) with ``pinv_grad="implicit"``; the port's CPU path is
its plain path with the same implicit pinv gradient.

Bars: the 15 outputs within 1e-5 of each output's scale, the 6 loss terms
within 2e-5 relative, per-leaf gradient cosine >= 0.9999 with norms within
1e-3; a 3-step trajectory of the two train steps (dropout 0 on both sides)
with per-step losses within 2e-5 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mirror_tpu.losses.mirror_loss import MirrorLossWeights as JaxWeights
from mirror_tpu.losses.mirror_loss import mirror_loss as jax_mirror_loss
from mirror_tpu.models import mirror as mirror_mod
from mirror_tpu.models import transmil as transmil_mod
from mirror_tpu.tools.import_torch_checkpoint import to_torch_state_dict
from mirror_tpu.train.optim import make_optimizer as jax_make_optimizer
from mirror_tpu.train.optim import make_schedule
from mirror_tpu.train.state import create_train_state
from mirror_tpu.train.steps import make_mirror_train_step as jax_make_step
from mirror_tpu_torch.convert import state_dict_from_jax
from mirror_tpu_torch.losses import MirrorLossWeights, mirror_loss
from mirror_tpu_torch.models import MIRROR
from mirror_tpu_torch.train.checkpoint import to_tensors
from mirror_tpu_torch.train.optim import make_optimizer
from mirror_tpu_torch.train.steps import make_mirror_train_step

B = 2
WSI_IN, RNA_IN, E = 40, 100, 24
N_TOK = 30  # side 6, 6 wrap-padded tokens, 37 rows (pad 11); decoder 31 rows (pad 5)
STYLE_HID, STYLE_OUT, LATENT, PROTO = 32, 20, 16, 37
WSI_RATIO, RNA_RATIO = 0.75, 0.5
MODEL_KW = dict(wsi_embed_dim=WSI_IN, rna_embed_dim=RNA_IN, embed_dim=E,
                wsi_num_tokens=N_TOK, style_mlp_hidden_dim=STYLE_HID,
                style_mlp_out_dim=STYLE_OUT, style_latent_dim=LATENT,
                num_prototypes=PROTO)
OUTPUT_NAMES = list(mirror_mod.MirrorOutput._fields)
LOSS_NAMES = ["total", "alignment", "wsi_retention", "rna_retention", "style", "cluster"]


def _rank_mask(noise: np.ndarray, mask_ratio: float) -> np.ndarray:
    len_keep = int(noise.shape[1] * (1 - mask_ratio))
    return (np.argsort(np.argsort(noise, axis=1), axis=1) >= len_keep).astype(np.float32)


def _draws(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return dict(
        wsi=rng.standard_normal((B, N_TOK, WSI_IN)).astype(np.float32),
        rna=rng.standard_normal((B, RNA_IN)).astype(np.float32),
        wsi_noise=rng.random((B, N_TOK)).astype(np.float32),
        rna_noise=rng.random((B, E)).astype(np.float32),
        wsi_eps=rng.standard_normal((B, LATENT)).astype(np.float32),
        rna_eps=rng.standard_normal((B, LATENT)).astype(np.float32),
    )


def _noise(d) -> dict:
    return {k: torch.from_numpy(d[k]) for k in ("wsi_noise", "rna_noise", "wsi_eps", "rna_eps")}


_INJECT: dict = {}


def _patch_flax(mp, no_dropout: bool):
    """Pin the flax model's masking and VAE draws to _INJECT's arrays."""
    mp.setattr(transmil_mod, "random_token_masking",
               lambda key, batch, num_tokens, ratio: _INJECT["masks"][num_tokens])

    def fixed_reparam(self, mu, logstd, rng):
        eps = _INJECT["eps"][_INJECT["i"] % 2]
        _INJECT["i"] += 1
        return mu + jnp.exp(0.5 * logstd) * eps.astype(mu.dtype)

    mp.setattr(mirror_mod.MIRROR, "reparameterize", fixed_reparam)
    if no_dropout:
        real = transmil_mod.NystromAttention
        mp.setattr(transmil_mod, "NystromAttention", lambda **kw: real(**{**kw, "dropout": 0.0}))


def _inject(d):
    _INJECT.update(masks={N_TOK: jnp.asarray(_rank_mask(d["wsi_noise"], WSI_RATIO)),
                          E: jnp.asarray(_rank_mask(d["rna_noise"], RNA_RATIO))},
                   eps=[jnp.asarray(d["wsi_eps"]), jnp.asarray(d["rna_eps"])], i=0)


def _flax_model(**extra):
    return mirror_mod.MIRROR(**MODEL_KW, pinv_grad="implicit", **extra)


def _init(model, d):
    rngs = dict(zip(["params", "dropout", "masking", "style"],
                    jax.random.split(jax.random.PRNGKey(0), 4)))
    return jax.device_get(jax.jit(model.init)(rngs, jnp.asarray(d["wsi"]),
                                              jnp.asarray(d["rna"]))["params"])


def _port_model(params, **extra) -> MIRROR:
    model = MIRROR(**MODEL_KW, **extra)
    model.load_state_dict(to_tensors(state_dict_from_jax(params)))
    return model


@pytest.fixture(scope="module")
def pair():
    d = _draws(7)
    model = _flax_model()
    mp = pytest.MonkeyPatch()
    try:
        _patch_flax(mp, no_dropout=False)
        _inject(d)
        params = _init(model, d)
        rngs = dict(zip(["dropout", "masking", "style"],
                        jax.random.split(jax.random.PRNGKey(1), 3)))

        def loss_fn(p):
            _INJECT["i"] = 0  # the draws are read while tracing
            out = model.apply({"params": p}, jnp.asarray(d["wsi"]), jnp.asarray(d["rna"]),
                              WSI_RATIO, RNA_RATIO, True, rngs=rngs)
            losses = jax_mirror_loss(*out)
            return losses[0], (out, losses)

        (_, (out_j, losses_j)), grads_j = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
    finally:
        mp.undo()

    port = _port_model(params).eval()
    out_t = port(torch.from_numpy(d["wsi"]), torch.from_numpy(d["rna"]), WSI_RATIO,
                 RNA_RATIO, noise=_noise(d))
    losses_t = mirror_loss(*out_t)
    losses_t[0].backward()
    grads_t = {k: p.grad for k, p in port.named_parameters()}
    return dict(params=params, out_j=out_j, out_t=out_t, losses_j=losses_j,
                losses_t=losses_t, grads_j=state_dict_from_jax(jax.device_get(grads_j)),
                grads_t=grads_t)


def test_state_dict_from_jax_covers_every_mirror_parameter(pair):
    """Every MIRROR leaf (retention_gene_embed, the mask tokens, logit_scale,
    the prototypes, the style Dense layers, the RNA retention blocks) maps
    to the reference key, the same as the JAX package's converter, and the
    keys are exactly the port MIRROR's."""
    ours, theirs = state_dict_from_jax(pair["params"]), to_torch_state_dict(pair["params"])
    assert list(ours) == list(theirs)
    for key in theirs:
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
    assert set(MIRROR(**MODEL_KW).state_dict()) == set(ours)
    for key in ("logit_scale", "prototypes.weight", "style_mu.weight",
                "wsi_encoder.retention_gene_embed", "wsi_encoder.mask_token",
                "rna_encoder.mask_token", "rna_encoder.retention_blocks.0.attn.proj.weight"):
        assert key in ours, key


def test_forward_matches_flax_all_15_outputs(pair):
    for name, a, b in zip(OUTPUT_NAMES, pair["out_j"], pair["out_t"]):
        a = np.asarray(a, np.float64)
        b = b.detach().numpy().astype(np.float64)
        assert a.shape == b.shape, f"{name}: {a.shape} vs {b.shape}"
        if name.endswith("mask"):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            scale = max(np.abs(a).max(), 1e-3)
            np.testing.assert_allclose(b / scale, a / scale, rtol=0, atol=1e-5, err_msg=name)


def test_loss_terms_match_flax(pair):
    for name, a, b in zip(LOSS_NAMES, pair["losses_j"], pair["losses_t"]):
        assert float(b.detach()) == pytest.approx(float(a), rel=2e-5, abs=1e-7), name


def test_gradients_match_flax(pair):
    grads_j, grads_t = pair["grads_j"], pair["grads_t"]
    assert set(grads_j) == set(grads_t)
    for key in sorted(grads_j):
        a = np.asarray(grads_j[key], np.float64).ravel()
        b = grads_t[key].detach().numpy().astype(np.float64).ravel()
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if na < 1e-12 and nb < 1e-12:
            continue
        assert float(a @ b / (na * nb)) >= 0.9999, f"{key}: cosine {a @ b / (na * nb)}"
        assert nb == pytest.approx(na, rel=1e-3), f"{key}: |g| {nb} vs {na}"


class _AdamArgs:
    """The pretrain template's optimizer: adam, lr 2e-5, no schedule."""

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


LR = 2e-5
WEIGHTS = (0.5, 0.15, 0.15, 0.1, 0.1)


def test_three_step_trajectory_matches_jax_step():
    """make_mirror_train_step + Adam of the port against the JAX package's
    make_mirror_train_step + make_optimizer: renorm, forward, loss,
    backward, update, clamp, for three steps with fresh draws each, dropout
    0 on both sides (the torch dropout masks are not injectable)."""
    steps = [_draws(100 + t) for t in range(3)]
    model = _flax_model(rna_proj_drop_rate=0.0)
    params = _init(model, steps[0])
    schedule = make_schedule(_AdamArgs, steps_per_epoch=3, base_lr=LR)
    tx = jax_make_optimizer(_AdamArgs, schedule)
    base = jax_make_step(model, tx, JaxWeights(*WEIGHTS), WSI_RATIO, RNA_RATIO)

    def step(state, batch, rng):
        _INJECT.update(masks={N_TOK: batch["wsi_mask"], E: batch["rna_mask"]},
                       eps=[batch["wsi_eps"], batch["rna_eps"]], i=0)
        return base(state, {"wsi": batch["wsi"], "rna": batch["rna"]}, rng)

    state = create_train_state(params, tx)
    jitted = jax.jit(step)
    losses_j = []
    mp = pytest.MonkeyPatch()
    try:
        _patch_flax(mp, no_dropout=True)
        for t, d in enumerate(steps):
            batch = {"wsi": d["wsi"], "rna": d["rna"], "wsi_eps": d["wsi_eps"],
                     "rna_eps": d["rna_eps"], "wsi_mask": _rank_mask(d["wsi_noise"], WSI_RATIO),
                     "rna_mask": _rank_mask(d["rna_noise"], RNA_RATIO)}
            state, metrics = jitted(state, jax.tree.map(jnp.asarray, batch),
                                    jax.random.PRNGKey(t))
            losses_j.append(float(metrics["loss"]))
    finally:
        mp.undo()

    port = _port_model(params, rna_proj_drop_rate=0.0, wsi_dropout=0.0)
    train_step = make_mirror_train_step(port, make_optimizer(_AdamArgs, port, LR),
                                        MirrorLossWeights(*WEIGHTS), WSI_RATIO, RNA_RATIO)
    losses_t = []
    for d in steps:
        metrics = train_step({"wsi": torch.from_numpy(d["wsi"]),
                              "rna": torch.from_numpy(d["rna"])}, noise=_noise(d))
        losses_t.append(float(metrics["loss"]))
    for t, (a, b) in enumerate(zip(losses_j, losses_t)):
        assert b == pytest.approx(a, rel=2e-5), f"step {t}: port {b} vs jax {a}"
    # and the parameters moved alike: logit_scale after three Adam updates
    assert port.logit_scale.item() == pytest.approx(float(state.params["logit_scale"]),
                                                    rel=1e-6)
