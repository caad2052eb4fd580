"""The compute types the port's kernels take beside bf16: float16 (``--amp-dtype
float16``) and float32 (``--no-amp``), on the CPU.

- The MIRROR train step in float16, 3 steps, against the JAX package's step
  in float16 on the same weights and draws (the recipe of
  tests/test_torch_port_train.py: the flax params carried over, the masking
  noise and VAE eps injected, dropout 0 on both sides). Neither side scales
  the loss: the JAX package has no loss scaler, so the port has none. Bar:
  per-step loss within 2e-3 relative. Both sides compute every layer in
  float16 (ulp 2^-10 = 9.8e-4 relative) with fp32 statistics and an fp32
  loss boundary, but sum in different orders, so activations land an ulp
  or two apart and the loss, a mean over many such terms, moves by a
  fraction of that; three Adam updates near sign(g) carry small gradient
  differences into the next steps.
- The float32 instances' products: the 3xTF32 split of ``csrc/attn_mma.cuh``
  emulated in numpy (tf32 rounding as ``cvt.rna``: the fp32 mantissa rounded
  to 10 bits, to nearest, ties away from zero; tf32 x tf32 products exact in
  fp32; fp32 sums). At [64, 64] the split's product is within 2e-6 relative
  (Frobenius) of the float64 product, where one TF32 pass is not: it keeps
  about three digits (a relative error near 2^-11 a product).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mirror_tpu.losses.mirror_loss import MirrorLossWeights as JaxWeights
from mirror_tpu.train.optim import make_optimizer as jax_make_optimizer
from mirror_tpu.train.optim import make_schedule
from mirror_tpu.train.state import create_train_state
from mirror_tpu.train.steps import make_mirror_train_step as jax_make_step
from mirror_tpu_torch.losses import MirrorLossWeights
from mirror_tpu_torch.train.optim import make_optimizer
from mirror_tpu_torch.train.steps import make_mirror_train_step
from test_torch_port_runctl import one_intra_op_thread  # noqa: F401 (the fixture)
from test_torch_port_train import (
    _INJECT,
    E,
    LR,
    N_TOK,
    RNA_RATIO,
    WEIGHTS,
    WSI_RATIO,
    _AdamArgs,
    _draws,
    _flax_model,
    _init,
    _noise,
    _patch_flax,
    _port_model,
    _rank_mask,
)

FP16_STEP_LOSS = 2e-3
SPLIT_BAR = 2e-6


def test_float16_train_step_matches_jax_step():
    """The port's make_mirror_train_step on a float16 MIRROR (the model
    kwargs of --amp-dtype float16) against the JAX step on the flax MIRROR
    with dtype float16, three steps with fresh draws each."""
    steps = [_draws(200 + t) for t in range(3)]
    init_model = _flax_model(rna_proj_drop_rate=0.0)
    params = _init(init_model, steps[0])  # fp32 parameters, as both packages keep them
    model = _flax_model(rna_proj_drop_rate=0.0, dtype=jnp.float16)
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

    port = _port_model(params, rna_proj_drop_rate=0.0, wsi_dropout=0.0, dtype=torch.float16)
    assert all(p.dtype == torch.float32 for p in port.parameters())
    train_step = make_mirror_train_step(port, make_optimizer(_AdamArgs, port, LR),
                                        MirrorLossWeights(*WEIGHTS), WSI_RATIO, RNA_RATIO)
    losses_t = []
    for d in steps:
        metrics = train_step({"wsi": torch.from_numpy(d["wsi"]),
                              "rna": torch.from_numpy(d["rna"])}, noise=_noise(d))
        losses_t.append(float(metrics["loss"]))
    assert all(np.isfinite(losses_t))
    for t, (a, b) in enumerate(zip(losses_j, losses_t)):
        assert b == pytest.approx(a, rel=FP16_STEP_LOSS), f"step {t}: port {b} vs jax {a}"


def _tf32(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: the fp32 mantissa rounded to 10 bits, to nearest,
    ties away from zero (half of the dropped 13 bits added to the magnitude,
    then the 13 bits cleared)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split_3xtf32_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """attn_mma.cuh's float32 product: hi = tf32(x), lo = tf32(x - hi) for
    each operand, a b = a_lo b_hi + a_hi b_lo + a_hi b_hi (a_lo b_lo
    dropped), each tf32 product exact in fp32 and summed in fp32."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    out = np.matmul(a_lo, b_hi, dtype=np.float32)
    out += np.matmul(a_hi, b_lo, dtype=np.float32)
    out += np.matmul(a_hi, b_hi, dtype=np.float32)
    return out


def _rel(x: np.ndarray, ref: np.ndarray) -> float:
    return float(np.linalg.norm(x.astype(np.float64) - ref) / np.linalg.norm(ref))


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = np.array([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                  -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12], np.float32)
    want = np.array([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                     -(1.0 + 2.0 ** -10), 1.0], np.float32)  # ties away from zero
    np.testing.assert_array_equal(_tf32(x), want)
    hi = _tf32(x)
    assert np.all(_tf32(hi) == hi)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_3xtf32_split_product_is_float32_accurate(seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((64, 64)).astype(np.float32)
    b = rng.standard_normal((64, 64)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    split = _rel(_split_3xtf32_matmul(a, b), ref)
    one_pass = _rel(np.matmul(_tf32(a), _tf32(b), dtype=np.float32), ref)
    assert split <= SPLIT_BAR, f"3xTF32 relative error {split}"
    assert one_pass > SPLIT_BAR, f"one TF32 pass {one_pass} is within the bar"
    # and within a small factor of a plain fp32 product
    assert split <= 4 * _rel(np.matmul(a, b, dtype=np.float32), ref) + 1e-7
