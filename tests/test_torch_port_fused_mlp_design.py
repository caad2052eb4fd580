"""The fused MLP sub-layer's order of work (``csrc/vit_fused.cu``, k7 and
k9), emulated in plain torch on the CPU and held against the TPU script's
kernels and the port's plain versions.

The emulation follows the kernel: the flattened [b n, d] rows in tiles of
64, a quad of CTAs walking ceil(G n / 64) consecutive tiles, two quads a
cluster (``kQuads``; rows past the end zero-filled, as the TMA map fills
them, and never stored; tiles wholly past the end never stored); k9's LN
once per row of the resident tile (the mean, then the mean of the squared
deviations, fp32) and y rounded once; each 128-column hidden chunk (chunk
q of the quad's sequence taken by fc1 CTA q % 2, warpgroup q / 2 % 3) as
fc1 summed over K steps of 64 in fp32 (y and W_1 zero past d, W_1 past
m), b_1 and the erf GELU in fp32, zeros past m, one rounding; fc2 (each
fc2 CTA 384 output columns, 128 a warpgroup) summed over the chunks in
order and within a chunk over K steps of 32 (at most m), in fp32; then b_2
(and x) added in fp32 and one rounding.

The script ``scripts/exp_vit_fused_sublayer.py`` is loaded by path, its
module constants set small with ``monkeypatch`` and its ``pallas_call``s
run in interpret mode, as ``test_torch_port_vit_fused.py`` runs it; the
same numpy inputs and the script's own ``make_weights`` (carried across by
``exp_vit_fused_sublayer.weights_from_numpy``) go to both sides.

Tolerances, with their reasons:
- fp32 against the script's ``_k7_kernel`` / ``_k9_kernel``: max abs error
  1e-5 of the largest magnitude, the bar of ``test_torch_port_vit_fused.py``
  (every rounding point the identity; sums in another order, erf against
  the script's A&S 7.1.26 polynomial, |error| <= 1.5e-7);
- bf16 against the port's plain versions (``fused_mlp_ref``,
  ``fused_mlp_block_ref``): relative Frobenius error 1e-2, the card's bar
  (BOUND_SINGLE_ROUNDING), on the output and for k9 on out - x: both round
  at the same points from fp32 values that differ in their last bits, so a
  few values land one bf16 ulp apart;
- G 1, 2 and 3 against each other: every row stored once, bit for bit.
  G changes which quad takes a tile, not a tile's arithmetic, so this
  checks the tiling's row coverage; the kernel's own bits at G 1 and 2 are
  checked on the card (``test_vit_fused_mlp_same_bits_twice``).
"""

import functools
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mirror_tpu_torch.scripts import exp_vit_fused_sublayer as probe
from test_torch_port_runctl import one_intra_op_thread  # noqa: F401 (the fixture)

REPO = Path(__file__).resolve().parent.parent
ROWS, CHUNK, K1, K2 = 64, 128, 64, 32  # the kernel's tile rows, hidden chunk, K steps
QUADS = 2  # the kernel's kQuads: quads a cluster
FC2_COLS = 6 * 128  # fc2's accumulators: two CTAs of three warpgroups of 128 columns
BATCH = 3
# (heads, dh, n, mlp): test_torch_port_vit_fused.py's shape (d 32, MLP 128,
# n 20: one tile, one chunk); and d 72 (fc1's K steps 64 and 8, the second
# zero-filled to 64) with MLP 520
# (four chunks of 128 columns and one of 8) at n 50 (150 rows: a tile of 22)
SHAPES = [(2, 16, 20, 128), (2, 36, 50, 520)]


def _script(monkeypatch, heads, dh, n, mlp):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    spec = importlib.util.spec_from_file_location(
        "_tpu_script_exp_vit_fused_sublayer_mlp_design",
        REPO / "scripts" / "exp_vit_fused_sublayer.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    d = heads * dh
    for name, value in dict(H=heads, DH=dh, D=d, MLP=mlp, SCALE=dh ** -0.5, N=n).items():
        monkeypatch.setattr(module, name, value)
    return module


def _inputs(script, n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BATCH, n, d)).astype(np.float32)
    arrays = {k: np.asarray(v, np.float32) for k, v in
              script.make_weights(jax.random.PRNGKey(seed)).items()}
    return x, {k: jnp.asarray(v) for k, v in arrays.items()}, probe.weights_from_numpy(arrays)


def _gelu(v):
    return 0.5 * v * (1.0 + torch.erf(v * 0.7071067811865476))


def emulate(x, wts, block, dtype, group=1, eps=probe.LN_EPS):
    """k7 (block False) or k9 on x [b, n, d] in the kernel's order of work,
    rounding to ``dtype`` at its points."""
    rnd = (lambda t: t.to(dtype).float()) if dtype != torch.float32 else (lambda t: t)
    b, n, d = x.shape
    rows = b * n
    xf = rnd(x.reshape(rows, d).float())
    w1, w2 = wts["fc1"].float(), wts["fc2"].float()
    m = w1.shape[1]
    nch, ks1 = -(-m // CHUNK), -(-d // K1)
    w1p = torch.zeros(ks1 * K1, nch * CHUNK)  # TMA's zeros past d and m
    w1p[:d, :m] = w1
    w2p = torch.zeros(nch * CHUNK, d)
    w2p[:m] = w2
    b1 = torch.zeros(nch * CHUNK)
    b1[:m] = wts["fc1_b"].reshape(-1).float()
    b2 = wts["fc2_b"].reshape(-1).float()
    tiles = -(-rows // ROWS)
    per_quad = -(-(group * n) // ROWS)
    clusters = -(-(-(-tiles // per_quad)) // QUADS)
    out = torch.full((rows, d), math.nan)
    stored = torch.zeros(rows, dtype=torch.int64)
    for cluster in range(clusters):
        for quad in range(QUADS):
            for t in range(per_quad):
                r0 = ((cluster * QUADS + quad) * per_quad + t) * ROWS
                if r0 >= rows:
                    continue  # wholly past the end: computed on stale rows, not stored
                valid = min(ROWS, rows - r0)
                y = torch.zeros(ROWS, ks1 * K1)
                y[:valid, :d] = xf[r0:r0 + valid]
                if block:
                    yd = y[:, :d]
                    mu = yd.mean(dim=1, keepdim=True)
                    rstd = torch.rsqrt(((yd - mu) ** 2).mean(dim=1, keepdim=True) + eps)
                    y[:, :d] = rnd((yd - mu) * rstd * wts["ln_s"].reshape(-1)
                                   + wts["ln_b"].reshape(-1))
                acc2 = torch.zeros(ROWS, FC2_COLS)
                for c in range(nch):
                    acc1 = torch.zeros(ROWS, CHUNK)
                    cols = slice(c * CHUNK, (c + 1) * CHUNK)
                    for ks in range(ks1):
                        acc1 += y[:, ks * K1:(ks + 1) * K1] @ w1p[ks * K1:(ks + 1) * K1, cols]
                    h = _gelu(acc1 + b1[cols])
                    h[:, max(0, m - c * CHUNK):] = 0.0
                    h = rnd(h)
                    for ks in range(-(-min(CHUNK, m - c * CHUNK) // K2)):
                        k0 = c * CHUNK + ks * K2
                        acc2[:, :d] += h[:, ks * K2:(ks + 1) * K2] @ w2p[k0:k0 + K2]
                val = acc2[:valid, :d] + b2
                if block:
                    val = xf[r0:r0 + valid] + val
                out[r0:r0 + valid] = rnd(val)
                stored[r0:r0 + valid] += 1
    assert torch.equal(stored, torch.ones_like(stored)), "a row stored other than once"
    return out.reshape(b, n, d)


@pytest.mark.parametrize("kernel", ["k7", "k9"])
@pytest.mark.parametrize("heads,dh,n,mlp", SHAPES)
def test_design_matches_the_script_kernels(monkeypatch, heads, dh, n, mlp, kernel):
    """fp32: the emulation against the script's Pallas kernels (interpret)."""
    script = _script(monkeypatch, heads, dh, n, mlp)
    x, jax_wts, wts = _inputs(script, n, heads * dh, 8)
    want = np.asarray(getattr(script, f"make_{kernel}")(1)(jnp.asarray(x), jax_wts), np.float64)
    got = emulate(torch.from_numpy(x), wts, kernel == "k9", torch.float32).numpy()
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), f"max abs err {err}"


@pytest.mark.parametrize("kernel", ["k7", "k9"])
@pytest.mark.parametrize("heads,dh,n,mlp", SHAPES)
def test_design_matches_the_plain_version_in_bf16(monkeypatch, heads, dh, n, mlp, kernel):
    """bf16 rounding points: the emulation against the port's plain version
    on the same bf16 inputs, and for k9 on what the half-block adds."""
    from mirror_tpu_torch.scripts import _timing

    script = _script(monkeypatch, heads, dh, n, mlp)
    x, _, wts = _inputs(script, n, heads * dh, 9)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = {k: (v.to(torch.bfloat16) if k in probe.MATRICES else v) for k, v in wts.items()}
    group = "mlp_blk" if kernel == "k9" else "mlp"
    ref = probe.PLAIN[group](xb, wb, heads).float()
    got = emulate(xb, wb, kernel == "k9", torch.bfloat16)
    assert _timing.rel_err(got, ref) <= _timing.BOUND_SINGLE_ROUNDING
    if kernel == "k9":
        assert _timing.rel_err(got - xb.float(), ref - xb.float()) <= \
            _timing.BOUND_SINGLE_ROUNDING


@pytest.mark.parametrize("heads,dh,n,mlp", SHAPES)
def test_group_and_quads_do_not_change_the_bits(monkeypatch, heads, dh, n, mlp):
    """G 1, 2 and 3 (two quads a cluster, as the kernel runs): every row
    stored once (``emulate`` asserts it), the same bits. A tile's arithmetic
    does not depend on the quad that takes it, so only the row coverage can
    fail here; the card test ``test_vit_fused_mlp_same_bits_twice`` checks
    the kernel's bits."""
    script = _script(monkeypatch, heads, dh, n, mlp)
    x, _, wts = _inputs(script, n, heads * dh, 10)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    for block in (False, True):
        first = emulate(xb, wts, block, torch.bfloat16)
        for group in (2, 3):
            assert torch.equal(emulate(xb, wts, block, torch.bfloat16, group), first)
