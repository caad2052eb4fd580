"""The fused attention sub-layer's order of work (``csrc/vit_fused.cu``, k5
and k8), emulated in plain torch on the CPU and held against the TPU
script's kernels and the port's plain versions.

The emulation follows the kernel: k8's LN statistics per row (the mean,
then the mean of the squared deviations) and y rounded once; the image's
rows padded with zeros to passes of 128 (two m64 tiles, as the 3-D TMA map
zero-fills rows past n); a head's q | k | v as passes of three boxes of 64
W_qkv columns starting at the head's column of q, k or v (columns past dh
belong to other heads and are dropped, columns past 3d are zeros), K summed
in the kernel's steps in fp32, the bias added in fp32, rounded, rows past n
zeroed; the attention in two passes over 16-key tiles (the row max and the
sum online, the sum rescaled by exp2 of the change of max; then the weights
exp2(s c - m c) times the sum's reciprocal, rounded, and P v in fp32,
rounded); the out product of CTA r over its hpc dh output columns, the
heads summed in order in fp32, then b_o (and x) added in fp32, rounded
once.

The script ``scripts/exp_vit_fused_sublayer.py`` is loaded by path, its
module constants set small with ``monkeypatch`` and its ``pallas_call``s
run in interpret mode, as ``test_torch_port_vit_fused.py`` runs it; the
same numpy inputs and the script's own ``make_weights`` (carried across by
``exp_vit_fused_sublayer.weights_from_numpy``) go to both sides.

Tolerances, with their reasons:
- fp32 against the script's ``_k5_kernel`` / ``_k8_kernel``: max abs error
  1e-5 of the largest magnitude, the bar of ``test_torch_port_vit_fused.py``
  (every rounding point the identity; sums in another order, exp2 of
  log2(e)-scaled scores against exp, a reciprocal against a division);
- bf16 against the port's plain versions (``fused_attn_ref``,
  ``fused_attn_block_ref``): relative Frobenius error 1e-2, the card's bar
  (BOUND_SINGLE_ROUNDING), on the output and for k8 on out - x: both round
  at the same points from fp32 values that differ in their last bits, so a
  few values land one bf16 ulp apart;
- one head a CTA against two: bit for bit (the mapping changes no output's
  arithmetic).
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
LOG2E = 1.4426950408889634
PASS_ROWS, BOX, KEY_TILE = 128, 64, 16  # the kernel's phase-1 rows, W_qkv box, key tile
K_STEP = 64  # the kernel's K step of phase 1 (kBK)
BATCH = 3
# (heads, dh, n): test_torch_port_vit_fused.py's shape (2 heads of 16, n 20:
# boxes reaching past 3d, one pass); and 2 heads of 80 at n 150 (two column
# passes, two row passes, a ragged last key tile)
SHAPES = [(2, 16, 20), (2, 80, 150)]


def _script(monkeypatch, heads, dh, n):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    spec = importlib.util.spec_from_file_location(
        "_tpu_script_exp_vit_fused_sublayer_design", REPO / "scripts" / "exp_vit_fused_sublayer.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    d = heads * dh
    for name, value in dict(H=heads, DH=dh, D=d, MLP=4 * d, SCALE=dh ** -0.5, N=n).items():
        monkeypatch.setattr(module, name, value)
    return module


def _inputs(script, n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BATCH, n, d)).astype(np.float32)
    arrays = {k: np.asarray(v, np.float32) for k, v in
              script.make_weights(jax.random.PRNGKey(seed)).items()}
    return x, {k: jnp.asarray(v) for k, v in arrays.items()}, probe.weights_from_numpy(arrays)


def _attention(q, k, v, n, dh, rnd):
    """Phase 2 for one head: q, k, v [npad, dh], rows past n zeros."""
    npad = q.shape[0]
    c = dh ** -0.5 * LOG2E
    s = q @ k.T
    s[:, n:] = -math.inf
    m = torch.full((npad,), -math.inf)
    total = torch.zeros(npad)
    for t in range(npad // KEY_TILE):
        st = s[:, KEY_TILE * t:KEY_TILE * (t + 1)]
        x = torch.maximum(m, st.max(dim=1).values)
        total = total * torch.exp2((m - x) * c) + torch.exp2(st * c - (x * c)[:, None]).sum(1)
        m = x
    p = rnd(torch.exp2(s * c - (m * c)[:, None]) * (1.0 / total)[:, None])
    return rnd(p @ v)


def emulate(x, wts, heads, hpc, block, dtype, eps=probe.LN_EPS):
    """k5 (block False) or k8 on x [b, n, d] in the kernel's order of work,
    rounding to ``dtype`` at its points; ``hpc`` heads a CTA."""
    rnd = (lambda t: t.to(dtype).float()) if dtype != torch.float32 else (lambda t: t)
    b, n, d = x.shape
    dh, nb = d // heads, -(-(d // heads) // BOX)
    npad = -(-n // 16) * 16
    rows = PASS_ROWS * -(-npad // PASS_ROWS)
    cw = hpc * dh
    w = torch.cat([wts["qkv"].float(), torch.zeros(d, BOX)], dim=1)  # TMA's zeros past 3d
    bias = wts["qkv_b"].reshape(-1).float()
    wo, bo = wts["out"].float(), wts["out_b"].reshape(-1).float()
    out = torch.empty(b, n, d)
    for img in range(b):
        xi = rnd(x[img].float())
        y = xi
        if block:
            mu = xi.mean(dim=1, keepdim=True)
            rstd = torch.rsqrt(((xi - mu) ** 2).mean(dim=1, keepdim=True) + eps)
            y = rnd((xi - mu) * rstd * wts["ln_s"].reshape(-1) + wts["ln_b"].reshape(-1))
        ypad = torch.zeros(rows, d)
        ypad[:n] = y
        heads_o = []
        for h in range(heads):  # CTA h // hpc takes it; the order of work is the head's own
            qkv = torch.zeros(3, npad, dh)
            for cp in range(nb):
                boxes = [cp * 3 + bx for bx in range(3)]
                cols = torch.cat([torch.arange(64) + (box // nb) * d + h * dh + 64 * (box % nb)
                                  for box in boxes])
                for rp in range(rows // PASS_ROWS):
                    acc = torch.zeros(PASS_ROWS, 3 * BOX)
                    for k0 in range(0, d, K_STEP):
                        acc += ypad[rp * PASS_ROWS:(rp + 1) * PASS_ROWS, k0:k0 + K_STEP] \
                            @ w[k0:k0 + K_STEP][:, cols]
                    for i, box in enumerate(boxes):
                        hc0 = (box % nb) * 64
                        width = min(64, dh - hc0)
                        if width <= 0:
                            continue
                        which = box // nb
                        val = acc[:, 64 * i:64 * i + width] \
                            + bias[which * d + h * dh + hc0:which * d + h * dh + hc0 + width]
                        r0 = rp * PASS_ROWS
                        r1 = min(npad, r0 + PASS_ROWS)
                        if r1 > r0:
                            qkv[which, r0:r1, hc0:hc0 + width] = rnd(val[:r1 - r0])
            qkv[:, n:] = 0.0
            heads_o.append(_attention(qkv[0], qkv[1], qkv[2], n, dh, rnd))
        for r in range(heads // hpc):  # CTA r: output columns [r cw, (r + 1) cw)
            sl = slice(r * cw, (r + 1) * cw)
            acc = torch.zeros(npad, cw)
            for hh in range(heads):
                acc += heads_o[hh] @ wo[hh * dh:(hh + 1) * dh, sl]
            val = acc[:n] + bo[sl]
            if block:
                val = xi[:, sl] + val
            out[img, :, sl] = rnd(val)
    return out


@pytest.mark.parametrize("hpc", [1, 2])
@pytest.mark.parametrize("kernel", ["k5", "k8"])
@pytest.mark.parametrize("heads,dh,n", SHAPES)
def test_design_matches_the_script_kernels(monkeypatch, heads, dh, n, kernel, hpc):
    """fp32: the emulation against the script's Pallas kernels (interpret)."""
    script = _script(monkeypatch, heads, dh, n)
    x, jax_wts, wts = _inputs(script, n, heads * dh, 5)
    want = np.asarray(getattr(script, f"make_{kernel}")(1)(jnp.asarray(x), jax_wts), np.float64)
    got = emulate(torch.from_numpy(x), wts, heads, hpc, kernel == "k8", torch.float32).numpy()
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), f"max abs err {err}"


@pytest.mark.parametrize("kernel", ["k5", "k8"])
@pytest.mark.parametrize("heads,dh,n", SHAPES)
def test_design_matches_the_plain_version_in_bf16(monkeypatch, heads, dh, n, kernel):
    """bf16 rounding points: the emulation against the port's plain version
    on the same bf16 inputs, and for k8 on what the half-block adds."""
    from mirror_tpu_torch.scripts import _timing

    script = _script(monkeypatch, heads, dh, n)
    x, _, wts = _inputs(script, n, heads * dh, 6)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = {k: (v.to(torch.bfloat16) if k in probe.MATRICES else v) for k, v in wts.items()}
    group = "attn_blk" if kernel == "k8" else "attn"
    ref = probe.PLAIN[group](xb, wb, heads).float()
    got = emulate(xb, wb, heads, 1, kernel == "k8", torch.bfloat16)
    assert _timing.rel_err(got, ref) <= _timing.BOUND_SINGLE_ROUNDING
    if kernel == "k8":
        assert _timing.rel_err(got - xb.float(), ref - xb.float()) <= \
            _timing.BOUND_SINGLE_ROUNDING


@pytest.mark.parametrize("heads,dh,n", SHAPES)
def test_heads_per_cta_does_not_change_the_bits(monkeypatch, heads, dh, n):
    script = _script(monkeypatch, heads, dh, n)
    x, _, wts = _inputs(script, n, heads * dh, 7)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    for block in (False, True):
        one, two = (emulate(xb, wts, heads, hpc, block, torch.bfloat16) for hpc in (1, 2))
        assert torch.equal(one, two)
