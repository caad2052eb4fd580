"""Every Nystrom width the JAX package serves, on the port's forward path,
against the JAX package's Pallas kernels (interpret mode on the CPU, as the
JAX package's own tests run them) and its models, on the same inputs made
with numpy from a seed, in float32.

The head dim is dim // 8 and the landmark count dim // 2
(``mirror_tpu/models/transmil.py``), and the JAX kernels take any of them;
the port's forward kernels (1, 3, 3b, 4, 9) take any since they were
extended: a ragged dh rounds up to the next 16-wide k step with zero-filled
columns, and a dh above 128 splits the output's dh over blocks of at most
128 columns, each block summing S = q k^T over 128-column chunks of dh.

- The plain versions (what CPU tensors run, and what the card's kernels are
  held to) of the landmark softmax, the two attentions (kv with its pad, q),
  the conv-fused attention, the standalone conv and PPEG, at dh 6, 24, 99,
  130 and 192 and m 12, 33 and 396 (396 at few rows).
- The extended kernels' order of work emulated in plain torch: the
  columns zero-filled to a whole k step, S summed over 128-column chunks
  of dh, the 64-column tiles' online softmax (the pad's closed form: the
  running max starts at 0 and the sum at ``pad``), each 128-column slice
  of the output with its own recomputed statistics (the same bits in every
  slice), the conv of the slice's columns of v; the landmark means and the
  two sweeps over chunked S; the standalone conv by feature parts of at
  most 128.
- ``mirror_classifier`` at embed 264 (dh 33, m 132) and embed 1032 (dh 129,
  m 516; embed 1040's dh 130 builds in neither package, whose RNA encoder's
  12 heads do not divide 1040), batch 2, 40 tokens (so the front pad is
  most of the sequence), against the flax classifier's logits; and the
  port's ``predict`` on a JAX msgpack checkpoint at embed 264 against the
  JAX tool, row for row.

Bar: max abs error <= 1e-5 of the JAX value's largest magnitude (the bar
of tests/test_torch_port_ops.py, scaled: the same fp32 arithmetic summed in
other orders; exp2 of log2(e)-scaled logits against exp in the emulation).
The model and the tool: max abs error <= 1e-5 (tests/test_torch_port_models.py,
test_torch_port_predict.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import torch.nn.functional as F
import yaml

from mirror_tpu.models.classifier import MIRRORClassifier as JaxClassifier
from mirror_tpu.ops.conv1d_pallas import depthwise_conv1d_seq as jax_conv
from mirror_tpu.ops.landmark_pallas import landmark_softmax as jax_landmark_softmax
from mirror_tpu.ops.nystrom_pallas import (
    fused_softmax_attn_conv as jax_fused_softmax_attn_conv,
    softmax_matmul_landmark_kv as jax_landmark_kv,
    softmax_matmul_landmark_q as jax_landmark_q,
)
from mirror_tpu.ops.ppeg_pallas import ppeg_fused as jax_ppeg_fused
from mirror_tpu.tools.predict import predict as jax_predict
from mirror_tpu.train.checkpoint import save_checkpoint_file as jax_save
from mirror_tpu_torch.convert import state_dict_from_jax
from mirror_tpu_torch.models import MIRRORClassifier
from mirror_tpu_torch.ops import (
    depthwise_conv1d_seq,
    fused_softmax_attn_conv,
    landmark_softmax,
    ppeg_fused,
    softmax_matmul_landmark_kv,
    softmax_matmul_landmark_q,
)
from mirror_tpu_torch.tools.predict import predict
from mirror_tpu_torch.train.checkpoint import to_tensors
from test_torch_port_runctl import one_intra_op_thread  # noqa: F401 (the fixture)

BAR = 1e-5
LOG2E = 1.4426950408889634
TILE = 64  # the kernels' walked column tiles (BN)
SLICE = 128  # dh chunks and output slices above 128 (softmax_attn.cu, landmark.cu: WD)
K_TAPS = 33
HEADS = 2
# (dh, m): ragged head dims (6 and 24 below one 16-byte row of float32 or a
# 16-wide k step, 99), two above 128 (130: a 2-column second slice; 192),
# landmark counts not a multiple of 8 (33, 396) and under one tile (12)
WIDTHS = [(6, 12), (24, 33), (99, 396), (130, 33), (192, 12), (192, 396)]
N_ROWS = {12: 50, 33: 70, 396: 390}  # pads 10, 29, 6
HEAD_DIMS = [6, 24, 99, 130, 192]


def _pad(n, m):
    return (m - n % m) % m


def _arrays(seed, *shapes, scale=None):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if scale is not None:
        out[0] *= scale
    return out


def _close(port, ref, name="out"):
    port = port.detach().float().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (name, port.shape, ref.shape)
    err = np.abs(port - ref).max()
    bound = BAR * max(np.abs(ref).max(), 1e-30)
    assert err <= bound, f"{name}: max abs error {err} > {bound}"


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@functools.lru_cache(maxsize=None)
def _attention_case(dh, m):
    """q (scaled), k, v [1, 2, n, dh], the landmarks of the JAX kernel, w
    [1, 2, m, dh] and the conv's taps, for (dh, m)."""
    n = N_ROWS[m]
    q, k, v, w, kern = _arrays(dh + m, (1, HEADS, n, dh), (1, HEADS, n, dh), (1, HEADS, n, dh),
                               (1, HEADS, m, dh), (HEADS, K_TAPS), scale=dh ** -0.5)
    kern *= K_TAPS ** -0.5
    q_l, k_l, _ = (np.array(x) for x in jax_landmark_softmax(jnp.asarray(q), jnp.asarray(k),
                                                             m, _pad(n, m)))
    return q, k, v, w, kern, q_l, k_l


# ---------------------------------------------------------------------------
# the plain versions against the JAX kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dh,m", WIDTHS)
def test_landmark_softmax_plain_matches_jax(dh, m):
    q, k, *_ = _attention_case(dh, m)
    pad = _pad(q.shape[2], m)
    ref = jax_landmark_softmax(jnp.asarray(q), jnp.asarray(k), m, pad)
    out = landmark_softmax(*_t(q, k), m, pad)
    for name, o, r in zip(("q_l", "k_l", "attn2"), out, ref, strict=True):
        _close(o, r, name)


@pytest.mark.parametrize("dh,m", WIDTHS)
def test_attention_kv_plain_matches_jax(dh, m):
    q, k, v, *_, q_l, _ = _attention_case(dh, m)
    pad = _pad(q.shape[2], m)
    ref = jax_landmark_kv(jnp.asarray(q_l), jnp.asarray(k), jnp.asarray(v), pad)
    _close(softmax_matmul_landmark_kv(*_t(q_l, k, v), pad), ref)


@pytest.mark.parametrize("dh,m", WIDTHS)
def test_attention_q_plain_matches_jax(dh, m):
    q, _, _, w, _, _, k_l = _attention_case(dh, m)
    ref = jax_landmark_q(jnp.asarray(q), jnp.asarray(k_l), jnp.asarray(w))
    _close(softmax_matmul_landmark_q(*_t(q, k_l, w)), ref)


@pytest.mark.parametrize("dh,m", WIDTHS)
def test_attention_conv_plain_matches_jax(dh, m):
    q, _, v, w, kern, _, k_l = _attention_case(dh, m)
    ref = jax_fused_softmax_attn_conv(*map(jnp.asarray, (q, k_l, w, v, kern)))
    _close(fused_softmax_attn_conv(*_t(q, k_l, w, v, kern)), ref)


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_conv_plain_matches_jax(dh):
    v, kern = _arrays(dh, (2, HEADS, 90, dh), (HEADS, K_TAPS))
    _close(depthwise_conv1d_seq(*_t(v, kern)), jax_conv(jnp.asarray(v), jnp.asarray(kern)))


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_ppeg_plain_matches_jax(dh):
    """PPEG at the embed of each head dim (C = 8 dh: 48 to 1536 channels),
    a 5 x 5 grid."""
    c = 8 * dh
    img, kern, bias = _arrays(c, (1, 5, 5, c), (7, 7, c), (c,))
    ref = jax_ppeg_fused(jnp.asarray(img), jnp.asarray(kern * 0.1), jnp.asarray(bias * 0.1))
    _close(ppeg_fused(*_t(img, kern * 0.1, bias * 0.1)), ref)


# ---------------------------------------------------------------------------
# the extended kernels' order of work
# ---------------------------------------------------------------------------


def _cols(dh):
    """The columns a kernel holds of a dh-wide row: dh rounded up to a whole
    16-wide k step up to 128 (the DT instance), whole 128-column chunks
    above (the wide kernel)."""
    return -(-dh // 16) * 16 if dh <= SLICE else -(-dh // SLICE) * SLICE


def _zero_fill(x, cols):
    return F.pad(x.float(), (0, cols - x.shape[-1]))


def _chunked_scores(a, b):
    """S = a b^T summed in fp32 over 128-column chunks of the (zero-filled)
    columns, each chunk's product added to the running sum."""
    s = torch.zeros(*a.shape[:-1], b.shape[-2])
    for c0 in range(0, a.shape[-1], SLICE):
        s = s + a[..., c0:c0 + SLICE] @ b[..., c0:c0 + SLICE].transpose(-1, -2)
    return s


def attention_emulation(q, k, w, pad, v=None, kern=None):
    """(out, lse) of kernels 3 / 3b / 4 in their order of work: q, k and w
    zero-filled to the held columns; for each output slice (one below 129
    columns), a walk of 64-column tiles of k (the ragged edge masked) with
    S recomputed over the dh chunks, the online max and sum in the exp2
    form starting from the pad's (0, pad), P rounded to q's dtype against
    the slice's columns of w; then O / l plus the conv of the slice's
    columns of v, rounded once. Returns every slice's lse too."""
    dh = q.shape[-1]
    cols = _cols(dh)
    qz, kz, wz = (_zero_fill(x, cols) for x in (q, k, w))
    c = k.shape[2]
    width = cols if dh <= SLICE else SLICE
    outs, lses = [], []
    for s0 in range(0, cols, width):
        mx = torch.full(q.shape[:-1], 0.0 if pad else -torch.inf)
        total = torch.full(q.shape[:-1], float(pad))
        o = torch.zeros(*q.shape[:-1], width)
        for c0 in range(0, c, TILE):
            s = _chunked_scores(qz, kz[:, :, c0:c0 + TILE])
            new = torch.maximum(mx, s.amax(-1))
            alpha = torch.exp2((mx - new) * LOG2E)
            p = torch.exp2(s * LOG2E - (new * LOG2E).unsqueeze(-1))
            total = total * alpha + p.sum(-1)
            o = o * alpha.unsqueeze(-1) + p.to(q.dtype).float() @ wz[:, :, c0:c0 + TILE,
                                                                     s0:s0 + width]
            mx = new
        o = o / total.unsqueeze(-1)
        if v is not None:  # the band product over the slice's columns of v
            vs = _zero_fill(v, cols)[..., s0:s0 + width]
            half = kern.shape[1] // 2
            vp = F.pad(vs, (0, 0, half, half))
            n = v.shape[2]
            o = o + sum(kern[:, t].float().view(1, -1, 1, 1) * vp[:, :, t:t + n]
                        for t in range(kern.shape[1]))
        outs.append(o)
        lses.append(mx + torch.log(total))
    out = torch.cat(outs, -1)[..., :dh].to(q.dtype)
    return out, lses


def landmark_emulation(q, k, m, pad):
    """(q_l, k_l, attn2, lse) of kernel 1: the means summed over each
    group's real rows in order (one element at a time for a ragged dh: the
    same order), times an fp32 1/l, rounded; S over the zero-filled chunks;
    sweep 1's online max and sum over 64-column tiles of k_l (ragged m
    masked); sweep 2's P = exp2(S log2e - lse log2e)."""
    b, h, n, dh = q.shape
    l = (n + pad) // m

    def means(x):
        s = torch.zeros(b, h, m, dh)
        for j in range(l):
            rows = torch.arange(m) * l - pad + j
            real = rows >= 0
            s[:, :, real] += x[:, :, rows[real]].float()
        return (s * torch.tensor(1.0 / l, dtype=torch.float32)).to(x.dtype)

    q_l, k_l = means(q), means(k)
    cols = _cols(dh)
    qz, kz = _zero_fill(q_l, cols), _zero_fill(k_l, cols)
    mx = torch.full((b, h, m), -torch.inf)
    total = torch.zeros(b, h, m)
    for c0 in range(0, m, TILE):
        s = _chunked_scores(qz, kz[:, :, c0:c0 + TILE])
        new = torch.maximum(mx, s.amax(-1))
        total = total * torch.exp2((mx - new) * LOG2E) \
            + torch.exp2(s * LOG2E - (new * LOG2E).unsqueeze(-1)).sum(-1)
        mx = new
    lse = mx + torch.log(total)
    p = torch.exp2(_chunked_scores(qz, kz) * LOG2E - (lse * LOG2E).unsqueeze(-1))
    return q_l, k_l, p.to(q.dtype), lse


def conv_parts_emulation(v, kern):
    """Kernel 9 by feature parts of at most 128 columns (the grid's z),
    each part's band sum over the taps in fp32, rounded once."""
    half = kern.shape[1] // 2
    n = v.shape[2]
    parts = []
    for f0 in range(0, v.shape[-1], SLICE):
        vp = F.pad(v[..., f0:f0 + SLICE].float(), (0, 0, half, half))
        parts.append(sum(kern[:, t].float().view(1, -1, 1, 1) * vp[:, :, t:t + n]
                         for t in range(kern.shape[1])))
    return torch.cat(parts, -1).to(v.dtype)


@pytest.mark.parametrize("dh,m", WIDTHS)
def test_landmark_order_of_work_matches_jax(dh, m):
    q, k, *_ = _attention_case(dh, m)
    pad = _pad(q.shape[2], m)
    ref = jax_landmark_softmax(jnp.asarray(q), jnp.asarray(k), m, pad)
    out = landmark_emulation(*_t(q, k), m, pad)
    for name, o, r in zip(("q_l", "k_l", "attn2"), out, ref):
        _close(o, r, name)


@pytest.mark.parametrize("dh,m", WIDTHS)
def test_attention_order_of_work_matches_jax(dh, m):
    """Kernel 3 (kv, with the pad) and kernel 4 (q with the conv) emulated
    against the JAX kernels; every output slice computes the same
    statistics bit for bit (slice 0 writes lse)."""
    q, k, v, w, kern, q_l, k_l = _attention_case(dh, m)
    pad = _pad(q.shape[2], m)
    out, lses = attention_emulation(*_t(q_l, k, v), pad)
    _close(out, jax_landmark_kv(jnp.asarray(q_l), jnp.asarray(k), jnp.asarray(v), pad))
    assert len(lses) == -(-dh // SLICE) and all(torch.equal(x, lses[0]) for x in lses)
    out, _ = attention_emulation(*_t(q, k_l, w), 0, *_t(v, kern))
    _close(out, jax_fused_softmax_attn_conv(*map(jnp.asarray, (q, k_l, w, v, kern))))


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_conv_parts_order_of_work_matches_jax(dh):
    v, kern = _arrays(dh + 1, (2, HEADS, 90, dh), (HEADS, K_TAPS))
    out = conv_parts_emulation(*_t(v, kern))
    _close(out, jax_conv(jnp.asarray(v), jnp.asarray(kern)))
    assert torch.equal(out[..., :min(dh, SLICE)],
                       conv_parts_emulation(*_t(v[..., :SLICE].copy(), kern)))


# ---------------------------------------------------------------------------
# the classifier and predict at the new widths
# ---------------------------------------------------------------------------

WSI_IN, RNA_IN, N_TOK = 32, 24, 40


def _classifier_kw(embed):
    return dict(wsi_embed_dim=WSI_IN, rna_embed_dim=RNA_IN, embed_dim=embed, num_classes=3,
                rna_mlp_ratio=1.0, rna_encoder_depth=1)


@pytest.mark.parametrize("embed", [264, 1032])
def test_classifier_at_wide_and_ragged_widths_matches_jax(embed):
    """Embed 264: 8 heads of 33, 132 landmarks; embed 1032: 8 heads of 129
    (a second 128-column slice on the card), 516 landmarks. 40 tokens wrap
    to 49 (+ cls: 50 rows), so the front pad is most of the sequence."""
    rng = np.random.default_rng(embed)
    wsi = rng.standard_normal((2, N_TOK, WSI_IN)).astype(np.float32)
    rna = rng.standard_normal((2, RNA_IN)).astype(np.float32)
    jm = JaxClassifier(**_classifier_kw(embed))
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, N_TOK, WSI_IN)),
                                             jnp.zeros((1, RNA_IN)))["params"])
    port = MIRRORClassifier(**_classifier_kw(embed))
    port.load_state_dict(to_tensors(state_dict_from_jax(params)))
    attn = port.wsi_encoder.layer1.attn
    assert (attn.dim_head, attn.num_landmarks) == (embed // 8, embed // 2)
    ref = jax.jit(jm.apply)({"params": params}, jnp.asarray(wsi), jnp.asarray(rna))
    with torch.no_grad():
        out = port.eval()(*_t(wsi, rna))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=BAR)


def test_predict_on_a_jax_checkpoint_at_embed_264_matches_jax(tmp_path):
    """The port's predict reads the JAX tool's msgpack checkpoint of an
    embed-264 classifier (dh 33, m 132) and scores 8 slides as the JAX tool
    does (batch 8, the same seed), row for row."""
    rng = np.random.default_rng(264)
    feat_dir = tmp_path / "feats"
    feat_dir.mkdir()
    ids = [f"TCGA-WD-{i:04d}-01A-01-TS1" for i in range(8)]
    for sid in ids:
        np.save(feat_dir / f"{sid}.npy", rng.standard_normal((int(rng.integers(10, 60)), WSI_IN))
                .astype(np.float16))
    rna = pd.DataFrame(rng.standard_normal((8, RNA_IN)).astype(np.float32),
                       index=[s[:15] for s in ids], columns=[f"g{j}" for j in range(RNA_IN)])
    rna.to_csv(tmp_path / "rna.csv")
    kw = _classifier_kw(264)
    jm = JaxClassifier(**dict(kw, num_classes=2))
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.zeros((1, 16, WSI_IN)),
                                             jnp.zeros((1, RNA_IN)))["params"])
    model_kwargs = {k: v for k, v in kw.items() if k != "num_classes"}
    args = dict(model="mirror_classifier", model_kwargs=model_kwargs, amp=False, num_classes=2,
                num_wsi_feature_tokens=16, wsi_feature_only=False)
    ckpt = str(tmp_path / "model_best.msgpack")
    jax_save(ckpt, {"epoch": 0, "arch": "mirror_classifier", "state_dict": params,
                    "args": yaml.safe_dump(args)})
    jax_csv, port_csv = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    jax_predict(ckpt, "subtyping", str(feat_dir), jax_csv, rna_feature_csv=str(tmp_path / "rna.csv"),
                batch_size=8, seed=7)
    predict(ckpt, "subtyping", str(feat_dir), port_csv, rna_feature_csv=str(tmp_path / "rna.csv"),
            batch_size=8, seed=7, device="cpu")
    ref, out = pd.read_csv(jax_csv), pd.read_csv(port_csv)
    assert len(out) == 8 and list(out.columns) == list(ref.columns)
    assert (out["slide_id"] == ref["slide_id"]).all() and (out["pred"] == ref["pred"]).all()
    num = [c for c in ref.columns if c not in ("slide_id", "pred")]
    np.testing.assert_allclose(out[num].to_numpy(), ref[num].to_numpy(), rtol=0, atol=BAR)


# ---------------------------------------------------------------------------
# the backward kernels' widths: refused by name, never the plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dh,m,n", [(24, 12, 50), (99, 396, 390), (192, 768, 800)])
def test_backward_beyond_the_kernels_raises_by_name(monkeypatch, dh, m, n):
    """The backward kernels (1b, 3c, 4b, 9b) take dh a multiple of 16 up to
    128 and m a multiple of 8 (9b: d a multiple of 8). On the card a
    backward beyond them raises, naming its kernel and --no-use-pallas,
    and never runs the plain version. The forwards run here on the CPU; the
    device check is then made to say "cuda", so each backward goes where
    the card's would, and the refusal comes before any launch."""
    from mirror_tpu_torch.ops import _common

    q, k, v, w, kern = (t.requires_grad_() for t in _t(*_arrays(
        dh, (1, HEADS, n, dh), (1, HEADS, n, dh), (1, HEADS, n, dh), (1, HEADS, m, dh),
        (HEADS, K_TAPS))))
    pad = _pad(n, m)
    q_l, k_l, attn2 = landmark_softmax(q, k, m, pad)
    attn = "softmax attention's backward kernels (3c, 4b)"
    outs = [("landmark softmax's backward kernel (1b)", attn2),
            (attn, softmax_matmul_landmark_kv(q_l, k, v, pad)),
            (attn, fused_softmax_attn_conv(q, k_l, w, v, kern))]
    if dh % 8 or dh > 128:
        outs.append(("conv's backward kernel (9b)", depthwise_conv1d_seq(v, kern)))
    monkeypatch.setattr(_common, "on_cuda", lambda *tensors: True)
    for name, out in outs:
        with pytest.raises(ValueError, match="--no-use-pallas") as err:
            out.float().sum().backward(retain_graph=True)
        assert name in str(err.value)
