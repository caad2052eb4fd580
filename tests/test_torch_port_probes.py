"""The port's TPU probes (``mirror_tpu_torch/scripts``) and the two repairs
that came with them, on the CPU.

The JAX side is the scripts of ``scripts/`` themselves, loaded by path, with
``pallas_call`` run in interpret mode (monkeypatched, so nothing under
``scripts/`` changes). In fp32 every rounding point of the two sides is the
identity, so each plain version of the port is held within 1e-5 of the
script's kernel (sums in another order). Each probe's ``main`` runs at a
small shape with ``--device cpu`` and ends in one JSON line.
"""

import functools
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mirror_tpu.ops import conv1d_pallas
from mirror_tpu.train.checkpoint import CheckpointSaver
from mirror_tpu_torch import config, registry
from mirror_tpu_torch.models import NystromAttention
from mirror_tpu_torch.ops import conv1d, pinv, vit_attn
from mirror_tpu_torch.scripts import (
    exp_conv_parts,
    exp_hbm_floor,
    exp_ln_qkv,
    exp_pinv_stash,
    exp_vit_attn_kernel,
)
from mirror_tpu_torch.train.harness import CheckpointHistory

REPO = Path(__file__).resolve().parent.parent
REL = 1e-5


def _load_script(name):
    """``scripts/{name}.py`` as a module (it is not a package)."""
    spec = importlib.util.spec_from_file_location(f"_tpu_script_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def interpret(monkeypatch):
    """The scripts' own pallas_calls in interpret mode, as the JAX
    package's tests run its kernels on the CPU."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _close(port, ref, rel=REL, name=""):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, name
    err = np.abs(port - ref).max()
    assert err <= rel * np.abs(ref).max(), f"{name}: max abs err {err} > {rel} x {np.abs(ref).max()}"


# --- 11d: the exact pinv backward's stash variants ---


def _softmax_like(seed, b=1, h=2, m=128):
    """Rows rescaled so that the max row and column sums are unique (the
    scale's gradient then does not depend on the summation order)."""
    rng = np.random.default_rng(seed)
    sim = rng.standard_normal((b, h, m, m)).astype(np.float32)
    x = np.exp(sim - sim.max(-1, keepdims=True))
    x /= x.sum(-1, keepdims=True)
    return (x * rng.uniform(0.5, 1.5, size=(b, h, m, 1))).astype(np.float32)


@pytest.mark.parametrize("stash", [1, 2])
def test_pinv_stash_variant_matches_the_script(interpret, stash):
    """dL/dx of sum(pinv(x)^2) through the port's stash variant against the
    script's ``make_variant(stash)`` (its ``_bwd_kernel_stash``)."""
    script = _load_script("exp_pinv_stash")
    x = _softmax_like(stash)
    fn = script.make_variant(stash)
    want = jax.grad(lambda t: jnp.sum(fn(t, 6).astype(jnp.float32) ** 2))(jnp.asarray(x))
    leaf = torch.from_numpy(x).requires_grad_()
    pinv.moore_penrose_pinv_stash(leaf, 6, stash).square().sum().backward()
    _close(leaf.grad.numpy(), want, name=f"stash {stash}")


@pytest.mark.parametrize("stash", [1, 2])
def test_pinv_stash_ref_is_the_full_backward(stash):
    """The recomputed products are the replay's, so the plain stash variant
    is the full plain backward exactly."""
    x = torch.from_numpy(_softmax_like(7, m=48))
    g = torch.from_numpy(np.random.default_rng(8).standard_normal(x.shape).astype(np.float32))
    s = pinv.global_scale(x)
    gx, gs = pinv.pinv_exact_bwd_stash_ref(x, s, g, 6, stash)
    gx_full, gs_full = pinv.pinv_exact_bwd_ref(x, s, g, 6)
    assert torch.equal(gx, gx_full) and torch.equal(gs, gs_full)
    with pytest.raises(ValueError, match="stash"):
        pinv.pinv_exact_bwd_stash_ref(x, s, g, 6, 3)


# --- 11c: the ViT attention layouts ---


@pytest.mark.parametrize("name", ["k1g8", "k2g8", "k3g1", "k3g2"])
def test_vit_attention_layouts_match_the_script(interpret, name):
    """The port's head-major and natural variants (their plain versions on
    the CPU) against the script's Pallas kernels and ``attn_xla``."""
    script = _load_script("exp_vit_attn_kernel")
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((2, script.N, script.D)).astype(np.float32)
               for _ in range(3))
    want = script.VARIANTS[name](*map(jnp.asarray, (q, k, v)))
    got = exp_vit_attn_kernel.VARIANTS[name](*map(torch.from_numpy, (q, k, v)))
    _close(got.numpy(), want, name=name)
    _close(exp_vit_attn_kernel.attn_xla(*map(torch.from_numpy, (q, k, v))).numpy(),
           script.attn_xla(*map(jnp.asarray, (q, k, v))), name="attn_xla")


def test_mha_headmajor_ref_is_mha_natural_ref_per_pair():
    g = torch.Generator().manual_seed(12)
    b, n, heads, dh = 2, 17, 3, 16
    q, k, v = (torch.randn(b, n, heads * dh, generator=g) for _ in range(3))
    hm = [t.view(b, n, heads, dh).transpose(1, 2).reshape(b * heads, n, dh) for t in (q, k, v)]
    out = vit_attn.mha_headmajor(*hm, 2).view(b, heads, n, dh).transpose(1, 2).reshape(b, n, -1)
    assert torch.equal(out, vit_attn.mha_natural_ref(q, k, v, heads))
    assert torch.equal(vit_attn.mha_natural(q, k, v, heads, 2),
                       vit_attn.mha_natural_ref(q, k, v, heads))


# --- 11b: the LN + q/k/v projection's dense form ---


def test_dense_ln_qkv_matches_the_script():
    script = _load_script("exp_ln_qkv")
    rng = np.random.default_rng(13)
    bsz, n, d, heads = 2, 24, 128, 2
    x = rng.standard_normal((bsz, n, d)).astype(np.float32)
    s = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal(d)).astype(np.float32)
    w = (0.05 * rng.standard_normal((d, 3 * d))).astype(np.float32)
    want = script.dense_ln_qkv(*map(jnp.asarray, (x, s, b, w)), heads)
    got = exp_ln_qkv.dense_ln_qkv(*map(torch.from_numpy, (x, s, b, w)), heads)
    for name, o, r in zip("qkv", got, want):
        assert o.is_contiguous()
        _close(o.numpy(), r, name=name)


# --- 11f: the conv backward's dv alone and its column sum ---


def test_conv_dv_only_and_column_sum_match_the_pallas_backward():
    """dv alone, and the column sum of per-batch dkern partials, against
    ``conv1d_pallas._bwd_call`` at [2, 2, 40, 16], K 5, fp32."""
    rng = np.random.default_rng(14)
    v, g = (rng.standard_normal((2, 2, 40, 16)).astype(np.float32) for _ in range(2))
    kern = (0.3 * rng.standard_normal((2, 5))).astype(np.float32)
    dv_want, dk_want = conv1d_pallas._bwd_call(*map(jnp.asarray, (v, kern, g)))
    vt, gt, kt = map(torch.from_numpy, (v, g, kern))
    _close(conv1d.conv1d_bwd_dv(gt, kt).numpy(), dv_want, name="dv")
    parts = torch.stack([conv1d.depthwise_conv_seq_bwd_ref(vt[i:i + 1], kt, gt[i:i + 1])[1]
                         .reshape(-1) for i in range(2)])
    _close(conv1d.column_sum(parts).reshape(2, 5).numpy(), dk_want, name="dkern")


# --- every probe at a small shape on the CPU ---

SMALL = {
    exp_hbm_floor: ["--batch", "3", "--heads", "2", "--n", "400", "--d", "16", "--d-wide",
                    "24", "--flat", "1000"],
    exp_conv_parts: ["--batch", "2", "--heads", "2", "--n", "40", "--d", "16", "--ksize", "5"],
    exp_ln_qkv: ["--batch", "2", "--n", "24", "--d", "128", "--heads", "2", "--chain", "1"],
    exp_pinv_stash: ["--b", "1", "--h", "2", "--m", "32"],
    exp_vit_attn_kernel: ["--batch", "2", "--variants", "xla", "k1g8", "k3g2", "library"],
}


@pytest.mark.parametrize("probe", list(SMALL), ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_probe_runs_on_the_cpu_and_ends_in_json(probe, capsys):
    assert probe.main(["--device", "cpu", *SMALL[probe]]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["probe"] == probe.__name__.rsplit(".", 1)[-1] and line["device"] == "cpu"
    assert line["variants"] and all(r["ms"] is None for r in line["variants"])
    for r in line["variants"]:
        for key in ("err", "err_gx"):
            if key in r:
                assert math.isfinite(r[key]), r


@pytest.mark.parametrize("probe,bar,value", [
    (exp_conv_parts, "BOUND_SINGLE_ROUNDING", -1.0),  # kernel 9, the column sum
    (exp_conv_parts, "BOUND_BWD", -1.0),  # kernel 9b's dv and dkern
    (exp_conv_parts, "BOUND_SUM_FP32", -1.0),  # 9b's dkern as a batch sum
    (exp_ln_qkv, "BOUND_SINGLE_ROUNDING", -1.0),  # kernel 10
    (exp_ln_qkv, "BOUND_BWD", -1.0),  # kernel 10b
    (exp_ln_qkv, "BOUND_SUM_FP32", -1.0),  # 10b's gs and gb
    (exp_ln_qkv, "BOUND_SUM_BF16", -1.0),  # 10b's gw
    (exp_pinv_stash, "BOUND_PINV_BWD", -1.0),  # 2b vs plain, the variants vs 2b
    (exp_pinv_stash, "BOUND_PINV_BWD_COS", 2.0),
    (exp_vit_attn_kernel, "BOUND_SINGLE_ROUNDING", -1.0),
], ids=lambda p: p.__name__.rsplit(".", 1)[-1] if hasattr(p, "__name__") else str(p))
def test_probe_exits_1_beyond_a_bar(probe, bar, value, monkeypatch):
    """Each probe holds its kernels against their plain versions at the bars
    it shares with chip_smoke.py: a bar that nothing can meet makes it exit
    1 (chip_smoke.py then fails)."""
    from mirror_tpu_torch.scripts import _timing

    monkeypatch.setattr(_timing, bar, value)
    assert probe.main(["--device", "cpu", *SMALL[probe]]) == 1


def test_ln_qkv_probe_exits_1_on_a_wrong_kernel(monkeypatch):
    """A kernel 10 whose q/k/v are 10 % off is caught at the probe's shape."""
    from mirror_tpu_torch.ops import ln_qkv

    fused = ln_qkv.ln_qkv_fused
    monkeypatch.setattr(ln_qkv, "ln_qkv_fused",
                        lambda *a, **k: tuple(1.1 * t for t in fused(*a, **k)))
    assert exp_ln_qkv.main(["--device", "cpu", *SMALL[exp_ln_qkv]]) == 1


def test_probe_module_runs_as_a_script():
    out = subprocess.run([sys.executable, "-m", "mirror_tpu_torch.scripts.exp_conv_parts",
                          "--device", "cpu", *SMALL[exp_conv_parts]], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    assert json.loads(out.strip().splitlines()[-1])["dv_bit_exact"] is True


def test_probes_need_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    for probe in SMALL:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            probe.main(SMALL[probe])


def _c_entry(source: Path, name: str) -> str:
    """The parameter list of C entry ``name`` in ``source``, whitespace
    collapsed."""
    text = source.read_text()
    head = f"MIRROR_EXPORT int {name}("
    assert text.count(head) == 1, (source, name)
    start = text.index(head) + len(head)
    return " ".join(text[start:text.index(")", start)].split())


@pytest.mark.parametrize("src,entry", [("softmax_attn.cu", "mirror_softmax_attn"),
                                       ("softmax_attn_bwd.cu", "mirror_softmax_attn_bwd")])
def test_wgmma_variant_keeps_the_shipped_c_entries(src, entry):
    """``exp_attn_wgmma`` runs the same wrappers on either library, so the
    variant's C entries take what the shipped ones take."""
    from mirror_tpu_torch.scripts import exp_attn_wgmma

    shipped = exp_attn_wgmma._common.CSRC_DIR / src
    assert _c_entry(exp_attn_wgmma.VARIANT_DIR / src, entry) == _c_entry(shipped, entry)
    assert exp_attn_wgmma.VARIANT_DIR / src in exp_attn_wgmma.SOURCES


def test_wgmma_probe_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    from mirror_tpu_torch.scripts import exp_attn_wgmma

    with pytest.raises(RuntimeError, match="no CUDA card"):
        exp_attn_wgmma.main([])


def test_no_port_module_imports_jax_or_the_jax_package():
    """jax, flax, optax, the JAX package and ``scripts/`` made unimportable:
    every module of mirror_tpu_torch still loads."""
    code = (
        "import importlib, pkgutil, sys\n"
        "blocked = ('jax', 'jaxlib', 'flax', 'optax', 'mirror_tpu', 'scripts')\n"
        "for name in blocked:\n"
        "    sys.modules[name] = None\n"
        "import mirror_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(mirror_tpu_torch.__path__, "
        "'mirror_tpu_torch.')]\n"
        "assert 'mirror_tpu_torch.scripts.exp_pinv_stash' in names, names\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in blocked "
        "and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


# --- repair: the kernel path refuses at start what the kernels do not take ---


@pytest.mark.parametrize("name", ["mirror", "mirror_classifier"])
@pytest.mark.parametrize("kwargs,why", [
    ({}, "compute dtype torch.float32"),  # --no-amp: no dtype, fp32
    ({"dtype": "bfloat16", "embed_dim": 1536}, "head dim 192"),
    ({"dtype": "bfloat16", "embed_dim": 792}, "396 landmarks"),
])
def test_kernel_config_is_refused_on_the_card_by_name(name, kwargs, why):
    with pytest.raises(ValueError, match="--no-use-pallas") as err:
        registry.check_kernel_config(name, "cuda", **kwargs)
    assert why in str(err.value)
    # the same model is not refused on the CPU, nor on the card's plain path
    registry.check_kernel_config(name, "cpu", **kwargs)
    registry.check_kernel_config(name, "cuda", use_pallas=False, **kwargs)
    with pytest.raises(ValueError, match="--no-use-pallas"):
        registry.create_model(name, device="cuda", **kwargs)


def test_the_templates_width_passes_the_kernel_check():
    for name in ("mirror", "mirror_classifier"):
        registry.check_kernel_config(name, "cuda", dtype="bfloat16", wsi_embed_dim=768)


def test_no_use_pallas_reaches_every_nystrom_attention_and_ppeg():
    args, _ = config.parse_args(["--no-use-pallas"])
    kwargs = config.model_kwargs_from_args(args)
    assert kwargs["use_pallas"] is False
    assert config.model_kwargs_from_args(config.parse_args([])[0])["use_pallas"] is True
    model = registry.create_model("mirror", device="cpu", embed_dim=48, wsi_embed_dim=16,
                                  rna_embed_dim=20, num_prototypes=10, **kwargs)
    flags = [m.use_pallas for m in model.modules() if hasattr(m, "use_pallas")]
    assert len(flags) == 4 and not any(flags)  # 3 Nystrom attentions and PPEG


def test_no_use_pallas_runs_the_plain_path(monkeypatch):
    """With use_pallas=False no kernel wrapper is reached, whatever the
    device, and the forward equals the default CPU path's."""
    from mirror_tpu_torch.models import nystrom, transmil

    torch.manual_seed(0)
    kernel_layer = NystromAttention(dim=64, dim_head=16, heads=4, num_landmarks=8).eval()
    plain_layer = NystromAttention(dim=64, dim_head=16, heads=4, num_landmarks=8,
                                   use_pallas=False).eval()
    plain_layer.load_state_dict(kernel_layer.state_dict())
    x = torch.randn(2, 30, 64)
    want = kernel_layer(x)

    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called on the plain path")
    for mod, attr in ((nystrom, "moore_penrose_pinv"), (nystrom, "landmark_softmax"),
                      (transmil, "ppeg_fused")):
        monkeypatch.setattr(mod, attr, refuse)
    monkeypatch.setattr(NystromAttention, "_forward_kernels", refuse)
    xg = x.clone().requires_grad_()
    out = plain_layer(xg)
    out.square().sum().backward()
    assert torch.allclose(out, want, atol=1e-6) and torch.isfinite(xg.grad).all()
    ppeg = transmil.PPEG(8, use_pallas=False)
    assert ppeg(torch.randn(1, 10, 8), 3, 3).shape == (1, 10, 8)


# --- repair: --checkpoint-hist, the JAX saver's best-k rule ---


class _State:
    step, params, ema_params, opt_state = 0, {}, None, {}


# eval metrics per epoch; None is an unranked epoch (a NaN metric, or no
# validation and no train metric of that name)
SEQUENCES = [
    [0.5, 0.3, None, 0.4, 0.2, 0.6, 0.1, 0.3, 0.3],
    [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7],
    [None, None, None],
]


@pytest.mark.parametrize("max_history", [1, 3, 5])
@pytest.mark.parametrize("decreasing", [True, False])
@pytest.mark.parametrize("metrics", SEQUENCES)
def test_checkpoint_history_follows_the_jax_saver(tmp_path, metrics, decreasing, max_history):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    port_dir.mkdir()
    saver = CheckpointSaver(str(jax_dir), decreasing=decreasing, max_history=max_history,
                            async_save=False)
    history = CheckpointHistory(str(port_dir), max_history, decreasing)

    def stems(root, ext):
        return sorted(p.name[: -len(ext)] for p in root.iterdir() if p.name.endswith(ext))

    for epoch, metric in enumerate(metrics):
        saver.save_checkpoint(_State(), epoch, metric)
        for path in history.paths(epoch, metric):
            Path(path).write_bytes(b"")
        assert stems(port_dir, ".pth.tar") == [s for s in stems(jax_dir, ".msgpack")
                                               if s != "model_best"], (epoch, metric)
