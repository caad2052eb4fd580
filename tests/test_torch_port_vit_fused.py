"""The fused ViT sub-layer probe (``mirror_tpu_torch/scripts/
exp_vit_fused_sublayer.py``, ``ops/vit_fused.py``) against the TPU script
``scripts/exp_vit_fused_sublayer.py``, on the CPU.

The script is loaded by path, its module constants set small with
``monkeypatch`` (``_k5_kernel`` and the builders read them as globals: 2
heads of 16, d 32, MLP 128, and n 20, which is not a multiple of 16), and
its ``pallas_call``s run in interpret mode, as the JAX package's tests run
its kernels on the CPU. Nothing under ``scripts/`` changes. Both sides get
the same numpy inputs and the script's own ``make_weights``, in fp32, where
every rounding point is the identity: the port's plain versions are held
within 1e-5 of the largest value (sums in another order; the script's A&S
erf is within 1.5e-7 of ``torch.erf``).
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

from mirror_tpu.ops.vit_attn_pallas import attn_block as jax_attn_block
from mirror_tpu.ops.vit_attn_pallas import mlp_block as jax_mlp_block
from mirror_tpu_torch.ops import vit_fused
from mirror_tpu_torch.scripts import exp_vit_fused_sublayer as probe

REPO = Path(__file__).resolve().parent.parent
REL = 1e-5
HEADS, DH, N, BATCH = 2, 16, 20, 4
D, MLP = HEADS * DH, 4 * HEADS * DH


def _close(port, ref, rel=REL, name=""):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, name
    err = np.abs(port - ref).max()
    bound = rel * np.abs(ref).max()
    assert err <= bound, f"{name}: max abs err {err} > {rel} x {np.abs(ref).max()}"


@pytest.fixture
def script(monkeypatch):
    """``scripts/exp_vit_fused_sublayer.py`` at the small shape, its
    pallas_calls in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    spec = importlib.util.spec_from_file_location(
        "_tpu_script_exp_vit_fused_sublayer", REPO / "scripts" / "exp_vit_fused_sublayer.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    for name, value in dict(H=HEADS, DH=DH, D=D, MLP=MLP, SCALE=DH ** -0.5, N=N).items():
        monkeypatch.setattr(module, name, value)
    return module


def _inputs(script, seed):
    """The same fp32 activations and the script's weights (drawn in bf16,
    carried across as fp32) for both sides."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((BATCH, N, D)).astype(np.float32)
    arrays = {k: np.asarray(v, np.float32) for k, v in
              script.make_weights(jax.random.PRNGKey(seed)).items()}
    jax_wts = {k: jnp.asarray(v) for k, v in arrays.items()}
    return y, jax_wts, probe.weights_from_numpy(arrays)


# (port variant, script builder, G): the four fused kernels at G 1 and 2,
# and the split path the port times in place of the script's failing
# xla_*_blk against the fused kernel of the same function
CASES = [(f"k{k}g{g}", f"make_k{k}", g) for k in (5, 7, 8, 9) for g in (1, 2)] + [
    ("xla_attn_blk", "make_k8", 1), ("xla_mlp_blk", "make_k9", 1)]


@pytest.mark.parametrize("name,builder,group", CASES, ids=[c[0] for c in CASES])
def test_fused_sublayer_matches_the_script(script, name, builder, group):
    y, jax_wts, wts = _inputs(script, 1)
    want = getattr(script, builder)(group)(jnp.asarray(y), jax_wts)
    got = probe.VARIANTS[name][1](torch.from_numpy(y), wts, HEADS)
    _close(got.numpy(), want, name=name)


@pytest.mark.parametrize("name", ["xla_attn", "xla_mlp"])
def test_baseline_matches_the_script(script, name):
    """The baselines: q/k/v products, kernel 8's plain version and the out
    product against the script's (its mha_natural in interpret mode);
    fc1, erf GELU, fc2."""
    y, jax_wts, wts = _inputs(script, 2)
    want = script.VARIANTS[name][1](jnp.asarray(y), jax_wts)
    got = probe.VARIANTS[name][1](torch.from_numpy(y), wts, HEADS)
    _close(got.numpy(), want, name=name)
    # the fused kernels' plain versions compute the same functions
    plain = probe.PLAIN[probe.VARIANTS[name][0]](torch.from_numpy(y), wts, HEADS)
    _close(plain.numpy(), want, name=f"{name} plain")


def test_block_plain_versions_are_the_jax_half_blocks(script):
    """k8 and k9 are kernels 6 and 7 with W_qkv whole: their plain versions
    against the JAX package's attn_block and mlp_block (interpret mode)."""
    y, w, wts = _inputs(script, 3)
    yj = jnp.asarray(y)
    qkv = w["qkv"]
    want = jax_attn_block(yj, w["ln_s"], w["ln_b"], qkv[:, :D], qkv[:, D:2 * D], qkv[:, 2 * D:],
                          w["qkv_b"], w["out"], w["out_b"], HEADS, probe.LN_EPS)
    _close(probe.plain_attn_blk(torch.from_numpy(y), wts, HEADS).numpy(), want, name="k8")
    want = jax_mlp_block(yj, w["ln_s"], w["ln_b"], w["fc1"], w["fc1_b"], w["fc2"], w["fc2_b"],
                         probe.LN_EPS)
    _close(probe.plain_mlp_blk(torch.from_numpy(y), wts, HEADS).numpy(), want, name="k9")


def test_make_weights_has_the_script_keys_and_shapes():
    spec = importlib.util.spec_from_file_location(
        "_tpu_script_weights", REPO / "scripts" / "exp_vit_fused_sublayer.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    want = module.make_weights(jax.random.PRNGKey(0))
    got = probe.make_weights(torch.device("cpu"))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert got[k].dtype == (torch.bfloat16 if k in probe.MATRICES else torch.float32), k


def test_probe_runs_on_the_cpu_and_ends_in_json(capsys):
    assert probe.main(["--device", "cpu", "--batch", "2"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["probe"] == "exp_vit_fused_sublayer" and line["device"] == "cpu"
    assert [r["name"] for r in line["variants"]] == list(probe.VARIANTS)
    for r in line["variants"]:
        assert r["ms"] is None and math.isfinite(r["err"]) and math.isfinite(r["max_abs_diff"])
        if r["name"].startswith("k"):  # the plain versions themselves on the CPU
            assert r["err"] == 0.0 and r.get("err_added", 0.0) == 0.0
    # the products counted for the bound at B 512, as csrc/vit_fused.cu's
    # note states them: 5.37e11 FLOP (k5, k8) and 9.52e11 (k7, k9)
    assert probe.work("attn_blk", 512, probe.make_weights(torch.device("cpu")))["mma"] \
        == pytest.approx(5.37e11, rel=1e-3)
    assert probe.work("mlp", 512, probe.make_weights(torch.device("cpu")))["mma"] \
        == pytest.approx(9.52e11, rel=1e-3)


@pytest.mark.parametrize("variants", [["k5g1"], ["k9g2"]])
def test_probe_exits_1_beyond_a_bar(variants, monkeypatch):
    from mirror_tpu_torch.scripts import _timing

    monkeypatch.setattr(_timing, "BOUND_SINGLE_ROUNDING", -1.0)
    assert probe.main(["--device", "cpu", "--batch", "2", "--variants", *variants]) == 1


def test_probe_exits_1_on_a_wrong_kernel(monkeypatch):
    """A k9 whose added term is 10 % off is caught by ``err_added`` even
    where the whole output's error stays under the bar."""
    fused = vit_fused.fused_mlp_block

    def off(x, *a, **k):
        out = fused(x, *a, **k)
        return (x.float() + 1.1 * (out.float() - x.float())).to(x.dtype)

    monkeypatch.setattr(vit_fused, "fused_mlp_block", off)
    assert probe.main(["--device", "cpu", "--batch", "2", "--variants", "k9g1"]) == 1


def test_probe_module_runs_as_a_script():
    out = subprocess.run([sys.executable, "-m", "mirror_tpu_torch.scripts.exp_vit_fused_sublayer",
                          "--device", "cpu", "--batch", "2"], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    assert json.loads(out.strip().splitlines()[-1])["probe"] == "exp_vit_fused_sublayer"


def test_probe_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        probe.main(["--batch", "2"])


def _small_weights(seed=4):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(*shape, generator=g) * 0.1 for k, shape in dict(
        qkv=(D, 3 * D), qkv_b=(1, 3 * D), out=(D, D), out_b=(1, D), fc1=(D, MLP),
        fc1_b=(1, MLP), fc2=(MLP, D), fc2_b=(1, D), ln_s=(1, D), ln_b=(1, D)).items()}


@pytest.mark.parametrize("name", ["k5g1", "k7g1", "k8g1", "k9g1"])
def test_kernel_wrappers_refuse_grad_recording(name):
    """Inference-only, as the TPU kernels (no VJP): an input that autograd
    would track is refused on every device, not detached; under no_grad
    the same call runs."""
    wts = _small_weights()
    x = torch.randn(2, N, D, requires_grad=True)
    fn = probe.VARIANTS[name][1]
    with pytest.raises(RuntimeError, match="inference-only"):
        fn(x, wts, HEADS)
    with torch.no_grad():
        assert fn(x, wts, HEADS).shape == x.shape


@pytest.mark.parametrize("variant", ["stamps", "no_weight_loads", "no_products", "no_gelu",
                                     "no_hidden_stores", "quads_1", "quads_4"])
def test_phase_diagnostic_patches_still_apply(variant):
    """``vit_fused_phases`` builds patched copies of ``csrc/vit_fused.cu``:
    each of its texts still occurs exactly once in the source."""
    from mirror_tpu_torch.scripts import vit_fused_phases

    text = vit_fused_phases.SOURCE.read_text()
    out = vit_fused_phases.patched(text, vit_fused_phases.VARIANTS[variant])
    assert out != text
    with pytest.raises(ValueError, match="exactly one"):
        vit_fused_phases.patched(text.replace("cluster_arrive();  // every", "// every"),
                                 vit_fused_phases.STAMPS)
