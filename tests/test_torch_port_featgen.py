"""The port's patch feature extraction against the JAX package's, on the CPU.

Same inputs, made with numpy from a seed, go through the JAX function and
its counterpart in the port; the JAX ViT kernels run in Pallas interpret
mode. Weights are always the JAX ones carried over with
``mirror_tpu_torch.convert`` (the two random inits draw different numbers).
Bounds, with their reasons:
- the ops, fp32, at the bounds tests/test_vit_sublayer_kernels.py holds the
  Pallas kernels to against plain jnp: 1e-5 (mha_natural), 2e-5
  (attn_block), 1e-4 (mlp_block: the TPU kernel's Abramowitz-Stegun erf
  against the port's exact erf, amplified by the fc2 contraction);
- the small ViT (image 32, patch 16, hidden 64, 4 heads, depth 2), fp32,
  2e-4 (tests/test_tools.py's bar for the fused against the dense path);
- its W8A8 path: a few activations land on the other side of a rounding
  boundary when fp32 sums are taken in another order, so it is held by
  cosine >= 0.9999 per image and max abs <= 1e-3 (observed on these inputs:
  cosine 1 within fp32 rounding, max abs 6.6e-7 on features of magnitude 3);
- the truncated ResNet50 at 64x64 with random BN statistics, rtol 1e-4 /
  atol 1e-5 (tests/test_reference_oracle.py's bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_tpu.models.feature_extractors import (
    TruncatedResNet50 as JaxResNet50,
    ViTB16 as JaxViTB16,
    device_normalize as jax_device_normalize,
    load_hf_vit_weights as jax_load_hf_vit_weights,
    load_torch_resnet50_weights as jax_load_resnet50_weights,
)
from mirror_tpu.ops.vit_attn_pallas import (
    attn_block as jax_attn_block,
    mha_natural as jax_mha_natural,
    mlp_block as jax_mlp_block,
)
from mirror_tpu_torch.convert import resnet50_state_dict_from_jax, vit_state_dict_from_jax
from mirror_tpu_torch.models.feature_extractors import (
    TruncatedResNet50,
    ViTB16,
    device_normalize,
    init_weights,
    load_hf_vit_weights,
    load_torch_resnet50_weights,
)
from mirror_tpu_torch.ops import vit_attn
from mirror_tpu_torch.train.checkpoint import to_tensors
from test_torch_port_runctl import one_intra_op_thread  # noqa: F401 (the fixture)

EPS = 1e-6  # non-default, as in tests/test_vit_sublayer_kernels.py


def _np(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


def test_mha_natural_matches_jax():
    rng = np.random.default_rng(0)
    b, n, heads, dh = 3, 37, 4, 16  # odd n
    q, k, v = (_np(rng, b, n, heads * dh) for _ in range(3))
    want = np.asarray(jax_mha_natural(*_j(q, k, v), heads))
    got = vit_attn.mha_natural(*_t(q, k, v), heads).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _attn_args(rng, b, n, heads, dh):
    d = heads * dh
    x = _np(rng, b, n, d)
    ln_s, ln_b = 1.0 + _np(rng, 1, d, scale=0.1), _np(rng, 1, d, scale=0.1)
    wq, wk, wv, wo = (_np(rng, d, d, scale=0.1) for _ in range(4))
    bqkv, bo = _np(rng, 1, 3 * d, scale=0.1), _np(rng, 1, d, scale=0.1)
    return x, ln_s, ln_b, wq, wk, wv, bqkv, wo, bo


def test_attn_block_matches_jax():
    args = _attn_args(np.random.default_rng(1), 2, 29, 4, 8)
    want = np.asarray(jax_attn_block(*_j(*args), 4, EPS))
    got = vit_attn.attn_block(*_t(*args), 4, EPS).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_mlp_block_matches_jax():
    rng = np.random.default_rng(2)
    b, n, d, m = 3, 23, 32, 128
    x = _np(rng, b, n, d)
    ln_s, ln_b = 1.0 + _np(rng, 1, d, scale=0.1), _np(rng, 1, d, scale=0.1)
    w1, b1 = _np(rng, d, m, scale=0.2), _np(rng, 1, m)
    w2, b2 = _np(rng, m, d, scale=0.2), _np(rng, 1, d)
    args = (x, ln_s, ln_b, w1, b1, w2, b2)
    want = np.asarray(jax_mlp_block(*_j(*args), EPS))
    got = vit_attn.mlp_block(*_t(*args), EPS).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_vit_ops_refuse_nondivisible_heads():
    d = 48
    x = torch.zeros(2, 8, d)
    with pytest.raises(ValueError, match="not divisible"):
        vit_attn.attn_block(x, torch.ones(d), torch.zeros(d), *(torch.zeros(d, d),) * 3,
                            torch.zeros(3 * d), torch.zeros(d, d), torch.zeros(d), heads=5)
    with pytest.raises(ValueError, match="not divisible"):
        vit_attn.mha_natural(x, x, x, heads=7)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

SMALL_VIT = dict(image_size=32, patch_size=16, hidden_size=64, depth=2, num_heads=4)


def _jax_vit_params(**kw):
    model = JaxViTB16(**SMALL_VIT, dtype=jnp.float32, **kw)
    init = jax.jit(model.init)
    return model, jax.device_get(init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"])


def _port_vit(params, **kw):
    model = ViTB16(**SMALL_VIT, **kw).eval()
    model.load_state_dict(to_tensors(vit_state_dict_from_jax(params)))
    return model


@pytest.mark.parametrize("jax_use_pallas", [True, False])
def test_vit_matches_jax(jax_use_pallas):
    """The port's one path (on the CPU, the kernels' plain versions) against
    the JAX ViT's fused path and its dense path, on the same weights."""
    jax_model, params = _jax_vit_params(use_pallas=jax_use_pallas)
    images = _np(np.random.default_rng(3), 3, 32, 32, 3)
    want = np.asarray(jax.jit(jax_model.apply)({"params": params}, jnp.asarray(images)))
    with torch.no_grad():
        got = _port_vit(params)(torch.from_numpy(images)).numpy()
    assert got.shape == (3, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_vit_int8_matches_jax():
    jax_model, params = _jax_vit_params(use_pallas=True, quant="int8")
    images = _np(np.random.default_rng(4), 3, 32, 32, 3)
    want = np.asarray(jax.jit(jax_model.apply)({"params": params}, jnp.asarray(images)))
    with torch.no_grad():
        got = _port_vit(params, quant="int8")(torch.from_numpy(images)).numpy()
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() >= 0.9999, cos
    assert np.abs(got - want).max() <= 1e-3


@pytest.fixture(scope="module")
def resnet_variables():
    """The JAX TruncatedResNet50's variables, initialised once."""
    init = jax.jit(JaxResNet50().init)
    return jax.device_get(init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))


def test_truncated_resnet50_matches_jax(resnet_variables):
    net = JaxResNet50()
    # random BN statistics and affine: fresh ones (0, 1) would hide eps
    # placement and statistics wiring
    rng = np.random.default_rng(5)
    variables = jax.tree.map(np.array, resnet_variables)  # a copy
    for tree, fields in ((variables["batch_stats"], ("mean", "var")),
                         (variables["params"], ("scale", "bias"))):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            name = path[-1].key
            if name not in fields or leaf.ndim != 1:
                continue
            node = tree
            for p in path[:-1]:
                node = node[p.key]
            node[name] = {"mean": lambda s: rng.normal(0.0, 0.5, s),
                          "var": lambda s: rng.uniform(0.5, 2.0, s),
                          "scale": lambda s: rng.normal(1.0, 0.2, s),
                          "bias": lambda s: rng.normal(0.0, 0.2, s)}[name](leaf.shape).astype(
                              np.float32)
    x = _np(np.random.default_rng(6), 2, 64, 64, 3)
    want = np.asarray(jax.jit(net.apply)(variables, jnp.asarray(x)))
    model = load_torch_resnet50_weights(TruncatedResNet50().eval(),
                                        to_tensors(resnet50_state_dict_from_jax(variables)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 1024)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# converters and loaders
# ---------------------------------------------------------------------------


def _assert_same_tree(a, b):
    la, lb = jax.tree_util.tree_flatten_with_path(a)[0], jax.tree_util.tree_flatten_with_path(b)[0]
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(path))


def test_vit_converter_inverts_the_jax_loader():
    _, params = _jax_vit_params(use_pallas=True)
    sd = vit_state_dict_from_jax(params)
    _assert_same_tree(jax_load_hf_vit_weights(params, sd), params)
    # the port's loader takes the same state_dict strictly
    load_hf_vit_weights(ViTB16(**SMALL_VIT), sd)
    with pytest.raises(KeyError, match="missing"):
        load_hf_vit_weights(ViTB16(**SMALL_VIT), {k: v for k, v in sd.items()
                                                   if "layer.1." not in k})
    with pytest.raises(KeyError, match="does not have"):
        load_hf_vit_weights(ViTB16(**SMALL_VIT), dict(sd, **{"encoder.layer.2.x": sd["layernorm.bias"]}))


def test_resnet50_converter_inverts_the_jax_loader(resnet_variables):
    variables = resnet_variables
    sd = resnet50_state_dict_from_jax(variables)
    back = jax_load_resnet50_weights(dict(variables), sd)
    _assert_same_tree(back["params"], variables["params"])
    _assert_same_tree(back["batch_stats"], variables["batch_stats"])
    # torchvision's layer4 and fc are not used; a missing layer3 key is refused
    model = load_torch_resnet50_weights(TruncatedResNet50(),
                                        dict(sd, **{"fc.weight": np.zeros((2, 2), np.float32)}))
    assert torch.equal(model.layer3[5].bn3.running_var, torch.from_numpy(np.array(sd["layer3.5.bn3.running_var"])))
    with pytest.raises(KeyError, match="missing"):
        load_torch_resnet50_weights(TruncatedResNet50(), {k: v for k, v in sd.items()
                                                          if not k.startswith("layer3.5")})


def test_port_loads_a_transformers_vit_strictly(monkeypatch):
    """A random HF ViTModel (pooler and all) loads into the port's ViT, which
    then gives HF's CLS feature."""
    monkeypatch.setenv("USE_TF", "0")  # the torch classes only: a faster import
    transformers = pytest.importorskip("transformers")
    cfg = transformers.ViTConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                                 intermediate_size=256, image_size=32, patch_size=16)
    torch.manual_seed(0)
    hf = transformers.ViTModel(cfg).eval()
    model = load_hf_vit_weights(ViTB16(**SMALL_VIT).eval(), hf.state_dict())
    x = torch.from_numpy(_np(np.random.default_rng(7), 2, 3, 32, 32))
    with torch.no_grad():
        want = hf(x).last_hidden_state[:, 0]
        got = model(x.permute(0, 2, 3, 1))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_init_weights_draws_the_jax_scheme():
    model = init_weights(ViTB16(**SMALL_VIT), torch.Generator().manual_seed(0))
    w = model.encoder.layer[0].intermediate["dense"].weight  # [256, 64]: fan_in 64
    std = 64 ** -0.5
    assert w.abs().max() <= 2 * std / 0.87962566103423978 + 1e-6
    assert abs(w.std().item() - std) < 0.05 * std
    assert model.encoder.layer[0].intermediate["dense"].bias.abs().max() == 0
    assert abs(model.embeddings.position_embeddings.std().item() - 0.02) < 0.002
    again = init_weights(ViTB16(**SMALL_VIT), torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))


def test_device_normalize_matches_jax():
    imgs = np.random.default_rng(8).integers(0, 256, (2, 5, 5, 3), dtype=np.uint8)
    np.testing.assert_allclose(device_normalize(torch.from_numpy(imgs)).numpy(),
                               np.asarray(jax_device_normalize(jnp.asarray(imgs))),
                               rtol=1e-6, atol=1e-6)
