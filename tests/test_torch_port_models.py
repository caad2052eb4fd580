"""The PyTorch port's modules against the JAX package's flax modules, fp32 on
the CPU, with the flax weights carried over by ``state_dict_from_jax`` and
the same inputs made with numpy from a seed. Bar: max abs error <= 1e-5
(the bar tests/test_torch_parity.py holds the flax models to)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_tpu.models.classifier import MIRRORClassifier as JaxClassifier
from mirror_tpu.models.nystrom import NystromAttention as JaxNystrom
from mirror_tpu.models.rna_transformer import TransFormer as JaxTransFormer
from mirror_tpu.models.transmil import (
    PPEG as JaxPPEG,
    FeatureTransMIL as JaxFeatureTransMIL,
    TransLayer as JaxTransLayer,
)
from mirror_tpu.tools.import_torch_checkpoint import to_torch_state_dict
from mirror_tpu_torch.convert import state_dict_from_jax
from mirror_tpu_torch.models import (
    PPEG,
    FeatureTransMIL,
    MIRRORClassifier,
    NystromAttention,
    TransFormer,
    TransLayer,
)
from mirror_tpu_torch.train.checkpoint import to_tensors
from test_torch_port_runctl import one_intra_op_thread  # noqa: F401 (the fixture)

ATOL = 1e-5
WSI_IN, RNA_IN, E = 32, 96, 48
N_TOK = 30  # -> 6x6 grid, 6 wrap-padded tokens, 37 rows, 24 landmarks, pad 11


def _init(module, *inputs, **kw):
    init = jax.jit(functools.partial(module.init, **kw))
    return jax.device_get(init(jax.random.PRNGKey(0), *map(jnp.asarray, inputs))["params"])


def _apply(module, params, *inputs, **kw):
    # jit: one compile is faster than running the module op by op
    fn = jax.jit(functools.partial(module.apply, **kw))
    return fn({"params": params}, *(None if a is None else jnp.asarray(a) for a in inputs))


def _port(module: torch.nn.Module, params) -> torch.nn.Module:
    module.load_state_dict(to_tensors(state_dict_from_jax(params)))
    return module.eval()


def _close(port_out, jax_out):
    np.testing.assert_allclose(port_out.detach().numpy(), np.asarray(jax_out),
                               rtol=0, atol=ATOL)


def _classifier_kw(fusion):
    return dict(wsi_embed_dim=WSI_IN, rna_embed_dim=RNA_IN, embed_dim=E, num_classes=3,
                rna_mlp_ratio=2.0, fusion=fusion)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(11)


@pytest.fixture(scope="module")
def classifier_params():
    """flax MIRRORClassifier params by fusion, initialised once."""
    return {
        fusion: _init(JaxClassifier(**_classifier_kw(fusion)),
                      np.zeros((1, N_TOK, WSI_IN)), np.zeros((1, RNA_IN)))
        for fusion in ("concat", "add")
    }


def test_state_dict_from_jax_equals_to_torch_state_dict(classifier_params):
    params = classifier_params["concat"]
    ours, theirs = state_dict_from_jax(params), to_torch_state_dict(params)
    assert list(ours) == list(theirs)
    for key in theirs:
        assert ours[key].shape == theirs[key].shape, key
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
    # and they are exactly the port model's keys
    port = MIRRORClassifier(**_classifier_kw("concat"))
    assert set(port.state_dict()) == set(ours)


@pytest.mark.parametrize("n", [130, 37, 10])
def test_nystrom_attention(rng, n):
    x = rng.standard_normal((2, n, 64)).astype(np.float32)
    kw = dict(dim=64, dim_head=8, heads=8, num_landmarks=32, pinv_iterations=6,
              residual=True)
    params = _init(JaxNystrom(**kw), x)
    port = _port(NystromAttention(**kw), params)
    xt = torch.from_numpy(x)
    # the CPU path (materialised pad, dense attention) against the dense flax path
    _close(port(xt), _apply(JaxNystrom(**kw), params, x))
    # the kernel path's glue (run here with the kernels' plain versions)
    # against the flax Pallas path
    ref = _apply(JaxNystrom(**kw, use_pallas=True), params, x)
    _close(port._forward_kernels(xt), ref)


def test_trans_layer(rng):
    x = rng.standard_normal((2, 37, E)).astype(np.float32)
    params = _init(JaxTransLayer(dim=E), x)
    _close(_port(TransLayer(E), params)(torch.from_numpy(x)),
           _apply(JaxTransLayer(dim=E), params, x))


def test_ppeg(rng):
    x = rng.standard_normal((2, 1 + 36, E)).astype(np.float32)
    params = _init(JaxPPEG(dim=E), x, h=6, w=6)
    out = _port(PPEG(E), params)(torch.from_numpy(x), 6, 6)
    _close(out, _apply(JaxPPEG(dim=E), params, x, h=6, w=6))


def test_feature_transmil(rng):
    x = rng.standard_normal((2, N_TOK, WSI_IN)).astype(np.float32)
    jm = JaxFeatureTransMIL(input_dim=WSI_IN, embed_dim=E)
    params = _init(jm, x)
    out = _port(FeatureTransMIL(WSI_IN, E), params)(torch.from_numpy(x))
    _close(out, _apply(jm, params, x))


def test_rna_transformer(rng):
    x = rng.standard_normal((3, RNA_IN)).astype(np.float32)
    jm = JaxTransFormer(input_dim=RNA_IN, embed_dim=E, depth=2, mlp_ratio=2.0)
    params = _init(jm, x)
    out = _port(TransFormer(RNA_IN, E, depth=2, mlp_ratio=2.0), params)(torch.from_numpy(x))
    _close(out, _apply(jm, params, x))


@pytest.mark.parametrize("fusion,with_rna", [("concat", True), ("add", True),
                                             ("add", False)])
def test_classifier(rng, classifier_params, fusion, with_rna):
    wsi = rng.standard_normal((2, N_TOK, WSI_IN)).astype(np.float32)
    rna = rng.standard_normal((2, RNA_IN)).astype(np.float32)
    jm = JaxClassifier(**_classifier_kw(fusion))
    params = classifier_params[fusion]
    port = _port(MIRRORClassifier(**_classifier_kw(fusion)), params)
    rna_in = rna if with_rna else None
    rna_t = torch.from_numpy(rna) if with_rna else None
    _close(port(torch.from_numpy(wsi), rna_t), _apply(jm, params, wsi, rna_in))


def test_l2_normalize(rng):
    from mirror_tpu.models.layers import l2_normalize as jax_l2_normalize
    from mirror_tpu_torch.models.layers import l2_normalize

    x = rng.standard_normal((3, E)).astype(np.float32)
    x[1] = 0.0  # the eps floor
    _close(l2_normalize(torch.from_numpy(x)), jax_l2_normalize(jnp.asarray(x)))
