"""The port's kernel self-test (``python -m mirror_tpu_torch.selftest``, the
counterpart of ``bench.py --selftest``) on the CPU, where it runs the
kernels' plain versions at a small size, and the port's NystromAttention at
the self-test's configuration against flax.

Bars for the NystromAttention at dim 512, dh 64, 256 landmarks, fp32 (the
suite's bars): forward within 1e-5 absolute; each parameter's gradient at
cosine >= 0.9999 of flax's.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_tpu.models.nystrom import NystromAttention as JaxNystrom
from mirror_tpu_torch import selftest
from mirror_tpu_torch.convert import state_dict_from_jax
from mirror_tpu_torch.models import NystromAttention
from mirror_tpu_torch.train.checkpoint import to_tensors
from test_torch_port_runctl import one_intra_op_thread  # noqa: F401 (the fixture)

REPO = Path(__file__).resolve().parent.parent
# the self-test at a size the CPU runs in seconds: Nystrom dim 64 (8 heads
# of 8, 32 landmarks) on 70 rows, PPEG [2, 5, 5, 64], the conv [2, 2, 40, 16]
SMALL = dict(batch=2, n=70, dim=64, side=5, conv_shape=(2, 2, 40, 16))


def test_selftest_cpu_prints_all_modes_true(capsys):
    assert selftest.main(["--device", "cpu"], **SMALL) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == selftest.METRIC and line["value"] == 1
    assert line["backend"] == "cpu" and line["device"] == "cpu"
    assert line["modes"] == {"exact": True, "implicit": True, "ppeg_fused": True,
                             "conv_standalone": True}


def test_selftest_fails_on_a_non_finite_input(capsys, monkeypatch):
    """A NaN in the conv's input makes its mode false and the exit code 1."""
    randn = selftest._randn

    def poisoned(gen, shape, dtype=torch.float32, scale=1.0):
        out = randn(gen, shape, dtype, scale)
        if tuple(shape) == SMALL["conv_shape"]:
            out.view(-1)[0] = float("nan")
        return out

    monkeypatch.setattr(selftest, "_randn", poisoned)
    assert selftest.main(["--device", "cpu"], **SMALL) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["value"] == 0
    assert line["modes"] == {"exact": True, "implicit": True, "ppeg_fused": True,
                             "conv_standalone": False}


def test_selftest_needs_a_card_unless_told_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")

    def never(*args, **kwargs):
        raise AssertionError("the self-test ran without a card")

    monkeypatch.setattr(selftest, "selftest", never)
    with pytest.raises(SystemExit, match="--device cpu"):
        selftest.main([])


def test_selftest_and_new_ops_import_with_jax_blocked():
    """jax, flax and the JAX package made unimportable: the self-test and
    the two new ops still load."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'mirror_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import mirror_tpu_torch.selftest, mirror_tpu_torch.ops.conv1d, "
        "mirror_tpu_torch.ops.ln_qkv\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'mirror_tpu') and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


@pytest.mark.parametrize("pinv_grad", ["exact", "implicit"])
def test_selftest_attention_matches_flax(pinv_grad):
    """The self-test's NystromAttention (dim 512, dh 64, 256 landmarks) in
    fp32 on 300 rows (front pad 212, groups of 2), flax's weights carried
    over: the forward and every parameter's gradient."""
    kw = dict(dim=512, dim_head=64, heads=8, num_landmarks=256, pinv_iterations=6,
              residual=True, pinv_grad=pinv_grad)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 300, 512)).astype(np.float32)
    t = rng.standard_normal((2, 300, 512)).astype(np.float32)
    jm = JaxNystrom(**kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]

    def loss(p):
        out = jm.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(out * t), out

    (_, want_out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    want_grads = state_dict_from_jax(jax.device_get(grads))

    port = NystromAttention(**kw)
    port.load_state_dict(to_tensors(state_dict_from_jax(jax.device_get(params))))
    port.eval()
    out = port(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=0, atol=1e-5)
    (out * torch.from_numpy(t)).sum().backward()
    for name, p in port.named_parameters():
        a = p.grad.double().ravel()
        b = torch.tensor(np.asarray(want_grads[name]), dtype=torch.float64).ravel()
        cos = (a @ b / (a.norm() * b.norm())).item()
        assert cos >= 0.9999, (name, cos)
