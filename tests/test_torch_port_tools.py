"""The port's tools (ROADMAP item 17) against the JAX package's, fp32 on the
CPU: the flax msgpack decoder against ``flax.serialization``, JAX
``CheckpointSaver`` files of the three archs the port trains read by the
port, ``export_model`` against the JAX ``export_model``'s StableHLO
artifact, ``split_weights`` against the JAX split, the ``mirror::`` ops
(``torch.library.opcheck``), ``MIRROR_PLATFORM``, the launchers and the
port's lint. Bars: max abs error <= 1e-5 (``test_torch_port_models.py``'s)."""

import json
import os
import subprocess
import sys

import flax.serialization as flax_ser
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from mirror_tpu.data import make_synthetic_cohort
from mirror_tpu.models.nystrom import NystromAttention as JaxNystrom
from mirror_tpu.registry import create_model as jax_create_model
from mirror_tpu.tools import export_model as jax_export_model
from mirror_tpu.tools import split_weights as jax_split_weights
from mirror_tpu.train.checkpoint import CheckpointSaver
from mirror_tpu.train.state import create_train_state
from mirror_tpu_torch import config
from mirror_tpu_torch.convert import state_dict_from_jax
from mirror_tpu_torch.models import NystromAttention
from mirror_tpu_torch.ops import landmark, nystrom_attn, pinv, ppeg
from mirror_tpu_torch.registry import create_model
from mirror_tpu_torch.tools import (
    downstream_tasks_evaluator,
    export_model,
    import_jax_checkpoint,
    launcher,
    lint_fallback,
    pretrain_job_launcher,
    split_weights,
)
from mirror_tpu_torch.train import jax_checkpoint
from mirror_tpu_torch.train.checkpoint import load_checkpoint_file, load_pretrained
from mirror_tpu_torch.utils import platform
from test_torch_port_runctl import one_intra_op_thread  # noqa: F401 (the fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
B, N_TOK, WSI_IN, RNA_IN = 2, 16, 32, 96
TINY = dict(wsi_embed_dim=WSI_IN, rna_embed_dim=RNA_IN, embed_dim=48, rna_mlp_ratio=2.0)
ARCH_KW = {
    "mirror_classifier": {**TINY, "num_classes": 3, "fusion": "concat"},
    "mirror": {**TINY, "wsi_num_tokens": N_TOK, "num_prototypes": 8, "style_mlp_hidden_dim": 16,
               "style_mlp_out_dim": 12, "style_latent_dim": 6},
    "mirror_dual": {**TINY, "rna_encoder_depth": 1},
}
_JAX_KEY = jax.random.PRNGKey(0)


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, N_TOK, WSI_IN)).astype(np.float32),
            rng.standard_normal((B, RNA_IN)).astype(np.float32))


def _jax_forward(arch, model, params, wsi, rna):
    """The JAX model's inference outputs, as numpy: the logits, MIRROR's
    two aligned embeddings at mask ratio 0, the dual encoder's pair."""
    if arch == "mirror":
        out = jax.jit(lambda p, w, r: model.apply(
            {"params": p}, w, r, 0.0, 0.0, True,
            rngs={"masking": _JAX_KEY, "style": _JAX_KEY}))(params, wsi, rna)
        return [np.asarray(out[0]), np.asarray(out[7])]
    out = jax.jit(lambda p, w, r: model.apply({"params": p}, w, r, True))(params, wsi, rna)
    return [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))]


def _port_forward(arch, model, wsi, rna):
    with torch.no_grad():
        if arch == "mirror":
            out = export_model.Embed(model)(torch.from_numpy(wsi), torch.from_numpy(rna))
        else:
            out = model(torch.from_numpy(wsi), torch.from_numpy(rna))
    return [o.numpy() for o in (out if isinstance(out, tuple) else (out,))]


@pytest.fixture(scope="module")
def jax_ckpts(tmp_path_factory):
    """Per arch: (flax model, params, EMA params, model_best.msgpack), saved
    by the JAX ``CheckpointSaver`` with an Adam state and an EMA that is not
    the live weights."""
    root = tmp_path_factory.mktemp("jax_ckpts")
    wsi, rna = _inputs(0)
    out = {}
    for arch, kw in ARCH_KW.items():
        model = jax_create_model(arch, **kw)
        rngs = dict(zip(["params", "dropout", "masking", "style"], jax.random.split(_JAX_KEY, 4)))
        extra = (0.75, 0.75, True) if arch == "mirror" else (True,)
        init = jax.jit(lambda r, w, x: model.init(r, w, x, *extra))  # one compile: faster
        params = jax.device_get(init(rngs, wsi, rna)["params"])
        ema = jax.tree.map(lambda x: np.asarray(x) * 0.5, params)
        state = create_train_state(params, optax.adam(1e-3), model_ema=True)
        state = state.replace(ema_params=ema)
        saver = CheckpointSaver(str(root / arch), arch=arch,
                                args_text=yaml.safe_dump({"model": arch}),
                                decreasing=True, async_save=False)
        saver.save_checkpoint(state, 3, 0.25)
        out[arch] = (model, params, ema, str(root / arch / "model_best.msgpack"))
    return out


# --------------------------------------------------------------------------
# the msgpack decoder
# --------------------------------------------------------------------------

def _same(want, got, path="") -> None:
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(want) == list(got), path
        for key in want:
            _same(want[key], got[key], f"{path}/{key}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(want) == len(got), path
        for i, (a, b) in enumerate(zip(want, got)):
            _same(a, b, f"{path}/{i}")
    elif getattr(want, "dtype", None) == jnp.bfloat16:
        assert torch.is_tensor(got) and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == np.shape(want), path
        assert np.array_equal(np.asarray(want).view(np.uint16),
                              got.view(torch.int16).numpy().view(np.uint16)), path
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        assert got.shape == want.shape and np.array_equal(got, want), path
    else:
        assert type(got) is type(want) and got == want, (path, want, got)


@pytest.mark.parametrize("chunk", [flax_ser.MAX_CHUNK_SIZE, 64])
def test_msgpack_decoder_matches_flax(monkeypatch, chunk):
    """Every leaf kind that flax writes (maps, lists, str, bin, ints of each
    width, floats, bool, nil, complex, numpy scalars, arrays of each dtype,
    bfloat16 arrays and scalars), with arrays over ``chunk`` bytes split
    into flax's chunked maps (bf16 ones too), decodes bit for bit as
    ``flax.serialization.msgpack_restore`` gives it."""
    rng = np.random.default_rng(3)
    tree = {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "nested": {"i8": np.arange(-5, 5, dtype=np.int8), "u16": np.arange(70, dtype=np.uint16),
                   "f64": rng.standard_normal(40), "bool": np.array([True, False]),
                   "c64": (rng.standard_normal(3) + 1j).astype(np.complex64), "empty": {}},
        "bf16": jnp.asarray(rng.standard_normal((4, 20)), jnp.bfloat16),
        "bf16_big": jnp.asarray(rng.standard_normal(100), jnp.bfloat16),
        "big_i64": np.arange(33, dtype=np.int64), "scalar0d": np.float32(2.5),
        "np_scalars": [np.int32(-7), np.float64(0.125), np.asarray(1.5, jnp.bfloat16)[()]],
        "text": "héllo", "long_text": "x" * 300, "bin": b"\x00\xff" * 200,
        "ints": [0, 127, 128, 255, 256, 65536, 2**32, 2**63 - 1, -1, -32, -33, -129, -2**40],
        "floats": [1.5, -0.0, 1e300], "flags": [True, False, None], "cx": 1 - 2j,
        "many": {str(i): i for i in range(20)}, "list16": list(range(20)),
    }
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", chunk)
    data = flax_ser.msgpack_serialize(tree)
    want = flax_ser.msgpack_restore(data)
    if chunk == 64:
        assert b"__msgpack_chunked_array__" in data
    _same(want, jax_checkpoint.msgpack_restore(data))


def test_msgpack_decoder_refuses_what_flax_does_not_write():
    data = flax_ser.msgpack_serialize({"a": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="ends at byte"):
        jax_checkpoint.msgpack_restore(data[:-2])
    with pytest.raises(ValueError, match="bytes after its value"):
        jax_checkpoint.msgpack_restore(data + b"\x00")
    with pytest.raises(ValueError, match="ext type 7"):
        jax_checkpoint.msgpack_restore(b"\x81\xa1a\xd4\x07\x00")
    with pytest.raises(ValueError, match="type byte 0xc1"):
        jax_checkpoint.msgpack_restore(b"\xc1")


# --------------------------------------------------------------------------
# JAX checkpoints read by the port
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCH_KW))
def test_jax_checkpoint_imports_and_matches_the_jax_forward(jax_ckpts, tmp_path, arch):
    """A JAX ``CheckpointSaver`` file through ``import_jax_checkpoint``: the
    payload keys carried, the optax state dropped, the EMA as
    ``state_dict_ema``; the weights load strict into the port's model, whose
    forward matches the JAX forward; ``load_checkpoint_file`` reads the
    msgpack file itself to the same tensors."""
    model, params, ema, ckpt = jax_ckpts[arch]
    out = str(tmp_path / "imported.pth.tar")
    assert import_jax_checkpoint.main(["--checkpoint", ckpt, "--output", out]) == out
    payload = load_checkpoint_file(out)
    assert (payload["epoch"], payload["arch"], payload["metric"], payload["version"]) == \
        (3, arch, 0.25, 2)
    assert yaml.safe_load(payload["args"]) == {"model": arch}
    assert "opt_state" not in payload and "ema_state_dict" not in payload
    for key, want in state_dict_from_jax(ema).items():
        assert torch.equal(payload["state_dict_ema"][key], torch.from_numpy(want)), key
    direct = load_checkpoint_file(ckpt)
    assert direct.keys() == payload.keys()
    for key, value in payload["state_dict"].items():
        assert torch.equal(direct["state_dict"][key], value), key

    port = create_model(arch, device="cpu", **ARCH_KW[arch])
    port.load_state_dict(payload["state_dict"])  # strict
    wsi, rna = _inputs()
    for got, want in zip(_port_forward(arch, port, wsi, rna),
                         _jax_forward(arch, model, params, wsi, rna)):
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_orbax_directories_and_other_files_are_refused_by_name(tmp_path):
    orbax = tmp_path / "last.orbax"
    orbax.mkdir()
    for call in (lambda: load_checkpoint_file(str(orbax)),
                 lambda: import_jax_checkpoint.import_checkpoint(str(orbax), str(tmp_path / "x")),
                 lambda: split_weights.main([str(orbax)])):
        with pytest.raises(SystemExit, match=r"Orbax checkpoint .*tensorstore.*msgpack"):
            call()
    other = tmp_path / "notes.txt"
    other.write_text("not a checkpoint")
    with pytest.raises(SystemExit, match="not a flax msgpack checkpoint"):
        import_jax_checkpoint.import_checkpoint(str(other), str(tmp_path / "x"))


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """The JAX package's synthetic cohort at the tiny widths: 8 patients, 2
    folds, 32-d features, 96 genes, two classes."""
    root = tmp_path_factory.mktemp("tools_cohort")
    return make_synthetic_cohort(str(root / "c"), n_patients=8, feature_dim=WSI_IN,
                                 rna_dim=RNA_IN, min_tokens=10, max_tokens=30, num_folds=2)


def _pretrain_config(cohort, out_root) -> dict:
    return dict(wsi_feature_dir=cohort["feature_dir"], rna_feature_csv=cohort["rna_csv"],
                split_dir=cohort["splits_dir"], num_wsi_feature_tokens=N_TOK, batch_size=4,
                epochs=1, lr=1e-4, amp=False, k=2, output=out_root, log_interval=1,
                model_kwargs={k: v for k, v in ARCH_KW["mirror"].items() if k != "rna_embed_dim"})


def _subtyping_config(cohort, out_root) -> dict:
    return dict(wsi_feature_dir=cohort["subtype_feature_dir"], rna_feature_csv=cohort["rna_csv"],
                split_dir=cohort["splits_dir"], classes=cohort["classes"], num_classes=2,
                num_wsi_feature_tokens=N_TOK, batch_size=4, epochs=1, lr=1e-3, amp=False, k=2,
                model="mirror_classifier", output=out_root, log_interval=1,
                model_kwargs={k: v for k, v in TINY.items() if k != "rna_embed_dim"})


def _write_yaml(path, cfg) -> str:
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_resume_from_a_jax_checkpoint_is_refused_and_it_warm_starts(jax_ckpts, cohort,
                                                                      tmp_path):
    """``--resume x.msgpack`` is refused by name (its optax state has no
    counterpart); ``--initial-checkpoint x.msgpack`` warm-starts the port's
    subtyping CLI: under the linear probe the encoders keep the JAX
    checkpoint's weights."""
    from mirror_tpu_torch import train_mirror, train_subtyping

    ckpt = jax_ckpts["mirror"][3]
    pre = _write_yaml(tmp_path / "pre.yaml", _pretrain_config(cohort, str(tmp_path / "runs")))
    with pytest.raises(SystemExit, match=r"--resume .*a JAX package checkpoint.*opt_state.*"
                                         r"--initial-checkpoint"):
        train_mirror.main(["--config", pre, "--device", "cpu", "--resume", ckpt])
    sub = _write_yaml(tmp_path / "sub.yaml", _subtyping_config(cohort, str(tmp_path / "runs")))
    train_subtyping.main(["--config", sub, "--device", "cpu", "--linear-probe",
                          "--experiment", "warm", "--initial-checkpoint", ckpt])
    saved = load_checkpoint_file(str(tmp_path / "runs" / "subtyping" / "warm" / "last.pth.tar"))
    want = state_dict_from_jax(jax_ckpts["mirror"][1])
    for key in ("wsi_encoder._fc1.0.weight", "wsi_encoder.layer1.attn.to_qkv.weight",
                "rna_encoder.blocks.0.mlp.fc1.weight"):
        assert torch.equal(saved["state_dict"][key], torch.from_numpy(want[key])), key


# --------------------------------------------------------------------------
# export_model and the mirror:: ops
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode,arch", [("classifier", "mirror_classifier"), ("embed", "mirror")])
def test_export_matches_the_jax_export(jax_ckpts, tmp_path, mode, arch):
    """``export_model`` on the CPU against the JAX ``export_model``'s
    artifact (``jax.export.deserialize(...).call``) from the same msgpack
    checkpoint and inputs; the manifest; the graph's ``mirror::`` ops (the
    plain path's pinv and PPEG); the ``.pt2`` after ``torch.export.load``."""
    ckpt = jax_ckpts[arch][3]
    kw = ARCH_KW[arch]
    wsi, rna = _inputs()
    jax_out = str(tmp_path / "jax.stablehlo")
    jax_export_model.export_model(mode, arch, ckpt, jax_out, batch=B, num_tokens=N_TOK,
                                  wsi_dim=WSI_IN, rna_dim=RNA_IN, model_kwargs=kw)
    with open(jax_out, "rb") as f:
        want = jax.export.deserialize(f.read()).call(wsi, rna)
    want = [np.asarray(w) for w in (want if isinstance(want, (tuple, list)) else (want,))]

    out = str(tmp_path / "port.pt2")
    manifest = export_model.export_model(mode, arch, ckpt, out, B, N_TOK, WSI_IN, RNA_IN, kw,
                                         device="cpu")
    assert manifest == json.load(open(out + ".json"))
    assert manifest["inputs"] == {"wsi": [B, N_TOK, WSI_IN], "rna": [B, RNA_IN]}
    assert (manifest["mode"], manifest["model"], manifest["device"], manifest["dtype"]) == \
        (mode, arch, "cpu", "float32")
    assert manifest["bytes"] == os.path.getsize(out) and manifest["torch"] == torch.__version__
    assert manifest["ops"] == ["mirror::pinv", "mirror::ppeg"]
    program = torch.export.load(out)
    assert export_model.mirror_ops(program) == manifest["ops"]
    with torch.no_grad():
        got = program.module()(torch.from_numpy(wsi), torch.from_numpy(rna))
    got = [g.numpy() for g in (got if isinstance(got, tuple) else (got,))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


def test_exported_program_loads_with_the_ops_module_alone(jax_ckpts, tmp_path):
    """The ``.pt2`` runs in a fresh process that imports only
    ``mirror_tpu_torch.ops`` (the model code stays unimported), bit for bit
    the exporting process's run; the CLI writes it."""
    ckpt = jax_ckpts["mirror_classifier"][3]
    out = str(tmp_path / "clf.pt2")
    kw = [f"{k}={v}" for k, v in ARCH_KW["mirror_classifier"].items()]
    export_model.main(["--checkpoint", ckpt, "--output", out, "--batch", str(B),
                       "--num-tokens", str(N_TOK), "--wsi-dim", str(WSI_IN), "--rna-dim",
                       str(RNA_IN), "--device", "cpu", "--model-kwargs", *kw])
    wsi, rna = _inputs()
    np.save(tmp_path / "wsi.npy", wsi)
    np.save(tmp_path / "rna.npy", rna)
    code = (
        "import sys, numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "import mirror_tpu_torch.ops\n"
        "d = sys.argv[1]\n"
        "program = torch.export.load(d + '/clf.pt2').module()\n"
        "with torch.no_grad():\n"
        "    out = program(torch.from_numpy(np.load(d + '/wsi.npy')),\n"
        "                  torch.from_numpy(np.load(d + '/rna.npy')))\n"
        "np.save(d + '/out.npy', out.numpy())\n"
        "assert 'mirror_tpu_torch.models' not in sys.modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-2000:]
    with torch.no_grad():
        here = torch.export.load(out).module()(torch.from_numpy(wsi), torch.from_numpy(rna))
    assert np.array_equal(np.load(tmp_path / "out.npy"), here.numpy())


class _KernelPath(torch.nn.Module):
    """The Nystrom attention's kernel path, which a CUDA input takes, called
    on the CPU: its ops run their plain versions."""

    def __init__(self, attn):
        super().__init__()
        self.attn = attn

    def forward(self, x):
        return self.attn._forward_kernels(x)


def test_kernel_path_ops_trace_and_round_trip(tmp_path):
    """At dh 16 and 8 landmarks the kernel path exports as its four
    ``mirror::`` ops, survives save and load bit for bit the eager call,
    and matches the JAX NystromAttention."""
    dim, heads, dh, m, n = 32, 2, 16, 8, 37
    attn = NystromAttention(dim, dim_head=dh, heads=heads, num_landmarks=m).eval()
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((B, n, dim)).astype(np.float32))
    with torch.no_grad():
        program = torch.export.export(_KernelPath(attn), (x,))
        eager = attn._forward_kernels(x)
    assert export_model.mirror_ops(program) == [
        "mirror::landmark_softmax", "mirror::pinv", "mirror::softmax_attn",
        "mirror::softmax_attn_conv"]
    torch.export.save(program, str(tmp_path / "attn.pt2"))
    with torch.no_grad():
        got = torch.export.load(str(tmp_path / "attn.pt2")).module()(x)
    assert torch.equal(got, eager)
    jm = JaxNystrom(dim=dim, dim_head=dh, heads=heads, num_landmarks=m, pinv_iterations=6,
                    residual=True)
    params = jax.device_get(jm.init(_JAX_KEY, jnp.asarray(x.numpy()))["params"])
    attn.load_state_dict({k: torch.tensor(v) for k, v in state_dict_from_jax(params).items()})
    with torch.no_grad():
        got = attn._forward_kernels(x)
    want = jm.apply({"params": params}, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def _op_cases():
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    b, h, n, dh, m, pad = 2, 2, 37, 16, 8, 3
    q, k, v, q_l = r(b, h, n, dh), r(b, h, n, dh), r(b, h, n, dh), r(b, h, m, dh)
    x = torch.softmax(r(b, h, m, m), -1)
    return {
        "landmark_softmax": (landmark.landmark_softmax_op, (q, k, m, pad)),
        "pinv": (pinv.pinv_op, (x, pinv.global_scale(x), 6)),
        "softmax_attn": (nystrom_attn.softmax_attn_op, (q_l, k, v, pad, "softmax_attn", False)),
        "softmax_attn_keep": (nystrom_attn.softmax_attn_op,
                              (q_l, k, v, pad, "softmax_attn", True)),
        "softmax_attn_conv": (nystrom_attn.softmax_attn_conv_op,
                              (q, q_l, q_l, v, r(h, 33), pad, False)),
        "softmax_attn_conv_keep": (nystrom_attn.softmax_attn_conv_op,
                                   (q, q_l, q_l, v, r(h, 33), pad, True)),
        "ppeg": (ppeg.ppeg_op, (r(2, 5, 5, 8), r(7, 7, 8), r(8))),
    }


@pytest.mark.parametrize("name", sorted(_op_cases()))
def test_mirror_ops_pass_opcheck(name):
    """Each op's schema, CPU implementation and fake implementation agree
    (``torch.library.opcheck``: the fake's shapes and dtypes are the CPU
    implementation's, lse and o_attn where kept)."""
    op, args = _op_cases()[name]
    torch.library.opcheck(op, args)


# --------------------------------------------------------------------------
# split_weights
# --------------------------------------------------------------------------

def test_split_weights_matches_the_jax_split(jax_ckpts, tmp_path):
    """The port's split of a JAX checkpoint against the JAX tool's: the same
    keys and values after ``state_dict_from_jax`` (the encoder prefix kept,
    no mask_token), the payload's keys carried; the wsi file warm-starts a
    port classifier."""
    ckpt = jax_ckpts["mirror"][3]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_split_weights.split_weights(ckpt, str(tmp_path / "jax"))
    paths = split_weights.split_weights(ckpt, str(tmp_path / "port"))
    assert [os.path.basename(p) for p in paths] == ["wsi_model_best.pth.tar",
                                                    "rna_model_best.pth.tar"]
    for modality, path in zip(("wsi", "rna"), paths):
        want = state_dict_from_jax(
            jax_checkpoint.msgpack_restore(
                open(tmp_path / "jax" / f"{modality}_model_best.msgpack", "rb").read()
            )["state_dict"])
        got = load_checkpoint_file(path)
        assert sorted(got["state_dict"]) == sorted(want)
        assert f"{modality}_encoder.mask_token" not in got["state_dict"]
        for key, value in want.items():
            assert torch.equal(got["state_dict"][key], torch.from_numpy(value)), key
        assert (got["epoch"], got["arch"], got["metric"], got["version"]) == (3, "mirror", 0.25, 2)
    clf = create_model("mirror_classifier", device="cpu", generator=torch.Generator().manual_seed(0),
                       **ARCH_KW["mirror_classifier"])
    loaded, _ = load_pretrained(clf, paths[0])
    assert "wsi_encoder._fc1.0.weight" in loaded
    assert torch.equal(clf.state_dict()["wsi_encoder._fc1.0.weight"],
                       load_checkpoint_file(paths[0])["state_dict"]["wsi_encoder._fc1.0.weight"])


# --------------------------------------------------------------------------
# MIRROR_PLATFORM and the launchers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("value,device", [(None, "cuda"), ("", "cuda"), ("cuda", "cuda"),
                                          ("cpu", "cpu")])
def test_mirror_platform_is_the_device_default(monkeypatch, value, device):
    """``MIRROR_PLATFORM`` sets the default of ``--device`` of the training
    CLIs (a YAML ``device: tpu`` means that default) and the tools; an
    explicit ``--device`` wins."""
    if value is None:
        monkeypatch.delenv(platform.ENV, raising=False)
    else:
        monkeypatch.setenv(platform.ENV, value)
    assert platform.default_device() == device
    assert config.parse_args([], task="subtyping")[0].device == device
    template = os.path.join(REPO, "configs", "subtyping", "mirror.template.yaml")
    assert config.parse_args(["--config", template], task="subtyping")[0].device == device
    assert config.parse_args(["--device", "cuda"])[0].device == "cuda"
    assert config.parse_args(["--device", "cpu"])[0].device == "cpu"


def test_an_unknown_mirror_platform_is_refused_by_name(monkeypatch, tmp_path):
    monkeypatch.setenv(platform.ENV, "tpu")
    with pytest.raises(SystemExit, match=r"MIRROR_PLATFORM='tpu': the PyTorch port runs on "
                                         r"cuda or cpu"):
        config.parse_args([])
    with pytest.raises(SystemExit, match="MIRROR_PLATFORM='tpu'"):
        export_model.main(["--checkpoint", "x", "--output", str(tmp_path / "x.pt2")])


def test_resource_manager_cycles_slots():
    mgr = launcher.GPUResourceManager(["a", "b"], virtual_factor=1)
    s1, s2 = mgr.acquire(), mgr.acquire()
    assert {s1, s2} == {"a", "b"} and mgr.total == 2
    mgr.release(s1)
    assert mgr.acquire() == s1
    assert launcher.GPUResourceManager(["0"], virtual_factor=3).total == 3


def test_run_jobs_reports_failures():
    codes = launcher.run_jobs([[sys.executable, "-c", "pass"],
                               [sys.executable, "-c", "raise SystemExit(3)"],
                               ["/nonexistent/binary"]], slots=["0"])
    assert codes == [0, 3, -1]


_ENV_PROBE = ("import os, sys, time; time.sleep(0.4); open(sys.argv[1], 'w').write("
              "'|'.join(os.environ.get(k, 'MISSING') for k in sys.argv[2:]))")


def test_run_jobs_pins_distinct_cards_and_the_cpu_slot(tmp_path):
    """Each child sees its slot's ``CUDA_VISIBLE_DEVICES`` (the reference's
    pretrain_job_launcher.py:86), both slots in use at once; the ``cpu``
    slot sets ``MIRROR_PLATFORM=cpu`` and no card."""
    outs = [str(tmp_path / f"env_{i}.txt") for i in range(4)]
    codes = launcher.run_jobs([[sys.executable, "-c", _ENV_PROBE, o, "CUDA_VISIBLE_DEVICES"]
                               for o in outs], slots=["0", "1"])
    assert codes == [0, 0, 0, 0]
    assert {open(o).read() for o in outs} == {"0", "1"}
    out = str(tmp_path / "cpu.txt")
    assert launcher.default_slot_env("cpu") == {"MIRROR_PLATFORM": "cpu"}
    assert launcher.run_jobs([[sys.executable, "-c", _ENV_PROBE, out, "MIRROR_PLATFORM"]],
                             slots=["cpu"]) == [0]
    assert open(out).read() == "cpu"


def test_run_distributed_sets_the_env_contract(tmp_path):
    """Each process gets ``parallel/distributed.py``'s env contract and its
    own ``LOCAL_RANK``."""
    keys = ["MIRROR_COORDINATOR", "MIRROR_NUM_PROCESSES", "MIRROR_PROCESS_ID", "LOCAL_RANK"]
    out = str(tmp_path / "env_{}.txt")
    code = _ENV_PROBE.replace("sys.argv[1]", "sys.argv[1].format(os.environ['LOCAL_RANK'])")
    codes = launcher.run_distributed([sys.executable, "-c", code, out, *keys], 2,
                                     coordinator="localhost:29999")
    assert codes == [0, 0]
    for i in range(2):
        assert open(out.format(i)).read() == f"localhost:29999|2|{i}|{i}"


def test_fold_discovery_takes_fold_1_never_fold_10(tmp_path):
    """Both drivers' discovery on laid-out run directories: fold 1's files,
    never fold 10's or 11's, the newest recovery or last one to resume
    from, the newest run's model_best (else last) to warm-start."""
    runs = tmp_path / "pretrain"
    files = {"20260101-000000-mirror-fold_1": ("last.pth.tar", "model_best.pth.tar"),
             "20260102-000000-mirror-fold_1": ("last.pth.tar", "recovery.pth.tar"),
             "20260103-000000-mirror-fold_10": ("recovery.pth.tar", "model_best.pth.tar"),
             "20260103-000000-mirror-fold_11": ("last.pth.tar",)}
    for t, (run, names) in enumerate(sorted(files.items())):
        (runs / run).mkdir(parents=True)
        for j, name in enumerate(names):
            (runs / run / name).write_text("")
            os.utime(runs / run / name, (1000 + 10 * t + j,) * 2)
    newest = pretrain_job_launcher.newest_resumable(str(tmp_path), 1)
    assert newest == str(runs / "20260102-000000-mirror-fold_1" / "recovery.pth.tar")
    assert pretrain_job_launcher.newest_resumable(str(tmp_path), 2) is None
    assert pretrain_job_launcher.newest_resumable("", 1) is None
    find = downstream_tasks_evaluator.find_fold_checkpoint
    assert find(str(runs), 1) == str(runs / "20260102-000000-mirror-fold_1" / "last.pth.tar")
    assert find(str(runs), 10) == str(runs / "20260103-000000-mirror-fold_10" / "model_best.pth.tar")
    assert find(str(runs), 11) == str(runs / "20260103-000000-mirror-fold_11" / "last.pth.tar")
    assert find(str(runs), 0) is None
    assert split_weights.find_latest_checkpoint(str(runs)).endswith("fold_10/model_best.pth.tar")


def test_pretrain_launcher_then_evaluator_on_the_cpu_slot(cohort, tmp_path):
    """k 2 folds of ``train_mirror`` on the ``cpu`` slot (two at once), then
    the evaluator's subtyping runs warm-started from each fold's
    ``model_best.pth.tar``: exit codes 0, a run directory and the
    ``--result`` of each."""
    out_root = str(tmp_path / "runs")
    pre = _write_yaml(tmp_path / "pre.yaml", _pretrain_config(cohort, out_root))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop(platform.ENV, None)
    proc = subprocess.run(
        [sys.executable, "-m", "mirror_tpu_torch.tools.pretrain_job_launcher", "--config", pre,
         "--k", "2", "--slots", "cpu", "--virtual-factor", "2", "--output-root", out_root],
        cwd=REPO, capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    pretrain_root = os.path.join(out_root, "pretrain")
    ckpts = [downstream_tasks_evaluator.find_fold_checkpoint(pretrain_root, f) for f in (0, 1)]
    assert all(c and c.endswith("model_best.pth.tar") for c in ckpts), ckpts
    assert proc.stdout.count("--result") == 2

    sub = _write_yaml(tmp_path / "sub.yaml", _subtyping_config(cohort, out_root))
    proc = subprocess.run(
        [sys.executable, "-m", "mirror_tpu_torch.tools.downstream_tasks_evaluator",
         "--pretrain-root", pretrain_root, "--task-configs", f"subtyping:{sub}", "--k", "2",
         "--slots", "cpu", "--virtual-factor", "2"],
        cwd=REPO, capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("--result") == 2
    assert "Loaded" in proc.stderr  # the warm start from the pretrain checkpoints
    assert len(os.listdir(os.path.join(out_root, "subtyping"))) == 2


# --------------------------------------------------------------------------
# lint
# --------------------------------------------------------------------------

def test_lint_fallback_finds_no_problem_in_the_port(tmp_path, capsys):
    """The port's tree is clean; the checks fire on a print in library
    code and an unused import, and pass a print under tools/."""
    assert lint_fallback.main([]) == 0
    assert capsys.readouterr().out.endswith(" 0 problems\n")
    lib = tmp_path / "mirror_tpu_torch"
    (lib / "tools").mkdir(parents=True)
    (lib / "mod.py").write_text("import os\n\nprint('x')\nprint('y')  # lint: allow-print\n")
    (lib / "tools" / "cli.py").write_text("print('x')\n")
    assert lint_fallback.main([str(lib)]) == 1
    out = capsys.readouterr().out
    assert "mod.py:1: unused import 'os'" in out and "mod.py:3: print() in library code" in out
    assert "mod.py:4" not in out and "cli.py" not in out
