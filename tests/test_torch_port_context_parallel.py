"""The port's context parallelism (``parallel/context_parallel.py``) on the
CPU, against the JAX package's on the 8-device CPU mesh.

The JAX side runs here: ``nystrom_attention_cp`` and ``transmil_encode_cp``
on the conftest's mesh (each jitted once a shape), the single-device
``NystromAttention`` and ``FeatureTransMIL.encode``, and the JAX tools
``encode_slide``, ``predict --whole-slide`` and ``predict`` at batch 8. The
port's side runs in ONE spawn of 2 gloo ranks and ONE of 4 for the whole
module (``parallel/cp_worker.py``: every case in each, started when the
module starts, while the JAX side compiles), and without a group here.
The sizes are the JAX tests': dim 32, 4 heads of 8, 16 landmarks, n 256
and 144 (and 128 for the gradient); the TransMIL encoder's input 24, embed
32, 50 patches. Bars: the forward at 2e-4, the gradients (x and every
parameter, the recipe of ``test_context_parallel.py::
test_cp_gradient_parity``: sum(out t), the pinv's exact gradient) and the
encoder at 5e-4.
"""

import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import yaml
from jax.sharding import Mesh

from mirror_tpu.models import NystromAttention as JaxNystrom
from mirror_tpu.models.transmil import FeatureTransMIL as JaxTransMIL
from mirror_tpu.parallel import context_parallel as jax_cp
from mirror_tpu.tools import encode_slide as jax_encode_slide
from mirror_tpu.tools.import_torch_checkpoint import convert_state_dict
from mirror_tpu.tools.predict import predict as jax_predict
from mirror_tpu.train.checkpoint import save_checkpoint_file as jax_save
from mirror_tpu_torch.convert import state_dict_from_jax
from mirror_tpu_torch.models.nystrom import NystromAttention
from mirror_tpu_torch.models.transmil import FeatureTransMIL
from mirror_tpu_torch.parallel import worker
from mirror_tpu_torch.registry import create_model, init_weights
from mirror_tpu_torch.parallel.context_parallel import (
    nystrom_attention_cp,
    transmil_encode_cp,
    wrap_pad_square,
)
from mirror_tpu_torch.tools import encode_slide, gen_patch_feature, predict
from mirror_tpu_torch.train.checkpoint import save_checkpoint_file
from test_torch_port_runctl import one_intra_op_thread  # noqa: F401 (the fixture)

DIM, HEADS, DH, M = 32, 4, 8, 16
ATTN_KW = dict(dim=DIM, dim_head=DH, heads=HEADS, num_landmarks=M, pinv_iterations=6,
               dropout=0.0, pinv_grad="exact")
PLAIN_KW = dict(ATTN_KW, use_pallas=False)  # the plain path (--no-use-pallas)
FORWARD_N = (256, 144, 32)  # 32: blocks of 8 rows at 4 ranks, under the 16-row halo
SINGLE_N = (256, 144)  # also against the single-device module
GRAD_N = 128
ENC_KW = dict(input_dim=24, embed_dim=32, dropout=0.0)
ENCODE_SIZES = (50, 61, 64)  # one grid side (8): one JAX program
CLS_KW = dict(wsi_embed_dim=32, rna_embed_dim=96, embed_dim=48, rna_mlp_ratio=2.0)
PREDICT_SIZES = (40, 37, 49, 44, 45, 38)  # one grid side (7)
PATCHES = {"LUAD/s1": 3, "LUAD/s2": 2, "LUSC/s3": 2}
WORLDS = (2, 4)
LAUNCH_S = 150.0


def _mesh():
    return Mesh(np.array(jax.devices()[:8]).reshape(8, 1), ("data", "model"))


def _torch_state(params):
    return {k: torch.from_numpy(np.array(v)) for k, v in state_dict_from_jax(params).items()}


def _jax_params(state_dict):
    """The port's weights as the JAX package's params (drawn by the port:
    no JAX init to compile)."""
    params, unmapped = convert_state_dict(state_dict)
    assert not unmapped, unmapped
    return params


def _write_patches(root: Path):
    import cv2

    rng = np.random.default_rng(9)
    for slide, n in PATCHES.items():
        os.makedirs(root / slide)
        for i in range(n):
            cv2.imwrite(str(root / slide / f"{i:03d}.png"),
                        rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The weights (drawn by the port, converted), the inputs (numpy, seeded), the
    cohorts and checkpoints of the tools, and the two spawns, started."""
    root = tmp_path_factory.mktemp("cp")
    rng = np.random.default_rng(3)
    attn = NystromAttention(**ATTN_KW)
    init_weights(attn, torch.Generator().manual_seed(0))
    attn_sd = attn.state_dict()
    enc = FeatureTransMIL(**ENC_KW)
    init_weights(enc, torch.Generator().manual_seed(1))
    enc_sd = enc.state_dict()
    attn_params, enc_params = _jax_params(attn_sd), _jax_params(enc_sd)
    xs = {n: rng.standard_normal((n, DIM)).astype(np.float32) for n in FORWARD_N + (GRAD_N,)}
    t = rng.standard_normal((GRAD_N, DIM)).astype(np.float32)
    tokens = rng.standard_normal((50, 24)).astype(np.float32)

    # encode_slide: the encoder's params as the JAX tool's msgpack and the port's .pth.tar
    enc_dir = root / "enc_feats"
    enc_dir.mkdir()
    for i, n in enumerate(ENCODE_SIZES):
        np.save(enc_dir / f"TCGA-CP-{i:04d}-01Z-00-DX1.npy",
                rng.standard_normal((n, 24)).astype(np.float32))
    jax_save(str(root / "enc.msgpack"), {"state_dict": enc_params})
    save_checkpoint_file(str(root / "enc.pth.tar"), enc_sd, args={})

    # predict: a classifier (fp32 run args) and a cohort of one grid side
    cls_sd = create_model("mirror_classifier", device="cpu", num_classes=2,
                          generator=torch.Generator().manual_seed(2), **CLS_KW).state_dict()
    run_args = dict(model="mirror_classifier", model_kwargs=dict(CLS_KW), amp=False,
                    num_classes=2, num_wsi_feature_tokens=16, wsi_feature_only=False)
    jax_save(str(root / "cls.msgpack"), {"epoch": 0, "arch": "mirror_classifier",
                                          "state_dict": _jax_params(cls_sd),
                                          "args": yaml.safe_dump(run_args)})
    save_checkpoint_file(str(root / "cls.pth.tar"), cls_sd, args=run_args)
    pred_dir = root / "pred_feats"
    pred_dir.mkdir()
    ids = [f"TCGA-PR-{i:04d}-01A-01-TS1" for i in range(len(PREDICT_SIZES))]
    for sid, n in zip(ids, PREDICT_SIZES):
        np.save(pred_dir / f"{sid}.npy", rng.standard_normal((n, 32)).astype(np.float16))
    pd.DataFrame(rng.standard_normal((len(ids), 96)).astype(np.float32),
                 index=[s[:15] for s in ids],
                 columns=[f"g{j}" for j in range(96)]).to_csv(root / "rna.csv")
    _write_patches(root / "patches")

    paths = dict(root=root, enc_dir=enc_dir, pred_dir=pred_dir)

    def tool_argv(world):
        out = root / f"w{world}"
        predict_argv = ["--checkpoint", str(root / "cls.pth.tar"), "--task", "subtyping",
                        "--wsi-feature-dir", str(pred_dir), "--rna-feature-csv",
                        str(root / "rna.csv"), "--batch-size", "8", "--seed", "7",
                        "--device", "cpu"]
        return {
            "encode_slide": ["--wsi-feature-dir", str(enc_dir), "--checkpoint",
                             str(root / "enc.pth.tar"), "--output", str(out / "emb"),
                             "--save", "full" if world < 4 else "cls", "--device", "cpu"],
            "predict_whole": predict_argv + ["--whole-slide", "--output",
                                             str(out / "whole.csv")],
            "predict": predict_argv + ["--output", str(out / "pred.csv")],
            "gen_patch_feature": [str(root / "patches"), str(out / "patch_feats"), "--model",
                                  "custom_resnet50", "--batch-size", "2", "--num-threads",
                                  "1", "--device", "cpu"],
        }

    spawns = {}
    for world in WORLDS:
        attention = dict(kind="attention", kwargs=ATTN_KW, state_dict=attn_sd)
        cases = [dict(attention, x=xs[n]) for n in FORWARD_N]
        cases.append(dict(attention, x=xs[GRAD_N], t=t))
        cases.append(dict(attention, x=xs[32], t=_gather_t(xs[32])))
        cases.append(dict(attention, kind="refuse", x=np.zeros((100, DIM), np.float32)))
        cases.append(dict(kind="encoder", kwargs=ENC_KW, state_dict=enc_sd, tokens=tokens))
        cases.append(dict(attention, kwargs=PLAIN_KW, x=xs[GRAD_N], t=t))
        tools = tool_argv(world)
        cases += [dict(kind="main", module=f"mirror_tpu_torch.tools.{tool.split('_whole')[0]}",
                       argv=argv) for tool, argv in tools.items()
                  if world == 2 or tool != "gen_patch_feature"]
        spec = root / f"spec{world}.pt"
        torch.save(dict(device="cpu", cases=cases), spec)
        spawns[world] = worker.start(spec, root / f"out{world}", world, root / f"rdv{world}",
                                     LAUNCH_S, module="mirror_tpu_torch.parallel.cp_worker")
    # predict's own main in 2 ranks under the MIRROR_* env, no group around it
    (root / "bare").mkdir()
    spawns["bare"] = worker.start_ranks(
        [sys.executable, "-m", "mirror_tpu_torch.tools.predict",
         *tool_argv(1)["predict"][:-2], "--output", str(root / "bare" / "pred.csv")],
        2, root / "rdv_bare", root / "bare" / "rank", LAUNCH_S)
    yield dict(attn_params=attn_params, enc_params=enc_params, attn_sd=attn_sd,
               enc_sd=enc_sd, xs=xs, t=t, tokens=tokens, paths=paths, tool_argv=tool_argv,
               spawns=spawns, outputs={})


def ranks(setup, world):
    """Rank 0's results of the ``world`` spawn, the spawn awaited once."""
    if world not in setup["outputs"]:
        setup["outputs"][world] = setup["spawns"][world]()[0]["results"]
    return setup["outputs"][world]


# --------------------------------------------------------------------------
# the JAX side, once a shape
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_forward(setup):
    """n -> (the JAX CP output on the 8-device mesh, the module's)."""
    mesh, params = _mesh(), setup["attn_params"]
    jattn = JaxNystrom(dim=DIM, dim_head=DH, heads=HEADS, num_landmarks=M, pinv_iterations=6,
                       dropout=0.0)
    cp = jax.jit(lambda p, x: jax_cp.nystrom_attention_cp(
        x, p, mesh, axis_name="data", dim_head=DH, heads=HEADS, num_landmarks=M))
    single = jax.jit(lambda p, x: jattn.apply({"params": p}, x[None])[0])
    return {n: (np.asarray(cp(params, setup["xs"][n])),
                np.asarray(single(params, setup["xs"][n])) if n in SINGLE_N else None)
            for n in FORWARD_N}


def _gather_t(x):
    """The t of the gather path's gradient, sum(out t), at n 32."""
    return x[::-1].copy()


@pytest.fixture(scope="module")
def jax_gradient(setup):
    """n -> (dL/dx, dL/dparams as the port's state dict) of the JAX CP
    attention, L = sum(out t): n GRAD_N with the module's t, and n 32 (the
    gather path on the mesh's blocks of 4) with :func:`_gather_t`."""
    mesh, params = _mesh(), setup["attn_params"]

    def loss(p, x, t):
        out = jax_cp.nystrom_attention_cp(x, p, mesh, axis_name="data", dim_head=DH,
                                          heads=HEADS, num_landmarks=M)
        return jnp.sum(out * t)

    grad = jax.jit(jax.grad(loss, argnums=(0, 1)))
    res = {}
    for n, t in ((GRAD_N, setup["t"]), (32, _gather_t(setup["xs"][32]))):
        gp, gx = grad(params, jnp.asarray(setup["xs"][n]), jnp.asarray(t))
        res[n] = np.asarray(gx), _torch_state(jax.device_get(gp))
    return res


@pytest.fixture(scope="module")
def jax_encoder(setup):
    """(the JAX CP whole-slide encoding, FeatureTransMIL.encode's)."""
    params, tokens = setup["enc_params"], jnp.asarray(setup["tokens"])
    jenc = JaxTransMIL(input_dim=24, embed_dim=32)
    cp = jax.jit(lambda p, x: jax_cp.transmil_encode_cp(p, x, _mesh(), axis_name="data"))
    enc = jax.jit(lambda p, x: jenc.apply({"params": p}, x[None], True, method="encode")[0][0])
    return np.asarray(cp(params, tokens)), np.asarray(enc(params, tokens))


@pytest.fixture(scope="module")
def jax_tools(setup):
    """The JAX tools' files: encode_slide (--save full) and the two predict CSVs."""
    root, p = setup["paths"]["root"], setup["paths"]
    jax_encode_slide.main(["--wsi-feature-dir", str(p["enc_dir"]), "--checkpoint",
                           str(root / "enc.msgpack"), "--output", str(root / "jax_emb"),
                           "--save", "full"])
    kw = dict(rna_feature_csv=str(root / "rna.csv"), batch_size=8, seed=7)
    jax_predict(str(root / "cls.msgpack"), "subtyping", str(p["pred_dir"]),
                str(root / "jax_whole.csv"), whole_slide=True, **kw)
    jax_predict(str(root / "cls.msgpack"), "subtyping", str(p["pred_dir"]),
                str(root / "jax_pred.csv"), **kw)
    return dict(emb=root / "jax_emb", whole=root / "jax_whole.csv", pred=root / "jax_pred.csv")


def _attention_here(setup, x, t=None, kwargs=ATTN_KW):
    """The port's CP attention without a group (world 1), its output and
    with ``t`` the gradients, as a rank reports them."""
    attn = NystromAttention(**kwargs).eval()
    attn.load_state_dict(setup["attn_sd"])
    x = torch.from_numpy(x).requires_grad_(t is not None)
    out = nystrom_attention_cp(x, attn)
    res = {"out": out.detach()}
    if t is not None:
        (out * torch.from_numpy(t)).sum().backward()
        res["gx"] = x.grad
        res["grads"] = {n: p.grad for n, p in attn.named_parameters()}
    return res


# the spawns' cases in order: the forwards of FORWARD_N, then these
CASES = ("gradient", "gather_gradient", "refuse", "encoder", "plain_gradient")


def _results(setup, world, case):
    index = FORWARD_N.index(case) if case in FORWARD_N else len(FORWARD_N) + CASES.index(case)
    return ranks(setup, world)[index]


# --------------------------------------------------------------------------
# the attention core
# --------------------------------------------------------------------------

@pytest.mark.parametrize("world", (1,) + WORLDS)
@pytest.mark.parametrize("n", FORWARD_N)
def test_cp_attention_matches_jax(setup, jax_forward, world, n):
    """n 256 and 144 split in whole landmark groups (144: not a multiple of
    m times the ranks); 32 at 4 ranks: blocks of 8 rows under the 16-row
    halo, the gather path (the JAX mesh's blocks of 4 take it too)."""
    got = (_attention_here(setup, setup["xs"][n]) if world == 1
           else _results(setup, world, n))["out"]
    want_cp, want_single = jax_forward[n]
    np.testing.assert_allclose(got.numpy(), want_cp, rtol=2e-4, atol=2e-4)
    if want_single is not None:
        np.testing.assert_allclose(got.numpy(), want_single, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("world", (1,) + WORLDS)
@pytest.mark.parametrize("path", ("kernels", "plain"))
def test_cp_gradient_matches_jax(setup, jax_gradient, world, path):
    """sum(out t) through the exact pinv gradient: x's gradient and every
    parameter's (each rank's summed) against the JAX CP gradient; on the
    kernels' path (their plain versions here: ``KvCombine`` and the conv's
    own backward) and on the plain path (``use_pallas=False``: autograd
    through plain torch, ``KvCombine`` on its plain versions)."""
    kwargs, case = (ATTN_KW, "gradient") if path == "kernels" else (PLAIN_KW, "plain_gradient")
    res = (_attention_here(setup, setup["xs"][GRAD_N], setup["t"], kwargs) if world == 1
           else _results(setup, world, case))
    gx, gp = jax_gradient[GRAD_N]
    np.testing.assert_allclose(res["gx"].numpy(), gx, rtol=5e-4, atol=5e-4)
    assert set(res["grads"]) == set(gp)
    for name, want in gp.items():
        np.testing.assert_allclose(res["grads"][name].numpy(), want.numpy(), rtol=5e-4,
                                   atol=5e-4, err_msg=name)


@pytest.mark.parametrize("world", WORLDS)
def test_cp_gather_path_gradient_matches_world_one(setup, jax_gradient, world):
    """n 32: at 4 ranks each block (8 rows) is shorter than the conv's
    16-row halo, so v is gathered whole; at 2 ranks a block is the halo
    exactly. The gradients against the port's without a group, and
    against the JAX CP gradient (its mesh's blocks of 4 take the gather
    path too) at 5e-4."""
    x = setup["xs"][32]
    res = _results(setup, world, "gather_gradient")
    want = _attention_here(setup, x, _gather_t(x))
    np.testing.assert_allclose(res["gx"].numpy(), want["gx"].numpy(), rtol=1e-5, atol=1e-5)
    for name, g in want["grads"].items():
        np.testing.assert_allclose(res["grads"][name].numpy(), g.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    gx, gp = jax_gradient[32]
    np.testing.assert_allclose(res["gx"].numpy(), gx, rtol=5e-4, atol=5e-4)
    assert set(res["grads"]) == set(gp)
    for name, g in gp.items():
        np.testing.assert_allclose(res["grads"][name].numpy(), g.numpy(), rtol=5e-4, atol=5e-4,
                                   err_msg=name)


@pytest.mark.parametrize("world", (1,) + WORLDS)
def test_cp_refuses_a_misaligned_length(setup, world):
    """n 100 is not a multiple of the 16 landmarks: refused, as the JAX code
    asserts, on every rank alike before any collective."""
    if world == 1:
        with pytest.raises(ValueError, match="multiple of the landmarks"):
            _attention_here(setup, np.zeros((100, DIM), np.float32))
        return
    error = _results(setup, world, "refuse")["error"]
    assert error and "multiple of the landmarks (16)" in error and f"ranks ({world})" in error


# --------------------------------------------------------------------------
# the whole-slide encoder and the tools
# --------------------------------------------------------------------------

@pytest.mark.parametrize("world", (1,) + WORLDS)
def test_whole_slide_encoder_matches_jax(setup, jax_encoder, world):
    """50 patches: the wrap pad to 64, the cls, 65 rows front-padded to 80."""
    if world == 1:
        enc = FeatureTransMIL(**ENC_KW).eval()
        enc.load_state_dict(setup["enc_sd"])
        with torch.no_grad():
            got = transmil_encode_cp(enc, torch.from_numpy(setup["tokens"]))
    else:
        got = _results(setup, world, "encoder")["seq"]
    want_cp, want_encode = jax_encoder
    assert got.shape == want_cp.shape == (65, 32)
    np.testing.assert_allclose(got.numpy(), want_cp, rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(got.numpy(), want_encode, rtol=5e-4, atol=5e-4)


def _run_tool_here(setup, tool):
    """A tool of the port run here without a group, with the spawns' argv
    (its files under ``w1``)."""
    module = {"encode_slide": encode_slide, "predict_whole": predict}[tool]
    module.main(setup["tool_argv"](1)[tool])


@pytest.mark.parametrize("world", (1,) + WORLDS)
def test_encode_slide_matches_the_jax_tool(setup, jax_tools, world):
    """The same weights (``state_dict_from_jax``) in both tools' checkpoint
    formats: --save full at 2 ranks and here, --save cls at 4 (the JAX
    tool's full rows, row 0); the wrap-pad rows trimmed."""
    root = setup["paths"]["root"]
    if world == 1:
        _run_tool_here(setup, "encode_slide")
    else:
        ranks(setup, world)
    files = sorted((root / "jax_emb").glob("*.npy"))
    assert len(files) == len(ENCODE_SIZES)
    for f, n in zip(files, ENCODE_SIZES):
        want = np.load(f)
        got = np.load(root / f"w{world}" / "emb" / f.name)
        assert want.shape == (n + 1, 32)
        if world == 4:
            want = want[0]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4, err_msg=f.name)


def _csv_matches(got_path, want_path):
    got, want = pd.read_csv(got_path), pd.read_csv(want_path)
    assert list(got.columns) == list(want.columns) and len(got) == len(PREDICT_SIZES)
    assert (got["slide_id"] == want["slide_id"]).all()
    assert (got["pred"] == want["pred"]).all()
    num = [c for c in want.columns if c.startswith("prob_")]
    np.testing.assert_allclose(got[num].to_numpy(), want[num].to_numpy(), rtol=0, atol=5e-4)


@pytest.mark.parametrize("world", (1,) + WORLDS)
def test_predict_whole_slide_matches_the_jax_tool(setup, jax_tools, world):
    """Every patch of each slide through the CP encoder, its cls row into
    head_from_wsi: row for row the JAX tool's CSV."""
    root = setup["paths"]["root"]
    if world == 1:
        _run_tool_here(setup, "predict_whole")
    else:
        ranks(setup, world)
    _csv_matches(root / f"w{world}" / "whole.csv", jax_tools["whole"])


@pytest.mark.parametrize("world", WORLDS)
def test_multi_rank_predict_matches_the_jax_tool_on_eight_devices(setup, jax_tools, world):
    """Batch 8 (the JAX tool's, rounded to its 8 devices), each rank scoring
    its block with the pinv's scale over the whole batch: row for row the
    JAX tool's CSV."""
    root = setup["paths"]["root"]
    ranks(setup, world)
    _csv_matches(root / f"w{world}" / "pred.csv", jax_tools["pred"])


def test_predict_in_two_ranks_of_its_own_writes_the_csv_once(setup, jax_tools):
    """``python -m mirror_tpu_torch.tools.predict`` as 2 ranks under the
    MIRROR_* env, with no group around it: predict makes the group and
    destroys it on the way out, and only rank 0 writes the CSV (its log
    says so; rank 1's does not), row for row the JAX tool's."""
    logs = setup["spawns"]["bare"]()
    assert "wrote 6 predictions" in logs[0]
    assert "wrote" not in logs[1], logs[1][-2000:]
    _csv_matches(setup["paths"]["root"] / "bare" / "pred.csv", jax_tools["pred"])


def test_two_rank_gen_patch_feature_writes_one_process_files(setup):
    """Each rank extracts its share of the slides: the files of one process,
    bit for bit."""
    root = setup["paths"]["root"]
    ranks(setup, 2)
    argv = setup["tool_argv"](1)["gen_patch_feature"]
    stats = gen_patch_feature.main(argv)
    assert stats["slides"] == len(PATCHES)
    for slide, n in PATCHES.items():
        want = np.load(root / "w1" / "patch_feats" / f"{slide}.npy")
        got = np.load(root / "w2" / "patch_feats" / f"{slide}.npy")
        assert want.shape == (n, 1024)
        np.testing.assert_array_equal(got, want, err_msg=slide)


def test_wrap_pad_square_matches_jax():
    rng = np.random.default_rng(7)
    for n in (2, 50, 61, 64, 65):
        tokens = rng.standard_normal((n, 24)).astype(np.float32)
        got, want = wrap_pad_square(tokens), jax_cp.wrap_pad_square(tokens)
        assert got.shape[0] == int(np.ceil(np.sqrt(n))) ** 2
        np.testing.assert_array_equal(got, want)


def test_encode_slide_refuses_float32_on_the_card_by_name(setup):
    """The JAX tool's default dtype (float32) with the kernels on the card
    passes the start check, since the kernels take float32, and so does an
    encoder at embed 1536 (head dim 192: the forward kernels take every
    width); a type beyond them (float64) is refused before any slide is
    read, naming --no-use-pallas."""
    root = setup["paths"]["root"]
    argv = ["--wsi-feature-dir", str(root / "none"), "--checkpoint", str(root / "enc.pth.tar"),
            "--output", str(root / "never")]
    cuda = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        encode_slide.refuse_kernel_path({"_fc1.0.weight": torch.empty(128, 40)}, dtype, True,
                                        cuda)
    wide = {"_fc1.0.weight": torch.empty(1536, 768)}
    for dtype in (torch.float32, torch.bfloat16):
        encode_slide.refuse_kernel_path(wide, dtype, True, cuda)
    with pytest.raises(SystemExit, match=r"compute dtype torch.float64.*--no-use-pallas"):
        encode_slide.refuse_kernel_path(wide, torch.float64, True, cuda)
    encode_slide.refuse_kernel_path(wide, torch.float64, False, cuda)  # the plain path
    with pytest.raises(SystemExit, match="--heads 4"):
        encode_slide.main(argv + ["--heads", "4", "--device", "cpu"])
