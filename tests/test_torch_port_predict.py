"""The whole slice: the port's ``predict`` against the JAX package's
``predict`` on the same weights and the same synthetic cohort.

A tiny JAX MIRRORClassifier is initialised and saved as the JAX package
saves checkpoints (flax msgpack, with its run args), converted to the
reference's ``.pth.tar`` with ``state_dict_from_jax``, and both tools score
the cohort with the same seed (so the same token subsample) on the CPU, in
fp32. The CSVs must agree row for row to 1e-5.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import yaml

from mirror_tpu.models.classifier import MIRRORClassifier as JaxClassifier
from mirror_tpu.tools.predict import predict as jax_predict
from mirror_tpu.train.checkpoint import save_checkpoint_file as jax_save
from mirror_tpu_torch.convert import state_dict_from_jax
from mirror_tpu_torch.tools.predict import predict
from mirror_tpu_torch.train.checkpoint import save_checkpoint_file

TINY = dict(wsi_embed_dim=32, rna_embed_dim=96, embed_dim=48, rna_mlp_ratio=2.0)
N_SLIDES, N_TOKENS = 10, 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """10 slides of 5..40 patches (fewer and more than the 16 tokens scored)
    and an RNA CSV keyed by the 15-char sample id."""
    root = tmp_path_factory.mktemp("port_cohort")
    rng = np.random.default_rng(3)
    feat_dir = root / "feats"
    feat_dir.mkdir()
    ids = [f"TCGA-AA-{i:04d}-01A-01-TS1" for i in range(N_SLIDES)]
    for sid in ids:
        n = int(rng.integers(5, 41))
        np.save(feat_dir / f"{sid}.npy", rng.standard_normal((n, 32)).astype(np.float16))
    rna = pd.DataFrame(rng.standard_normal((N_SLIDES, 96)).astype(np.float32),
                       index=[s[:15] for s in ids],
                       columns=[f"g{j}" for j in range(96)])
    rna.to_csv(root / "rna.csv")
    return dict(feature_dir=str(feat_dir), rna_csv=str(root / "rna.csv"))


def _checkpoints(tmp_path, task, wsi_only):
    """The same random weights as a JAX msgpack and a reference .pth.tar."""
    num_classes = 4 if task == "survival" else 2
    fusion = "add" if wsi_only else "concat"
    model = JaxClassifier(**TINY, num_classes=num_classes, fusion=fusion)
    params = jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(5), jnp.zeros((1, N_TOKENS, 32)), jnp.zeros((1, 96))
    )["params"])
    args = dict(model="mirror_classifier", model_kwargs=dict(TINY), amp=False,
                num_classes=num_classes, num_bins=num_classes,
                num_wsi_feature_tokens=N_TOKENS, wsi_feature_only=wsi_only)
    msgpack = str(tmp_path / "model_best.msgpack")
    jax_save(msgpack, {"epoch": 0, "arch": "mirror_classifier", "state_dict": params,
                       "args": yaml.safe_dump(args)})
    pth = str(tmp_path / "model_best.pth.tar")
    save_checkpoint_file(pth, state_dict_from_jax(params), args=args)
    return msgpack, pth


@pytest.mark.parametrize("task,wsi_only", [("subtyping", False), ("survival", False),
                                           ("subtyping", True)])
def test_port_predict_matches_jax_predict(cohort, tmp_path, task, wsi_only):
    msgpack, pth = _checkpoints(tmp_path, task, wsi_only)
    rna_csv = "" if wsi_only else cohort["rna_csv"]
    jax_csv, port_csv = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    # batch 8: the JAX tool rounds the batch up to its device count (8 on
    # the test mesh), and the pinv's global scale makes a slide's score
    # depend on its batch, so both tools must batch the slides alike
    jax_predict(msgpack, task, cohort["feature_dir"], jax_csv, rna_feature_csv=rna_csv,
                batch_size=8, seed=7)
    rows = predict(pth, task, cohort["feature_dir"], port_csv, rna_feature_csv=rna_csv,
                   batch_size=8, seed=7, device="cpu")
    ref, out = pd.read_csv(jax_csv), pd.read_csv(port_csv)
    assert len(rows) == len(out) == N_SLIDES
    assert list(out.columns) == list(ref.columns)
    assert (out["slide_id"] == ref["slide_id"]).all()
    num = [c for c in ref.columns if c not in ("slide_id", "pred")]
    np.testing.assert_allclose(out[num].to_numpy(), ref[num].to_numpy(), rtol=0, atol=1e-5)
    if task == "subtyping":
        assert (out["pred"] == ref["pred"]).all()
        np.testing.assert_allclose(out[num].sum(axis=1), 1.0, atol=1e-6)


def test_whole_slide_is_refused(cohort, tmp_path):
    with pytest.raises(SystemExit, match="whole-slide"):
        predict("unused.pth.tar", "subtyping", cohort["feature_dir"],
                str(tmp_path / "o.csv"), whole_slide=True, device="cpu")


def test_port_imports_no_jax():
    code = (
        "import sys, mirror_tpu_torch, mirror_tpu_torch.tools.predict, "
        "mirror_tpu_torch.registry, mirror_tpu_torch.convert, mirror_tpu_torch.ops, "
        "mirror_tpu_torch.models, mirror_tpu_torch.data.formats, "
        "mirror_tpu_torch.train.checkpoint\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'mirror_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_cli_scores_a_port_checkpoint(cohort, tmp_path):
    """The CLI on a checkpoint written by the port itself (random weights
    from a seeded generator), on the CPU."""
    import torch

    from mirror_tpu_torch.registry import create_model
    from mirror_tpu_torch.tools.predict import main

    args = dict(model="mirror_classifier", model_kwargs=dict(TINY), amp=False,
                num_classes=3, num_wsi_feature_tokens=N_TOKENS)
    model = create_model("mirror_classifier", device="cpu",
                         generator=torch.Generator().manual_seed(0), num_classes=3, **TINY)
    ckpt = str(tmp_path / "port.pth.tar")
    save_checkpoint_file(ckpt, model.state_dict(), args=args)
    out = str(tmp_path / "cli.csv")
    main(["--checkpoint", ckpt, "--task", "subtyping", "--wsi-feature-dir",
          cohort["feature_dir"], "--rna-feature-csv", cohort["rna_csv"], "--output", out,
          "--batch-size", "4", "--device", "cpu"])
    df = pd.read_csv(out)
    assert len(df) == N_SLIDES and {"pred", "prob_0", "prob_1", "prob_2"} <= set(df.columns)
    probs = df[["prob_0", "prob_1", "prob_2"]].to_numpy()
    assert np.isfinite(probs).all()
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-6)
