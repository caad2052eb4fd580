"""The port's feature-extraction tool (``mirror_tpu_torch.tools.
gen_patch_feature``) and ``convert_features`` on the CPU: per-slide features
against the JAX tool's on the same weights, the CLI end to end, its
refusals, and the patch stream's producer/consumer contract
(tests/test_tools.py's three stream tests, ported).
"""

import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_tpu.models.feature_extractors import (
    ViTB16 as JaxViTB16,
    device_normalize as jax_device_normalize,
)
from mirror_tpu.tools.gen_patch_feature import extract_features as jax_extract_features
from mirror_tpu_torch.convert import vit_state_dict_from_jax
from mirror_tpu_torch.data.formats import load_feature_file
from mirror_tpu_torch.models.feature_extractors import ViTB16, device_normalize
from mirror_tpu_torch.tools import convert_features, gen_patch_feature
from mirror_tpu_torch.train.checkpoint import to_tensors
from test_torch_port_runctl import one_intra_op_thread  # noqa: F401 (the fixture)

# slides of 5, 3 and 4 patches in a {root}/{class}/{slide}/ layout
SLIDES = {"LUAD/s1": 5, "LUAD/s2": 3, "LUSC/s3": 4}


@pytest.fixture(scope="module")
def patch_root(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("patches")
    rng = np.random.default_rng(9)
    for slide, n in SLIDES.items():
        os.makedirs(root / slide)
        for i in range(n):
            img = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
            cv2.imwrite(str(root / slide / f"{i:03d}.png"), img)
    return str(root)


def test_extract_features_matches_jax_tool(patch_root, tmp_path):
    """The same ViT weights through both tools' extract_features: a tail
    batch (batch 3), --fold/--k over the slides, .npy and .pt."""
    kw = dict(image_size=224, patch_size=16, hidden_size=64, depth=1, num_heads=4)
    jax_model = JaxViTB16(**kw, use_pallas=True, dtype=jnp.float32)
    params = jax.device_get(jax.jit(jax_model.init)(jax.random.PRNGKey(2),
                                                    jnp.zeros((1, 224, 224, 3))))["params"]
    apply = jax.jit(lambda imgs: jax_model.apply({"params": params}, jax_device_normalize(imgs)))
    jax_out = tmp_path / "jax"
    jax_extract_features(patch_root, str(jax_out), batch_size=3, num_threads=2,
                         extractor=(apply, 64))

    model = ViTB16(**kw).eval()
    model.load_state_dict(to_tensors(vit_state_dict_from_jax(params)))

    @torch.no_grad()
    def fn(images):
        return model(device_normalize(torch.as_tensor(images)))

    port_out = tmp_path / "port"
    for fold, fmt in ((0, "npy"), (1, "pt")):
        stats = gen_patch_feature.extract_features(
            patch_root, str(port_out), batch_size=3, fold=fold, k=2, num_threads=2, fmt=fmt,
            extractor=(fn, 64), device="cpu")
        slides = list(SLIDES)[fold::2]
        assert stats["slides"] == len(slides)
        assert stats["patches"] == sum(SLIDES[s] for s in slides)
    for i, (slide, n) in enumerate(SLIDES.items()):
        fmt = ("npy", "pt")[i % 2]
        got = np.asarray(load_feature_file(str(port_out / f"{slide}.{fmt}")))
        want = np.load(jax_out / f"{slide}.npy")
        assert got.shape == (n, 64) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4, err_msg=slide)
    assert not (port_out / "LUAD" / "s1.pt").exists()  # fold 1 of 2 skips s1


def test_main_runs_on_the_cpu(patch_root, tmp_path):
    out = tmp_path / "feats"
    stats = gen_patch_feature.main([patch_root, str(out), "--model", "custom_resnet50",
                                    "--batch-size", "4", "--num-threads", "2",
                                    "--device", "cpu"])
    assert stats["patches"] == sum(SLIDES.values())
    for slide, n in SLIDES.items():
        feats = np.load(out / f"{slide}.npy")
        assert feats.shape == (n, 1024) and np.isfinite(feats).all()
    # a second run skips what exists
    again = gen_patch_feature.main([patch_root, str(out), "--model", "custom_resnet50",
                                    "--device", "cpu"])
    assert again["patches"] == 0


def test_tool_refuses_the_plain_path_on_the_card_and_a_missing_card(patch_root, tmp_path):
    # the JAX tool's dense path has no counterpart, on any device
    for device in ("cuda", "cpu"):
        with pytest.raises(SystemExit, match="no-use-pallas"):
            gen_patch_feature.build_extractor("phikon", use_pallas=False, device=device)
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit, match="no CUDA card"):
        gen_patch_feature.main([patch_root, str(tmp_path / "x"), "--model", "phikon"])
    with pytest.raises(SystemExit, match="local HF snapshot"):
        gen_patch_feature._load_hf_state(str(tmp_path / "not-a-dir"))


def test_patch_stream_propagates_decode_errors(tmp_path):
    import cv2

    good = str(tmp_path / "ok.jpg")
    cv2.imwrite(good, np.zeros((224, 224, 3), np.uint8))
    bad = str(tmp_path / "corrupt.jpg")
    with open(bad, "wb") as f:
        f.write(b"not a jpeg")
    with pytest.raises(ValueError, match="unreadable patch image"):
        list(gen_patch_feature.batched_patch_stream([good, bad], batch_size=2))


def _small_patches(tmp_path, n):
    import cv2

    for i in range(n):
        cv2.imwrite(str(tmp_path / f"p{i:02d}.jpg"), np.full((16, 16, 3), i, np.uint8))
    return sorted(str(p) for p in tmp_path.glob("*.jpg"))


def test_patch_stream_abandonment_joins_producer(tmp_path):
    files = _small_patches(tmp_path, 8)
    before = set(threading.enumerate())
    gen = gen_patch_feature.batched_patch_stream(files, batch_size=1, size=16, num_threads=2,
                                                 prefetch=1)
    arr, n_valid = next(gen)
    assert arr.shape == (1, 16, 16, 3) and n_valid == 1
    gen.close()  # abandon mid-stream: the generator's finally stops and joins
    leaked = [t for t in threading.enumerate() if t not in before and t.is_alive()]
    assert not leaked, leaked


def test_patch_stream_slow_consumer_receives_every_batch(tmp_path):
    """The queue stays full when the producer ends: the sentinel waits, and
    no data batch is evicted. The tail batch repeats its last patch."""
    files = _small_patches(tmp_path, 12)
    got, last = 0, None
    for arr, n_valid in gen_patch_feature.batched_patch_stream(files, batch_size=5, size=16,
                                                               num_threads=2, prefetch=1):
        time.sleep(0.05)
        got += n_valid
        last = (arr, n_valid)
    assert got == 12
    arr, n_valid = last
    assert n_valid == 2 and (arr[2:] == arr[1]).all()


def test_convert_features_round_trip(tmp_path):
    rng = np.random.default_rng(10)
    src = tmp_path / "npy" / "LUAD"
    src.mkdir(parents=True)
    arrays = {f"s{i}": rng.normal(size=(3 + i, 8)).astype(np.float32) for i in range(2)}
    for name, a in arrays.items():
        np.save(src / f"{name}.npy", a)
    assert convert_features.main([str(tmp_path / "npy"), str(tmp_path / "pt"), "--to", "pt"]) == 2
    assert convert_features.convert_dir(str(tmp_path / "pt"), str(tmp_path / "back"),
                                        delete_src=True) == 2
    for name, a in arrays.items():
        np.testing.assert_array_equal(np.load(tmp_path / "back" / "LUAD" / f"{name}.npy"), a)
        assert not (tmp_path / "pt" / "LUAD" / f"{name}.pt").exists()
