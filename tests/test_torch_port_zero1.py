"""ZeRO-1 of the port's optimizer (``--optimizer-sharding``, the JAX
package's ``shard_state(zero1=True)``) in 2 gloo ranks on the CPU.

Each rank keeps the buffers of its own range of the parameters
(``train/optim.py::partition``), clips on the whole averaged gradient,
updates its range and broadcasts it. Held here: 5 steps of the MIRROR
train step with and without sharding give the same weights bit for bit
after every step (Adam with coupled decay and global-norm clipping, and
lamb with AGC); the gathered optimizer state after 3 steps is the
unsharded one bit for bit, so the ``.pth.tar`` payload is the same; and a
sharded run resumed from the unsharded run's state, and the reverse, end
bit for bit where the uninterrupted run ends. With fewer tensors than
ranks (the linear probe's head at 3 ranks) a rank's range is empty: every
``--opt`` still gives the unsharded weights and state on every rank.
"""

import os
import sys

import numpy as np
import pytest
import torch

from mirror_tpu_torch.parallel import worker
from mirror_tpu_torch.train import optim
from mirror_tpu_torch.train.optim import ChainOptimizer, partition

KW = dict(wsi_embed_dim=40, rna_embed_dim=100, embed_dim=24, wsi_num_tokens=30,
          style_mlp_hidden_dim=32, style_mlp_out_dim=20, style_latent_dim=16,
          num_prototypes=37, rna_proj_drop_rate=0.0, wsi_dropout=0.0)
OPTIMIZERS = {
    "adam_decay_clip": ["--weight-decay", "0.05", "--clip-grad", "0.5"],
    "lamb_agc": ["--opt", "lamb", "--weight-decay", "0.05", "--clip-grad", "0.01",
                 "--clip-mode", "agc"],
}
STEPS, SNAPSHOT = 5, 3


def _batches(seed):
    rng = np.random.default_rng(seed)
    batches, noise = [], []
    for _ in range(STEPS):
        batches.append({"wsi": torch.from_numpy(rng.standard_normal((4, 30, 40), np.float32)),
                        "rna": torch.from_numpy(rng.standard_normal((4, 100), np.float32))})
        noise.append({"wsi_noise": torch.from_numpy(rng.random((4, 30), np.float32)),
                      "rna_noise": torch.from_numpy(rng.random((4, 24), np.float32)),
                      "wsi_eps": torch.from_numpy(rng.standard_normal((4, 16), np.float32)),
                      "rna_eps": torch.from_numpy(rng.standard_normal((4, 16), np.float32))})
    return batches, noise


def _start(tmp_path, name, argv, **extra):
    batches, noise = _batches(7)
    spec = dict(model="mirror", model_kwargs=KW, device="cpu", seed=0, step="mirror",
                negatives="local", argv=argv, lr=1e-3, batches=batches, noise=noise, **extra)
    if "optimizer_state" in extra:
        spec.update(batches=batches[SNAPSHOT:], noise=noise[SNAPSHOT:])
    path = tmp_path / f"{name}.spec.pt"
    torch.save(spec, path)
    return worker.start(path, tmp_path / name, 2, tmp_path / f"{name}.rdv", 120.0)


@pytest.fixture(scope="module", params=sorted(OPTIMIZERS))
def runs(request, tmp_path_factory):
    """Both ranks of: the unsharded and the sharded run, 5 steps, each with
    its snapshot after 3; then each resumed from the other's snapshot."""
    tmp = tmp_path_factory.mktemp(request.param)
    argv = OPTIMIZERS[request.param]
    plain = _start(tmp, "plain", argv, snapshot_after=SNAPSHOT)
    sharded = _start(tmp, "sharded", argv + ["--optimizer-sharding"], snapshot_after=SNAPSHOT)
    out = {"plain": plain(), "sharded": sharded()}
    snap_p, snap_s = out["plain"][0]["snapshot"], out["sharded"][0]["snapshot"]
    from_plain = _start(tmp, "sharded_from_plain", argv + ["--optimizer-sharding"],
                        state_dict=snap_p["weights"], optimizer_state=snap_p["optimizer"])
    from_sharded = _start(tmp, "plain_from_sharded", argv, state_dict=snap_s["weights"],
                          optimizer_state=snap_s["optimizer"])
    out.update(sharded_from_plain=from_plain(), plain_from_sharded=from_sharded())
    return out


def test_zero1_weights_are_the_unsharded_runs_after_every_step(runs):
    for name in ("plain", "sharded"):
        for t in range(STEPS):
            assert runs[name][0]["digests"][t] == runs[name][1]["digests"][t], (name, t)
    assert runs["sharded"][0]["digests"] == runs["plain"][0]["digests"]
    for t in range(STEPS):
        assert runs["sharded"][0]["metrics"][t] == runs["plain"][0]["metrics"][t], t


def test_zero1_gathered_state_is_the_unsharded_payload(runs):
    want, got = runs["plain"][0]["snapshot"]["optimizer"], runs["sharded"][1]["snapshot"][
        "optimizer"]
    assert set(got) == set(want) and list(got["state"]) == list(want["state"])
    for key, bufs in want["state"].items():
        assert list(got["state"][key]) == list(bufs)
        for name, value in bufs.items():
            assert torch.equal(got["state"][key][name], value), (key, name)
    assert {k: v for k, v in got.items() if k != "state"} == \
        {k: v for k, v in want.items() if k != "state"}


def test_zero1_checkpoints_resume_either_way_bit_for_bit(runs):
    end = runs["plain"][0]["digests"][-1]
    for name in ("sharded_from_plain", "plain_from_sharded"):
        for rank in range(2):
            assert runs[name][rank]["digests"][-1] == end, (name, rank)


@pytest.mark.parametrize("numels,parts,bounds", [
    ([10, 10, 10, 10], 2, [0, 2, 4]),
    ([10, 10, 10, 10], 4, [0, 1, 2, 3, 4]),
    ([100, 1, 1, 1], 2, [0, 1, 4]),
    ([1, 1, 100], 3, [0, 1, 2, 3]),
    ([1, 2, 3, 4, 5, 6, 7, 8, 9], 3, [0, 5, 7, 9]),
    ([24, 3], 3, [0, 1, 2, 2]),
    ([5], 1, [0, 1]),
])
def test_partition_is_contiguous_and_even_in_elements(numels, parts, bounds):
    assert partition(numels, parts) == bounds


# --------------------------------------------------------------------------
# an empty range: the linear probe's two head tensors over 3 ranks
# --------------------------------------------------------------------------

PROBE_RANKS = 3
PROBE_RANK_CODE = """
import sys
import torch
sys.path.insert(0, sys.argv[2])
from test_torch_port_zero1 import run_probe
from mirror_tpu_torch.parallel import distributed
from mirror_tpu_torch.train.optim import OPTIMIZERS
torch.set_num_threads(1)
with distributed.session(None, torch.device("cpu")):
    shard = (distributed.rank(), distributed.world_size())
    out = {opt: run_probe(opt, shard) for opt in OPTIMIZERS}
torch.save(out, f"{sys.argv[1]}.{shard[0]}")
"""


def run_probe(opt, shard, steps=3):
    """3 updates of ``opt`` (decay, global-norm clipping; amsgrad for
    adam, momentum for rmsprop) on a [3, 8] head and its bias, the
    probe's parameters: the weights and the gathered state."""
    gen = torch.Generator().manual_seed(0)
    named = [("head.weight", torch.nn.Parameter(torch.randn(3, 8, generator=gen))),
             ("head.bias", torch.nn.Parameter(torch.randn(3, generator=gen)))]
    chain = ChainOptimizer(named, opt, lambda count: 1e-2, weight_decay=0.05,
                           amsgrad=opt == "adam", momentum=0.9, clip_grad=1.0, shard=shard)
    for _ in range(steps):
        for _, p in named:
            p.grad = torch.randn(p.shape, generator=gen)
        chain.step()
    return [p.detach().clone() for _, p in named], chain.state_dict()


def test_zero1_with_an_empty_range_is_the_unsharded_update_for_every_opt(tmp_path):
    """3 ranks over 2 tensors (``--linear-probe --optimizer-sharding`` at
    3 ranks): the last rank's range is empty; it takes no update but the
    broadcasts and gathers, and every rank ends with the unsharded
    weights and state, bit for bit, for every ``--opt``."""
    assert partition([24, 3], PROBE_RANKS) == [0, 1, 2, 2]
    wait = worker.start_ranks(
        [sys.executable, "-c", PROBE_RANK_CODE, str(tmp_path / "probe"),
         os.path.dirname(os.path.abspath(__file__))],
        PROBE_RANKS, tmp_path / "probe.rdv", tmp_path / "probe", 60.0)
    wait()
    for rank in range(PROBE_RANKS):
        got = torch.load(tmp_path / f"probe.{rank}", weights_only=False)
        for opt in optim.OPTIMIZERS:
            weights, state = run_probe(opt, None)
            assert all(torch.equal(a, b) for a, b in zip(got[opt][0], weights)), (rank, opt)
            assert list(got[opt][1]["state"]) == list(state["state"]), (rank, opt)
            for key, bufs in state["state"].items():
                for name, value in bufs.items():
                    assert torch.equal(got[opt][1]["state"][key][name], value), \
                        (rank, opt, key, name)
