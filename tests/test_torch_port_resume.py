"""``--resume``, ``--no-resume-opt`` and ``--start-epoch`` of the port on the
CPU: a resumed run against the uninterrupted one, bit for bit; the schedule
fast-forward and the plateau controller after a resume against the JAX
package's; the two places where the port follows timm and not the JAX
package (the logged lr under accumulation, an explicit ``--start-epoch``
with ``--resume``); and the flags in each of the four entry points.
"""

import numpy as np
import optax
import pandas as pd
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from mirror_tpu.config import parse_args as jax_parse_args
from mirror_tpu.train import optim as jax_optim
from mirror_tpu_torch import config
from mirror_tpu_torch.train import harness, optim
from mirror_tpu_torch.train.checkpoint import load_checkpoint_file
from mirror_tpu_torch.train.steps import ModelEma
from test_torch_port_runctl import (  # noqa: F401 (the fixtures)
    CLIS, cli_argv, cohort, one_intra_op_thread, run_dir)

ACCUM_EMA = ["--model-ema", "--grad-accum-steps", "2"]


# --------------------------------------------------------------------------
# a resumed run is the uninterrupted run
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["train_mirror", "survival"])
def pair(request, cohort):
    """2 epochs straight, and 1 epoch then ``--resume last.pth.tar`` for 1
    more, with --model-ema and --grad-accum-steps 2 (train_mirror: 3
    micro-steps an epoch, so the accumulated gradient crosses the epoch
    boundary and the resume). Returns the two run directories."""
    cli = request.param
    main = CLIS[cli]
    main(cli_argv(cohort, cli, "straight", *ACCUM_EMA))
    main(cli_argv(cohort, cli, "resumed", *ACCUM_EMA, "--epochs", "1"))
    last = run_dir(cohort, cli, "resumed") / "last.pth.tar"
    main(cli_argv(cohort, cli, "resumed", *ACCUM_EMA, "--resume", str(last)))
    return cli, run_dir(cohort, cli, "straight"), run_dir(cohort, cli, "resumed")


def _last(path):
    return load_checkpoint_file(str(path / "last.pth.tar"))


def test_resume_gives_the_uninterrupted_weights(pair):
    _, straight, resumed = pair
    a, b = _last(straight), _last(resumed)
    assert a["epoch"] == b["epoch"] == 1
    assert a["state_dict"].keys() == b["state_dict"].keys()
    for key in a["state_dict"]:
        assert torch.equal(a["state_dict"][key], b["state_dict"][key]), key


def test_resume_gives_the_uninterrupted_ema(pair):
    _, straight, resumed = pair
    a, b = _last(straight), _last(resumed)
    for key in a["state_dict_ema"]:
        assert torch.equal(a["state_dict_ema"][key], b["state_dict_ema"][key]), key
    assert a["step"] == b["step"] > 0


def test_resume_gives_the_uninterrupted_optimizer_state(pair):
    """The moments, both counts, the micro-step, the accumulated gradient,
    the host lr and the step generator's state."""
    cli, straight, resumed = pair
    a, b = _last(straight)["optimizer"], _last(resumed)["optimizer"]
    for key in ("count", "moment_count", "mini_step", "host_lr"):
        assert a[key] == b[key], key
    if cli == "train_mirror":  # 6 micro-steps: 3 updates, none pending
        assert (a["count"], a["mini_step"]) == (3, 0)
    assert a["state"].keys() == b["state"].keys() and a["state"]
    for key in a["state"]:
        for name, t in a["state"][key].items():
            assert torch.equal(t, b["state"][key][name]), (key, name)
    assert (a["acc"] is None) == (b["acc"] is None)
    assert torch.equal(_last(straight)["rng_state"], _last(resumed)["rng_state"])


def test_resume_logs_the_uninterrupted_lr_and_appends_the_summary(pair):
    """summary.csv of the resumed run: one header, epoch 1 appended, the
    lr column (and every train metric) equal to the straight run's."""
    _, straight, resumed = pair
    text = (resumed / "summary.csv").read_text()
    assert text.count("epoch,") == 1
    a, b = pd.read_csv(straight / "summary.csv"), pd.read_csv(resumed / "summary.csv")
    assert a["epoch"].tolist() == b["epoch"].tolist() == [0, 1]
    pd.testing.assert_frame_equal(a, b)


def test_every_checkpoint_loads_with_weights_only(pair):
    """The run's state in the .pth.tar (optimizer, step, rng_state) is plain
    tensors, numbers and dicts: torch.load(weights_only=True) reads it."""
    _, straight, _ = pair
    paths = sorted(straight.glob("*.pth.tar"))
    assert "last.pth.tar" in [p.name for p in paths]
    for path in paths:
        payload = torch.load(path, map_location="cpu", weights_only=True)
        assert {"optimizer", "step", "rng_state", "state_dict_ema"} <= set(payload)
        assert payload["rng_state"].dtype == torch.uint8


# --------------------------------------------------------------------------
# the flags in each entry point
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def first_epochs(cohort):
    """One epoch of each entry point, whose last.pth.tar the cases resume."""
    out = {}
    for cli, main in CLIS.items():
        main(cli_argv(cohort, cli, "first", "--epochs", "1"))
        out[cli] = str(run_dir(cohort, cli, "first") / "last.pth.tar")
    return out


FLAG_CASES = {"resume": ([], [1]), "no_resume_opt": (["--no-resume-opt"], [1]),
              "start_epoch": (["--start-epoch", "0"], [0, 1])}


@pytest.mark.parametrize("case", sorted(FLAG_CASES))
@pytest.mark.parametrize("cli", sorted(CLIS))
def test_the_resume_flags_run_in_every_entry_point(cohort, first_epochs, cli, case):
    """--resume, --resume --no-resume-opt, and --resume --start-epoch 0 (a
    rewind to the first epoch) from the first epoch's last.pth.tar: the
    epochs trained, the optimizer's count after them (restored, or
    fast-forwarded to the start epoch's updates, or rewound to 0)."""
    extra, epochs = FLAG_CASES[case]
    experiment = f"flags_{case}"
    results = CLIS[cli](cli_argv(cohort, cli, experiment, "--resume", first_epochs[cli],
                                 *extra))
    assert "preempted" not in results
    out = run_dir(cohort, cli, experiment)
    assert pd.read_csv(out / "summary.csv")["epoch"].tolist() == epochs
    first = load_checkpoint_file(first_epochs[cli])["optimizer"]["count"]
    assert _last(out)["optimizer"]["count"] == first * len(epochs) + \
        (first if case != "start_epoch" else 0)


def test_no_resume_opt_restores_the_weights_and_the_ema_step_only(cohort, first_epochs):
    """harness.start_epoch_of under --resume --no-resume-opt: the weights and
    the EMA (its update count from ``step``) come back, the optimizer
    starts with no moments, its schedule count fast-forwarded to 1 epoch of
    updates and its moment count at 0 (optax keeps the two apart)."""
    from mirror_tpu_torch.registry import create_model
    from mirror_tpu_torch.train.checkpoint import run_args

    payload = load_checkpoint_file(first_epochs["train_mirror"])
    saved = run_args(payload)
    model = create_model("mirror", device="cpu", **saved["model_kwargs"])
    ema = ModelEma(model)
    args, _ = config.parse_args(cli_argv(cohort, "train_mirror", "unused", "--resume",
                                         first_epochs["train_mirror"], "--no-resume-opt"))
    opt = optim.make_optimizer(args, model, 2e-5, steps_per_epoch=3)

    class Loader:
        def __len__(self):
            return 3

    assert harness.start_epoch_of(args, model, Loader(), opt, ema) == 1
    assert opt.state == {} and (opt.count, opt.moment_count) == (3, 0)
    assert ema.updates == payload["step"] == 3
    for key, value in model.state_dict().items():
        assert torch.equal(value, payload["state_dict"][key]), key


# --------------------------------------------------------------------------
# the schedule after a resume, against the JAX package
# --------------------------------------------------------------------------

SCHEDULES = {
    "constant": [],
    "cosine_epochs": ["--use-sched", "--sched", "cosine", "--warmup-epochs", "2",
                      "--epochs", "8"],
    "cosine_updates": ["--use-sched", "--sched", "cosine", "--sched-on-updates",
                       "--warmup-epochs", "1", "--epochs", "6"],
    "step": ["--use-sched", "--sched", "step", "--decay-epochs", "2", "--epochs", "8"],
    "multistep": ["--use-sched", "--sched", "multistep", "--decay-milestones", "2", "4",
                  "--epochs", "8", "--warmup-epochs", "1"],
}
UPDATES_PER_EPOCH, LR = 3, 1e-3


def _jax_lrs(argv, start_epoch, n_updates, accum):
    """The lr of each real update of the JAX chain after
    ``fast_forward_schedule`` to the start epoch, read from the schedule
    state's count as the micro-steps advance it."""
    args, _ = jax_parse_args("pretrain", argv)
    schedule = jax_optim.make_schedule(args, UPDATES_PER_EPOCH, LR)
    tx = jax_optim.make_optimizer(args, schedule)
    params = {"w": jnp.ones((2, 2))}
    state = jax_optim.fast_forward_schedule(tx.init(params),
                                            start_epoch * UPDATES_PER_EPOCH)

    def count(s):
        found = []
        jax.tree.map(lambda x: found.append(int(x.count)) if isinstance(
            x, optax.ScaleByScheduleState) else None, s,
            is_leaf=lambda x: isinstance(x, optax.ScaleByScheduleState))
        return found[0]

    update = jax.jit(tx.update)
    grads = {"w": jnp.full((2, 2), 0.5)}
    lrs = []
    for _ in range(n_updates):
        lrs.append(float(schedule(jnp.asarray(count(state)))))
        for _ in range(accum):
            _, state = update(grads, state, params)
    return lrs


def _port_lrs(argv, start_epoch, n_updates, accum):
    """The port's: the lr each micro-step logs and the lr each real update
    applies (read where the Adam step takes it), after the fast-forward."""
    args, _ = config.parse_args(argv)
    model = nn.Linear(2, 2)
    opt = optim.make_optimizer(args, model, LR, steps_per_epoch=UPDATES_PER_EPOCH)
    optim.fast_forward_schedule(opt, start_epoch * UPDATES_PER_EPOCH)
    applied, logged = [], []
    real_apply = opt._adam_apply
    opt._adam_apply = lambda grads, lr: (applied.append(lr), real_apply(grads, lr))
    while len(applied) < n_updates:
        logged.append(opt.current_lr())
        for p in model.parameters():
            p.grad = torch.full_like(p, 0.5)
        opt.step()
    return applied, logged


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("sched", sorted(SCHEDULES))
def test_the_fast_forwarded_schedule_is_the_jax_packages(sched, accum):
    """--start-epoch 2 on a fresh optimizer (or --no-resume-opt): the lr of
    each of 8 real updates against the JAX chain after its
    fast_forward_schedule, within 1e-6; under accumulation the lr each
    micro-step logs is the lr its update applies (the JAX package logs
    MultiSteps' own counter there, ADVICE.md round 5: not copied)."""
    argv = ["--opt", "adam", "--grad-accum-steps", str(accum), *SCHEDULES[sched]]
    want = _jax_lrs(argv, 2, 8, accum)
    applied, logged = _port_lrs(argv, 2, 8, accum)
    np.testing.assert_allclose(applied, want, rtol=1e-6, atol=0)
    assert logged[accum - 1::accum] == applied
    assert logged[::accum] == applied


def test_an_explicit_start_epoch_with_resume_rewinds_the_count(cohort, first_epochs):
    """timm rebuilds its scheduler at --start-epoch; the JAX package keeps a
    restored count that is larger (ADVICE.md round 5: not copied). Resumed
    from 1 epoch (count 3), --start-epoch 0 sets the count to 0 and so
    retrains with epoch 0's lr; the JAX fast-forward would have left 3."""
    argv = ["--use-sched", "--sched", "step", "--decay-epochs", "1", "--decay-rate", "0.5",
            "--lr", "1e-3", "--warmup-epochs", "0"]
    CLIS["train_mirror"](cli_argv(cohort, "train_mirror", "rewind_base", *argv, "--epochs",
                                  "1"))
    last = str(run_dir(cohort, "train_mirror", "rewind_base") / "last.pth.tar")
    CLIS["train_mirror"](cli_argv(cohort, "train_mirror", "rewind", *argv, "--resume", last,
                                  "--start-epoch", "0", "--epochs", "1"))
    lr = pd.read_csv(run_dir(cohort, "train_mirror", "rewind") / "summary.csv")["train_lr"]
    assert lr.tolist() == pytest.approx([1e-3], rel=1e-6)
    state = jax_optim.fast_forward_schedule(
        (optax.ScaleByScheduleState(count=jnp.asarray(3, jnp.int32)),), 0)
    assert int(state[0].count) == 3


# --------------------------------------------------------------------------
# the plateau controller after a resume, against the JAX package
# --------------------------------------------------------------------------

PLATEAU = ["--use-sched", "--sched", "plateau", "--warmup-epochs", "3", "--warmup-lr", "1e-5",
           "--patience-epochs", "1", "--decay-rate", "0.5", "--cooldown-epochs", "1",
           "--lr", "1e-3"]
METRICS = [1.0, 0.9, 0.95, 0.97, 0.96, 0.99, 0.5]


class _State:
    """The slice of the JAX TrainState the controller reads and writes."""

    def __init__(self, opt_state):
        self.opt_state = opt_state

    def replace(self, opt_state):
        return _State(opt_state)


@pytest.mark.parametrize("resume_opt", [True, False])
@pytest.mark.parametrize("start_epoch", [2, 5])
def test_the_plateau_after_a_resume_is_the_jax_packages(start_epoch, resume_opt):
    """With the optimizer restored (host lr 2.5e-4, a decayed value) both
    controllers adopt it (sync_from_state); without it both take the epoch
    before the start (step_epoch(start - 1, None)). Then the lr of each
    later epoch under the same metrics, within 1e-6."""
    args, _ = config.parse_args(PLATEAU)
    jargs, _ = jax_parse_args("pretrain", PLATEAU)
    ours = optim.PlateauController.from_args(args, 1e-3)
    theirs = jax_optim.PlateauController.from_args(jargs, 1e-3)
    opt = optim.make_optimizer(args, nn.Linear(2, 2), 1e-3)
    tx = jax_optim.make_optimizer(jargs, jax_optim.make_schedule(jargs, 1, 1e-3))
    state = _State(tx.init({"w": jnp.ones((2, 2))}))
    if resume_opt:
        opt.set_lr(2.5e-4)
        state = _State(jax_optim.set_host_lr(state.opt_state, 2.5e-4))
        ours.sync_from_optimizer(opt)
        theirs.sync_from_state(state)
    else:
        ours.step_epoch(opt, start_epoch - 1, None)
        state = theirs.step_epoch(state, start_epoch - 1, None)
    got, want = [opt.current_lr()], [jax_optim.get_host_lr(state.opt_state)]
    for epoch, metric in enumerate(METRICS, start=start_epoch):
        ours.step_epoch(opt, epoch, metric)
        state = theirs.step_epoch(state, epoch, metric)
        got.append(opt.current_lr())
        want.append(jax_optim.get_host_lr(state.opt_state))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert len(set(np.round(got, 12))) > 1  # the metrics moved the lr


def test_a_resumed_plateau_run_starts_from_the_restored_lr(cohort):
    """train_survival under the plateau with a warmup: resumed after epoch 0
    (the warmup's lr), the next epoch trains at the restored lr's successor
    the straight run used."""
    argv = ["--opt", "sgd", "--use-sched", "--sched", "plateau", "--warmup-epochs", "1",
            "--warmup-lr", "1e-4"]
    CLIS["survival"](cli_argv(cohort, "survival", "plateau_straight", *argv))
    CLIS["survival"](cli_argv(cohort, "survival", "plateau_resumed", *argv, "--epochs", "1"))
    last = str(run_dir(cohort, "survival", "plateau_resumed") / "last.pth.tar")
    CLIS["survival"](cli_argv(cohort, "survival", "plateau_resumed", *argv, "--resume", last))
    a = pd.read_csv(run_dir(cohort, "survival", "plateau_straight") / "summary.csv")
    b = pd.read_csv(run_dir(cohort, "survival", "plateau_resumed") / "summary.csv")
    assert a["train_lr"].tolist() == b["train_lr"].tolist()
    assert a["train_lr"].tolist()[0] == pytest.approx(1e-4)
