"""Two-stage YAML + CLI configuration of the training entry points.

The port's copy of ``mirror_tpu/config.py``'s three surfaces (pretrain,
subtyping, survival; the reference's train_*.py argument groups): a
mini-parser takes ``--config <yaml>``, the YAML keys become argparse
defaults, and the full parser reads the rest of argv, so CLI flags override
YAML. The flags and dest names are the JAX package's, so its YAML templates
parse unchanged.

What differs: ``--device`` defaults to ``cuda``, or to ``cpu`` under
``MIRROR_PLATFORM=cpu`` (the job launcher's ``cpu`` slot,
``utils/platform.py``), and a YAML ``device: tpu``, the JAX package's
accelerator, means that default here; ``--use-pallas`` (the
default here, on every device) runs the card's kernels on a CUDA device
and ``--no-use-pallas`` the plain path on any device, as the JAX package's
dense branch (:func:`model_kwargs_from_args`); ``--ckpt-format`` keeps the
JAX parser's choices, but the port always writes the reference's
``.pth.tar`` and refuses ``orbax``; and :func:`refuse_unported` stops at
start on a model or loss that this port does not run for the task, naming
it.
"""

import argparse
import ast
import logging
from typing import Any, Dict, Optional, Sequence, Tuple

import yaml

from .utils.platform import default_device

_logger = logging.getLogger(__name__)


class ParseKwargs(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        kw = dict(getattr(namespace, self.dest) or {})
        for value in values:
            key, _, v = value.partition("=")
            try:
                kw[key] = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                kw[key] = str(v)
        setattr(namespace, self.dest, kw)


TASKS = ("pretrain", "subtyping", "survival")


def build_parser(task: str = "pretrain") -> argparse.ArgumentParser:
    if task not in TASKS:
        raise ValueError(f"unknown task {task!r}; one of {TASKS}")
    p = argparse.ArgumentParser(description=f"MIRROR {task} (PyTorch port)")
    g = p.add_argument_group("Dataset")
    g.add_argument("--wsi-feature-dir", type=str, default=None)
    g.add_argument("--rna-feature-csv", type=str, default=None)
    g.add_argument("--split-dir", type=str, default=None)
    g.add_argument("--num-wsi-feature-tokens", type=int, default=2048)
    g.add_argument("--k", type=int, default=5)
    g.add_argument("--fold-nb", type=int, default=0)
    g.add_argument("--cache", action="store_true", default=False)
    g.add_argument("--val", action="store_true", default=True)
    g.add_argument("--no-val", action="store_false", dest="val")

    g = p.add_argument_group("Model")
    g.add_argument("--model", type=str, default="mirror")
    g.add_argument("--initial-checkpoint", type=str, default="")
    g.add_argument("--resume", type=str, default="")
    g.add_argument("--no-resume-opt", action="store_true", default=False)
    g.add_argument("--ckpt-format", type=str, default="msgpack",
                   choices=["msgpack", "orbax"],
                   help="the JAX package's serialisation; the port always writes the "
                        "reference's .pth.tar (and reads the JAX package's msgpack "
                        "files), and refuses orbax")
    g.add_argument("--batch-size", type=int, default=16)
    g.add_argument("--validation-batch-size", type=int, default=None)
    g.add_argument("--grad-accum-steps", type=int, default=1)
    g.add_argument("--grad-checkpointing", action="store_true", default=False)
    g.add_argument("--model-kwargs", nargs="*", default={}, action=ParseKwargs)
    g.add_argument("--use-pallas", action="store_true", default=None,
                   help="the hand-written CUDA kernels of the Nystrom attention and "
                        "PPEG on a CUDA device (the default); --no-use-pallas runs "
                        "their plain versions on any device")
    g.add_argument("--no-use-pallas", action="store_false", dest="use_pallas")
    g.add_argument("--pinv-grad", type=str, default="implicit",
                   choices=["exact", "implicit"],
                   help="Nystrom pinv backward: 'implicit' (-Z^T g Z^T) or 'exact' "
                        "(through the 6 iterations)")

    g = p.add_argument_group("Device")
    g.add_argument("--device", type=str, default=default_device(),
                   help="cuda runs the kernels; cpu runs their plain versions")
    g.add_argument("--distributed", action="store_true", default=False)
    g.add_argument("--amp", action="store_true", default=True)
    g.add_argument("--no-amp", action="store_false", dest="amp")
    g.add_argument("--amp-dtype", type=str, default="bfloat16")
    g.add_argument("--contrastive-negatives", type=str, default="local",
                   choices=["global", "local"],
                   help="each rank's own rows (local) or the global batch's; the same "
                        "with one process")

    g = p.add_argument_group("Optimizer")
    g.add_argument("--opt", type=str, default="adam")
    g.add_argument("--opt-eps", type=float, default=None)
    g.add_argument("--opt-betas", type=float, nargs="+", default=None)
    g.add_argument("--momentum", type=float, default=0.9)
    g.add_argument("--weight-decay", type=float, default=0.0)
    g.add_argument("--clip-grad", type=float, default=None)
    g.add_argument("--clip-mode", type=str, default="norm")
    g.add_argument("--layer-decay", type=float, default=None)
    g.add_argument("--opt-kwargs", nargs="*", default={}, action=ParseKwargs)

    g = p.add_argument_group("Schedule")
    g.add_argument("--use-sched", action="store_true", default=False)
    g.add_argument("--sched", type=str, default="cosine")
    g.add_argument("--sched-on-updates", action="store_true", default=False)
    g.add_argument("--lr", type=float, default=None)
    g.add_argument("--lr-base", type=float, default=0.1)
    g.add_argument("--lr-base-size", type=int, default=256)
    g.add_argument("--lr-base-scale", type=str, default="")
    g.add_argument("--lr-noise", type=float, nargs="+", default=None)
    g.add_argument("--lr-noise-pct", type=float, default=0.67)
    g.add_argument("--lr-noise-std", type=float, default=1.0)
    g.add_argument("--lr-cycle-mul", type=float, default=1.0)
    g.add_argument("--lr-cycle-decay", type=float, default=0.5)
    g.add_argument("--lr-cycle-limit", type=int, default=1)
    g.add_argument("--lr-k-decay", type=float, default=1.0)
    g.add_argument("--min-lr", type=float, default=0.0)
    g.add_argument("--warmup-lr", type=float, default=1e-5)
    g.add_argument("--epochs", type=int, default=100)
    g.add_argument("--start-epoch", type=int, default=None)
    g.add_argument("--decay-milestones", type=int, nargs="+", default=(90, 180, 270))
    g.add_argument("--decay-epochs", type=float, default=90)
    g.add_argument("--warmup-epochs", type=int, default=5)
    g.add_argument("--warmup-prefix", action="store_true", default=False)
    g.add_argument("--cooldown-epochs", type=int, default=0)
    g.add_argument("--patience-epochs", type=int, default=10)
    g.add_argument("--decay-rate", "--dr", type=float, default=0.1)

    g = p.add_argument_group("EMA")
    g.add_argument("--model-ema", action="store_true", default=False)
    g.add_argument("--model-ema-decay", type=float, default=0.9998)
    g.add_argument("--model-ema-warmup", action="store_true", default=False)

    g = p.add_argument_group("Misc")
    g.add_argument("--seed", type=int, default=42)
    g.add_argument("--log-interval", type=int, default=50)
    g.add_argument("--recovery-interval", type=int, default=0)
    g.add_argument("--checkpoint-hist", type=int, default=5)
    g.add_argument("--workers", type=int, default=4)
    g.add_argument("--output", type=str, default="")
    g.add_argument("--experiment", type=str, default="")
    g.add_argument("--log-wandb", action="store_true", default=False)
    g.add_argument("--wandb-project", type=str, default="MIRROR")
    g.add_argument("--wandb-watch", action="store_true", default=False)
    g.add_argument("--synchronize-step", action="store_true", default=False)
    g.add_argument("--profile", action="store_true", default=False)
    g.add_argument("--model-parallel", type=int, default=1)
    g.add_argument("--optimizer-sharding", action="store_true", default=False)

    # GPU/torch-only reference flags, accepted and ignored as the JAX package
    # does (the same _IGNORED_KEYS)
    g = p.add_argument_group("Ignored (reference surface)")
    g.add_argument("--torchscript", action="store_true", default=False)
    g.add_argument("--torchcompile", nargs="?", type=str, default=None, const="inductor")
    g.add_argument("--fuser", type=str, default="")
    g.add_argument("--fast-norm", action="store_true", default=False)
    g.add_argument("--amp-impl", type=str, default="native")
    g.add_argument("--no-ddp-bb", action="store_true", default=False)
    g.add_argument("--device-modules", type=str, nargs="+", default=None)
    g.add_argument("--local_rank", type=int, default=0)
    g.add_argument("--sync-bn", action="store_true", default=False)
    g.add_argument("--dist-bn", type=str, default="reduce")
    g.add_argument("--pin-mem", action="store_true", default=False)
    g.add_argument("--model-ema-force-cpu", action="store_true", default=False)
    g.add_argument("--worker-seeding", type=str, default="all")
    g.add_argument("--epoch-repeats", type=float, default=0.0)
    g.add_argument("--in-chans", type=int, default=None)

    if task == "pretrain":
        p.add_argument("--wsi-mask-ratio", type=float, default=0.75)
        p.add_argument("--rna-mask-ratio", type=float, default=0.75)
        p.add_argument("--loss", type=str, default="mirror_loss")
        p.add_argument("--loss-kwargs", nargs="*", default={}, action=ParseKwargs)
        p.add_argument("--temperature", type=float, default=0.1)
        p.add_argument("--eval-metric", type=str, default="loss")
        return p
    if task == "subtyping":
        p.add_argument("--classes", type=str, nargs="+", default=None)
        p.add_argument("--num-classes", type=int, default=None)
        p.add_argument("--loss", type=str, default="ce_loss")
        p.add_argument("--smoothing", type=float, default=0.1)
    else:
        p.add_argument("--survival-csv", type=str, default=None)
        p.add_argument("--num-bins", type=int, default=4)
        p.add_argument("--num-classes", type=int, default=4)
        p.add_argument("--loss", type=str, default="nll_surv")
        p.add_argument("--loss-alpha", type=float, default=0.0)
    p.add_argument("--wsi-feature-only", action="store_true", default=False)
    p.add_argument("--init-head", action="store_true", default=False)
    p.add_argument("--head-init-scale", type=float, default=None)
    p.add_argument("--head-init-bias", type=float, default=None)
    # "--linear_probe" is the reference's own spelling, kept as an alias
    p.add_argument("--linear-probe", "--linear_probe", action="store_true", default=False)
    p.add_argument("--drop-last", action="store_true", default=True)
    p.add_argument("--no-drop-last", action="store_false", dest="drop_last")
    p.add_argument("--weighted-sampler", action="store_true", default=False)
    if task == "subtyping":
        p.add_argument("--eval-metric", type=str, default="acc")
        p.add_argument("--eval-metric-average", type=str, default="macro")
    else:
        p.add_argument("--eval-metric", type=str, default="c-index")
    return p


_IGNORED_KEYS = {
    "fuser", "torchscript", "torchcompile", "fast_norm", "amp_impl", "no_ddp_bb",
    "local_rank", "device_modules", "sync_bn", "dist_bn", "pin_mem",
    "model_ema_force_cpu", "worker_seeding", "epoch_repeats", "in_chans",
}

ORBAX_REFUSAL = (
    "--ckpt-format orbax: the port writes the reference's .pth.tar only, a departure on "
    "purpose (an Orbax directory's OCDBT store needs tensorstore, which the card's machine "
    "lacks); `python -m mirror_tpu.tools.import_torch_checkpoint --checkpoint <port "
    ".pth.tar> --output <dir> --format orbax` makes an Orbax directory with the JAX package"
)
# what each task's port runs of --model and --loss; pretrain: train_mirror
# runs mirror and its loss, train_pretrain mirror_dual (the default mirror
# maps to it) and InfoNCE, whatever --loss says (as the JAX CLI)
_PORTED_VALUES = {
    "pretrain": {"model": ("mirror", "mirror_dual"), "loss": ("mirror_loss", "info_nce")},
    "subtyping": {"model": ("mirror", "mirror_classifier"), "loss": ("ce_loss",)},
    "survival": {"model": ("mirror", "mirror_classifier"), "loss": ("nll_surv", "ce_surv")},
}


def parse_args(argv: Optional[Sequence[str]] = None,
               task: str = "pretrain") -> Tuple[argparse.Namespace, str]:
    """Returns (args, resolved-yaml-text) for ``task``. CLI overrides YAML
    overrides defaults."""
    config_parser = argparse.ArgumentParser(add_help=False)
    config_parser.add_argument("-c", "--config", type=str, default="")
    cfg_args, remaining = config_parser.parse_known_args(argv)

    parser = build_parser(task)
    if cfg_args.config:
        with open(cfg_args.config) as f:
            cfg: Dict[str, Any] = yaml.safe_load(f) or {}
        known = {a.dest for a in parser._actions}
        defaults = {}
        for key, value in cfg.items():
            if key in _IGNORED_KEYS:
                continue
            if key not in known:
                _logger.warning("Ignoring unknown config key: %s", key)
                continue
            defaults[key] = value
        if defaults.get("device") == "tpu":
            defaults["device"] = default_device()
        parser.set_defaults(**defaults)

    args = parser.parse_args(remaining)
    args.defaults = vars(build_parser(task).parse_args([]))
    args.task = task
    for dest in sorted(_IGNORED_KEYS):
        if getattr(args, dest, None) != args.defaults.get(dest):
            _logger.warning("Ignoring --%s=%r (no meaning in the PyTorch port)",
                            dest.replace("_", "-"), getattr(args, dest))
    args.config = cfg_args.config
    args_text = yaml.safe_dump({k: v for k, v in vars(args).items() if k != "defaults"},
                               default_flow_style=False)
    return args, args_text


def refuse_unported(args: argparse.Namespace) -> None:
    """Raise SystemExit on ``--ckpt-format orbax`` (:data:`ORBAX_REFUSAL`)
    and on a ``--model`` or ``--loss`` that the port does not run for
    ``args.task``, naming it."""
    if args.ckpt_format == "orbax":
        raise SystemExit(ORBAX_REFUSAL)
    for dest, ported in _PORTED_VALUES[args.task].items():
        value = getattr(args, dest)
        if value not in ported:
            raise SystemExit(
                f"--{dest}={value!r}: the port's {args.task} runs {' or '.join(ported)} only; "
                "the other models and losses are not ported yet"
            )


def refuse_clip_values(args: argparse.Namespace) -> None:
    """train_mirror's own refusal: the CLIP baseline's model and loss run
    through ``train_pretrain``."""
    for dest, value in (("model", "mirror_dual"), ("loss", "info_nce")):
        if getattr(args, dest) == value:
            raise SystemExit(f"--{dest}={value!r}: train_mirror trains MIRROR; the CLIP "
                             "baseline runs through mirror_tpu_torch.train_pretrain")


def model_kwargs_from_args(args: argparse.Namespace) -> Dict[str, Any]:
    """The model kwargs that every entry point derives from its flags:
    ``--model-kwargs``, then, unless it set them, the compute dtype
    (``--amp``), the pinv gradient, the kernel path (``--use-pallas``, on
    by default) and ``--grad-checkpointing``."""
    kwargs = dict(args.model_kwargs or {})
    if args.amp:
        kwargs.setdefault("dtype", args.amp_dtype)
    kwargs.setdefault("pinv_grad", args.pinv_grad)
    kwargs.setdefault("use_pallas", args.use_pallas is not False)
    kwargs.setdefault("grad_checkpointing", bool(args.grad_checkpointing))
    return kwargs


def resolve_lr(args: argparse.Namespace, global_batch_size: int) -> float:
    """LR auto-scaling (the reference's train_mirror.py:725-740): lr =
    lr_base * global_batch / base_size, linear or sqrt (sqrt for adam)."""
    if args.lr is not None:
        return args.lr
    scale = args.lr_base_scale
    if not scale:
        on = args.opt.lower()
        scale = "sqrt" if any(o in on for o in ("ada", "lamb")) else "linear"
    ratio = global_batch_size * max(args.grad_accum_steps, 1) / args.lr_base_size
    if scale == "sqrt":
        ratio = ratio ** 0.5
    return args.lr_base * ratio
