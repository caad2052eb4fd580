"""Two-stage YAML + CLI configuration of the pretrain entry point.

The port's copy of ``mirror_tpu/config.py``'s pretrain surface (the
reference's train_mirror.py:76-88, 625-639): a mini-parser takes ``--config
<yaml>``, the YAML keys become argparse defaults, and the full parser reads
the rest of argv, so CLI flags override YAML. The flags and dest names are
the JAX package's, so its YAML templates parse unchanged.

What differs: ``--device`` defaults to ``cuda`` (a YAML ``device: tpu``, the
JAX package's accelerator, means the card here); ``use_pallas`` is accepted
and ignored (the device alone picks the kernel path); and
:func:`refuse_unported` stops at start on any flag that this port does not
implement when it is set away from its default, naming it.
"""

import argparse
import ast
import logging
from typing import Any, Dict, Optional, Sequence, Tuple

import yaml

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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MIRROR pretraining (PyTorch port)")
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
                   help="the JAX package's serialisation; the port writes the "
                        "reference's .pth.tar")
    g.add_argument("--batch-size", type=int, default=16)
    g.add_argument("--validation-batch-size", type=int, default=None)
    g.add_argument("--grad-accum-steps", type=int, default=1)
    g.add_argument("--grad-checkpointing", action="store_true", default=False)
    g.add_argument("--model-kwargs", nargs="*", default={}, action=ParseKwargs)
    g.add_argument("--use-pallas", action="store_true", default=None,
                   help="accepted for the JAX package's configs; ignored: the "
                        "device picks the kernel path")
    g.add_argument("--no-use-pallas", action="store_false", dest="use_pallas")
    g.add_argument("--pinv-grad", type=str, default="implicit",
                   choices=["exact", "implicit"],
                   help="Nystrom pinv backward: 'implicit' (-Z^T g Z^T); 'exact' "
                        "(through the 6 iterations) runs on the CPU only until "
                        "its backward kernel is ported")

    g = p.add_argument_group("Device")
    g.add_argument("--device", type=str, default="cuda",
                   help="cuda runs the kernels; cpu runs their plain versions")
    g.add_argument("--distributed", action="store_true", default=False)
    g.add_argument("--amp", action="store_true", default=True)
    g.add_argument("--no-amp", action="store_false", dest="amp")
    g.add_argument("--amp-dtype", type=str, default="bfloat16")
    g.add_argument("--contrastive-negatives", type=str, default="local",
                   choices=["global", "local"],
                   help="one process: the batch's own negatives either way")

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

    p.add_argument("--wsi-mask-ratio", type=float, default=0.75)
    p.add_argument("--rna-mask-ratio", type=float, default=0.75)
    p.add_argument("--loss", type=str, default="mirror_loss")
    p.add_argument("--loss-kwargs", nargs="*", default={}, action=ParseKwargs)
    p.add_argument("--temperature", type=float, default=0.1)
    p.add_argument("--eval-metric", type=str, default="loss")
    return p


_IGNORED_KEYS = {
    "fuser", "torchscript", "torchcompile", "fast_norm", "amp_impl", "no_ddp_bb",
    "local_rank", "device_modules", "sync_bn", "dist_bn", "pin_mem",
    "model_ema_force_cpu", "worker_seeding", "epoch_repeats", "in_chans", "use_pallas",
}

# flags this port does not implement: (dest, what it would need)
_UNPORTED = (
    ("resume", "resume"), ("no_resume_opt", "resume"), ("start_epoch", "resume"),
    ("initial_checkpoint", "warm start from a checkpoint"),
    ("recovery_interval", "recovery checkpoints"), ("checkpoint_hist", "best-k history"),
    ("log_wandb", "wandb"), ("wandb_watch", "wandb"),
    ("grad_accum_steps", "gradient accumulation"),
    ("grad_checkpointing", "activation checkpointing"),
    ("model_parallel", "tensor parallelism"), ("distributed", "multi-process training"),
    ("optimizer_sharding", "ZeRO-1"), ("ckpt_format", "the JAX package's checkpoints"),
    ("profile", "the profiler hook"), ("loss", "the other losses"),
    ("model", "the other models"),
)


def parse_args(argv: Optional[Sequence[str]] = None) -> Tuple[argparse.Namespace, str]:
    """Returns (args, resolved-yaml-text). CLI overrides YAML overrides
    defaults."""
    config_parser = argparse.ArgumentParser(add_help=False)
    config_parser.add_argument("-c", "--config", type=str, default="")
    cfg_args, remaining = config_parser.parse_known_args(argv)

    parser = build_parser()
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
            defaults["device"] = "cuda"
        parser.set_defaults(**defaults)

    args = parser.parse_args(remaining)
    args.defaults = vars(build_parser().parse_args([]))
    for dest in sorted(_IGNORED_KEYS):
        if getattr(args, dest, None) != args.defaults.get(dest):
            _logger.warning("Ignoring --%s=%r (no meaning in the PyTorch port)",
                            dest.replace("_", "-"), getattr(args, dest))
    args.config = cfg_args.config
    args_text = yaml.safe_dump({k: v for k, v in vars(args).items() if k != "defaults"},
                               default_flow_style=False)
    return args, args_text


def refuse_unported(args: argparse.Namespace) -> None:
    """Raise SystemExit on the first unported flag set away from its
    default, naming it."""
    for dest, what in _UNPORTED:
        value = getattr(args, dest)
        if value != args.defaults[dest]:
            raise SystemExit(
                f"--{dest.replace('_', '-')}={value!r}: {what} is not ported to the "
                "PyTorch port yet (ROADMAP items 8-10); leave it at its default"
            )
    if args.pinv_grad == "exact" and args.device.split(":")[0] == "cuda":
        raise SystemExit(
            "--pinv-grad exact: its CUDA backward kernel (TPU kernel 2b, "
            "mirror_tpu/ops/pinv_pallas.py:171) is not ported yet; use --pinv-grad "
            "implicit, or --device cpu"
        )


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
