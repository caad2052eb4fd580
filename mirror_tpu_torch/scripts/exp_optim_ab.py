"""The MIRROR train step and its optimizer update of this tree against an earlier tree's.

A probe beside ``train/optim.py``. With ``--parent DIR`` (a checkout of an
earlier tree, e.g. unpacked by ``git archive`` into a git-ignored
directory) it imports that tree's ``mirror_tpu_torch`` under another name,
which builds its own kernel library under ``DIR/build/kernels``, and runs
both trees' pretrain path as ``train_mirror`` builds it: the pretrain
template's model at full width (768-d features, 2048 tokens, RNA 10234,
embed 768, bf16, implicit pinv gradient), its optimizer (``--opt adam``,
lr 2e-5, no weight decay) from each tree's ``make_optimizer``, each tree's
``make_mirror_train_step``, on one random batch of 16 from a seed. For
each tree

- the train step, timed in the order parent, this, this, parent (medians
  of runs of calls between CUDA events; a step as the CLI runs it, host
  work included);
- the update alone (``optimizer.step()`` on one step's gradients), timed
  in the same order, and its launches under ``torch.profiler``: device
  time by kernel and their sum;
- one update from the same weights and gradients held against the other
  tree's: the weights' displacement within 1e-4 relative Frobenius. The
  two are not bit for bit: this tree's chain takes Adam's bias corrections
  in fp32 as optax does (1 - 0.999 is 9.9998713e-4 there), torch's Adam in
  float64, 6.4e-6 of the first update; and each displacement is read
  through the weight it was added to, rounded to that weight's ulp.

Without ``--parent`` it runs this tree alone. Needs a card:

    python -m mirror_tpu_torch.scripts.exp_optim_ab --parent build/parent

Prints one line a (tree, what), the profiler's split under the updates, and
one JSON line; exits 1 if the two updates disagree beyond the bar or a loss
is not finite.
"""

import argparse
import importlib
import sys
from pathlib import Path

import torch

from ..train_mirror import loss_weights_from_args
from . import _timing as T

REPO = Path(__file__).resolve().parents[2]
TEMPLATE = REPO / "configs" / "pretrain" / "mirror.template.yaml"
B, N_TOKENS, WSI_DIM, RNA_DIM = 16, 2048, 768, 10234
SEED = 0
BOUND_UPDATE = 1e-4


def tree_modules(pkg: str):
    """(config, registry, optim, steps) of package ``pkg`` (modules that
    import their own package relatively, so an earlier tree's stay its own)."""
    return [importlib.import_module(f"{pkg}.{name}") for name in
            ("config", "registry", "train.optim", "train.steps")]


def build(pkg: str, device: torch.device):
    """The pretrain template's model, optimizer and train step in ``pkg``,
    and a maker of fresh optimizers over the model."""
    config, registry, optim, steps = tree_modules(pkg)
    args, _ = config.parse_args(["--config", str(TEMPLATE)])
    kw = dict(config.model_kwargs_from_args(args), rna_embed_dim=RNA_DIM)
    kw.setdefault("wsi_num_tokens", args.num_wsi_feature_tokens)
    model = registry.create_model("mirror", device=device,
                                  generator=torch.Generator().manual_seed(SEED), **kw)

    def new_opt():
        return optim.make_optimizer(args, model, config.resolve_lr(args, B))
    opt = new_opt()
    step = steps.make_mirror_train_step(
        model, opt, loss_weights_from_args(args), args.wsi_mask_ratio,
        args.rna_mask_ratio, generator=torch.Generator(device=device).manual_seed(SEED))
    return model, opt, step, new_opt


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", type=Path, default=None,
                   help="a checkout of the earlier tree (its mirror_tpu_torch/)")
    p.add_argument("--runs", type=int, default=5, help="calls per timed sample")
    p.add_argument("--reps", type=int, default=9, help="timed samples (median)")
    a = p.parse_args(argv)
    device = T.device_from_arg("cuda")
    pkgs = {"this": "mirror_tpu_torch"}
    if a.parent is not None:
        T.load_parent(a.parent.resolve(), op="ppeg")
        pkgs["parent"] = T.PARENT_NAME
    batch = {"wsi": T.randn(device, B, N_TOKENS, WSI_DIM, seed=1).float(),
             "rna": T.randn(device, B, RNA_DIM, seed=2).float()}
    built = {name: build(pkg, device) for name, pkg in pkgs.items()}
    failed, result = [], []

    losses = {name: float(step(batch)["loss"]) for name, (_, _, step, _) in built.items()}
    if not all(map(torch.isfinite, map(torch.tensor, losses.values()))):
        failed.append(f"loss {losses}")
    step_ms = T.in_turns({name: (lambda s=s: s(batch)) for name, (_, _, s, _) in built.items()},
                         device, a.runs, a.reps)
    update_ms = T.in_turns({name: o.step for name, (_, o, _, _) in built.items()}, device,
                           a.runs * 4, a.reps)
    for name, (model, opt, _, _) in built.items():
        n = sum(p.numel() for p in model.parameters())
        split = T.launch_split(opt.step)
        device_ms = sum(kms for _, kms, _ in split)
        launches = sum(cnt for _, _, cnt in split)
        row = dict(tree=name, optimizer=type(opt).__name__, params=n,
                   step_ms=sum(step_ms[name]) / len(step_ms[name]), step_samples_ms=step_ms[name],
                   update_ms=sum(update_ms[name]) / len(update_ms[name]),
                   update_samples_ms=update_ms[name], update_device_ms=device_ms,
                   update_launches=launches, loss=losses[name],
                   split=[dict(kernel=k, ms=kms, per_call=cnt) for k, kms, cnt in split])
        result.append(row)
        print(f"[{name}] {row['optimizer']} on {n} fp32 parameters: train step "
              f"{row['step_ms']:.3f} ms (samples {', '.join(f'{s:.3f}' for s in step_ms[name])}); "
              f"update alone {row['update_ms']:.4f} ms (samples "
              f"{', '.join(f'{s:.4f}' for s in update_ms[name])}), {device_ms:.4f} ms of device "
              f"time in {launches:g} launches; loss {losses[name]:.6g}", flush=True)
        for kname, kms, cnt in split:
            print(f"    {kms:9.4f} ms x{cnt:g} {kname[:100]}", flush=True)

    if "parent" in built:
        # one update each by a fresh optimizer from the same weights and
        # gradients (this tree's, after its last step)
        m_this, m_par = built["this"][0], built["parent"][0]
        with torch.no_grad():
            for p_par, p_this in zip(m_par.parameters(), m_this.parameters(), strict=True):
                p_par.copy_(p_this)
                p_par.grad = None if p_this.grad is None else p_this.grad.clone()
        moved = {}
        for name in ("this", "parent"):
            model, new_opt = built[name][0], built[name][3]
            before = [p.detach().clone() for p in model.parameters()]
            new_opt().step()
            moved[name] = [p.detach() - b for p, b in zip(model.parameters(), before)]
        num = sum(float((x - y).double().square().sum()) for x, y in
                  zip(moved["this"], moved["parent"]))
        den = sum(float(y.double().square().sum()) for y in moved["parent"])
        err = (num / den) ** 0.5
        print(f"one update from the same weights and gradients: this vs parent displacement "
              f"rel Frobenius err {err:.3g} (bar {BOUND_UPDATE:g})", flush=True)
        if not err <= BOUND_UPDATE:
            failed.append(f"update displacement {err:.3g}")
        this, parent = result
        print(f"this / parent: train step {this['step_ms'] / parent['step_ms']:.3f}, update "
              f"{this['update_ms'] / parent['update_ms']:.3f} (device "
              f"{this['update_device_ms'] / parent['update_device_ms']:.3f})", flush=True)
    T.emit("exp_optim_ab", device, dict(b=B, n=N_TOKENS, wsi=WSI_DIM, rna=RNA_DIM), result,
           failed=failed)
    if failed:
        print(f"beyond the bar: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
