#!/usr/bin/env python
"""Export a trained model's inference function as a ``torch.export``
program (``.pt2``) for serving.

Counterpart of ``mirror_tpu/tools/export_model.py`` (``jax.export`` to
StableHLO), with its flags, modes and manifest:

    python -m mirror_tpu_torch.tools.export_model --checkpoint model_best.pth.tar \\
        --output clf.pt2 --mode classifier --model mirror_classifier --batch 16

Modes (``--mode``):

- ``classifier``: MIRRORClassifier logits ``f(wsi [B,T,D], rna [B,R]) ->
  [B, num_classes]`` (also the survival head: the same signature, the
  hazards' logits);
- ``embed``: MIRROR's forward with mask ratio 0, its aligned embeddings
  ``f(wsi, rna) -> (wsi_alignment_emb [B,E], rna_alignment_emb [B,E])``.

The model is rebuilt from the checkpoint's run args (``model_kwargs``),
``--model-kwargs`` over them, and loaded strict from its ``state_dict``
(the reference's ``.pth.tar`` or the JAX package's msgpack file). It is
traced under ``eval()`` and ``no_grad`` at a static batch on ``--device``
and saved with ``torch.export.save``, the weights inside; export once per
batch size and device you serve. On the card the Nystrom attention's and
PPEG's forward kernels are dispatcher ops (``mirror::landmark_softmax``,
``mirror::pinv``, ``mirror::softmax_attn``, ``mirror::softmax_attn_conv``,
``mirror::ppeg``; ``ops/_common.py``), each one node of the graph; an
export on the card whose graph holds none is an error (the kernels were
traced away). On the CPU the plain path traces, with its pinv and PPEG ops.
A JSON manifest (mode, model, checkpoint, inputs, dtype, bytes, device,
the torch version and the graph's ``mirror::`` ops) is written beside it.

A departure from StableHLO: the artifact needs the ops registered before it
is loaded, so ``import mirror_tpu_torch.ops`` first (it registers them; the
kernel library is built or loaded at the first launch). The model code is
not needed:

    import torch
    import mirror_tpu_torch.ops  # noqa: F401
    program = torch.export.load("clf.pt2").module()
    with torch.no_grad():
        logits = program(wsi.cuda(), rna.cuda())
"""

import argparse
import json
import logging
import os
from typing import Any, Dict

import torch
from torch import nn

from mirror_tpu_torch.config import ParseKwargs
from mirror_tpu_torch.ops import _common
from mirror_tpu_torch.registry import create_model
from mirror_tpu_torch.train.checkpoint import load_checkpoint_file, run_args
from mirror_tpu_torch.utils.platform import default_device

_logger = logging.getLogger("export_model")


class Embed(nn.Module):
    """``embed`` mode: MIRROR's forward with mask ratio 0 (every token kept,
    so the masking noise does not matter: zeros, and zeros for the style
    draws, which the aligned embeddings do not read); its two aligned
    embeddings."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, wsi: torch.Tensor, rna: torch.Tensor):
        b = wsi.shape[0]
        latent = self.model.style_mu.out_features
        noise = {
            "wsi_noise": wsi.new_zeros(b, wsi.shape[1]),
            "rna_noise": wsi.new_zeros(b, self.model.rna_encoder.retention_gene_embed.shape[1]),
            "wsi_eps": wsi.new_zeros(b, latent),
            "rna_eps": wsi.new_zeros(b, latent),
        }
        out = self.model(wsi, rna, 0.0, 0.0, noise=noise)
        return out.wsi_alignment_emb, out.rna_alignment_emb


MODES = ("classifier", "embed")


def build_inference_module(mode: str, model_name: str, ckpt_path: str,
                           model_kwargs: Dict[str, Any], device: torch.device) -> nn.Module:
    """The checkpoint's model on ``device`` in eval mode (``classifier``:
    its logits), or :class:`Embed` around it."""
    if mode not in MODES:
        raise SystemExit(f"unknown mode {mode}")
    payload = load_checkpoint_file(ckpt_path)
    kwargs = dict(run_args(payload).get("model_kwargs") or {})
    kwargs.update(model_kwargs)
    model = create_model(model_name, device=device, **kwargs)
    model.load_state_dict(payload["state_dict"])
    return (Embed(model) if mode == "embed" else model).eval()


def mirror_ops(program: torch.export.ExportedProgram) -> list:
    """The ``mirror::`` ops that the program's graph calls, by name."""
    return sorted({node.target.name() for node in program.graph.nodes
                   if getattr(node.target, "namespace", None) == _common.OP_NAMESPACE})


def export_model(
    mode: str,
    model_name: str,
    ckpt_path: str,
    output: str,
    batch: int,
    num_tokens: int,
    wsi_dim: int,
    rna_dim: int,
    model_kwargs: Dict[str, Any],
    device: str = "cuda",
) -> dict:
    """Trace, save and describe the program; returns the manifest."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card is available; pass --device cpu to "
                         "export the plain path on the CPU")
    module = build_inference_module(mode, model_name, ckpt_path, model_kwargs, device)
    inputs = (torch.zeros(batch, num_tokens, wsi_dim, device=device),
              torch.zeros(batch, rna_dim, device=device))
    with torch.no_grad():
        program = torch.export.export(module, inputs)
    ops = mirror_ops(program)
    if device.type == "cuda" and not ops:
        raise RuntimeError("the program exported on the card calls no mirror:: op: the "
                           "Nystrom and PPEG kernels were traced away")
    torch.export.save(program, output)
    manifest = {
        "mode": mode,
        "model": model_name,
        "checkpoint": os.path.abspath(ckpt_path),
        "inputs": {
            "wsi": [batch, num_tokens, wsi_dim],
            "rna": [batch, rna_dim],
        },
        "dtype": "float32",
        "bytes": os.path.getsize(output),
        "device": device.type,
        "torch": torch.__version__,
        "ops": ops,
    }
    with open(output + ".json", "w") as f:
        json.dump(manifest, f, indent=2)
    _logger.info("exported %s (%d bytes, ops %s) -> %s", mode, manifest["bytes"], ops, output)
    return manifest


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--output", required=True, help="output .pt2 path")
    p.add_argument("--mode", default="classifier", choices=MODES)
    p.add_argument("--model", default="mirror_classifier")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--num-tokens", type=int, default=2048)
    p.add_argument("--wsi-dim", type=int, default=768)
    p.add_argument("--rna-dim", type=int, default=10234)
    p.add_argument("--model-kwargs", nargs="*", default={}, action=ParseKwargs,
                   help="k=v pairs over the checkpoint's model kwargs")
    p.add_argument("--device", default=default_device(),
                   help="cuda traces the kernel path; cpu the plain path")
    a = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return export_model(a.mode, a.model, a.checkpoint, a.output, a.batch, a.num_tokens,
                        a.wsi_dim, a.rna_dim, a.model_kwargs or {}, a.device)


if __name__ == "__main__":
    main()
