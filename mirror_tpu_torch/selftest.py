"""On-card self-test of the port's kernels at the flagship TransMIL shapes.

Counterpart of ``bench.py::selftest`` (``python bench.py --selftest`` in the
JAX package), with its four modes and shapes:

- ``exact`` and ``implicit``: ``NystromAttention(dim=512, dim_head=64,
  heads=8, num_landmarks=256, pinv_iterations=6, residual=True,
  pinv_grad=mode, dtype=bf16)`` forward and backward on x [8, 2117, 512]
  (2048 tokens as a 46 x 46 grid plus the cls token; front pad 187, groups
  of 9): the landmark, pinv, attention and conv-fused attention kernels
  and their backward kernels at dh 64 and m 256, the exact pinv backward
  with ``exact``;
- ``ppeg_fused``: PPEG forward and backward on [8, 46, 46, 512] bf16, taps
  0.1 randn [7, 7, 512], zero bias;
- ``conv_standalone``: ``depthwise_conv1d_seq`` forward and backward on v
  [8, 8, 2117, 96] bf16 with fp32 taps [8, 33].

Each mode sums its output in fp32, differentiates it and passes when the
loss and every gradient are finite. One JSON line reports the modes, and
the exit code is 1 if any mode failed; an exception is not caught. Weights
and inputs come from seeded ``torch.Generator``s.

    python -m mirror_tpu_torch.selftest [--device cuda]

``--device`` defaults to cuda; on a host without a card the command stops
and names ``--device cpu``, which runs the kernels' plain versions.
"""

import argparse
import json
import sys

import torch

from .models.nystrom import NystromAttention
from .ops.conv1d import depthwise_conv1d_seq
from .ops.ppeg import ppeg_fused
from .registry import init_weights
from .utils.platform import default_device

METRIC = "cuda_kernel_selftest"
CONV_TAPS, SEED = 33, 0


def attention(dim: int, pinv_grad: str) -> NystromAttention:
    """The self-test's NystromAttention on the CPU, weights drawn from seed
    SEED + 1 (the same for both gradient modes): 8 heads of dim / 8, dim / 2
    landmarks, 6 pinv iterations, the residual conv, bf16 compute (as
    ``bench.py`` builds it)."""
    model = NystromAttention(dim=dim, dim_head=dim // 8, heads=8, num_landmarks=dim // 2,
                             pinv_iterations=6, residual=True, pinv_grad=pinv_grad,
                             dtype=torch.bfloat16)
    init_weights(model, torch.Generator().manual_seed(SEED + 1))
    return model.eval()


def _randn(gen: torch.Generator, shape, dtype=torch.float32, scale: float = 1.0):
    return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(dtype)


def _finite(*tensors: torch.Tensor) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def _loss_and_grads(out: torch.Tensor, inputs):
    loss = out.float().sum()
    return (loss, *torch.autograd.grad(loss, list(inputs)))


def selftest(device="cuda", batch: int = 8, n: int = 2117, dim: int = 512, side: int = 46,
             conv_shape=(8, 8, 2117, 96)) -> dict:
    """Run the four modes on ``device`` and return the JSON line's fields.
    The defaults are ``bench.py``'s shapes; PPEG runs [batch, side, side,
    dim]."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    x = _randn(gen, (batch, n, dim))
    modes = {}
    for grad_mode in ("exact", "implicit"):
        model = attention(dim, grad_mode).to(device)
        modes[grad_mode] = _finite(*_loss_and_grads(model(x), model.parameters()))
        del model

    bf16 = torch.bfloat16
    img = _randn(gen, (batch, side, side, dim), bf16).requires_grad_()
    kern = _randn(gen, (7, 7, dim), bf16, scale=0.1).requires_grad_()
    bias = torch.zeros(dim, dtype=bf16, device=device, requires_grad=True)
    modes["ppeg_fused"] = _finite(*_loss_and_grads(ppeg_fused(img, kern, bias),
                                                   (img, kern, bias)))

    v = _randn(gen, conv_shape, bf16).requires_grad_()
    ckern = _randn(gen, (conv_shape[1], CONV_TAPS), scale=0.1).requires_grad_()
    modes["conv_standalone"] = _finite(*_loss_and_grads(depthwise_conv1d_seq(v, ckern),
                                                        (v, ckern)))
    ok = all(modes.values())
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {"metric": METRIC, "value": 1 if ok else 0, "unit": "ok",
            "backend": device.type, "device": name, "modes": modes}


def main(argv=None, **shapes) -> int:
    """The CLI: ``bench.py``'s shapes unless ``shapes`` (the keyword
    arguments of :func:`selftest`) says otherwise. Prints the JSON line and
    returns 0 when every mode passed, else 1."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=default_device(),
                        help="cuda (the default: the kernels) or cpu (their plain versions)")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card is available; pass --device cpu to "
                         "run the kernels' plain versions on the CPU")
    line = selftest(args.device, **shapes)
    print(json.dumps(line), flush=True)  # lint: allow-print
    return 0 if line["value"] else 1


if __name__ == "__main__":
    sys.exit(main())
