#!/usr/bin/env python
"""Convert a JAX package checkpoint (flax msgpack) to the port's ``.pth.tar``.

Counterpart of ``mirror_tpu/tools/import_torch_checkpoint.py`` in the
reverse direction:

    python -m mirror_tpu_torch.tools.import_jax_checkpoint \\
        --checkpoint model_best.msgpack --output model_best.pth.tar

The params become the reference's ``state_dict`` keys and layouts
(``convert.state_dict_from_jax``), the EMA params ``state_dict_ema``;
``epoch``, ``arch``, ``metric``, ``args`` and ``version`` are carried, and
the optax state is dropped (``train/jax_checkpoint.py``). Every loader of
the port also reads the msgpack file directly
(``train/checkpoint.py::load_checkpoint_file``): the tool is for a file the
reference's own code should read. An Orbax directory is refused by name.
"""

import argparse
import logging
import os

from mirror_tpu_torch.train import jax_checkpoint
from mirror_tpu_torch.train.checkpoint import ORBAX_DIRECTORY_REFUSAL, save_payload

_logger = logging.getLogger("import_jax_checkpoint")


def import_checkpoint(checkpoint: str, output: str) -> dict:
    """Write the port's payload of the msgpack file ``checkpoint`` to
    ``output``; returns the payload."""
    if os.path.isdir(checkpoint):
        raise SystemExit(ORBAX_DIRECTORY_REFUSAL.format(path=checkpoint))
    if not jax_checkpoint.is_msgpack_file(checkpoint):
        raise SystemExit(f"{checkpoint}: not a flax msgpack checkpoint")
    payload = jax_checkpoint.load_jax_checkpoint(checkpoint)
    save_payload(output, payload)
    _logger.info("wrote %s: %d tensors%s", output, len(payload["state_dict"]),
                 ", with state_dict_ema" if "state_dict_ema" in payload else "")
    return payload


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", required=True, help="the JAX package's .msgpack file")
    p.add_argument("--output", required=True, help="output .pth.tar")
    a = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    import_checkpoint(a.checkpoint, a.output)
    return os.path.abspath(a.output)


if __name__ == "__main__":
    main()
