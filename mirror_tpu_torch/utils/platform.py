"""The device an entry point runs on when ``--device`` is not given.

Counterpart of ``mirror_tpu/utils/platform.py``. The job launchers pin each
child to a slot through its environment (``tools/launcher.py::
default_slot_env``): a numeric slot sets ``CUDA_VISIBLE_DEVICES``, the
``cpu`` slot sets ``MIRROR_PLATFORM=cpu``. Every entry point of the port
with a ``--device`` flag takes :func:`default_device` as that flag's
default, so a child on the ``cpu`` slot runs on the CPU (the kernels' plain
versions) and every other one on the card. This is the slot contract, not a
fallback: the CPU runs only where the variable or the flag asks for it, and
an explicit ``--device`` wins over the variable.
"""

import os

ENV = "MIRROR_PLATFORM"
PLATFORMS = ("cuda", "cpu")


def default_device() -> str:
    """``cuda`` where ``MIRROR_PLATFORM`` is unset, empty or ``cuda``;
    ``cpu`` where it is ``cpu``. Any other value (the JAX package's ``tpu``,
    say) names no device of the port and is refused by name."""
    forced = os.environ.get(ENV, "")
    if forced in ("", "cuda"):
        return "cuda"
    if forced == "cpu":
        return "cpu"
    raise SystemExit(f"{ENV}={forced!r}: the PyTorch port runs on {' or '.join(PLATFORMS)} "
                     "(unset means cuda)")
