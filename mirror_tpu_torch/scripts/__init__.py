"""The TPU probes of ``scripts/``, asked again of the H100.

Each module has the name of the JAX package's script whose question it asks
(``scripts/exp_<name>.py``) and runs as

    python -m mirror_tpu_torch.scripts.exp_<name> [--device cuda|cpu] [shape flags]

with the script's flags and its default shapes, which are the production
ones and exceed the card's 50 MB L2, so a run of calls needs no flush. On
``--device cuda`` (the default) the variants run their hand-written kernels
and are timed with CUDA events; a missing card raises. ``--device cpu`` runs
the plain versions once each, untimed, as the tests do. Each prints one row
per variant and, as its last line, one JSON object: the probe, the device,
the shape, and per variant its time, rate, bound, error and launches.
``main(argv) -> int`` is the entry point that ``chip_smoke.py`` calls.

| module | script (pallas_call) | kernels |
| --- | --- | --- |
| ``exp_hbm_floor`` | ``exp_hbm_floor.py`` (:54, :103, :126) | ``csrc/copy_floor.cu`` |
| ``exp_conv_parts`` | ``exp_conv_parts.py`` (times kernels 9, 9b) | ``csrc/conv1d.cu`` (+ dv alone, the column sum alone) |
| ``exp_ln_qkv`` | ``exp_ln_qkv.py`` (:128, ``big_core``) | ``csrc/ln_qkv.cu`` (kernel 10 is ``big_core``'s design) |
| ``exp_pinv_stash`` | ``exp_pinv_stash.py`` (:99) | ``csrc/pinv.cu`` (the exact backward, stash 4 / 2 / 1) |
| ``exp_vit_attn_kernel`` | ``exp_vit_attn_kernel.py`` (:101, :149) | ``csrc/vit_attn.cu`` (head-major, G pairs or N images a block) |
| ``exp_vit_fused_sublayer`` | ``exp_vit_fused_sublayer.py`` (:111, :167, :256, :300) | ``csrc/vit_fused.cu`` (k5, k7, k8, k9: one launch a sub-layer; the split kernels 6 and 7 as the ``xla_*_blk`` baselines) |

``exp_landmark_ab`` and ``exp_ln_qkv_ab`` ask no script's question either:
they time kernels 1 / 1b and 10 / 10b of this tree against an earlier
tree's (``--parent DIR``) in one process, with ``torch.profiler``'s split of
each call by launch.

``vit_fused_phases`` asks no script's question: it splits the time of
``csrc/vit_fused.cu``'s four kernels by phase (``clock64`` stamps in a copy
of the source built beside the library, and k7/k9 built without their
weight loads or their products), for the redesign of those kernels.
"""
