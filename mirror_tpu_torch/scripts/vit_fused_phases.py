"""Where the time of the fused ViT sub-layer kernels goes, on the card.

A diagnostic beside the probe ``exp_vit_fused_sublayer`` for the redesign of
``csrc/vit_fused.cu``. It builds copies of that source, each into its own
library under ``build/kernels/phases/`` (the shipped library is untouched):

- ``stamps``: ``clock64()`` stamps of thread 0 of every CTA around each
  phase of k5 and k8 (the LN statistics and their exchange, the q|k|v
  products with their ring waits and epilogue, the attention, the o-ready
  cluster barrier, the out product with its distributed loads, its
  epilogue), and of every block of k7 and k9 around the ring's wait and the
  W_1 and W_2 tiles' products, summed in a device array;
- ``no_weight_loads`` (k7, k9: the ring never loads a weight tile) and
  ``no_products`` (k7, k9: no WMMA product), timed.

It prints the mean clocks per image and CTA (attention) or per 32-row tile
(MLP), the SM clock, each variant's ms (CUDA events, median) and one JSON
line. At the probe's shapes (B 512, n 197, d 768, 12 heads, MLP 3072):

    python -m mirror_tpu_torch.scripts.vit_fused_phases
"""

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from ..ops import _common
from . import _timing as T
from . import exp_vit_fused_sublayer as P

SOURCE = _common.CSRC_DIR / "vit_fused.cu"
OUT_DIR = _common.BUILD_DIR / "phases"
ATTN_PHASES = ("ln_stats", "qkv_products", "attention", "cluster_wait", "out_product",
               "out_epilogue")

# (text in vit_fused.cu, its replacement): each must match exactly once
STAMPS = (
    ("namespace {\n\nnamespace cg",
     "__device__ unsigned long long g_clk[16];\n"
     "extern \"C\" int mirror_read_clocks(unsigned long long* host) {\n"
     "  cudaMemcpyFromSymbol(host, g_clk, sizeof(g_clk));\n"
     "  unsigned long long zero[16] = {0};\n"
     "  return (int)cudaMemcpyToSymbol(g_clk, zero, sizeof(zero));\n"
     "}\nnamespace {\n\nnamespace cg"),
    # the attention kernels: per image, the LN statistics and their
    # exchange, phase 1 (the ring's waits, the q|k|v products and their
    # epilogue) and phase 2 summed over the CTA's heads, the o-ready cluster
    # barrier, phase 3's products (with the W_o waits and the distributed
    # loads) and its epilogue
    ("  for (int img = first; img < last; ++img) {\n",
     "  for (int img = first; img < last; ++img) {\n"
     "    long long T0 = clock64(), T1 = T0, ph1 = 0, ph2 = 0, tq = 0;\n"),
    ("    for (int j = 0; j < hpc; ++j) {\n      const int head = rank * hpc + j;\n",
     "    T1 = clock64();\n    for (int j = 0; j < hpc; ++j) {\n"
     "      const int head = rank * hpc + j;\n      tq = clock64();\n"),
    ("      __syncthreads();  // head j's q, k and v are complete\n",
     "      __syncthreads();  // head j's q, k and v are complete\n"
     "      ph1 += clock64() - tq;\n      tq = clock64();\n"),
    ("      __syncthreads();  // k and v are free for the next head\n",
     "      __syncthreads();  // k and v are free for the next head\n"
     "      ph2 += clock64() - tq;\n"),
    ("    cluster_arrive();  // every head's o is in its CTA's shared memory\n"
     "    cluster_wait();\n",
     "    const long long T3 = clock64();\n    cluster_arrive();\n    cluster_wait();\n"
     "    const long long T4 = clock64();\n"),
    ("  const int rounds = (L.npad + kPassRows - 1) / kPassRows;\n",
     "  const int rounds = (L.npad + kPassRows - 1) / kPassRows;\n"
     "  const long long P0 = clock64();\n  long long EPI = 0;\n"),
    ("    fence_regs(acc);\n    // + b_o",
     "    fence_regs(acc);\n    const long long P1 = clock64();\n    // + b_o"),
    ("        *reinterpret_cast<__nv_bfloat162*>(a.out + at) = __floats2bfloat162_rn(v0, v1);\n"
     "      }\n    }\n  }\n}\n",
     "        *reinterpret_cast<__nv_bfloat162*>(a.out + at) = __floats2bfloat162_rn(v0, v1);\n"
     "      }\n    }\n    EPI += clock64() - P1;\n  }\n  if (threadIdx.x == 0) {\n"
     "    atomicAdd(&g_clk[4], (unsigned long long)(clock64() - P0 - EPI));\n"
     "    atomicAdd(&g_clk[5], (unsigned long long)EPI);\n  }\n}\n"),
    ("    }\n  }\n  if (end_pending) cluster_wait();",
     "    }\n    if (threadIdx.x == 0) {\n"
     "      atomicAdd(&g_clk[0], (unsigned long long)(T1 - T0));\n"
     "      atomicAdd(&g_clk[1], (unsigned long long)ph1);\n"
     "      atomicAdd(&g_clk[2], (unsigned long long)ph2);\n"
     "      atomicAdd(&g_clk[3], (unsigned long long)(T4 - T3));\n"
     "      atomicAdd(&g_clk[15], 1ull);\n    }\n  }\n  if (end_pending) cluster_wait();"),
    # the MLP kernels: per 32-row tile, the ring's waits and the W_1 and
    # W_2 products
    ("    for (int s = 0; s < tiles; ++s) {",
     "    long long wait = 0, prod1 = 0, prod2 = 0, t_tile = clock64();\n"
     "    for (int s = 0; s < tiles; ++s) {\n      const long long ta = clock64();"),
    ("      cp_async_commit();\n      const bf16* tile = ring + (size_t)st * L.stage;",
     "      cp_async_commit();\n      const long long tb = clock64();\n      wait += tb - ta;\n"
     "      const bf16* tile = ring + (size_t)st * L.stage;"),
    ("      }\n    }\n    cp_async_wait<0>();\n\n    // epilogue: + b_2",
     "      }\n      (j < t1 ? prod1 : prod2) += clock64() - tb;\n    }\n"
     "    cp_async_wait<0>();\n\n    // epilogue: + b_2"),
    ("    __syncthreads();  // before the next row tile",
     "    if (threadIdx.x == 0) {\n      atomicAdd(&g_clk[8], (unsigned long long)wait);\n"
     "      atomicAdd(&g_clk[9], (unsigned long long)prod1);\n"
     "      atomicAdd(&g_clk[10], (unsigned long long)prod2);\n"
     "      atomicAdd(&g_clk[11], (unsigned long long)(clock64() - t_tile));\n"
     "      atomicAdd(&g_clk[14], 1ull);\n    }\n"
     "    __syncthreads();  // before the next row tile"),
)
VARIANTS = {
    "stamps": STAMPS,
    "no_weight_loads": (("      if (s + kMlpStages - 1 < tiles) load_tile(",
                         "      if (false) load_tile("),),
    "no_products": (("      if (j < t1) {  // h_c", "      if (false) {  // h_c"),
                    ("      } else {  // acc +=", "      } else if (false) {  // acc +=")),
}


def patched(text: str, patches) -> str:
    """``text`` with each (old, new) of ``patches`` applied; raises unless
    every old text occurs exactly once (the source moved on)."""
    for old, new in patches:
        if text.count(old) != 1:
            raise ValueError(f"vit_fused.cu no longer has exactly one {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build(names):
    """Each variant's library, all nvcc runs at once."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    cmds, libs = [], {}
    for name in names:
        src, lib = OUT_DIR / f"{name}.cu", OUT_DIR / f"lib_{name}.so"
        src.write_text(patched(text, VARIANTS[name]))
        cmds.append([_common._nvcc(), *_common.NVCC_FLAGS, "-shared", f"-I{_common.CSRC_DIR}",
                     "-o", str(lib), str(src)])
        libs[name] = lib
    _common._run_all(cmds)
    return {name: ctypes.CDLL(str(lib)) for name, lib in libs.items()}


def callers(lib, x, wts, b):
    """(k5, k8, k7, k9) as calls of ``lib``'s entries on the probe's inputs."""
    p = ctypes.c_void_p
    stream = p(torch.cuda.current_stream().cuda_stream)
    attn, mlp = lib.mirror_vit_fused_attn, lib.mirror_vit_fused_mlp
    attn.argtypes = [p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [p]
    mlp.argtypes = [p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float, p]
    out = torch.empty_like(x)

    def ptr(name):
        return p(wts[name].data_ptr())

    def run(fn, *args):
        def call():
            err = fn(*args)
            if err:
                raise RuntimeError(f"CUDA error {err}")
        return call

    ln = (ptr("ln_s"), ptr("ln_b"))
    none = (p(None), p(None))
    attn_rest = (ptr("qkv"), ptr("qkv_b"), ptr("out"), ptr("out_b"), p(out.data_ptr()), b, P.N,
                 P.H, P.DH, 1, P.DH ** -0.5, P.LN_EPS, stream)
    mlp_rest = (ptr("fc1"), ptr("fc1_b"), ptr("fc2"), ptr("fc2_b"), p(out.data_ptr()), b * P.N,
                P.N, P.D, P.MLP, P.LN_EPS, stream)
    xp = p(x.data_ptr())
    return {"k5": run(attn, xp, *none, *attn_rest), "k8": run(attn, xp, *ln, *attn_rest),
            "k7": run(mlp, xp, *none, *mlp_rest), "k9": run(mlp, xp, *ln, *mlp_rest)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=P.B)
    p.add_argument("--steps", type=int, default=4, help="calls per timed sample")
    p.add_argument("--reps", type=int, default=3, help="timed samples (median)")
    a = p.parse_args(argv)
    device = T.device_from_arg("cuda")
    libs = build(VARIANTS)
    wts = P.make_weights(device)
    x = T.randn(device, a.batch, P.N, P.D, seed=1)
    clocks = (ctypes.c_ulonglong * 16)()
    read = libs["stamps"].mirror_read_clocks
    read.argtypes = [ctypes.c_void_p]
    result = {}
    for kernel, call in callers(libs["stamps"], x, wts, a.batch).items():
        ms = T.median_ms(call, device, a.steps, a.reps)
        read(clocks)  # reset
        call()
        torch.cuda.synchronize()
        read(clocks)
        if kernel in ("k5", "k8"):
            per = {k: clocks[i] / clocks[15] for i, k in enumerate(ATTN_PHASES)}
            unit = "clocks per image and CTA"
        else:
            per = dict(wait=clocks[8] / clocks[14], w1_products=clocks[9] / clocks[14],
                       w2_products=clocks[10] / clocks[14], row_tile=clocks[11] / clocks[14])
            unit = "clocks per 32-row tile"
        result[kernel] = dict(ms_stamped=ms, unit=unit, **per)
        print(f"{kernel}: {ms:.4f} ms (stamped build); {unit}: "
              + ", ".join(f"{k} {v:.0f}" for k, v in per.items()), flush=True)
    for name in ("no_weight_loads", "no_products"):
        for kernel in ("k7", "k9"):
            ms = T.median_ms(callers(libs[name], x, wts, a.batch)[kernel], device, a.steps,
                             a.reps)
            result[kernel][f"ms_{name}"] = ms
            print(f"{kernel} {name}: {ms:.4f} ms", flush=True)
    sm_clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip()
    print(json.dumps(dict(probe="vit_fused_phases", device=T.device_name(device), sm_clock=sm_clock,
                          shape=dict(b=a.batch, n=P.N, heads=P.H, dh=P.DH, mlp=P.MLP),
                          kernels=result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
