"""Where the time of the fused ViT sub-layer kernels goes, on the card.

A diagnostic beside the probe ``exp_vit_fused_sublayer`` for the redesign of
``csrc/vit_fused.cu``. It builds copies of that source, each into its own
library under ``build/kernels/phases/`` (the shipped library is untouched):

- ``stamps``: ``clock64()`` stamps of thread 0 of every CTA around each
  phase of k5 and k8 (the LN statistics and their exchange, the q|k|v
  products with their ring waits and epilogue, the attention, the o-ready
  cluster barrier, the out product with its distributed loads, its
  epilogue), and of thread 0 of every consumer warpgroup of k7 and k9: in
  the fc1 CTAs the W_1 ring's waits, the fc1 products, the wait for a
  free hidden buffer and the GELU with its stores into the first fc2 CTA; in the
  fc2 CTAs the wait for a hidden chunk, the W_2 ring's waits, the fc2
  products and the epilogue; summed in a device array;
- ``no_weight_loads`` (k7, k9: no W_1 or W_2 box is loaded; the ring's
  barriers still turn), ``no_products`` (k7, k9: no fc1 or fc2 product),
  ``no_gelu`` (the hidden chunk is acc + b_1, no GELU) and
  ``no_hidden_stores`` (the GELU computed, its stores into the first fc2
  CTA left out: wrong results, timed only), timed;
- ``quads_1`` and ``quads_4``: the MLP kernels at 1 and 4 quads a cluster
  (``kQuads``; the shipped library has 2), timed in turns with the shipped
  library and checked for the same bits.

It prints the mean clocks per image and CTA (attention) or per 64-row tile
and consumer warpgroup (MLP), the SM clock, each variant's ms (CUDA events,
median), k7 and k9 at 1, 2 and 4 quads a cluster, and one JSON line. At
the probe's shapes (B 512, n 197, d 768, 12 heads, MLP 3072):

    python -m mirror_tpu_torch.scripts.vit_fused_phases
"""

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from ..ops import _common, vit_fused
from . import _timing as T
from . import exp_vit_fused_sublayer as P

SOURCE = _common.CSRC_DIR / "vit_fused.cu"
OUT_DIR = _common.BUILD_DIR / "phases"
ATTN_PHASES = ("ln_stats", "qkv_products", "attention", "cluster_wait", "out_product",
               "out_epilogue")

# (text in vit_fused.cu, its replacement): each must match exactly once
STAMPS = (
    ("namespace {\n\nnamespace cg",
     "__device__ unsigned long long g_clk[24];\n"
     "extern \"C\" int mirror_read_clocks(unsigned long long* host) {\n"
     "  cudaMemcpyFromSymbol(host, g_clk, sizeof(g_clk));\n"
     "  unsigned long long zero[24] = {0};\n"
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
    # the MLP kernels, thread 0 of each consumer warpgroup: the fc1 CTAs'
    # ring waits (6), fc1 products (7), hidden-buffer waits (8), GELU and
    # stores (9), waits for their turn (16); the fc2 CTAs' hidden waits
    # (10), ring waits (11), fc2 products (12), epilogue (13); the fc2
    # warpgroups' tiles (14)
    ("      mbar_wait(&bars.turn[j], ((u / 3) & 1) ^ (j == 0));\n",
     "      const long long TT = clock64();\n"
     "      mbar_wait(&bars.turn[j], ((u / 3) & 1) ^ (j == 0));\n"
     "      if (ct == 0) atomicAdd(&g_clk[16], (unsigned long long)(clock64() - TT));\n"),
    ("      int prev = 0;\n#pragma unroll 1\n      for (int ks = 0; ks < ksteps; ++ks) {\n"
     "        const int pos = u * ksteps + ks, s = pos % kStages1;\n"
     "        mbar_wait(&bars.full[s], (pos / kStages1) & 1);\n",
     "      int prev = 0;\n      long long T0 = clock64(), W = 0;\n#pragma unroll 1\n"
     "      for (int ks = 0; ks < ksteps; ++ks) {\n"
     "        const int pos = u * ksteps + ks, s = pos % kStages1;\n"
     "        const long long TW = clock64();\n"
     "        mbar_wait(&bars.full[s], (pos / kStages1) & 1);\n        W += clock64() - TW;\n"),
    ("      mbar_wait(&bars.hfree[j], (q / kBufs) & 1);\n",
     "      const long long T1 = clock64();\n      mbar_wait(&bars.hfree[j], (q / kBufs) & 1);\n"
     "      const long long T2 = clock64();\n"),
    ("      mbar_arrive_rank_release(&bars.h_full[hb], 2 * kQuads + quad);\n",
     "      mbar_arrive_rank_release(&bars.h_full[hb], 2 * kQuads + quad);\n"
     "      if (ct == 0) {\n        atomicAdd(&g_clk[6], (unsigned long long)W);\n"
     "        atomicAdd(&g_clk[7], (unsigned long long)(T1 - T0 - W));\n"
     "        atomicAdd(&g_clk[8], (unsigned long long)(T2 - T1));\n"
     "        atomicAdd(&g_clk[9], (unsigned long long)(clock64() - T2));\n      }\n"),
    ("      mbar_wait_cluster(&bars.h_full[hb], (q / kBufs) & 1);\n",
     "      const long long H0 = clock64();\n      mbar_wait_cluster(&bars.h_full[hb], (q / kBufs) & 1);\n"
     "      const long long H1 = clock64();\n      long long W = 0;\n"),
    ("        mbar_wait(&bars.full[stage], phase);\n",
     "        const long long TW = clock64();\n        mbar_wait(&bars.full[stage], phase);\n"
     "        W += clock64() - TW;\n"),
    ("      if (lane == 0) mbar_arrive(&bars.h_empty[hb]);\n",
     "      if (lane == 0) mbar_arrive(&bars.h_empty[hb]);\n      if (ct == 0) {\n"
     "        atomicAdd(&g_clk[10], (unsigned long long)(H1 - H0));\n"
     "        atomicAdd(&g_clk[11], (unsigned long long)W);\n"
     "        atomicAdd(&g_clk[12], (unsigned long long)(clock64() - H1 - W));\n      }\n"),
    ("    fence_regs(acc);\n\n    // + b_2",
     "    fence_regs(acc);\n    const long long E0 = clock64();\n\n    // + b_2"),
    ("          *reinterpret_cast<__nv_bfloat162*>(a.out + at) = __floats2bfloat162_rn(o0, o1);\n"
     "        }\n      }\n    }\n  }\n}\n",
     "          *reinterpret_cast<__nv_bfloat162*>(a.out + at) = __floats2bfloat162_rn(o0, o1);\n"
     "        }\n      }\n    }\n    if (ct == 0) {\n"
     "      atomicAdd(&g_clk[13], (unsigned long long)(clock64() - E0));\n"
     "      atomicAdd(&g_clk[14], 1ull);\n    }\n  }\n}\n"),
)
VARIANTS = {
    "stamps": STAMPS,
    "no_weight_loads": (
        ("      mbar_expect_tx(&bars.full[stage], boxes * kW1Box);\n",
         "      mbar_arrive(&bars.full[stage]);\n"),
        ("      for (int bx = quad; bx < boxes; bx += kQuads)\n        load_weight_box(dst + bx * kW1Box",
         "      for (int bx = quad; bx < 0; bx += kQuads)\n        load_weight_box(dst + bx * kW1Box"),
        ("      mbar_expect_tx(&bars.full[stage], boxes * kW2Box);\n",
         "      mbar_arrive(&bars.full[stage]);\n"),
        ("      for (int bx = quad; bx < boxes; bx += kQuads)\n        load_weight_box(dst + bx * kW2Box",
         "      for (int bx = quad; bx < 0; bx += kQuads)\n        load_weight_box(dst + bx * kW2Box")),
    "no_products": (
        ("          wgmma_ss_m64n128k16(acc, sw128_desc(smem + (k / 64)",
         "          if (false) wgmma_ss_m64n128k16(acc, sw128_desc(smem + (k / 64)"),
        ("          wgmma_ss_m64n128k16(acc, sw128_desc(hid + (k / 64)",
         "          if (false) wgmma_ss_m64n128k16(acc, sw128_desc(hid + (k / 64)")),
    "no_gelu": (
        ("        const float v0 = in ? gelu_erf(acc[4 * jj + 2 * h2] + b.x) : 0.f;\n"
         "        const float v1 = in ? gelu_erf(acc[4 * jj + 2 * h2 + 1] + b.y) : 0.f;\n",
         "        const float v0 = in ? acc[4 * jj + 2 * h2] + b.x : 0.f;\n"
         "        const float v1 = in ? acc[4 * jj + 2 * h2 + 1] + b.y : 0.f;\n"),),
    "no_hidden_stores": (
        ("      st_cluster_v4(dst + (k / 2) * kBox + 8 * h2 * 128 + (((4 * (k % 2) + t4) ^ g) << 4), pk);\n",
         "      asm volatile(\"\" ::\"r\"(pk[0]), \"r\"(pk[1]), \"r\"(pk[2]), \"r\"(pk[3]));\n"),),
    "quads_1": (("constexpr int kQuads = 2;\n", "constexpr int kQuads = 1;\n"),),
    "quads_4": (("constexpr int kQuads = 2;\n", "constexpr int kQuads = 4;\n"),),
}
MLP_PHASES = ("fc1_ring_wait", "fc1_products", "hidden_free_wait", "gelu_and_store",
              "fc2_hidden_wait", "fc2_ring_wait", "fc2_products", "fc2_epilogue")
MLP_TURN = 16  # the fc1 warpgroups' waits for their turn


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


def callers(lib, x, wts, b, out=None):
    """(k5, k8, k7, k9) as calls of ``lib``'s entries on the probe's inputs,
    writing ``out``."""
    p = ctypes.c_void_p
    stream = p(torch.cuda.current_stream().cuda_stream)
    attn, mlp = lib.mirror_vit_fused_attn, lib.mirror_vit_fused_mlp
    attn.argtypes = [p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [p]
    mlp.argtypes = [p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float, p]
    out = torch.empty_like(x) if out is None else out

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
    clocks = (ctypes.c_ulonglong * 24)()
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
            per = {k: clocks[6 + i] / clocks[14] for i, k in enumerate(MLP_PHASES)}
            per["fc1_turn_wait"] = clocks[MLP_TURN] / clocks[14]
            unit = "clocks per 64-row tile and consumer warpgroup"
        result[kernel] = dict(ms_stamped=ms, unit=unit, **per)
        print(f"{kernel}: {ms:.4f} ms (stamped build); {unit}: "
              + ", ".join(f"{k} {v:.0f}" for k, v in per.items()), flush=True)
    for name in ("no_weight_loads", "no_products", "no_gelu", "no_hidden_stores"):
        for kernel in ("k7", "k9"):
            ms = T.median_ms(callers(libs[name], x, wts, a.batch)[kernel], device, a.steps,
                             a.reps)
            result[kernel][f"ms_{name}"] = ms
            print(f"{kernel} {name}: {ms:.4f} ms", flush=True)
    # k7 and k9 at each number of quads a cluster (2: the shipped library),
    # in turns: the same bits at every one
    by_quads = {1: libs["quads_1"], 2: _common.library(), 4: libs["quads_4"]}
    print(f"the shipped MLP kernel: {vit_fused.mlp_clusters(device.index or 0)} clusters "
          f"at once", flush=True)
    outs = {}
    for quads in (1, 2, 4, 2, 1, 4):
        for kernel in ("k7", "k9"):
            call = callers(by_quads[quads], x, wts, a.batch)[kernel]
            ms = T.median_ms(call, device, a.steps, a.reps)
            result[kernel].setdefault("ms_by_quads", {}).setdefault(str(quads), []).append(ms)
            print(f"{kernel} at {quads} quads a cluster: {ms:.4f} ms", flush=True)
            out = torch.empty_like(x)
            callers(by_quads[quads], x, wts, a.batch, out)[kernel]()
            outs.setdefault(kernel, []).append(out)
    for kernel, got in outs.items():
        result[kernel]["same_bits_by_quads"] = all(torch.equal(o, got[0]) for o in got)
        print(f"{kernel}: the same bits at 1, 2 and 4 quads: "
              f"{result[kernel]['same_bits_by_quads']}", flush=True)
    sm_clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip()
    print(json.dumps(dict(probe="vit_fused_phases", device=T.device_name(device), sm_clock=sm_clock,
                          shape=dict(b=a.batch, n=P.N, heads=P.H, dh=P.DH, mlp=P.MLP),
                          kernels=result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
