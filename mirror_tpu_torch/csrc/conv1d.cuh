// The backward of the depthwise conv along the sequence (csrc/conv1d.cu),
// shared by the standalone op (K9b) and the attention backward that carries
// the same conv (K4b, csrc/softmax_attn_bwd.cu).
#pragma once

#include "common.cuh"

// Elements of the fp32 `partial` scratch that conv1d_bwd needs: one dkern
// partial per (batch, row tile, feature part) and (head, tap); dtype is the
// type code of v (common.cuh's Elem).
long long conv1d_bwd_partial_elems(int bh, int n, int d, int ksize, int dtype);

// dv[bh, i] = sum_t kern[h, t] g[bh, i - t + K/2] (in T) and dkern[h, t] =
// sum over batch, rows and features of g[i] v[i + t - K/2] (fp32, summed in
// a fixed order). v, g, dv: [bh, n, d]; kern: [heads, ksize], all of T
// (bf16, float16 or float32); d a multiple of 8 up to 128, ksize odd up to 65.
template <typename T>
cudaError_t conv1d_bwd(const T* v, const T* kern, const T* g, T* dv, float* dkern,
                       float* partial, int bh, int heads, int n, int d, int ksize,
                       cudaStream_t stream);
