// What the landmark softmax's forward (landmark.cu, kernel 1) and backward
// (landmark_bwd.cu, kernel 1b) share: the tile strides and the shapes both
// take. landmark.cu's head comment has the design.
#pragma once

#include "attn_mma.cuh"

namespace landmark {

template <int DT>
__host__ __device__ constexpr int row_stride() { return 16 * DT + 8; }

constexpr int LDP = attn::BN + 8;  // the stride of a staged 64-column tile (P, ga2)

// The forward (landmark.cu) takes any dh and m, n + pad = m l.
inline bool fwd_shape_ok(int n, int dh, int m, int l, int pad) {
  return dh >= 1 && m > 0 && l > 0 && pad >= 0 && (long long)m * l == (long long)n + pad;
}

// The backward (landmark_bwd.cu): dh a multiple of 16 up to 128, m a
// multiple of 8.
inline bool bwd_shape_ok(int n, int dh, int m, int l, int pad) {
  return fwd_shape_ok(n, dh, m, l, pad) && dh % 16 == 0 && dh <= 128 && m % 8 == 0;
}

}  // namespace landmark
