// One span of the cluster kernels: a ray against the T triangles of one
// cluster block held in shared memory. Shared by sweep.cu and
// cluster_intersect.cu so the two kernels cannot drift apart.
//
// The block in shared memory is the first 41*T floats of trifeat[c]
// (models/clusters.py): rows 0..9 of the four T-column groups
// [A | TN | U | V], then row 10 (the parallel threshold E) of group A.
// rayfeat rows 10..15 are always 0, so only rows 0..9 enter the
// contraction: 40 FP32 FMAs per ray x triangle on the CUDA cores. The
// contraction never goes to TF32 tensor cores: a 10-bit mantissa on t is
// the precision class that shows as self-intersection acne.

#pragma once

#include <cuda_runtime.h>

namespace mt {

constexpr int TILE_R = 128;     // rays per CTA, one per thread
constexpr int N_FEAT = 16;      // rayfeat width
constexpr int BEST_W = 8;       // best-record width
constexpr int USED_ROWS = 10;   // rayfeat rows 10..15 are always 0
constexpr float INF_T = 114514.0f;
constexpr float T_MIN = 0.0005f;

// floats of one cluster block that a span reads
__host__ __device__ constexpr int span_floats(int t_blk) {
  return USED_ROWS * 4 * t_blk + t_blk;
}

// Copy the used part of one cluster block (src = trifeat + c * 16 * 4T)
// into shared memory: float4 for the bulk, scalars for a ragged tail.
// The caller synchronises the CTA before (the previous span is no longer
// read) and after (the copy is visible).
__device__ __forceinline__ void load_span(float* tf, const float* src,
                                          int t_blk, int tid) {
  const int n_used = span_floats(t_blk);
  const int n4 = n_used / 4;
  float4* tf4 = reinterpret_cast<float4*>(tf);
  const float4* src4 = reinterpret_cast<const float4*>(src);
  for (int i = tid; i < n4; i += TILE_R) tf4[i] = src4[i];
  for (int i = 4 * n4 + tid; i < n_used; i += TILE_R) tf[i] = src[i];
}

// Det-scaled Moller-Trumbore of one ray (features f) against the T
// triangles in tf, folded into the ray's best record: |A| > E, strict
// interior, t >= T_MIN, the 1e-5 pullback; the lowest lane wins inside a
// span and a later span must be strictly closer.
__device__ __forceinline__ void intersect_span(
    const float* tf, const float (&f)[USED_ROWS], int cid, int t_blk,
    float& best_t, int& best_slot, float& best_in) {
  const int row = 4 * t_blk;                  // floats per trifeat row
  float tmin = INF_T;
  int kmin = t_blk;
  float a_win = 0.0f;
  const float* eps_row = tf + USED_ROWS * row;
  for (int k = 0; k < t_blk; ++k) {
    float a = 0.0f, tn = 0.0f, u = 0.0f, v = 0.0f;
#pragma unroll
    for (int i = 0; i < USED_ROWS; ++i) {
      const float* r = tf + i * row + k;
      a = fmaf(f[i], r[0], a);
      tn = fmaf(f[i], r[t_blk], tn);
      u = fmaf(f[i], r[2 * t_blk], u);
      v = fmaf(f[i], r[3 * t_blk], v);
    }
    const float abs_a = fabsf(a);
    if (!(abs_a > eps_row[k])) continue;          // parallel (or pad)
    const float s = a > 0.0f ? -1.0f : 1.0f;
    const float us = u * s;
    const float vs = v * s;
    if (!(us > 0.0f && vs > 0.0f && us + vs < abs_a)) continue;
    const float t = tn / a;
    if (!(t >= T_MIN)) continue;
    const float tm = t - 1e-5f;
    if (tm < tmin) {   // strict: the lowest lane keeps a tie
      tmin = tm;
      kmin = k;
      a_win = a;
    }
  }
  if (tmin < INF_T && tmin < best_t) {
    best_t = tmin;
    best_slot = cid * t_blk + kmin;
    best_in = a_win > 0.0f ? 1.0f : 0.0f;
  }
}

}  // namespace mt
