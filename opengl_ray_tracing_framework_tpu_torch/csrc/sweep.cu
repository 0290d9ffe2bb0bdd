// Span-sweep closest hit for Hopper (sm_90a).
//
// Replaces opengl_ray_tracing_framework_tpu/ops/sweep.py::_sweep_kernel, the
// TPU Pallas kernel every cast of the forward render goes through. Same
// contract as the plain PyTorch version in ops/sweep.py (sweep_plain):
//
//   for each tile of TILE_R rays (one CTA, one thread per ray), walk the
//   tile's nearest-first span list of clusters; for each span compute
//   [A | TN | U | V] = rayfeat . trifeat[cluster] for all T triangles, run
//   the det-scaled Moller-Trumbore test (|A| > E, strict interior,
//   t >= T_MIN, t - 1e-5 pullback), keep each ray's minimum t (the lowest
//   lane wins inside a span, a later span must be strictly closer), and
//   stop when the next span's tile entry distance is >= the tile max of
//   min(best_t, cap) over rays still live. A per-ray any-hit flag (record
//   column 4) retires occluded rays from that max, so one launch serves
//   closest-hit, any-hit and mixed (NEE shadow + bounce) batches.
//
// What bounds it on this card: streaming each span's cluster block from
// L2/DRAM into shared memory (41*T floats = 41 KB at T = 256, re-read by
// every tile whose list names the cluster; the whole 31.7 MB trifeat of an
// 82k-triangle scene fits the 50 MB L2), and FP32 FMA throughput: 40 FMAs
// per ray x triangle for the contraction (rayfeat rows 10-15 are zero, so
// only rows 0-9 are read) plus a division. The contraction stays on the
// CUDA cores in true FP32: TF32 tensor cores keep a 10-bit mantissa, the
// precision class that shows as self-intersection acne. What this first
// design does about it: one contiguous vectorised (float4) copy per span
// into shared memory, read back as warp-wide broadcasts (every thread of
// the CTA reads the same triangle at the same time, so no bank conflicts),
// the ray's 10 features held in registers, and the sweep's nearest-first
// order plus the CTA-wide stop test to skip spans that cannot improve any
// live ray. Double-buffering the span copy, several rays per thread and a
// persistent grid are later work.

#include <cuda_runtime.h>

#include "mt_span.cuh"

namespace {

using mt::BEST_W;
using mt::INF_T;
using mt::N_FEAT;
using mt::TILE_R;       // rays per CTA; must match ops/sweep.py
using mt::USED_ROWS;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// smem holds one span's cluster block (mt_span.cuh: 41*T floats).
__global__ void __launch_bounds__(TILE_R)
sweep_kernel(const int* __restrict__ nspan, const int* __restrict__ spans,
             const float* __restrict__ tile_sorted,
             const float* __restrict__ rayfeat, float* __restrict__ best,
             const float* __restrict__ trifeat, int n_clusters, int t_blk) {
  extern __shared__ float4 smem4[];
  float* tf = reinterpret_cast<float*>(smem4);
  __shared__ float warp_red[TILE_R / 32];

  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const long long ray = static_cast<long long>(g) * TILE_R + tid;
  const int limit = nspan[g];
  if (limit <= 0) return;   // block-uniform: the record stays as given

  float f[USED_ROWS];
#pragma unroll
  for (int i = 0; i < USED_ROWS; ++i) f[i] = rayfeat[ray * N_FEAT + i];

  float* rec = best + ray * BEST_W;
  float best_t = rec[0];
  int best_slot = static_cast<int>(rec[1]);
  float best_in = rec[2];
  const float cap = rec[3];
  const bool anyflag = rec[4] > 0.5f;

  const size_t block = static_cast<size_t>(N_FEAT) * 4 * t_blk;
  const int* span_row = spans + static_cast<size_t>(g) * n_clusters;
  const float* tn_row = tile_sorted + static_cast<size_t>(g) * n_clusters;

  for (int j = 0; j < limit; ++j) {
    const int cid = span_row[j];
    __syncthreads();   // every thread is done reading the previous span
    mt::load_span(tf, trifeat + static_cast<size_t>(cid) * block, t_blk, tid);
    __syncthreads();
    mt::intersect_span(tf, f, cid, t_blk, best_t, best_slot, best_in);

    // stop test: the next span is needed only if its tile entry distance
    // is below some live ray's min(best_t, cap); occluded any-hit rays
    // are no longer live
    float live_t = (anyflag && best_slot >= 0) ? -INF_T : best_t;
    live_t = fminf(live_t, cap);
    live_t = warp_max(live_t);
    if ((tid & 31) == 0) warp_red[tid >> 5] = live_t;
    __syncthreads();
    float thresh = warp_red[0];
#pragma unroll
    for (int w = 1; w < TILE_R / 32; ++w) thresh = fmaxf(thresh, warp_red[w]);
    const bool more = (j + 1 < limit) && (tn_row[j + 1] < thresh);
    if (!more) break;   // block-uniform
    __syncthreads();    // warp_red is rewritten by the next span
  }

  rec[0] = best_t;
  rec[1] = static_cast<float>(best_slot);
  rec[2] = best_in;
}

}  // namespace

extern "C" int sweep_tile_rays() { return TILE_R; }

// nspan (G,) i32; spans, tile_sorted (G, C); rayfeat (G*TILE_R, 16) f32;
// best (G*TILE_R, 8) f32, updated in place; trifeat (C, 16, 4T) f32.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int sweep_launch(const int* nspan, const int* spans,
                            const float* tile_sorted, const float* rayfeat,
                            float* best, const float* trifeat, int n_tiles,
                            int n_clusters, int t_blk, void* stream) {
  if (n_tiles > 0) {
    const size_t smem_bytes =
        static_cast<size_t>(mt::span_floats(t_blk)) * sizeof(float);
    sweep_kernel<<<n_tiles, TILE_R, smem_bytes,
                   static_cast<cudaStream_t>(stream)>>>(
        nspan, spans, tile_sorted, rayfeat, best, trifeat, n_clusters, t_blk);
  }
  return static_cast<int>(cudaGetLastError());
}
