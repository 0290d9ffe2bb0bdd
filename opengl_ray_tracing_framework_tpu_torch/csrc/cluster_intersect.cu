// Dense ray-tile x elected-cluster intersection for Hopper (sm_90a).
//
// Replaces opengl_ray_tracing_framework_tpu/ops/intersect_pallas.py::_kernel
// (reached through cluster_intersect), the TPU Pallas kernel the schedule
// tracer runs once per round on every cast. Same contract as the plain
// PyTorch version in ops/cluster_intersect.py (cluster_intersect_plain):
//
//   rays come in tiles of rays_per_tile (a multiple of 128); tile g names up
//   to K elected clusters spans[g, 0..K). For every j < nspan[g] whose
//   spans[g, j] lies in [0, C), every ray of the tile is tested against all
//   T triangles of that cluster ([A | TN | U | V] = rayfeat . trifeat[c],
//   det-scaled Moller-Trumbore, mt_span.cuh) and its record [t, slot,
//   inside] is lowered where the span holds a strictly closer hit. There is
//   no stop test: the caller elected the clusters. Records are updated in
//   place; columns 3..7 are left as given.
//
// The TPU kernel's grid is (tile, j) and revisits a tile's record block
// once per j while it stays resident in fast memory. Here j is a loop
// inside the block: one CTA of 128 threads owns 128 rays (one per thread)
// of one tile, keeps t / slot / inside in registers across the K spans and
// writes them once.
//
// What bounds it on this card: per visited span and CTA, 41*T*4 bytes of
// the cluster block come from L2 (or HBM on first touch) into shared memory
// against 128*T*40 FP32 FMAs on the CUDA cores, 31 FMAs (62 FLOPs) per
// byte: above the card's FP32-rate-to-memory-rate ratio, so the FMAs are
// the bound and the copy is not (an 82k-triangle scene's 31.7 MB trifeat
// also fits the 50 MB L2). What the design does about it: one contiguous float4
// copy per span, shared-memory reads that are warp-wide broadcasts (every
// thread reads the same triangle), the ray's 10 features in registers, and
// spans skipped block-uniformly. The copy is not overlapped with the
// triangle loop and each FMA still costs one shared-memory load; both are
// later work.

#include <cuda_runtime.h>

#include "mt_span.cuh"

namespace {

using mt::BEST_W;
using mt::N_FEAT;
using mt::TILE_R;
using mt::USED_ROWS;

__global__ void __launch_bounds__(TILE_R)
cluster_intersect_kernel(const float* __restrict__ rayfeat,
                         float* __restrict__ best,
                         const int* __restrict__ spans,
                         const int* __restrict__ nspan,
                         const float* __restrict__ trifeat,
                         int rays_per_tile, int n_spans, int n_clusters,
                         int t_blk) {
  extern __shared__ float4 smem4[];
  float* tf = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const long long first = static_cast<long long>(blockIdx.x) * TILE_R;
  const long long ray = first + tid;
  // rays_per_tile is a multiple of TILE_R: the CTA lies inside one tile
  const int g = static_cast<int>(first / rays_per_tile);
  const int limit = min(nspan[g], n_spans);
  if (limit <= 0) return;   // block-uniform: the records stay as given

  float f[USED_ROWS];
#pragma unroll
  for (int i = 0; i < USED_ROWS; ++i) f[i] = rayfeat[ray * N_FEAT + i];

  float* rec = best + ray * BEST_W;
  float best_t = rec[0];
  int best_slot = static_cast<int>(rec[1]);
  float best_in = rec[2];

  const size_t block = static_cast<size_t>(N_FEAT) * 4 * t_blk;
  const int* span_row = spans + static_cast<size_t>(g) * n_spans;

  for (int j = 0; j < limit; ++j) {
    const int cid = span_row[j];
    if (cid < 0 || cid >= n_clusters) continue;   // block-uniform skip
    __syncthreads();   // every thread is done reading the previous span
    mt::load_span(tf, trifeat + static_cast<size_t>(cid) * block, t_blk, tid);
    __syncthreads();
    mt::intersect_span(tf, f, cid, t_blk, best_t, best_slot, best_in);
  }

  rec[0] = best_t;
  rec[1] = static_cast<float>(best_slot);
  rec[2] = best_in;
}

}  // namespace

extern "C" int cluster_intersect_block_rays() { return TILE_R; }

// rayfeat (R, 16) f32; best (R, 8) f32, updated in place; spans (G, K) i32;
// nspan (G,) i32; trifeat (C, 16, 4T) f32; R = G * rays_per_tile and
// rays_per_tile a multiple of 128. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int cluster_intersect_launch(const float* rayfeat, float* best,
                                        const int* spans, const int* nspan,
                                        const float* trifeat, int n_rays,
                                        int rays_per_tile, int n_spans,
                                        int n_clusters, int t_blk,
                                        void* stream) {
  if (n_rays > 0 && n_spans > 0) {
    const size_t smem_bytes =
        static_cast<size_t>(mt::span_floats(t_blk)) * sizeof(float);
    cluster_intersect_kernel<<<n_rays / TILE_R, TILE_R, smem_bytes,
                               static_cast<cudaStream_t>(stream)>>>(
        rayfeat, best, spans, nspan, trifeat, rays_per_tile, n_spans,
        n_clusters, t_blk);
  }
  return static_cast<int>(cudaGetLastError());
}
