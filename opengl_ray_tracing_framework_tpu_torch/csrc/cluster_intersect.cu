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
// once per j while it stays resident in fast memory. Here a block of 128
// rays of one tile belongs to a thread-block cluster of 1-8 CTAs (the size
// follows from the number of ray blocks alone); j is a loop inside each
// CTA, which tests T/size triangle columns of every elected span.
//
// What bounds it on this card: the FP32 instruction rate of the SMs that hold a
// busy tile. Per span and ray block 41*T*4 bytes come from L2 against
// 128*T*40 FP32 FMAs, 31 FMAs per byte, and an 82k-triangle scene's 31.7
// MB trifeat fits the 50 MB L2: the copy is not the bound, its latency was
// (a first design copied and tested a tile's up to 8 spans one after the
// other, a thread per ray, at 40-53 us per span: 0.32-0.36 ms for the mean
// launch of a pass). What the design does about it: the span body of
// mt_span.cuh (8 warps, 4 x 4 register tiles, 16-byte shared-memory
// broadcasts, 10.7 us per span on one CTA); the elected spans stream
// through two buffers filled by cp.async.bulk, the next one in flight
// under the FMAs; and, with no stop test, nothing is exchanged per span:
// each thread keeps its rays' least key (t, j, k) over all spans, and the
// warps and the cluster's CTAs meet once, at the end. The key orders equal
// t by span position j and then lane k, which is the tie rule of the loop
// over j. Blocks of 256 < T <= 4,096 triangles stream as chunks of at most
// 256 of a CTA's columns per span (tensor-map copies, mt_span.cuh); a key
// holds a 12-bit lane and a 19-bit span position. The mean launch of a
// bounce cast's rounds is 0.054 ms, of a whole schedule pass 0.026 ms
// (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py phase 4 and --profile).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>

#include "mt_span.cuh"

namespace {

namespace cg = cooperative_groups;

using mt::BEST_W;
using mt::CTA_THREADS;
using mt::Key;
using mt::N_FEAT;
using mt::RAYS_PER_THREAD;
using mt::STAGES;
using mt::TILE_R;
using mt::USED_ROWS;

// first position >= j of the span list that names a cluster, or limit
__device__ __forceinline__ int next_span(const int* span_row, int j, int limit,
                                         int n_clusters) {
  while (j < limit && (span_row[j] < 0 || span_row[j] >= n_clusters)) ++j;
  return j;
}

// MODE is how a CTA fills its span buffers (mt::Mode); `map` is read by
// TENSOR only. The elected spans are a stream of (span, chunk) items, one
// chunk per span unless the CTA's columns exceed a buffer.
template <int MODE>
__global__ void __launch_bounds__(CTA_THREADS, 1)
cluster_intersect_kernel(const __grid_constant__ CUtensorMap map,
                         const float* __restrict__ rayfeat,
                         float* __restrict__ best,
                         const int* __restrict__ spans,
                         const int* __restrict__ nspan,
                         const float* __restrict__ trifeat,
                         int rays_per_tile, int n_spans, int n_clusters,
                         int t_blk, int tc) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr bool ASYNC = MODE != mt::HAND;
  cg::cluster_group cluster = cg::this_cluster();
  const int size = cluster.num_blocks();
  const int rank = cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int grp = tid >> 5;   // the warp: its share of a span's triangles
  const long long first = static_cast<long long>(blockIdx.x / size) * TILE_R;
  // rays_per_tile is a multiple of TILE_R: the ray block lies in one tile
  const int g = static_cast<int>(first / rays_per_tile);
  const int limit = min(nspan[g], n_spans);
  const int* span_row = spans + static_cast<size_t>(g) * n_spans;
  // cluster-uniform: without a span the records stay as given
  int jc = next_span(span_row, 0, limit, n_clusters);
  if (jc >= limit) return;

  const mt::Smem sm = mt::carve(smem_raw);
  const mt::Share sh = mt::share<MODE>(t_blk, tc, rank);
  const int n_chunks = sh.n_chunks;
  mt::init_smem(sm, ASYNC, cluster, tid);

  const size_t block = static_cast<size_t>(N_FEAT) * 4 * t_blk;
  int jp = jc, qp = 0;   // the next item whose copy has not been started
  if (ASYNC) {
    for (int s = 0; s < STAGES && jp < limit; ++s) {
      if (tid == 0)
        mt::stage_async<MODE>(mt::span_buffer(sm, s), sm.bar + s, trifeat,
                              &map, span_row[jp], t_blk, sh, qp);
      if (++qp == n_chunks) {
        qp = 0;
        jp = next_span(span_row, jp + 1, limit, n_clusters);
      }
    }
  }

  // a thread's rays: lane + 32 r of the block, the same in every warp
  float f[RAYS_PER_THREAD][USED_ROWS];
  const long long ray0 = first + lane;
#pragma unroll
  for (int r = 0; r < RAYS_PER_THREAD; ++r)
#pragma unroll
    for (int i = 0; i < USED_ROWS; ++i)
      f[r][i] = rayfeat[(ray0 + 32 * r) * N_FEAT + i];

  Key key[RAYS_PER_THREAD];
#pragma unroll
  for (int r = 0; r < RAYS_PER_THREAD; ++r) key[r] = mt::NO_HIT;

  int q = 0, slot = 0;
  uint32_t parity = 0;
  for (;;) {
    float* buf = mt::span_buffer(sm, slot);
    if (ASYNC) {
      mt::mbar_wait(sm.bar + slot, parity);
    } else {
      mt::stage_hand(buf, trifeat + span_row[jc] * block, t_blk, sh, q, tid);
      __syncthreads();
    }
    mt::intersect_chunk<MODE>(
        buf, sh, q, static_cast<uint32_t>(jc) << (mt::KEY_LANE_BITS + 1),
        grp, f, key);
    if (++q == n_chunks) {
      q = 0;
      jc = next_span(span_row, jc + 1, limit, n_clusters);
      if (jc >= limit) break;   // the reduction's barrier ends the last item
    }
    __syncthreads();          // the buffer is free
    if (ASYNC && jp < limit) {
      if (tid == 0)
        mt::stage_async<MODE>(buf, sm.bar + slot, trifeat, &map, span_row[jp],
                              t_blk, sh, qp);
      if (++qp == n_chunks) {
        qp = 0;
        jp = next_span(span_row, jp + 1, limit, n_clusters);
      }
    }
    if (++slot == STAGES) {
      slot = 0;
      parity ^= 1;
    }
  }

  mt::reduce_keys(key, sm, 0, cluster, tid);

  if (rank == 0 && grp == 0) {
#pragma unroll
    for (int r = 0; r < RAYS_PER_THREAD; ++r) {
      float* rec = best + (ray0 + 32 * r) * BEST_W;
      if (mt::closer(key[r], rec[0])) {
        rec[0] = mt::key_time(key[r]);
        rec[1] = static_cast<float>(span_row[mt::key_span(key[r])] * t_blk
                                    + mt::key_lane(key[r]));
        rec[2] = mt::key_inside(key[r]);
      }
    }
  }
}

}  // namespace

extern "C" int cluster_intersect_block_rays() { return TILE_R; }

// Span positions a key can name: K beyond it is refused by the wrapper.
extern "C" int cluster_intersect_max_spans() {
  return 1 << (32 - mt::KEY_LANE_BITS - 1);
}

// The widest cluster block (T) the kernel takes.
extern "C" int cluster_intersect_max_block_tris() {
  return mt::MAX_BLOCK_TRIS;
}

// rayfeat (R, 16) f32; best (R, 8) f32, updated in place; spans (G, K) i32;
// nspan (G,) i32; trifeat (C, 16, 4T) f32, T <= MAX_BLOCK_TRIS; R = G *
// rays_per_tile and rays_per_tile a multiple of 128. Launches on `stream`
// and returns the CUDA error of the launch (0: none).
extern "C" int cluster_intersect_launch(const float* rayfeat, float* best,
                                        const int* spans, const int* nspan,
                                        const float* trifeat, int n_rays,
                                        int rays_per_tile, int n_spans,
                                        int n_clusters, int t_blk,
                                        void* stream) {
  if (n_rays <= 0 || n_spans <= 0)
    return static_cast<int>(cudaGetLastError());
  return static_cast<int>(mt::launch_staged(
      cluster_intersect_kernel<mt::BULK>, cluster_intersect_kernel<mt::TENSOR>,
      cluster_intersect_kernel<mt::HAND>, n_rays / TILE_R, n_clusters, t_blk,
      trifeat, static_cast<cudaStream_t>(stream), rayfeat, best, spans, nspan,
      trifeat, rays_per_tile, n_spans, n_clusters, t_blk));
}
