// Span-sweep closest hit for Hopper (sm_90a).
//
// Replaces opengl_ray_tracing_framework_tpu/ops/sweep.py::_sweep_kernel, the
// TPU Pallas kernel every cast of the forward render goes through. Same
// contract as the plain PyTorch version in ops/sweep.py (sweep_plain):
//
//   for each tile of TILE_R rays, walk the tile's nearest-first span list
//   of clusters; for each span compute [A | TN | U | V] = rayfeat .
//   trifeat[cluster] for all T triangles, run the det-scaled
//   Moller-Trumbore test (|A| > E, strict interior, t >= T_MIN, t - 1e-5
//   pullback), keep each ray's minimum t (the lowest lane wins inside a
//   span, a later span must be strictly closer), and stop when the next
//   span's tile entry distance is >= the tile max of min(best_t, cap) over
//   rays still live. A per-ray any-hit flag (record column 4) retires
//   occluded rays from that max, so one launch serves closest-hit, any-hit
//   and mixed (NEE shadow + bounce) batches.
//
// What bounds it on this card: a launch lasts as long as its longest
// tile's walk, and that walk is a chain of spans, each bounded by one SM's
// FP32 instruction rate (mt_span.cuh: 10,240 cycles of FMAs for 128 rays x 256
// triangles, and the tests). The deep bounces of a render are a handful of
// tiles that overlap ~100-240 clusters each while the rest of the card
// idles. A first design (one CTA of 128 threads per tile, a thread per
// ray, a synchronous copy per span) took 53.3 us per span: 5.11 ms on the
// first bounce's merged cast and 12.07 ms on the 4 tiles of a bounce-4
// cast. What this design does about it (mt_span.cuh has the span body):
//   * the span: 8 warps, a 4 rays x 4 triangles register tile per thread
//     fed by 16-byte shared-memory broadcasts, the test predicated, the
//     division only under a hit: 10.7 us per span on one CTA;
//   * the copy: two span buffers, each filled by one cp.async.bulk on an
//     mbarrier, the next span of the list in flight under this span's
//     FMAs; a prefetched span that the stop test then makes useless costs
//     bandwidth only, and the CTA waits for it before it exits;
//   * the walk: a thread-block cluster of 8, 4 or 2 CTAs per tile while the
//     launch has at most 1, 2 or 4 tiles per SM (the size follows from the
//     tile count alone), each CTA testing T/size triangle columns of every
//     span. The rays' keys meet through distributed shared memory once per
//     span, every CTA folds the same keys into the same records, so the
//     stop test is uniform over the cluster without another exchange, and
//     the walk visits exactly the spans the plain version visits: 2.8 us
//     per span with 8 CTAs, 1.02 ms on the merged cast (1,024 tiles, one
//     CTA each) and 0.69 ms on the bounce-4 cast (NVIDIA H100 80GB HBM3,
//     700 W, chip_smoke.py phase 3).
// The per-span cost beside the FMAs is a CTA barrier, in a cluster the key
// exchange and a cluster barrier, and a warp-wide maximum for the stop
// test: a warp holds the whole tile. Blocks of 256 < T <= 4,096 triangles
// (the reference's larger cluster_size) take the same walk: a CTA's
// columns of a span arrive as chunks of at most 256 by tensor-map copies
// through the same two buffers, every chunk folds into the keys, and the
// keys are reduced and tested once per span (mt_span.cuh).
//
// A record's slot lane holds the hit's slot cid * T + k as an int32 by its
// bits (ops/sweep.py::record_slots), so every slot up to 2^31 - 1 comes
// back exact; a float32's value would name integers exactly only up to
// 2^24 and round an odd slot past it to a neighbouring lane. Before any hit
// the lane holds -1.0f, whose bits are a negative int32. The wrapper refuses
// more than 2^31 - 1 slots, so cid * T + k and every other int product here
// stays below 2^31; offsets into trifeat, spans, tile_sorted, rayfeat and
// best are 64-bit.
//
// Tracing (utils/timing.py): a non-null `walked` makes CTA 0 of each tile's
// cluster add the spans its walk visited, once per tile, with one atomicAdd
// after the walk; null (tracing off) costs one uniform branch.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>

#include "mt_span.cuh"

namespace {

namespace cg = cooperative_groups;

using mt::BEST_W;
using mt::CTA_THREADS;
using mt::INF_T;
using mt::Key;
using mt::N_FEAT;
using mt::RAYS_PER_THREAD;
using mt::STAGES;
using mt::TILE_R;
using mt::USED_ROWS;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ void next_slot(int& slot, uint32_t& parity) {
  if (++slot == STAGES) {
    slot = 0;
    parity ^= 1;
  }
}

// Grid: cluster-size CTAs per tile, in clusters. tc = triangle columns of a
// span per CTA (T / cluster size, or T rounded up to 4 when T is no
// multiple of 4: then the cluster is one CTA and stages by hand). MODE is
// how a CTA fills its span buffers (mt::Mode); `map` is read by TENSOR
// only. The walk is a stream of (span, chunk) items, one chunk per span
// unless the CTA's columns exceed a buffer; the copy of item i + 2 starts
// as soon as item i's buffer is free.
template <int MODE>
__global__ void __launch_bounds__(CTA_THREADS, 1)
sweep_kernel(const __grid_constant__ CUtensorMap map,
             const int* __restrict__ nspan, const int* __restrict__ spans,
             const float* __restrict__ tile_sorted,
             const float* __restrict__ rayfeat, float* __restrict__ best,
             const float* __restrict__ trifeat, int n_clusters, int t_blk,
             unsigned long long* __restrict__ walked, int tc) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr bool ASYNC = MODE != mt::HAND;
  cg::cluster_group cluster = cg::this_cluster();
  const int size = cluster.num_blocks();
  const int rank = cluster.block_rank();
  const int g = blockIdx.x / size;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int grp = tid >> 5;   // the warp: its share of a span's triangles
  const int limit = nspan[g];
  if (limit <= 0) return;   // cluster-uniform: the records stay as given

  const mt::Smem sm = mt::carve(smem_raw);
  const mt::Share sh = mt::share<MODE>(t_blk, tc, rank);
  const int n_chunks = sh.n_chunks;
  const int n_items = limit * n_chunks;
  mt::init_smem(sm, ASYNC, cluster, tid);

  const size_t block = static_cast<size_t>(N_FEAT) * 4 * t_blk;
  const int* span_row = spans + static_cast<size_t>(g) * n_clusters;
  const float* tn_row = tile_sorted + static_cast<size_t>(g) * n_clusters;

  int started = 0;   // items whose copy has been started (uniform)
  if (ASYNC) {
    started = min(STAGES, n_items);
    if (tid == 0)
      for (int s = 0; s < started; ++s)
        mt::stage_async<MODE>(mt::span_buffer(sm, s), sm.bar + s, trifeat,
                              &map, span_row[s / n_chunks], t_blk, sh,
                              s % n_chunks);
  }

  // a thread's rays: lane + 32 r of the tile, the same in every warp
  float f[RAYS_PER_THREAD][USED_ROWS];
  float best_t[RAYS_PER_THREAD], best_in[RAYS_PER_THREAD],
      cap[RAYS_PER_THREAD];
  int best_slot[RAYS_PER_THREAD];
  bool anyflag[RAYS_PER_THREAD];
  const long long ray0 = static_cast<long long>(g) * TILE_R + lane;
#pragma unroll
  for (int r = 0; r < RAYS_PER_THREAD; ++r) {
    const long long ray = ray0 + 32 * r;
#pragma unroll
    for (int i = 0; i < USED_ROWS; ++i) f[r][i] = rayfeat[ray * N_FEAT + i];
    const float* rec = best + ray * BEST_W;
    best_t[r] = rec[0];
    best_slot[r] = __float_as_int(rec[1]);   // an int32 by its bits; < 0: none
    best_in[r] = rec[2];
    cap[r] = rec[3];
    anyflag[r] = rec[4] > 0.5f;
  }

  int j = 0, item = 0, slot = 0;
  uint32_t parity = 0;
  for (;; ++j) {
    const int cid = span_row[j];
    // read ahead of the FMAs what the end of the span needs
    const bool last = j + 1 >= limit;
    const float tn_next = last ? 0.0f : tn_row[j + 1];

    Key key[RAYS_PER_THREAD];
#pragma unroll
    for (int r = 0; r < RAYS_PER_THREAD; ++r) key[r] = mt::NO_HIT;
    for (int q = 0;; ++q) {
      const int ahead = item + STAGES;
      const int cid_ahead =
          (ASYNC && ahead < n_items) ? span_row[ahead / n_chunks] : -1;
      float* buf = mt::span_buffer(sm, slot);
      if (ASYNC) {
        mt::mbar_wait(sm.bar + slot, parity);
      } else {
        mt::stage_hand(buf, trifeat + cid * block, t_blk, sh, q, tid);
        __syncthreads();
      }
      mt::intersect_chunk<MODE>(buf, sh, q, 0u, grp, f, key);
      const bool span_done = q + 1 == n_chunks;
      if (span_done)
        mt::reduce_keys(key, sm, j, cluster, tid);
      else if (ASYNC)
        __syncthreads();   // every warp is done with the chunk
      // the buffer is free: start the copy of the item STAGES ahead
      if (cid_ahead >= 0) {
        if (tid == 0)
          mt::stage_async<MODE>(buf, sm.bar + slot, trifeat, &map, cid_ahead,
                                t_blk, sh, ahead % n_chunks);
        started = ahead + 1;
      }
      if (span_done) break;
      ++item;
      next_slot(slot, parity);
    }

    // stop test: the next span is needed only if its tile entry distance
    // is below some live ray's min(best_t, cap); occluded any-hit rays
    // are no longer live. A warp holds the whole tile.
    float live = -INF_T;
#pragma unroll
    for (int r = 0; r < RAYS_PER_THREAD; ++r) {
      if (mt::closer(key[r], best_t[r])) {
        best_t[r] = mt::key_time(key[r]);
        best_slot[r] = cid * t_blk + mt::key_lane(key[r]);
        best_in[r] = mt::key_inside(key[r]);
      }
      const float live_t =
          (anyflag[r] && best_slot[r] >= 0) ? -INF_T : best_t[r];
      live = fmaxf(live, fminf(live_t, cap[r]));
    }
    const float thresh = warp_max(live);
    if (last || !(tn_next < thresh)) break;   // cluster-uniform
    ++item;
    next_slot(slot, parity);
  }

  // copies still in flight must land before the CTA gives up its memory
  for (int ii = item + 1; ii < started; ++ii) {
    next_slot(slot, parity);
    mt::mbar_wait(sm.bar + slot, parity);
  }

  if (walked != nullptr && rank == 0 && tid == 0)
    atomicAdd(walked, static_cast<unsigned long long>(j + 1));

  if (rank == 0 && grp == 0) {
#pragma unroll
    for (int r = 0; r < RAYS_PER_THREAD; ++r) {
      float* rec = best + (ray0 + 32 * r) * BEST_W;
      rec[0] = best_t[r];
      rec[1] = __int_as_float(best_slot[r]);
      rec[2] = best_in[r];
    }
  }
}

}  // namespace

extern "C" int sweep_tile_rays() { return TILE_R; }

// The widest cluster block (T) the kernel takes.
extern "C" int sweep_max_block_tris() { return mt::MAX_BLOCK_TRIS; }

// CTAs that share one tile in a launch of n_tiles tiles of T-triangle
// cluster blocks.
extern "C" int sweep_cluster_size(int n_tiles, int t_blk) {
  return mt::cut_launch(n_tiles, t_blk).cluster;
}

// nspan (G,) i32; spans, tile_sorted (G, C); rayfeat (G*TILE_R, 16) f32;
// best (G*TILE_R, 8) f32, updated in place; trifeat (C, 16, 4T) f32, T <=
// MAX_BLOCK_TRIS; walked: null, or a uint64 counter that each tile adds
// the spans it walked to. Launches on `stream` and returns the CUDA error of
// the launch (0: none).
extern "C" int sweep_launch(const int* nspan, const int* spans,
                            const float* tile_sorted, const float* rayfeat,
                            float* best, const float* trifeat, int n_tiles,
                            int n_clusters, int t_blk,
                            unsigned long long* walked, void* stream) {
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  return static_cast<int>(mt::launch_staged(
      sweep_kernel<mt::BULK>, sweep_kernel<mt::TENSOR>, sweep_kernel<mt::HAND>,
      n_tiles, n_clusters, t_blk, trifeat, static_cast<cudaStream_t>(stream),
      nspan, spans, tile_sorted, rayfeat, best, trifeat, n_clusters, t_blk,
      walked));
}
