// The span machinery shared by the two cluster kernels, sweep.cu (K1) and
// cluster_intersect.cu (K2), for Hopper (sm_90a): how one span (a ray tile
// against the T triangles of one cluster block) is staged, intersected and
// reduced. One body, so the two kernels cannot drift apart.
//
// A cluster block is the first 41*T floats of trifeat[c]
// (models/clusters.py), a (41, T) matrix: rows 0..9 of the four T-column
// groups [A | TN | U | V] (piece p = 4 * row + group starts at float p*T),
// then row 10 (the parallel threshold E) of group A as piece 40. rayfeat
// rows 10..15 are always 0, so only rows 0..9 enter the contraction: 40
// FP32 FMAs per ray x triangle on the CUDA cores. The contraction never
// goes to TF32 tensor cores: a 10-bit mantissa on t is the precision class
// that shows as self-intersection acne.
//
// What bounds a span on this card is the FP32 instruction rate of one SM: 128
// rays x 256 triangles x 40 FMAs over 128 lanes is 10,240 cycles, ~5.2 us
// at 1.98 GHz, and the test of each pair costs another ~8 instructions;
// the 41 KB block comes from L2 in 1-2 us. A first design (a thread per
// ray, one scalar shared-memory load per FMA, four warps, a synchronous
// copy) took 53.3 us per span of a tile's walk. This design takes 10.7 us
// with one CTA on the tile and 2.8 us with a cluster of 8 (NVIDIA H100
// 80GB HBM3, 700 W; chip_smoke.py's span-latency cases):
//   * a CTA of 8 warps; a warp holds the tile's 128 rays, four to a
//     thread, and takes every eighth quad of triangles: a 4 x 4 register
//     tile of 64 independent FMA chains fed by four 16-byte shared-memory
//     loads per row (every lane reads the same address: a broadcast), so
//     one load feeds 16 FMAs where it fed one;
//   * the test is predicated and outside the contraction: sign flips by
//     bit operations, one branch per ray and quad, the division only under
//     the (rare) hit;
//   * spans arrive through a ring of two shared-memory buffers, each
//     filled by ONE cp.async.bulk of the whole block with completion on an
//     mbarrier, so the copy of the next span runs under the FMAs of this
//     one (the copy engine charges by the request, not by the byte: 41
//     requests of one run each cost more than the span's FMAs);
//   * a thread-block cluster of 1, 2, 4 or 8 CTAs shares a tile: every CTA
//     stages the whole block (it comes from L2) and CTA r tests columns
//     [r * T/size, (r + 1) * T/size); the per-ray results meet through
//     distributed shared memory and one cluster barrier per reduction
//     (at size 8 most of a span's 2.8 us are the barriers and the
//     exchange: the walk of one tile scales 3.8x on 8 SMs).
// A span buffer holds 41 runs of CHUNK_TRIS = 256 floats. A wider block
// (256 < T <= 4,096, the reference's Scene.build(cluster_size=512 / 1024))
// is walked as chunks of at most 256 of the CTA's own columns through the
// same two buffers: each chunk arrives by one tensor-map copy
// (cp.async.bulk.tensor.2d: trifeat seen as C * 64 rows of T floats, a box
// of 41 rows x the chunk's columns), every chunk folds into the rays' keys,
// and the keys are reduced, tested and exchanged once per span as for a
// narrow block. A T that is no multiple of 4 is hand-copied chunk by chunk.
// Numerics are those of the first design bit for bit: each of A, TN, U, V
// is the same chain of ten fmaf over rows 0..9, the same tests, the IEEE
// division tn / a and the 1e-5 pullback. A ray's result of a span is the
// least key (t bits, span position, lane k, inside bit) as one unsigned
// 64-bit integer: t > 0, so its float bits order as integers, and the
// lowest lane (and the earlier span) keeps a tie in whatever order the
// groups of triangles are reduced.

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math_constants.h>
#include <stdint.h>

namespace mt {

namespace cg = cooperative_groups;

constexpr int TILE_R = 128;     // rays per tile; must match ops/sweep.py
constexpr int N_FEAT = 16;      // rayfeat width
constexpr int BEST_W = 8;       // best-record width
constexpr int USED_ROWS = 10;   // rayfeat rows 10..15 are always 0
constexpr int PIECES = 4 * USED_ROWS + 1;   // T-float runs of a cluster block
constexpr int CHUNK_TRIS = 256;             // columns a span buffer holds
constexpr int MAX_BLOCK_TRIS = 4096;        // T of the widest cluster block
constexpr int FEAT_RUNS = 64;               // T-float runs of a block: 16 x 4
constexpr int RAYS_PER_THREAD = 4;          // a warp holds the whole tile
constexpr int TRIS_PER_STEP = 4;            // triangle columns per load
constexpr int TRI_GROUPS = 8;               // warps of a CTA
constexpr int CTA_THREADS = 32 * TRI_GROUPS;
constexpr int STAGES = 2;                   // span buffers of a CTA's ring
constexpr int KEY_TURNS = 3;                // key boxes in rotation
constexpr int MAX_CLUSTER = 8;              // CTAs sharing one tile
constexpr int KEY_LANE_BITS = 12;           // lane k < 4096 in a key
constexpr float INF_T = 114514.0f;
constexpr float T_MIN = 0.0005f;

static_assert(32 * RAYS_PER_THREAD == TILE_R, "a warp holds one tile");
static_assert(MAX_BLOCK_TRIS <= 1 << KEY_LANE_BITS, "a key names every lane");

using Key = unsigned long long;
constexpr Key NO_HIT = ~0ull;

// ---------------------------------------------------------------------------
// How a launch is cut: cluster size, triangle columns per CTA
// ---------------------------------------------------------------------------

struct Cut {
  int cluster;   // CTAs per tile
  int tc;        // triangle columns of each span a CTA tests (multiple of 4)
};

// How a CTA fills its span buffers: one bulk copy of the whole block (T <=
// 256, a multiple of 4), one tensor-map copy per chunk of its own columns
// (T > 256, a multiple of 4), or a hand copy per chunk (T no multiple of 4).
enum Mode { BULK = 0, TENSOR = 1, HAND = 2 };

static Mode staging(int t_blk) {
  return t_blk % 4 ? HAND : t_blk <= CHUNK_TRIS ? BULK : TENSOR;
}

// a span buffer holds 41 runs of up to 256 floats: a whole block of T <=
// 256, or one chunk of a wider block's columns
constexpr size_t RING_BYTES =
    sizeof(float) * STAGES * PIECES * CHUNK_TRIS;
constexpr size_t SMEM_BYTES =
    RING_BYTES + sizeof(Key) * TILE_R * (KEY_TURNS + 2 * MAX_CLUSTER)
    + sizeof(uint64_t) * STAGES;

// Cluster size from the number of tiles alone (a shape): while a launch
// has at most 1, 2 or 4 tiles per SM, 8, 4 or 2 CTAs share each tile, each
// testing T/size columns of every span; beyond that the tiles fill the
// card by themselves. The columns are cut in steps of TRIS_PER_STEP; a T
// that is no multiple of 4 takes one CTA and the element-wise staging into
// a buffer padded to a multiple of 4.
static Cut cut_launch(int n_tiles, int t_blk) {
  static int n_sms = 0;
  if (n_sms == 0) {
    int device = 0;
    if (cudaGetDevice(&device) != cudaSuccess
        || cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount,
                                  device) != cudaSuccess)
      n_sms = 132;
  }
  Cut c;
  if (t_blk % 4) {
    c.cluster = 1;
    c.tc = (t_blk + 3) / 4 * 4;
    return c;
  }
  c.cluster = n_tiles <= n_sms ? 8 : n_tiles <= 2 * n_sms ? 4
              : n_tiles <= 4 * n_sms ? 2 : 1;
  while (c.cluster > 1 && t_blk % (TRIS_PER_STEP * c.cluster)) c.cluster >>= 1;
  c.tc = t_blk / c.cluster;
  return c;
}

// A CTA's share of every span, walked as chunks: columns [col0, col0 + tc)
// of the block, chunk q being [col0 + q * width, col0 + q * width + n_q)
// with n_q = min(width, tc - q * width). A BULK buffer holds the whole block
// (one chunk, runs of T floats); a TENSOR or HAND buffer one chunk (runs of
// `width` floats).
struct Share {
  int col0, tc, width, n_chunks;
};

template <int MODE>
__host__ __device__ __forceinline__ Share share(int t_blk, int tc,
                                                int rank) {
  Share s;
  s.col0 = rank * tc;
  s.tc = tc;
  if (MODE == BULK) {
    s.width = t_blk;
    s.n_chunks = 1;
  } else {
    s.width = tc < CHUNK_TRIS ? tc : CHUNK_TRIS;
    s.n_chunks = (tc + CHUNK_TRIS - 1) / CHUNK_TRIS;
  }
  return s;
}

// cuTensorMapEncodeTiled, from libcuda, which the runtime has loaded
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

static EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* libcuda = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    if (libcuda != nullptr)
      fn = reinterpret_cast<EncodeTiled>(
          dlsym(libcuda, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// The tensor map of trifeat (C, 16, 4T) seen as C * 64 rows of T floats
// (row c * 64 + p is piece p of cluster c), with a box of 41 rows x
// `width` columns: one chunk of one span. T must be a multiple of 4 (the
// row stride a multiple of 16 bytes) and trifeat 16-byte aligned. Encoded
// once per (pointer, C, T, width): a map names only an address and a shape.
static cudaError_t tensor_map(CUtensorMap* map, const float* trifeat,
                              int n_clusters, int t_blk, int width) {
  struct Entry {
    const float* ptr;
    int c, t, w;
    CUtensorMap map;
  };
  constexpr int N_ENTRIES = 8;
  static Entry cache[N_ENTRIES] = {};
  static int next = 0;
  for (const Entry& e : cache)
    if (e.ptr == trifeat && e.c == n_clusters && e.t == t_blk
        && e.w == width) {
      *map = e.map;
      return cudaSuccess;
    }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(t_blk),
                              static_cast<cuuint64_t>(n_clusters) * FEAT_RUNS};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(t_blk)
                                 * sizeof(float)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(width),
                             static_cast<cuuint32_t>(PIECES)};
  const cuuint32_t steps[2] = {1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<float*>(trifeat), dims, strides, box, steps,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  Entry& e = cache[next];
  next = (next + 1) % N_ENTRIES;
  e.ptr = trifeat;
  e.c = n_clusters;
  e.t = t_blk;
  e.w = width;
  e.map = *map;
  return cudaSuccess;
}

// Launch `kernel` on n_tiles * cut.cluster CTAs in clusters of cut.cluster.
// Returns the error of a refused shared-memory request or launch. Internal
// linkage: `granted` belongs to this library's kernels (one per staging
// mode), and a second loaded copy of the library must not share it.
template <typename... Params, typename... Args>
static cudaError_t launch(void (*kernel)(Params...), int n_tiles,
                          const Cut& cut, cudaStream_t stream, Args... args) {
  static const void* granted[3] = {};   // kernels given SMEM_BYTES
  const void* key = reinterpret_cast<const void*>(kernel);
  int i = 0;
  while (i < 3 && granted[i] != nullptr && granted[i] != key) ++i;
  if (i == 3 || granted[i] != key) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(SMEM_BYTES));
    if (err != cudaSuccess) return err;
    if (i < 3) granted[i] = key;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cut.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(n_tiles * cut.cluster);
  config.blockDim = dim3(CTA_THREADS);
  config.dynamicSmemBytes = SMEM_BYTES;
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&config, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Launch the BULK, TENSOR or HAND instance of one kernel, as staging(T)
// picks, for a T-column block. Every instance takes the TENSOR instance's
// tensor map first (zeros for the others), then `args`, then the columns
// of a span each CTA tests.
template <typename... Params, typename... Args>
static cudaError_t launch_staged(void (*bulk)(Params...),
                                 void (*tensor)(Params...),
                                 void (*hand)(Params...), int n_tiles,
                                 int n_clusters, int t_blk,
                                 const float* trifeat, cudaStream_t stream,
                                 Args... args) {
  if (t_blk < 1 || t_blk > MAX_BLOCK_TRIS) return cudaErrorInvalidValue;
  const Cut cut = cut_launch(n_tiles, t_blk);
  const Mode mode = staging(t_blk);
  CUtensorMap map = {};
  if (mode == TENSOR) {
    const cudaError_t err =
        tensor_map(&map, trifeat, n_clusters, t_blk,
                   share<TENSOR>(t_blk, cut.tc, 0).width);
    if (err != cudaSuccess) return err;
  }
  return launch(mode == BULK ? bulk : mode == TENSOR ? tensor : hand,
                n_tiles, cut, stream, map, args..., cut.tc);
}

// ---------------------------------------------------------------------------
// Device side
// ---------------------------------------------------------------------------

// A CTA's dynamic shared memory: the ring of span buffers, three boxes of
// per-ray keys in rotation, two inboxes of the cluster's keys, one
// mbarrier per span buffer.
struct Smem {
  float* ring;     // [STAGES][PIECES * CHUNK_TRIS]
  Key* box;        // [KEY_TURNS][TILE_R]
  Key* inbox;      // [2][MAX_CLUSTER][TILE_R]
  uint64_t* bar;   // [STAGES]
};

__device__ __forceinline__ Smem carve(unsigned char* base) {
  Smem s;
  s.ring = reinterpret_cast<float*>(base);
  s.box = reinterpret_cast<Key*>(base + RING_BYTES);
  s.inbox = s.box + KEY_TURNS * TILE_R;
  s.bar = reinterpret_cast<uint64_t*>(s.inbox + 2 * MAX_CLUSTER * TILE_R);
  return s;
}

__device__ __forceinline__ float* span_buffer(const Smem& sm, int slot) {
  return sm.ring + slot * (PIECES * CHUNK_TRIS);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Set up the CTA's barriers and key boxes; ends in a cluster barrier, so
// that every CTA of the cluster runs, with clean boxes, before any of them
// writes into another's shared memory.
__device__ __forceinline__ void init_smem(const Smem& sm, bool async,
                                          cg::cluster_group& cluster,
                                          int tid) {
  if (async && tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(sm.bar + s, 1);
    mbar_fence_init();
  }
  for (int i = tid; i < KEY_TURNS * TILE_R; i += CTA_THREADS)
    sm.box[i] = NO_HIT;
  cluster.sync();
}

// One thread starts the copy of a whole cluster block (block = trifeat +
// c * 16 * 4T, T a multiple of 4: 41 * T contiguous, 16-byte aligned
// floats) into `buf` as one bulk asynchronous copy; the block has landed
// when `bar` completes its phase. One request: the copy engine charges by
// the request, and 41 requests of one run each cost more than the span's
// FMAs.
__device__ __forceinline__ void stage_bulk(float* buf, uint64_t* bar,
                                           const float* block, int t_blk) {
  const uint32_t bytes = PIECES * t_blk * sizeof(float);
  mbar_expect_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(buf)),
      "l"(block), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One thread starts the copy of chunk q of one span (a BULK chunk is the
// whole block): the chunk has landed when `bar` completes its phase. A
// TENSOR chunk is a 41 x width box of `map` at column col0 + q * width of
// the cluster's first row; its last chunk may run past the CTA's columns
// (or, zero-filled, past T): the surplus columns are never tested.
template <int MODE>
__device__ __forceinline__ void stage_async(float* buf, uint64_t* bar,
                                            const float* trifeat,
                                            const CUtensorMap* map, int cid,
                                            int t_blk, const Share& s, int q) {
  if (MODE == BULK) {
    stage_bulk(buf, bar,
               trifeat + static_cast<size_t>(cid) * N_FEAT * 4 * t_blk,
               t_blk);
  } else {
    mbar_expect_tx(bar, PIECES * s.width * sizeof(float));
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
            smem_addr(buf)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(s.col0 + q * s.width),
        "r"(cid * FEAT_RUNS), "r"(smem_addr(bar))
        : "memory");
  }
}

// The whole CTA copies chunk q of a cluster block whose T is no multiple of
// 4 into a buffer of runs of `width` floats; columns at or past T get E =
// +inf and can never hit. The caller synchronises the CTA before and after.
__device__ __forceinline__ void stage_hand(float* buf, const float* block,
                                           int t_blk, const Share& s, int q,
                                           int tid) {
  const int c0 = s.col0 + q * s.width;
  const int n = min(s.width, s.tc - q * s.width);
  for (int idx = tid; idx < PIECES * n; idx += CTA_THREADS) {
    const int p = idx / n;
    const int k = idx - p * n;
    const int col = c0 + k;
    buf[p * s.width + k] = col < t_blk
                               ? block[p * t_blk + col]
                               : (p == PIECES - 1 ? CUDART_INF_F : 0.0f);
  }
}

// Det-scaled Moller-Trumbore epilogue of one ray x triangle: |A| > E and
// the strict interior test ...
__device__ __forceinline__ bool candidate(float a, float u, float v, float e) {
  // u * s and v * s with s = -1 where a > 0, else +1: the sign of a, turned
  // over, flips theirs (a = +0 fails |A| > E whatever the signs: E >= 0)
  const uint32_t flip = ~__float_as_uint(a) & 0x80000000u;
  const float us = __uint_as_float(__float_as_uint(u) ^ flip);
  const float vs = __uint_as_float(__float_as_uint(v) ^ flip);
  const float abs_a = fabsf(a);
  return abs_a > e && us > 0.0f && vs > 0.0f && us + vs < abs_a;
}

// ... then, for a candidate, t >= T_MIN and the 1e-5 pullback. `low` is the
// key's low word without the inside bit.
__device__ __forceinline__ void record(float a, float tn, uint32_t low,
                                       Key& key) {
  const float t = tn / a;
  if (t >= T_MIN) {
    const float tm = t - 1e-5f;
    const Key cand = (static_cast<Key>(__float_as_uint(tm)) << 32) | low
                     | (a > 0.0f ? 1u : 0u);
    if (cand < key) key = cand;
  }
}

__device__ __forceinline__ void load_cols(const float* p,
                                          float (&c)[TRIS_PER_STEP]) {
  static_assert(TRIS_PER_STEP == 4, "one 16-byte load per step");
  const float4 x = *reinterpret_cast<const float4*>(p);
  c[0] = x.x, c[1] = x.y, c[2] = x.z, c[3] = x.w;
}

// The rays of one thread (features f) against this warp's steps of the
// columns [col0, col0 + tc) of the triangles in tf (41 runs of `stride`
// floats), folded into the rays' keys; column k of tf is lane lane0 + k of
// the cluster block. `span_bits` is the span's position already shifted
// into the key.
__device__ __forceinline__ void intersect_share(
    const float* tf, int stride, int col0, int tc, int lane0,
    uint32_t span_bits, int grp, const float (&f)[RAYS_PER_THREAD][USED_ROWS],
    Key (&key)[RAYS_PER_THREAD]) {
  constexpr int TW = TRIS_PER_STEP;
  for (int k = col0 + TW * grp; k < col0 + tc; k += TW * TRI_GROUPS) {
    float a[RAYS_PER_THREAD][TW], tn[RAYS_PER_THREAD][TW],
        u[RAYS_PER_THREAD][TW], v[RAYS_PER_THREAD][TW];
#pragma unroll
    for (int r = 0; r < RAYS_PER_THREAD; ++r)
#pragma unroll
      for (int c = 0; c < TW; ++c) a[r][c] = tn[r][c] = u[r][c] = v[r][c] = 0.0f;
    const float* col = tf + k;
#pragma unroll
    for (int i = 0; i < USED_ROWS; ++i) {
      float ca[TW], ctn[TW], cu[TW], cv[TW];
      load_cols(col + (4 * i + 0) * stride, ca);
      load_cols(col + (4 * i + 1) * stride, ctn);
      load_cols(col + (4 * i + 2) * stride, cu);
      load_cols(col + (4 * i + 3) * stride, cv);
#pragma unroll
      for (int r = 0; r < RAYS_PER_THREAD; ++r)
#pragma unroll
        for (int c = 0; c < TW; ++c) {
          a[r][c] = fmaf(f[r][i], ca[c], a[r][c]);
          tn[r][c] = fmaf(f[r][i], ctn[c], tn[r][c]);
          u[r][c] = fmaf(f[r][i], cu[c], u[r][c]);
          v[r][c] = fmaf(f[r][i], cv[c], v[r][c]);
        }
    }
    float e[TW];
    load_cols(col + (PIECES - 1) * stride, e);
    const uint32_t low =
        span_bits | (static_cast<uint32_t>(lane0 + k) << 1);
#pragma unroll
    for (int r = 0; r < RAYS_PER_THREAD; ++r) {
      // one branch per ray and step: candidates are rare
      bool cand[TW], any = false;
#pragma unroll
      for (int c = 0; c < TW; ++c) {
        cand[c] = candidate(a[r][c], u[r][c], v[r][c], e[c]);
        any |= cand[c];
      }
      if (any) {
#pragma unroll
        for (int c = 0; c < TW; ++c)
          if (cand[c]) record(a[r][c], tn[r][c], low + 2 * c, key[r]);
      }
    }
  }
}

// The rays of one thread against chunk q of the CTA's share of a span, the
// chunk in `buf` as share() and stage_async / stage_hand lay it out.
template <int MODE>
__device__ __forceinline__ void intersect_chunk(
    const float* buf, const Share& s, int q, uint32_t span_bits, int grp,
    const float (&f)[RAYS_PER_THREAD][USED_ROWS],
    Key (&key)[RAYS_PER_THREAD]) {
  if (MODE == BULK) {
    intersect_share(buf, s.width, s.col0, s.tc, 0, span_bits, grp, f, key);
  } else {
    const int c0 = q * s.width;
    intersect_share(buf, s.width, 0, min(s.width, s.tc - c0), s.col0 + c0,
                    span_bits, grp, f, key);
  }
}

// Every thread enters with the keys of its four rays (ray lane + 32 r of
// the tile) over its own warp's triangles and leaves with the least key
// over all warps of all CTAs of the cluster, the same in every thread
// that holds the ray; `n` numbers the kernel's reductions from 0.
//   1. A thread that holds a hit lowers the ray's key in the CTA's box of
//      this turn (an atomic minimum in shared memory; hits are rare, most
//      threads send nothing), and a CTA barrier makes the box whole. Three
//      boxes rotate (turn = n mod 3): after the barriers of reduction n
//      the box of turn n + 2 is wiped, which every thread of the CTA read
//      during reduction n - 1 and none lowers before reduction n + 2.
//   2. In a cluster, one thread per ray stores the box's key into its
//      CTA's row of every CTA's inbox (distributed shared memory, plain
//      stores, each row has one writer), one cluster barrier makes the
//      stores visible, and every thread takes the least of the rows. Two
//      inboxes alternate, so a CTA that runs ahead into the next reduction
//      cannot overwrite keys still being read.
// After the barriers no thread of the cluster reads the span buffers of
// this reduction's spans any more.
__device__ __forceinline__ void reduce_keys(Key (&key)[RAYS_PER_THREAD],
                                            const Smem& sm, int n,
                                            cg::cluster_group& cluster,
                                            int tid) {
  const int lane = tid & 31;
  const int size = cluster.num_blocks();
  const int turn = n % KEY_TURNS;
  Key* box = sm.box + turn * TILE_R;
#pragma unroll
  for (int r = 0; r < RAYS_PER_THREAD; ++r)
    if (key[r] != NO_HIT) atomicMin(box + lane + 32 * r, key[r]);
  __syncthreads();
  if (size == 1) {
#pragma unroll
    for (int r = 0; r < RAYS_PER_THREAD; ++r) key[r] = box[lane + 32 * r];
  } else {
    Key* inbox = sm.inbox + (n & 1) * MAX_CLUSTER * TILE_R;
    if (tid < TILE_R) {
      const Key mine = box[tid];
      const int row = cluster.block_rank() * TILE_R + tid;
      for (int d = 0; d < size; ++d)
        cluster.map_shared_rank(inbox, d)[row] = mine;
    }
    cluster.sync();
#pragma unroll
    for (int r = 0; r < RAYS_PER_THREAD; ++r) {
      Key m = NO_HIT;
#pragma unroll
      for (int s = 0; s < MAX_CLUSTER; ++s)
        if (s < size) m = min(m, inbox[s * TILE_R + lane + 32 * r]);
      key[r] = m;
    }
  }
  if (tid < TILE_R) sm.box[(n + 2) % KEY_TURNS * TILE_R + tid] = NO_HIT;
}

// Whether a reduced key is a hit strictly closer than a record's t.
__device__ __forceinline__ bool closer(Key key, float best_t) {
  const float t = __uint_as_float(static_cast<uint32_t>(key >> 32));
  return key != NO_HIT && t < INF_T && t < best_t;
}

__device__ __forceinline__ float key_time(Key key) {
  return __uint_as_float(static_cast<uint32_t>(key >> 32));
}

__device__ __forceinline__ int key_lane(Key key) {
  return (static_cast<uint32_t>(key) >> 1) & ((1 << KEY_LANE_BITS) - 1);
}

__device__ __forceinline__ int key_span(Key key) {
  return static_cast<uint32_t>(key) >> (KEY_LANE_BITS + 1);
}

__device__ __forceinline__ float key_inside(Key key) {
  return (key & 1) ? 1.0f : 0.0f;
}

}  // namespace mt
