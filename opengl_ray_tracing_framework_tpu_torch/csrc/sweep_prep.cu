// Span-list preparation of the span sweep for Hopper (sm_90a): the slab
// test, the coherence key and each tile's span list.
//
// Replaces the rest of opengl_ray_tracing_framework_tpu/ops/sweep.py::
// _swept_impl, the jitted TPU program around the Pallas span sweep
// (_sweep_kernel; csrc/sweep.cu here): its slab test and coherence key
// (:286-291) and its second slab test over the sorted rays with the
// per-tile minimum, the stable argsort, the per-ray cap and the records
// (:299-322). XLA fuses both slab passes into their reductions there, so
// no (rays, clusters) matrix is written; the same holds here. Same
// contract as the plain PyTorch versions in ops/sweep.py (sweep_key_plain,
// sweep_spans_plain), value for value:
//
//   sweep_key: one thread per ray. The cluster boxes pass through shared
//   memory in chunks of CHUNK (24 bytes each, read as two 16-byte
//   broadcasts); each thread keeps the count of clusters its ray enters,
//   the least entry distance and its first index, and writes the key
//   nearest * 128 + kphi * 8 + kct, or DEAD_KEY for a masked ray or one
//   that enters no cluster. The stable sort of the keys stays torch.sort.
//
//   sweep_spans: one CTA per tile of TILE_R rays in kernel order (ray i of
//   the tile is ray perm[i] of the inputs: the sort's gathers happen
//   here). Thread i owns the tile's ray i: it writes the ray's feature row
//   and record, and folds its ray's finite entry distances into the cap.
//   For the tile minimum each thread owns up to PER_THREAD clusters of a
//   chunk and walks the tile's rays, held in shared memory: twice the slab
//   arithmetic, no reduction across threads and no atomics. The tile's C
//   (minimum, index) pairs are 64-bit keys in shared memory (the float's
//   bits above the index: every entry distance is +0.0, positive or INF,
//   so the bits order as the floats do), sorted by a bitonic sort; the
//   index in the low bits makes it the stable sort. C is bounded by that
//   shared memory: MAX_CLUSTERS (ops/sweep.py refuses more).
//
// What bounds it on this card: FP32 operations, a slab test of ~27 per
// (ray, cluster) pair and few bytes (PERF.md; chip_smoke.py phase 3 holds
// both kernels against their plain versions and times them). The eager
// version wrote each 16,384-ray chunk of the (rays, clusters) matrix
// through ~25 elementwise kernels; these write only the results.
//
// Exactness: every step rounds as the eager torch version does on the
// card. No fast math (utils/nvcc.py passes none): 1 / d is IEEE division,
// and the key's products and sums are __fmul_rn / __fadd_rn, which the
// compiler does not contract into an FMA (torch rounds each op). The
// cross product of the ray features is fma(a_i, b_j, -(a_j * b_i)), the
// contraction torch.linalg.cross gets. The argmin keeps the first least
// index (ascending scan, strict <); the slab folds x, y, z from -INF / INF
// and clamps the entry to +0.0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_R = 128;           // rays per tile: ops/sweep.py TILE_R
constexpr int MAX_CLUSTERS = 8192;    // ops/sweep.py MAX_CLUSTERS
constexpr int N_FEAT = 16;            // ray feature row [o, d, o x d, 1, 0]
constexpr int BEST_W = 8;             // record [t, slot, inside, cap, anyhit]
constexpr float INF = 114514.0f;      // ops/intersect.py INF
constexpr long long DEAD_KEY = 1LL << 30;
constexpr int KEY_THREADS = 256;
constexpr int CHUNK = 512;            // cluster boxes staged at a time
constexpr int PER_THREAD = CHUNK / TILE_R;
// 0.5 / pi as the float torch multiplies by (a Python float scalar)
constexpr float PHI_SCALE = static_cast<float>(0.5 / 3.14159265358979323846);

// 1 / d with |d| < 1e-12 replaced by +-1e-12 (the sign of d; +0 for -0.0).
__device__ __forceinline__ float reciprocal(float d) {
  const float s = fabsf(d) < 1e-12f ? (d < 0.0f ? -1e-12f : 1e-12f) : d;
  return __fdiv_rn(1.0f, s);
}

__device__ __forceinline__ void slab_axis(float lo, float hi, float o,
                                          float inv, float& t0, float& t1) {
  const float near = __fmul_rn(__fsub_rn(lo, o), inv);
  const float far = __fmul_rn(__fsub_rn(hi, o), inv);
  t0 = fmaxf(t0, fminf(near, far));
  t1 = fminf(t1, fmaxf(near, far));
}

// Entry distance of a ray (ra = o.xyz, inv.x; rb = inv.yz, ...) into a box
// (ba = min.xyz, max.x; bb = max.yz, ...): max(t0, +0) where the slab test
// passes (t1 >= t0 and t1 > 0), INF where it misses.
__device__ __forceinline__ float entry(const float4& ba, const float4& bb,
                                       const float4& ra, const float4& rb) {
  float t0 = -INF, t1 = INF;
  slab_axis(ba.x, ba.w, ra.x, ra.w, t0, t1);
  slab_axis(ba.y, bb.x, ra.y, rb.x, t0, t1);
  slab_axis(ba.z, bb.y, ra.z, rb.y, t0, t1);
  return (t1 >= t0 && t1 > 0.0f) ? (t0 > 0.0f ? t0 : 0.0f) : INF;
}

// Clusters [lo, lo + n) of cl_min / cl_max (C, 3) into box_a / box_b.
__device__ __forceinline__ void stage_boxes(const float* __restrict__ cl_min,
                                            const float* __restrict__ cl_max,
                                            int lo, int n, float4* box_a,
                                            float4* box_b) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float* mn = cl_min + 3LL * (lo + k);
    const float* mx = cl_max + 3LL * (lo + k);
    box_a[k] = make_float4(mn[0], mn[1], mn[2], mx[0]);
    box_b[k] = make_float4(mx[1], mx[2], 0.0f, 0.0f);
  }
}

__global__ void __launch_bounds__(KEY_THREADS)
sweep_key_kernel(const float* __restrict__ origin,
                 const float* __restrict__ direction,
                 const bool* __restrict__ mask,
                 const float* __restrict__ cl_min,
                 const float* __restrict__ cl_max, long long* __restrict__ key,
                 int n_rays, int n_clusters) {
  __shared__ float4 box_a[CHUNK], box_b[CHUNK];
  const int i = blockIdx.x * KEY_THREADS + threadIdx.x;
  const bool in = i < n_rays;
  const bool live = in && mask[i];
  float d[3] = {0.0f, 0.0f, 0.0f};
  float4 ra = make_float4(0.0f, 0.0f, 0.0f, 0.0f), rb = ra;
  if (live) {
    const float* o = origin + 3LL * i;
    d[0] = direction[3LL * i];
    d[1] = direction[3LL * i + 1];
    d[2] = direction[3LL * i + 2];
    ra = make_float4(o[0], o[1], o[2], reciprocal(d[0]));
    rb = make_float4(reciprocal(d[1]), reciprocal(d[2]), 0.0f, 0.0f);
  }
  int ncand = 0, nearest = 0;
  float least = INF;
  for (int lo = 0; lo < n_clusters; lo += CHUNK) {
    const int n = min(CHUNK, n_clusters - lo);
    __syncthreads();   // the previous chunk is read
    stage_boxes(cl_min, cl_max, lo, n, box_a, box_b);
    __syncthreads();
    if (live) {
      for (int k = 0; k < n; ++k) {
        const float tn = entry(box_a[k], box_b[k], ra, rb);
        ncand += tn < INF;
        if (tn < least) {   // strict: the first least index, as argmin
          least = tn;
          nearest = lo + k;
        }
      }
    }
  }
  if (!in) return;
  long long out = DEAD_KEY;
  if (live && ncand > 0) {
    const float phi = atan2f(d[2], d[0]);
    long long kphi = static_cast<long long>(__fmul_rn(
        __fadd_rn(__fmul_rn(phi, PHI_SCALE), 0.5f), 16.0f));
    long long kct = static_cast<long long>(__fmul_rn(
        __fadd_rn(__fmul_rn(d[1], 0.5f), 0.5f), 8.0f));
    kphi = kphi < 0 ? 0 : (kphi > 15 ? 15 : kphi);
    kct = kct < 0 ? 0 : (kct > 7 ? 7 : kct);
    out = static_cast<long long>(nearest) * 128 + kphi * 8 + kct;
  }
  key[i] = out;
}

__global__ void __launch_bounds__(TILE_R)
sweep_spans_kernel(const float* __restrict__ origin,
                   const float* __restrict__ direction,
                   const bool* __restrict__ mask,
                   const bool* __restrict__ anyhit,
                   const long long* __restrict__ perm,
                   const float* __restrict__ cl_min,
                   const float* __restrict__ cl_max, int n_clusters,
                   int n_sort, int* __restrict__ nspan,
                   int* __restrict__ spans, float* __restrict__ tile_sorted,
                   float* __restrict__ rayfeat, float* __restrict__ best) {
  extern __shared__ unsigned long long keys[];   // n_sort >= n_clusters
  __shared__ float4 box_a[CHUNK], box_b[CHUNK];
  __shared__ float4 ray_a[TILE_R], ray_b[TILE_R];
  const int t = threadIdx.x;
  const long long row = static_cast<long long>(blockIdx.x) * TILE_R + t;
  const long long src = perm != nullptr ? perm[row] : row;
  const float o[3] = {origin[3 * src], origin[3 * src + 1],
                      origin[3 * src + 2]};
  const float d[3] = {direction[3 * src], direction[3 * src + 1],
                      direction[3 * src + 2]};
  const bool live = mask[src];
  const float4 ra = make_float4(o[0], o[1], o[2], reciprocal(d[0]));
  const float4 rb = make_float4(reciprocal(d[1]), reciprocal(d[2]),
                                live ? 1.0f : 0.0f, 0.0f);
  ray_a[t] = ra;
  ray_b[t] = rb;

  float4* feat = reinterpret_cast<float4*>(rayfeat + row * N_FEAT);
  feat[0] = make_float4(o[0], o[1], o[2], d[0]);
  feat[1] = make_float4(d[1], d[2],
                        __fmaf_rn(o[1], d[2], -__fmul_rn(o[2], d[1])),
                        __fmaf_rn(o[2], d[0], -__fmul_rn(o[0], d[2])));
  feat[2] = make_float4(__fmaf_rn(o[0], d[1], -__fmul_rn(o[1], d[0])), 1.0f,
                        0.0f, 0.0f);
  feat[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  float far = -INF;   // the ray's farthest finite entry distance
  for (int lo = 0; lo < n_clusters; lo += CHUNK) {
    const int n = min(CHUNK, n_clusters - lo);
    __syncthreads();   // the previous chunk is read (the first: the rays)
    stage_boxes(cl_min, cl_max, lo, n, box_a, box_b);
    __syncthreads();
    if (live) {
      for (int k = 0; k < n; ++k) {
        const float tn = entry(box_a[k], box_b[k], ra, rb);
        if (tn < INF) far = fmaxf(far, tn);
      }
    }
    // the tile minimum of clusters t, t + TILE_R, ... of the chunk; the
    // count of them is uniform over the CTA
    const int owned = (n + TILE_R - 1) / TILE_R;
    float4 ba[PER_THREAD], bb[PER_THREAD];
    float least[PER_THREAD];
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q) {
      const int k = t + q * TILE_R;
      ba[q] = k < n ? box_a[k] : box_a[0];
      bb[q] = k < n ? box_b[k] : box_b[0];
      least[q] = INF;
    }
    for (int j = 0; j < TILE_R; ++j) {
      const float4 qa = ray_a[j], qb = ray_b[j];
      if (qb.z == 0.0f) continue;   // a masked ray: INF against every box
#pragma unroll
      for (int q = 0; q < PER_THREAD; ++q)
        if (q < owned) least[q] = fminf(least[q], entry(ba[q], bb[q], qa, qb));
    }
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q) {
      const int k = t + q * TILE_R;
      if (k < n)
        keys[lo + k] =
            (static_cast<unsigned long long>(__float_as_uint(least[q])) << 32)
            | static_cast<unsigned>(lo + k);
    }
  }
  for (int k = n_clusters + t; k < n_sort; k += TILE_R) keys[k] = ~0ULL;

  // bitonic sort of the n_sort keys, ascending
  for (int size = 2; size <= n_sort; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int p = t; p < (n_sort >> 1); p += TILE_R) {
        const int a = 2 * p - (p & (stride - 1));
        const int b = a + stride;
        const unsigned long long ka = keys[a], kb = keys[b];
        if ((ka > kb) == ((a & size) == 0)) {
          keys[a] = kb;
          keys[b] = ka;
        }
      }
    }
  }
  __syncthreads();

  const long long base = static_cast<long long>(blockIdx.x) * n_clusters;
  for (int k = t; k < n_clusters; k += TILE_R) {
    const unsigned long long kv = keys[k];
    const float v = __uint_as_float(static_cast<unsigned>(kv >> 32));
    tile_sorted[base + k] = v;
    spans[base + k] = static_cast<int>(kv & 0xffffffffULL);
    // nspan: the count of entries < INF, which lead the sorted list
    if (v < INF && (k + 1 == n_clusters ||
                    !(__uint_as_float(static_cast<unsigned>(
                          keys[k + 1] >> 32)) < INF)))
      nspan[blockIdx.x] = k + 1;
  }
  if (t == 0 && !(__uint_as_float(static_cast<unsigned>(keys[0] >> 32)) < INF))
    nspan[blockIdx.x] = 0;

  float4* rec = reinterpret_cast<float4*>(best + row * BEST_W);
  rec[0] = make_float4(live ? INF : -INF, -1.0f, 0.0f, nextafterf(far, INF));
  rec[1] = make_float4(anyhit[src] ? 1.0f : 0.0f, 0.0f, 0.0f, 0.0f);
}

bool spans_smem_set = false;   // this library's kernel may take MAX_CLUSTERS

}  // namespace

extern "C" int sweep_prep_tile_rays() { return TILE_R; }

// The most clusters sweep_spans takes (its shared-memory sort).
extern "C" int sweep_prep_max_clusters() { return MAX_CLUSTERS; }

// origin, direction (R, 3) f32; mask (R,) bool; cl_min, cl_max (C, 3) f32
// -> key (R,) int64. Launches on `stream` and returns the CUDA error of the
// launch (0: none).
extern "C" int sweep_key_launch(const float* origin, const float* direction,
                                const bool* mask, const float* cl_min,
                                const float* cl_max, long long* key,
                                int n_rays, int n_clusters, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  sweep_key_kernel<<<(n_rays + KEY_THREADS - 1) / KEY_THREADS, KEY_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      origin, direction, mask, cl_min, cl_max, key, n_rays, n_clusters);
  return static_cast<int>(cudaGetLastError());
}

// origin, direction (R, 3) f32, mask, anyhit (R,) bool, perm (R,) int64 or
// null (kernel order = input order), R = n_tiles * TILE_R; cl_min, cl_max
// (C, 3) f32, 1 <= C <= MAX_CLUSTERS -> nspan (G,) i32, spans (G, C) i32,
// tile_sorted (G, C) f32, rayfeat (R, 16) f32, best (R, 8) f32, the last
// two 16-byte aligned. Launches on `stream` and returns the first CUDA
// error (0: launched).
extern "C" int sweep_spans_launch(const float* origin, const float* direction,
                                  const bool* mask, const bool* anyhit,
                                  const long long* perm, const float* cl_min,
                                  const float* cl_max, int* nspan, int* spans,
                                  float* tile_sorted, float* rayfeat,
                                  float* best, int n_tiles, int n_clusters,
                                  void* stream) {
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  if (n_clusters < 1 || n_clusters > MAX_CLUSTERS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!spans_smem_set) {
    const cudaError_t rc = cudaFuncSetAttribute(
        sweep_spans_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(MAX_CLUSTERS * sizeof(unsigned long long)));
    if (rc != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(rc);
    }
    spans_smem_set = true;
  }
  int n_sort = 1;
  while (n_sort < n_clusters) n_sort <<= 1;
  sweep_spans_kernel<<<n_tiles, TILE_R, n_sort * sizeof(unsigned long long),
                       static_cast<cudaStream_t>(stream)>>>(
      origin, direction, mask, anyhit, perm, cl_min, cl_max, n_clusters,
      n_sort, nspan, spans, tile_sorted, rayfeat, best);
  return static_cast<int>(cudaGetLastError());
}
