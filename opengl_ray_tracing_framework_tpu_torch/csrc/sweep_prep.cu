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
// sweep_spans_plain, group_boxes_plain), value for value.
//
// What bounds the kernels on this card: the slab test, ~27 FP32
// operations per (live ray, cluster) pair against few bytes
// (probes.prep_bound). Of its instructions the 6 subtractions and 6
// products issue on the FMA pipe; the 10 min / max and the compares issue
// on the ALU pipe, at half the FMA pipe's rate, so the ALU pipe and the
// issue rate, not the FP32 peak, set how near the bound a kernel gets
// (probes/prep_kernels.py counts each kernel's SASS per pair; PERF.md has
// the times). So the kernels test as few pairs as they can, and spend as
// few instructions on each as that allows: each pair's slab test runs at
// most once in each kernel, boxes come from shared memory as 16-byte
// broadcasts, the INF starting values of the fold are gone, and what a
// warp shares (its tile minimum, an all-masked warp's skip) costs one
// warp-wide instruction, not one per ray. A cast runs sweep_groups once,
// then sweep_key, torch.sort of the keys and sweep_spans, whatever its C.
//
//   sweep_groups: one box per GROUP consecutive clusters (the last group
//   may be partial), the exact elementwise min / max of its members'
//   boxes. Clusters are BVH subtrees in leaf order, so a run of them is a
//   spatial neighbourhood and its box is tight. A ray tests a group's
//   members only if it enters the group box (group_covers has the
//   argument that this skips no member a ray enters). The members of an
//   entered group are read from global memory (the boxes stay in L2).
//
//   sweep_key: two rays per thread (KEY_RAYS), as independent chains,
//   and CTAs of 128 threads (KEY_THREADS). The group boxes pass through
//   shared memory in chunks of CHUNK, as six coordinate arrays read four
//   boxes at a time (six 16-byte broadcasts per four boxes); a warp whose
//   rays are all masked skips them. A warp tests a group's 32 members,
//   staged in its own slab, only if one of its rays enters the group box
//   at an entry below that ray's least so far. Each ray keeps its least
//   entry distance and its first index (groups and members in ascending
//   index order, strict <, as argmin) and writes the int32 key nearest *
//   128 + kphi * 8 + kct, or DEAD_KEY for a masked ray or one that enters
//   no cluster (least < INF says whether it entered one). The stable sort
//   of the keys stays torch.sort. Small casts (a few hundred rays) are
//   latency: CTAs of 128 keep more SMs busy there.
//
//   sweep_spans: one CTA per tile of TILE_R rays in kernel order (ray i
//   of the tile is ray perm[i] of the inputs: the sort's gathers happen
//   here). Thread i owns the tile's ray i. Its culled pass: each warp
//   ballots its live rays' group tests into a flag per group; the members
//   of the groups some warp enters are staged CHUNK at a time and each
//   entering warp tests them (a warp that enters no member's group gives
//   INF without a test). A ray computes its entry distance to each member
//   once: it folds it into the ray's cap and, by one redux.sync minimum
//   over the warp, into the warp's row of minima in shared memory (every
//   lane stores the same word: one store, no branch); the four rows'
//   minimum is the tile minimum. Every entry distance is +0.0, positive
//   or INF, so its bits order as unsigned integers do (cluster_tnear never
//   gives -0.0). A masked ray gives INF; a tile with no live ray writes
//   every entry INF with the clusters in index order and sorts nothing.
//   The finite tile minima are kept in shared memory as 64-bit keys (the
//   float's bits above the index) in cluster order and sorted: a tile
//   overlaps few clusters, so the bitonic sort runs on one warp over at
//   most 64 keys in most tiles, and the index in the low bits makes it
//   the stable sort. The INF clusters follow in index order, each placed
//   by a binary search over the finite indices. The keys hold KEYS_CAP
//   finite minima: a tile with more takes the runs path below, found
//   part-way; so does a tile whose entered groups, counted after each
//   chunk's group tests, hold more than KEYS_CAP members and at least half
//   the clusters (it would fill the keys with little culled, so it goes
//   before its member tests). A tile whose entered groups hold fewer
//   members leaves behind under half the clusters' tests when its keys
//   fill; at C <= KEYS_CAP no tile leaves. The outputs never depend on
//   which path a tile took.
//
//   sweep_spans's runs path: the clusters pass in runs of RUN_CLUSTERS,
//   each chunk of a run tested as the culled pass tests it (a warp tests
//   the members of the group boxes it enters and writes INF for the
//   others); each run's warp rows give its tile minima, whose finite ones
//   are compacted and sorted as above, and the run is written, sorted, to
//   a per-tile row of a (G, C) uint64 scratch in global memory (the run's
//   finite keys, then its INF clusters in index order as keys with INF's
//   bits), at the run's own cluster offset. The ray's cap folds across
//   every run. Then a rank merge: every key is unique (the cluster index
//   is its low word), so a finite key's place in the tile's list is its
//   place in its run plus, for each other run, the count of keys below it
//   (a binary search of that run's row, from L2); an INF cluster's place
//   is nf + the INF clusters before it, which each run's finite count (a
//   binary search for INF's bits) gives. Exact and stable by
//   construction, and one CTA owns a tile, so nothing syncs across CTAs.
//   Runs of 2,048 clusters keep the CTA at 60 KB of shared memory, three
//   CTAs an SM. The wrapper allocates the scratch for every cast, since
//   whether a tile needs it shows only inside the kernel.
//
// Tracing (utils/timing.py): a non-null `live_rays` makes sweep_spans
// count the tile's rays that are masked on and enter at least one cluster
// box (a finite farthest entry: the rays whose key is not DEAD_KEY), by
// one barrier count and one atomicAdd per CTA; null (tracing off) costs
// one uniform branch. A non-null `pairs_tested` makes sweep_key and
// sweep_spans add the (ray, cluster) member slab tests their warps make
// (32 lanes, each with its KEY_RAYS or one ray, times the members of each
// group a warp tests, in either of sweep_spans's paths), one atomicAdd
// per CTA; group tests are not counted. A non-null `runs_tiles` makes
// sweep_spans count the tiles that take the runs path, one atomicAdd by
// each such CTA.
//
// Index arithmetic: offsets into the (G, C) outputs and the runs scratch,
// the rays' rows and the boxes are 64-bit (G x C passes 2^31 at 2,048
// tiles of ~1.05M clusters); a cluster or group index and the key
// nearest * 128 + 127 are int32, which the wrappers keep below 2^30
// (ops/sweep.py::MAX_KEY_CLUSTERS).
//
// Exactness: every step rounds as the eager torch version does on the
// card. No fast math (utils/nvcc.py passes none): 1 / d is IEEE division,
// and the key's products and sums are __fmul_rn / __fadd_rn, which the
// compiler does not contract into an FMA (torch rounds each op). The
// cross product of the ray features is fma(a_i, b_j, -(a_j * b_i)), the
// contraction torch.linalg.cross gets. The argmin keeps the first least
// index (ascending scan, strict <). The slab test folds its three axes
// without the plain version's -INF / INF starting values and tests the
// entry against INF instead (`enters`), which decides every case alike;
// the entry is max(t0, +0.0), never -0.0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KEY_THREADS = 128;      // sweep_key's threads per CTA
constexpr int KEY_RAYS = 2;           // sweep_key's rays per thread
constexpr int TILE_R = 128;           // rays per tile: ops/sweep.py TILE_R
constexpr int WARPS = TILE_R / 32;
constexpr int RUN_CLUSTERS = 2048;    // the runs path's clusters a run
constexpr int N_FEAT = 16;            // ray feature row [o, d, o x d, 1, 0]
constexpr int BEST_W = 8;             // record [t, slot, inside, cap, anyhit]
constexpr float INF = 114514.0f;      // ops/intersect.py INF
constexpr unsigned INF_BITS = 0x47dfa900u;   // the bits of INF
constexpr int DEAD_KEY = 1 << 30;
constexpr int CHUNK = 512;            // cluster boxes staged at a time
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP_SORT = 64;         // most keys a warp sorts alone
constexpr int GROUP = 32;             // clusters a group box covers
constexpr int GROUP_THREADS = 256;    // sweep_groups's threads per CTA
constexpr int KEYS_CAP = 4096;        // finite tile minima sweep_spans's
                                      // culled pass holds
// 0.5 / pi as the float torch multiplies by (a Python float scalar)
constexpr float PHI_SCALE = static_cast<float>(0.5 / 3.14159265358979323846);

struct Box { float lx, ly, lz, hx, hy, hz; };
struct Ray { float ox, oy, oz, ix, iy, iz; };

// N staged boxes: min x, y, z, max x, y, z, each an array of N.
template <int N>
struct BoxArrays { float v[6][N]; };
using Boxes = BoxArrays<CHUNK>;   // a chunk of boxes
using Slab = BoxArrays<GROUP>;    // one group's members
// sweep_spans's dynamic shared memory: a run's keys and warp rows
constexpr int SPANS_SMEM = RUN_CLUSTERS * (8 + 4 * WARPS);
// a power of two, so a run's keys sort in RUN_CLUSTERS slots
static_assert((RUN_CLUSTERS & (RUN_CLUSTERS - 1)) == 0,
              "RUN_CLUSTERS must be a power of two");
// a group is one warp's lanes; a batch of entered groups' members fills a
// chunk; the culled pass's keys, rows, flags and lists (and, after it, the
// finite indices) fit in sweep_spans's dynamic shared memory
static_assert(GROUP == 32 && CHUNK % GROUP == 0 && WARPS == 4,
              "a group is a warp's 32 lanes; a flag word holds 4 warps");
static_assert(KEYS_CAP * 8 + WARPS * CHUNK * 4 + CHUNK * WARPS + CHUNK * 4
                      <= SPANS_SMEM &&
                  KEYS_CAP * (8 + 4) <= SPANS_SMEM &&
                  (KEYS_CAP & (KEYS_CAP - 1)) == 0,
              "sweep_spans's culled pass exceeds its dynamic shared memory");
// the least key of an INF minimum: every finite minimum's key is below it
constexpr unsigned long long INF_KEY =
    static_cast<unsigned long long>(INF_BITS) << 32;

// 1 / d with |d| < 1e-12 replaced by +-1e-12 (the sign of d; +0 for -0.0).
__device__ __forceinline__ float reciprocal(float d) {
  const float s = fabsf(d) < 1e-12f ? (d < 0.0f ? -1e-12f : 1e-12f) : d;
  return __fdiv_rn(1.0f, s);
}

__device__ __forceinline__ Ray make_ray(const float* o, const float* d) {
  return Ray{o[0], o[1], o[2], reciprocal(d[0]), reciprocal(d[1]),
             reciprocal(d[2])};
}

// The ray's entry t0 and exit t1 of the box's three slabs.
__device__ __forceinline__ void slabs(const Box& b, const Ray& r, float& t0,
                                      float& t1) {
  const float nx = __fmul_rn(__fsub_rn(b.lx, r.ox), r.ix);
  const float fx = __fmul_rn(__fsub_rn(b.hx, r.ox), r.ix);
  const float ny = __fmul_rn(__fsub_rn(b.ly, r.oy), r.iy);
  const float fy = __fmul_rn(__fsub_rn(b.hy, r.oy), r.iy);
  const float nz = __fmul_rn(__fsub_rn(b.lz, r.oz), r.iz);
  const float fz = __fmul_rn(__fsub_rn(b.hz, r.oz), r.iz);
  t0 = fmaxf(fmaxf(fminf(nx, fx), fminf(ny, fy)), fminf(nz, fz));
  t1 = fminf(fminf(fmaxf(nx, fx), fmaxf(ny, fy)), fmaxf(nz, fz));
}

// The slab test passes (t1 >= t0 and t1 > 0 after folding from -INF /
// INF): without those starting values, t0 > INF is the one case to add.
__device__ __forceinline__ bool enters(float t0, float t1) {
  return t1 >= t0 && t1 > 0.0f && t0 <= INF;
}

// The bits of max(t0, +0.0): as a signed int, t0 < 0 and -0.0 are < 0.
__device__ __forceinline__ unsigned entry_bits(float t0) {
  return static_cast<unsigned>(max(__float_as_int(t0), 0));
}

// Clusters [lo, lo + n) of cl_min / cl_max (C, 3) into s, coalesced.
__device__ __forceinline__ void stage_boxes(const float* __restrict__ cl_min,
                                            const float* __restrict__ cl_max,
                                            int lo, int n, Boxes& s) {
  for (int j = threadIdx.x; j < 3 * n; j += blockDim.x) {
    const int k = j / 3, ax = j - 3 * k;
    s.v[ax][k] = cl_min[3LL * lo + j];
    s.v[3 + ax][k] = cl_max[3LL * lo + j];
  }
}

// f(k, box) for the staged boxes k in [lo, lo + n), lo a multiple of 4,
// in ascending k, four at a time.
template <int N, class F>
__device__ __forceinline__ void for_boxes(const BoxArrays<N>& s, int lo,
                                          int n, F&& f) {
  int k = lo;
  for (; k + 4 <= lo + n; k += 4) {
    float4 q[6];
#pragma unroll
    for (int a = 0; a < 6; ++a)
      q[a] = *reinterpret_cast<const float4*>(&s.v[a][k]);
    f(k, Box{q[0].x, q[1].x, q[2].x, q[3].x, q[4].x, q[5].x});
    f(k + 1, Box{q[0].y, q[1].y, q[2].y, q[3].y, q[4].y, q[5].y});
    f(k + 2, Box{q[0].z, q[1].z, q[2].z, q[3].z, q[4].z, q[5].z});
    f(k + 3, Box{q[0].w, q[1].w, q[2].w, q[3].w, q[4].w, q[5].w});
  }
  for (; k < lo + n; ++k)
    f(k, Box{s.v[0][k], s.v[1][k], s.v[2][k], s.v[3][k], s.v[4][k],
             s.v[5][k]});
}

// f(k, box) for the n staged boxes in ascending k, four at a time.
template <class F>
__device__ __forceinline__ void for_each_box(const Boxes& s, int n, F&& f) {
  for_boxes(s, 0, n, f);
}

// The thread's KEY_RAYS rays (rays first + q * KEY_THREADS): whether each
// is live (in range and masked on), its reciprocal ray (an idle one when
// not), least = INF and nearest = 0. Returns whether any is live.
__device__ __forceinline__ bool key_rays(const float* __restrict__ origin,
                                         const float* __restrict__ direction,
                                         const bool* __restrict__ mask,
                                         long long first, int n_rays,
                                         Ray* ray, bool* live, float* least,
                                         int* nearest) {
  const float idle[3] = {0.0f, 0.0f, 1.0f};   // a ray whose key is unused
  bool any = false;
#pragma unroll
  for (int q = 0; q < KEY_RAYS; ++q) {
    const long long i = first + q * KEY_THREADS;
    live[q] = i < n_rays && mask[i];
    ray[q] = live[q] ? make_ray(origin + 3 * i, direction + 3 * i)
                     : make_ray(idle, idle);
    least[q] = INF;
    nearest[q] = 0;
    any |= live[q];
  }
  return any;
}

// The key of a ray: nearest * 128 + kphi * 8 + kct, or DEAD_KEY for a
// masked ray or one that enters no cluster (least < INF says whether it
// entered one).
__device__ __forceinline__ int ray_key(const float* d, bool live,
                                       float least, int nearest) {
  if (!live || !(least < INF)) return DEAD_KEY;
  const float phi = atan2f(d[2], d[0]);
  int kphi = static_cast<int>(__fmul_rn(
      __fadd_rn(__fmul_rn(phi, PHI_SCALE), 0.5f), 16.0f));
  int kct = static_cast<int>(__fmul_rn(
      __fadd_rn(__fmul_rn(d[1], 0.5f), 0.5f), 8.0f));
  kphi = kphi < 0 ? 0 : (kphi > 15 ? 15 : kphi);
  kct = kct < 0 ? 0 : (kct > 7 ? 7 : kct);
  return nearest * 128 + kphi * 8 + kct;
}

// One box per GROUP consecutive clusters: g_min / g_max (G, 3) the exact
// elementwise min / max of the members' cl_min / cl_max, a warp a group,
// a lane a member (no rounding: fminf / fmaxf return an operand).
__global__ void __launch_bounds__(GROUP_THREADS)
sweep_groups_kernel(const float* __restrict__ cl_min,
                    const float* __restrict__ cl_max,
                    float* __restrict__ g_min, float* __restrict__ g_max,
                    int n_clusters, int n_groups) {
  const int lane = threadIdx.x & 31;
  const long long g =
      (static_cast<long long>(blockIdx.x) * GROUP_THREADS + threadIdx.x) /
      32;
  if (g >= n_groups) return;   // the whole warp
  const long long k = g * GROUP + lane;
  const bool member = k < n_clusters;
  const float inf = __int_as_float(0x7f800000);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float lo = member ? cl_min[3 * k + a] : inf;
    float hi = member ? cl_max[3 * k + a] : -inf;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(FULL, lo, s));
      hi = fmaxf(hi, __shfl_xor_sync(FULL, hi, s));
    }
    if (lane == 0) {
      g_min[3 * g + a] = lo;
      g_max[3 * g + a] = hi;
    }
  }
}

// Why a group test skips no member a ray enters (group_covers): take a
// member box b inside its group box G (G.l <= b.l, G.h >= b.h on each axis,
// sweep_groups) and any ray. Per axis, with i the ray's reciprocal:
// (l - o) * i rounds monotonically in l (__fsub_rn then __fmul_rn by the
// same i, each correctly rounded, hence non-decreasing in its operand for
// i > 0 and non-increasing for i < 0), and no lane forms 0 x inf: |i| <=
// 1e12 (reciprocal clamps |d| to 1e-12) and the coordinates are finite.
// For i > 0, G's near value is <= b's near and G's far value >= b's far,
// and for i < 0 the two swap, so G's slab entry min(near, far) is <= b's
// and its exit max(near, far) is >= b's; fmaxf / fminf over the axes keep
// that order. So G's t0 <= b's t0 and G's t1 >= b's t1, as values (a -0.0
// and a +0.0 compare equal, and entry_bits maps both to 0). If the ray
// enters b (t1 >= t0, t1 > 0, t0 <= INF) it enters G, and G's entry bits
// are <= b's (max(t0, +0.0) is monotone, and non-negative floats order as
// their bits do). tests/test_torch_prep.py holds this on the CPU.
__device__ __forceinline__ bool group_covers(const Box& g, const Ray& r,
                                             unsigned below) {
  float t0, t1;
  slabs(g, r, t0, t1);
  return enters(t0, t1) && entry_bits(t0) < below;
}

// Members [m0, m0 + n) of cl_min / cl_max into the warp's slab, a lane a
// member (n <= GROUP).
__device__ __forceinline__ void stage_members(
    const float* __restrict__ cl_min, const float* __restrict__ cl_max,
    long long m0, int n, int lane, Slab& s) {
  if (lane >= n) return;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    s.v[a][lane] = cl_min[3 * (m0 + lane) + a];
    s.v[3 + a][lane] = cl_max[3 * (m0 + lane) + a];
  }
}

// Add each warp's `pairs` (the same on every lane) to *counter: one
// barrier, one atomic. Every thread of the CTA calls it.
__device__ __forceinline__ void count_pairs(unsigned long long* counter,
                                            unsigned long long pairs) {
  __shared__ unsigned long long warp_pairs[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_pairs[warp] = pairs;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long n = 0;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w)
      n += warp_pairs[w];
    if (n > 0) atomicAdd(counter, n);
  }
}

// The key of each ray, its slab tests culled by the group boxes g_min /
// g_max.
__global__ void __launch_bounds__(KEY_THREADS)
sweep_key_kernel(const float* __restrict__ origin,
                 const float* __restrict__ direction,
                 const bool* __restrict__ mask,
                 const float* __restrict__ cl_min,
                 const float* __restrict__ cl_max,
                 const float* __restrict__ g_min,
                 const float* __restrict__ g_max, int* __restrict__ key,
                 int n_rays, int n_clusters,
                 unsigned long long* __restrict__ pairs_tested) {
  __shared__ __align__(16) Boxes groups;
  __shared__ __align__(16) Slab slabs_of[KEY_THREADS / 32];
  const int lane = threadIdx.x & 31;
  Slab& slab = slabs_of[threadIdx.x >> 5];
  const int n_groups = (n_clusters + GROUP - 1) / GROUP;
  const long long first =
      static_cast<long long>(blockIdx.x) * KEY_THREADS * KEY_RAYS +
      threadIdx.x;
  Ray ray[KEY_RAYS];
  bool live[KEY_RAYS];
  float least[KEY_RAYS];
  int nearest[KEY_RAYS];
  const bool warp_live = __any_sync(
      FULL, key_rays(origin, direction, mask, first, n_rays, ray, live,
                     least, nearest));
  unsigned long long tested = 0;   // members the warp tested
  for (int lo = 0; lo < n_groups; lo += CHUNK) {
    const int n = min(CHUNK, n_groups - lo);
    __syncthreads();   // the previous chunk is read
    stage_boxes(g_min, g_max, lo, n, groups);
    __syncthreads();
    if (!warp_live) continue;
    for_each_box(groups, n, [&](int k, const Box& g) {
      // a member can lower least only below the group's entry (group_covers)
      bool want = false;
#pragma unroll
      for (int q = 0; q < KEY_RAYS; ++q)
        want |= live[q] &&
                group_covers(g, ray[q], __float_as_uint(least[q]));
      if (!__any_sync(FULL, want)) return;
      const long long m0 = static_cast<long long>(lo + k) * GROUP;
      const int m = static_cast<int>(min(static_cast<long long>(GROUP),
                                         n_clusters - m0));
      __syncwarp();   // the previous group's members are read
      stage_members(cl_min, cl_max, m0, m, lane, slab);
      __syncwarp();
      for_boxes(slab, 0, m, [&](int j, const Box& b) {
#pragma unroll
        for (int q = 0; q < KEY_RAYS; ++q) {
          float t0, t1;
          slabs(b, ray[q], t0, t1);
          const float e = __uint_as_float(entry_bits(t0));
          // strict: the first least index, as argmin. A miss (INF) never
          // lowers least, which starts at INF, so e < least also holds
          // enters()'s test t0 <= INF.
          if (t1 >= t0 && t1 > 0.0f && e < least[q]) {
            least[q] = e;
            nearest[q] = static_cast<int>(m0) + j;
          }
        }
      });
      tested += m;
    });
  }
#pragma unroll
  for (int q = 0; q < KEY_RAYS; ++q) {
    const long long i = first + q * KEY_THREADS;
    if (i < n_rays) key[i] = ray_key(direction + 3 * i, live[q], least[q],
                                     nearest[q]);
  }
  if (pairs_tested != nullptr)
    count_pairs(pairs_tested, tested * 32 * KEY_RAYS);
}

// Add the CTA's count of `flag` to *counter: one barrier count, one atomic.
__device__ __forceinline__ void count_live(unsigned long long* counter,
                                           bool flag) {
  const int n = __syncthreads_count(flag);
  if (threadIdx.x == 0 && n > 0)
    atomicAdd(counter, static_cast<unsigned long long>(n));
}

// Ascending bitonic sort of keys[0, n), n a power of two >= 2, by
// `threads` threads numbered t: the whole CTA (block) or one warp.
__device__ __forceinline__ void bitonic(unsigned long long* keys, int n,
                                        int t, int threads, bool block) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (block) __syncthreads(); else __syncwarp();
      for (int p = t; p < (n >> 1); p += threads) {
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
}

// The count of a[0, n) below x, a ascending (read through L2: the CTA
// wrote the row in this launch).
__device__ __forceinline__ int count_below(const unsigned long long* a,
                                           int n, unsigned long long x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldcg(a + mid) < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// One step of a CTA's stable compaction: the place of this thread's entry
// among the CTA's `fin` entries (nf of them before this step, then in
// thread order), with nf advanced by the step's count. Every thread calls
// it, and writes its entry after it returns.
__device__ __forceinline__ int compact_place(bool fin, int& nf,
                                             int* warp_count) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(FULL, fin);
  if (lane == 0) warp_count[warp] = __popc(ballot);
  __syncthreads();
  int before = nf + __popc(ballot & ((1u << lane) - 1u)), total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int n_w = warp_count[w];
    before += w < warp ? n_w : 0;
    total += n_w;
  }
  nf += total;
  __syncthreads();   // warp_count is read
  return before;
}

// Group gi of g_min / g_max (G, 3), read by every lane of a warp.
__device__ __forceinline__ Box group_box(const float* __restrict__ g_min,
                                         const float* __restrict__ g_max,
                                         int gi) {
  const float* l = g_min + 3LL * gi;
  const float* h = g_max + 3LL * gi;
  return Box{l[0], l[1], l[2], h[0], h[1], h[2]};
}

// sweep_spans's runs path for a tile with a live ray: each run of
// RUN_CLUSTERS, its members tested where the warp enters their group box,
// sorted into the tile's row of the (G, C) scratch `runs`, then the rank
// merge into spans / tile_sorted. Folds each ray's entries into far_bits,
// adds the members each warp tests to `tested` and returns the tile's
// finite minima.
__device__ int sorted_runs(const Ray& ray, bool live, bool warp_live,
                           const float* __restrict__ cl_min,
                           const float* __restrict__ cl_max,
                           const float* __restrict__ g_min,
                           const float* __restrict__ g_max, int c,
                           long long base, int* __restrict__ spans,
                           float* __restrict__ tile_sorted,
                           unsigned long long* runs, unsigned long long* keys,
                           Boxes& boxes, int* warp_count, int& far_bits,
                           unsigned long long& tested) {
  // keys: one run's finite keys (RUN_CLUSTERS); rows: each warp's minima
  // of the run; the first row then holds the run's tile minima (tmin) and
  // in place its clusters whose minimum is INF, in index order
  unsigned* rows = reinterpret_cast<unsigned*>(keys + RUN_CLUSTERS);
  unsigned* tmin = rows;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned* row_w = rows + warp * RUN_CLUSTERS;
  unsigned long long* tile_runs = runs + base;
  for (int first = 0; first < c; first += RUN_CLUSTERS) {
    const int m = min(RUN_CLUSTERS, c - first);
    __syncthreads();   // the previous run's rows and keys are read
    if (!warp_live)
      for (int k = lane; k < m; k += 32) row_w[k] = INF_BITS;
    for (int lo = 0; lo < m; lo += CHUNK) {
      const int n = min(CHUNK, m - lo);
      __syncthreads();   // the previous chunk is read
      stage_boxes(cl_min, cl_max, first + lo, n, boxes);
      __syncthreads();
      if (!warp_live) continue;
      // first + lo is a multiple of GROUP: the chunk holds whole groups
      for (int s = 0; s < n; s += GROUP) {
        const int mg = min(GROUP, n - s);
        const Box g = group_box(g_min, g_max, (first + lo + s) / GROUP);
        if (!__any_sync(FULL, live && group_covers(g, ray, ~0u))) {
          // no live ray of the warp enters a member (group_covers)
          if (lane < mg) row_w[lo + s + lane] = INF_BITS;
          continue;
        }
        for_boxes(boxes, s, mg, [&](int k, const Box& b) {
          float t0, t1;
          slabs(b, ray, t0, t1);
          const unsigned e =
              live && enters(t0, t1) ? entry_bits(t0) : INF_BITS;
          if (e < INF_BITS) far_bits = max(far_bits, static_cast<int>(e));
          row_w[lo + k] = __reduce_min_sync(FULL, e);   // every lane
        });
        tested += mg;
      }
    }
    __syncthreads();
    for (int k = t; k < m; k += TILE_R) {
      unsigned v = rows[k];
#pragma unroll
      for (int w = 1; w < WARPS; ++w)
        v = min(v, rows[w * RUN_CLUSTERS + k]);
      tmin[k] = v;
    }
    __syncthreads();

    // compact the run's finite minima into keys (the float's bits above
    // the cluster's index) and the rest into tmin, both in index order
    int nf = 0;
    for (int lo = 0; lo < m; lo += TILE_R) {
      const int k = lo + t;
      const unsigned v = k < m ? tmin[k] : INF_BITS;
      const bool fin = v < INF_BITS;
      const int before = compact_place(fin, nf, warp_count);
      if (fin)
        keys[before] = (static_cast<unsigned long long>(v) << 32) |
                       static_cast<unsigned>(first + k);
      else if (k < m)
        tmin[k - before] = static_cast<unsigned>(first + k);   // <= k
    }
    int n_sort = 1;
    while (n_sort < nf) n_sort <<= 1;
    for (int j = nf + t; j < n_sort; j += TILE_R) keys[j] = ~0ULL;
    __syncthreads();
    if (n_sort > WARP_SORT) {
      bitonic(keys, n_sort, t, TILE_R, true);
    } else if (n_sort > 1 && warp == 0) {
      bitonic(keys, n_sort, lane, 32, false);
    }
    __syncthreads();
    // the sorted run: its finite keys, then its INF clusters as keys
    for (int p = t; p < m; p += TILE_R)
      tile_runs[first + p] = p < nf ? keys[p] : (INF_KEY | tmin[p - nf]);
  }
  __syncthreads();   // every run is written

  int nf = 0;   // the tile's finite minima: each run's below INF_KEY
  for (int first = 0; first < c; first += RUN_CLUSTERS)
    nf += count_below(tile_runs + first, min(RUN_CLUSTERS, c - first),
                      INF_KEY);
  int nf_before = 0;   // finite minima in the runs before this one
  for (int first = 0; first < c; first += RUN_CLUSTERS) {
    const int m = min(RUN_CLUSTERS, c - first);
    const unsigned long long* own = tile_runs + first;
    const int nf_run = count_below(own, m, INF_KEY);
    for (int p = t; p < m; p += TILE_R) {
      const unsigned long long kv = __ldcg(own + p);
      int at;
      if (p < nf_run) {
        at = p;
        for (int other = 0; other < c; other += RUN_CLUSTERS)
          if (other != first)
            at += count_below(tile_runs + other,
                              min(RUN_CLUSTERS, c - other), kv);
      } else {
        // after every finite minimum, behind the INF clusters before it
        at = nf + (first - nf_before) + (p - nf_run);
      }
      spans[base + at] = static_cast<int>(kv & 0xffffffffULL);
      tile_sorted[base + at] =
          __uint_as_float(static_cast<unsigned>(kv >> 32));
    }
    nf_before += nf_run;
  }
  return nf;
}

// The count of a[0, n) at or below x, a ascending (shared memory).
__device__ __forceinline__ int count_upto(const int* a, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// sweep_spans's culled pass for a tile with a live ray: the tile's finite
// minima as keys (the float's bits above the cluster's index) into
// keys[0, nf), in cluster order, from the members of the groups some warp
// enters. Folds each ray's entries into far_bits and adds the members each
// warp tests to `tested`. Returns nf, or -1 (keys and far_bits then
// undefined) past KEYS_CAP finite minima, or when the entered groups hold
// more than KEYS_CAP members and at least half the clusters.
__device__ int culled_minima(const Ray& ray, bool live, bool warp_live,
                             const float* __restrict__ cl_min,
                             const float* __restrict__ cl_max,
                             const float* __restrict__ g_min,
                             const float* __restrict__ g_max, int c,
                             unsigned long long* keys, Boxes& boxes,
                             int* warp_count, int& far_bits,
                             unsigned long long& tested) {
  // rows: each warp's minima of a batch's members; entered: a byte per
  // (chunk's group, warp), set if a live ray of the warp enters the group
  // box; elist: the chunk's groups some warp enters, in order
  unsigned* rows = reinterpret_cast<unsigned*>(keys + KEYS_CAP);
  unsigned char* entered =
      reinterpret_cast<unsigned char*>(rows + WARPS * CHUNK);
  int* elist = reinterpret_cast<int*>(entered + CHUNK * WARPS);
  __shared__ int n_entered;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned* row_w = rows + warp * CHUNK;
  const int n_groups = (c + GROUP - 1) / GROUP;
  int nf = 0;
  int members = 0;   // members of the entered groups so far
  for (int glo = 0; glo < n_groups; glo += CHUNK) {
    const int gn = min(CHUNK, n_groups - glo);
    __syncthreads();   // the previous chunk's members and lists are read
    stage_boxes(g_min, g_max, glo, gn, boxes);
    __syncthreads();
    if (warp_live) {
      for_each_box(boxes, gn, [&](int k, const Box& g) {
        // a warp none of whose live rays enters g enters none of its
        // members (group_covers)
        entered[k * WARPS + warp] =
            __any_sync(FULL, live && group_covers(g, ray, ~0u));
      });
    } else {
      for (int k = lane; k < gn; k += 32) entered[k * WARPS + warp] = 0;
    }
    __syncthreads();
    if (warp == 0) {
      int ne = 0;
      for (int lo = 0; lo < gn; lo += 32) {
        const int k = lo + lane;
        const bool any =
            k < gn &&
            *reinterpret_cast<const unsigned*>(entered + k * WARPS) != 0u;
        const unsigned ballot = __ballot_sync(FULL, any);
        if (any) elist[ne + __popc(ballot & ((1u << lane) - 1u))] = k;
        ne += __popc(ballot);
      }
      if (lane == 0) n_entered = ne;
    }
    __syncthreads();
    const int ne = n_entered;
    // the entered groups' members (the last group may be partial): the
    // same count on every thread, so every thread leaves together
    members += ne * GROUP;
    if (ne > 0 && glo + elist[ne - 1] == n_groups - 1)
      members -= n_groups * GROUP - c;
    if (members > KEYS_CAP && 2 * members >= c) return -1;
    for (int b0 = 0; b0 < ne; b0 += CHUNK / GROUP) {
      const int nb = min(CHUNK / GROUP, ne - b0);
      __syncthreads();   // the group boxes, the previous batch are read
      // slot s of the batch: the members of group glo + elist[b0 + s]
      for (int j = t; j < nb * GROUP * 3; j += TILE_R) {
        const int s = j / (GROUP * 3), r = j - s * GROUP * 3;
        const long long at =
            3LL * (glo + elist[b0 + s]) * GROUP + r;   // r = 3 member + axis
        if (at < 3LL * c) {
          const int k = GROUP * s + r / 3, ax = r - 3 * (r / 3);
          boxes.v[ax][k] = cl_min[at];
          boxes.v[3 + ax][k] = cl_max[at];
        }
      }
      __syncthreads();
      for (int s = 0; s < nb; ++s) {
        const int k = elist[b0 + s];
        const int m = min(GROUP, c - (glo + k) * GROUP);
        if (warp_live && entered[k * WARPS + warp]) {
          for_boxes(boxes, GROUP * s, m, [&](int j, const Box& b) {
            float t0, t1;
            slabs(b, ray, t0, t1);
            const unsigned e =
                live && enters(t0, t1) ? entry_bits(t0) : INF_BITS;
            if (e < INF_BITS) far_bits = max(far_bits, static_cast<int>(e));
            row_w[j] = __reduce_min_sync(FULL, e);   // every lane, one word
          });
          if (lane >= m) row_w[GROUP * s + lane] = INF_BITS;
          tested += m;
        } else {
          row_w[GROUP * s + lane] = INF_BITS;
        }
      }
      __syncthreads();
      // the batch's tile minima; the finite ones appended to keys
      for (int lo = 0; lo < nb * GROUP; lo += TILE_R) {
        const int j = lo + t;
        unsigned v = INF_BITS;
        if (j < nb * GROUP) {
          v = rows[j];
#pragma unroll
          for (int w = 1; w < WARPS; ++w) v = min(v, rows[w * CHUNK + j]);
        }
        const bool fin = v < INF_BITS;
        const int before = compact_place(fin, nf, warp_count);
        if (fin && before < KEYS_CAP)
          keys[before] =
              (static_cast<unsigned long long>(v) << 32) |
              static_cast<unsigned>((glo + elist[b0 + j / GROUP]) * GROUP +
                                    j % GROUP);
      }
      if (nf > KEYS_CAP) return -1;   // the same nf on every thread
    }
  }
  __syncthreads();   // the last keys are written
  return nf;
}

__global__ void __launch_bounds__(TILE_R)
sweep_spans_kernel(const float* __restrict__ origin,
                   const float* __restrict__ direction,
                   const bool* __restrict__ mask,
                   const bool* __restrict__ anyhit,
                   const long long* __restrict__ perm,
                   const float* __restrict__ cl_min,
                   const float* __restrict__ cl_max,
                   const float* __restrict__ g_min,
                   const float* __restrict__ g_max, int n_clusters,
                   int* __restrict__ nspan, int* __restrict__ spans,
                   float* __restrict__ tile_sorted,
                   float* __restrict__ rayfeat, float* __restrict__ best,
                   unsigned long long* runs,
                   unsigned long long* __restrict__ live_rays,
                   unsigned long long* __restrict__ pairs_tested,
                   unsigned long long* __restrict__ runs_tiles) {
  extern __shared__ __align__(16) unsigned long long keys[];
  __shared__ __align__(16) Boxes boxes;
  __shared__ int warp_count[WARPS];
  const int t = threadIdx.x;
  const int c = n_clusters;
  const long long row = static_cast<long long>(blockIdx.x) * TILE_R + t;
  const long long src = perm != nullptr ? perm[row] : row;
  const float o[3] = {origin[3 * src], origin[3 * src + 1],
                      origin[3 * src + 2]};
  const float d[3] = {direction[3 * src], direction[3 * src + 1],
                      direction[3 * src + 2]};
  const bool live = mask[src];
  const Ray ray = make_ray(o, d);

  float4* feat = reinterpret_cast<float4*>(rayfeat + row * N_FEAT);
  feat[0] = make_float4(o[0], o[1], o[2], d[0]);
  feat[1] = make_float4(d[1], d[2],
                        __fmaf_rn(o[1], d[2], -__fmul_rn(o[2], d[1])),
                        __fmaf_rn(o[2], d[0], -__fmul_rn(o[0], d[2])));
  feat[2] = make_float4(__fmaf_rn(o[0], d[1], -__fmul_rn(o[1], d[0])), 1.0f,
                        0.0f, 0.0f);
  feat[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  const long long base = static_cast<long long>(blockIdx.x) * c;
  int far_bits = -1;   // the ray's farthest finite entry distance; -1: none
  unsigned long long tested = 0;   // members the warp tested
  if (!__syncthreads_or(live)) {
    // no live ray: every tile minimum is INF, in index order
    for (int k = t; k < c; k += TILE_R) {
      spans[base + k] = k;
      tile_sorted[base + k] = INF;
    }
    if (t == 0) nspan[blockIdx.x] = 0;
  } else {
    const bool warp_live = __any_sync(FULL, live);
    int nf = culled_minima(ray, live, warp_live, cl_min, cl_max, g_min,
                           g_max, c, keys, boxes, warp_count, far_bits,
                           tested);
    if (nf >= 0) {
      // fidx: each finite cluster's index less its rank in index order,
      // ascending; the INF cluster at place nf + i is i + (the count of
      // fidx at or below i)
      int* fidx = reinterpret_cast<int*>(keys + KEYS_CAP);
      for (int i = t; i < nf; i += TILE_R)
        fidx[i] = static_cast<int>(keys[i] & 0xffffffffULL) - i;
      int n_sort = 1;
      while (n_sort < nf) n_sort <<= 1;
      for (int j = nf + t; j < n_sort; j += TILE_R) keys[j] = ~0ULL;
      __syncthreads();
      if (n_sort > WARP_SORT) {
        bitonic(keys, n_sort, t, TILE_R, true);
      } else if (n_sort > 1 && (t >> 5) == 0) {
        bitonic(keys, n_sort, t & 31, 32, false);
      }
      __syncthreads();
      for (int k = t; k < c; k += TILE_R) {
        if (k < nf) {
          const unsigned long long kv = keys[k];
          spans[base + k] = static_cast<int>(kv & 0xffffffffULL);
          tile_sorted[base + k] =
              __uint_as_float(static_cast<unsigned>(kv >> 32));
        } else {
          spans[base + k] = k - nf + count_upto(fidx, nf, k - nf);
          tile_sorted[base + k] = INF;
        }
      }
    } else {
      // more than the keys hold: the runs path (the members the culled
      // pass tested fold into far_bits again, alike)
      if (runs_tiles != nullptr && t == 0) atomicAdd(runs_tiles, 1ULL);
      nf = sorted_runs(ray, live, warp_live, cl_min, cl_max, g_min, g_max,
                       c, base, spans, tile_sorted, runs, keys, boxes,
                       warp_count, far_bits, tested);
    }
    if (t == 0) nspan[blockIdx.x] = nf;
  }

  if (live_rays != nullptr) count_live(live_rays, far_bits >= 0);
  if (pairs_tested != nullptr) count_pairs(pairs_tested, tested * 32);
  const float far = far_bits < 0 ? -INF : __int_as_float(far_bits);
  float4* rec = reinterpret_cast<float4*>(best + row * BEST_W);
  // the slot lane: -1.0f, no hit (K1 keeps a slot there by its bits, and
  // -1.0f's bits are a negative int32)
  rec[0] = make_float4(live ? INF : -INF, -1.0f, 0.0f, nextafterf(far, INF));
  rec[1] = make_float4(anyhit[src] ? 1.0f : 0.0f, 0.0f, 0.0f, 0.0f);
}

// sweep_spans's opt-in to its dynamic shared memory, set at its first
// launch
bool smem_set = false;

cudaError_t allow_smem() {
  if (smem_set) return cudaSuccess;
  const cudaError_t rc = cudaFuncSetAttribute(
      sweep_spans_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SPANS_SMEM);
  if (rc != cudaSuccess) {
    cudaGetLastError();
    return rc;
  }
  smem_set = true;
  return cudaSuccess;
}

}  // namespace

extern "C" int sweep_prep_tile_rays() { return TILE_R; }

// The clusters a group box covers.
extern "C" int sweep_prep_group() { return GROUP; }

// cl_min, cl_max (C, 3) f32, C >= 1 -> groups (2, G, 3) f32, G = ceil(C /
// GROUP): each group's min corner, then its max corner. Launches on
// `stream` and returns the CUDA error of the launch (0: none).
extern "C" int sweep_groups_launch(const float* cl_min, const float* cl_max,
                                   float* groups, int n_clusters,
                                   void* stream) {
  if (n_clusters < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n_groups = (n_clusters + GROUP - 1) / GROUP;
  constexpr int per_cta = GROUP_THREADS / 32;
  sweep_groups_kernel<<<(n_groups + per_cta - 1) / per_cta, GROUP_THREADS,
                        0, static_cast<cudaStream_t>(stream)>>>(
      cl_min, cl_max, groups, groups + 3LL * n_groups, n_clusters, n_groups);
  return static_cast<int>(cudaGetLastError());
}

// origin, direction (R, 3) f32; mask (R,) bool; cl_min, cl_max (C, 3) f32,
// C >= 1; groups: sweep_groups's (2, G, 3) boxes of these clusters -> key
// (R,) int32. pairs_tested: null, or a uint64 counter of the member slab
// tests. Launches on `stream` and returns the CUDA error of the launch (0:
// none).
extern "C" int sweep_key_launch(const float* origin, const float* direction,
                                const bool* mask, const float* cl_min,
                                const float* cl_max, const float* groups,
                                int* key, int n_rays, int n_clusters,
                                unsigned long long* pairs_tested,
                                void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  if (n_clusters < 1 || groups == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int per_cta = KEY_THREADS * KEY_RAYS;
  const long long n_groups = (n_clusters + GROUP - 1) / GROUP;
  sweep_key_kernel<<<(n_rays + per_cta - 1) / per_cta, KEY_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      origin, direction, mask, cl_min, cl_max, groups, groups + 3 * n_groups,
      key, n_rays, n_clusters, pairs_tested);
  return static_cast<int>(cudaGetLastError());
}

// origin, direction (R, 3) f32, mask, anyhit (R,) bool, perm (R,) int64 or
// null (kernel order = input order), R = n_tiles * TILE_R; cl_min, cl_max
// (C, 3) f32, C >= 1; groups: sweep_groups's (2, G, 3) boxes of these
// clusters; runs: the (n_tiles, C) uint64 scratch of the runs path ->
// nspan (n_tiles,) i32, spans (n_tiles, C) i32, tile_sorted (n_tiles, C)
// f32, rayfeat (R, 16) f32, best (R, 8) f32, the last two 16-byte
// aligned. live_rays: null, or a uint64 counter of the rays that are
// masked on and enter some cluster; pairs_tested: null, or a uint64
// counter of the member slab tests; runs_tiles: null, or a uint64 counter
// of the tiles that take the runs path. Launches on `stream` and returns
// the first CUDA error (0: launched).
extern "C" int sweep_spans_launch(const float* origin, const float* direction,
                                  const bool* mask, const bool* anyhit,
                                  const long long* perm, const float* cl_min,
                                  const float* cl_max, const float* groups,
                                  int* nspan, int* spans, float* tile_sorted,
                                  float* rayfeat, float* best,
                                  unsigned long long* runs, int n_tiles,
                                  int n_clusters,
                                  unsigned long long* live_rays,
                                  unsigned long long* pairs_tested,
                                  unsigned long long* runs_tiles,
                                  void* stream) {
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  if (n_clusters < 1 || groups == nullptr || runs == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t rc = allow_smem();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long n_groups = (n_clusters + GROUP - 1) / GROUP;
  sweep_spans_kernel<<<n_tiles, TILE_R, SPANS_SMEM,
                       static_cast<cudaStream_t>(stream)>>>(
      origin, direction, mask, anyhit, perm, cl_min, cl_max, groups,
      groups + 3 * n_groups, n_clusters, nspan, spans, tile_sorted, rayfeat,
      best, runs, live_rays, pairs_tested, runs_tiles);
  return static_cast<int>(cudaGetLastError());
}
