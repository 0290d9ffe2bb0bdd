// Per-CTA scheduling cost probe for Hopper (sm_90a).
//
// Replaces the grid-step overhead kernels of exp/grid_overhead.py (its four
// pl.pallas_call sites): out = best + rayfeat[:, :8] per tile of rows, with
// and without every tile also reading its own (C,) span and entry-distance
// rows, the block structure of the span-sweep kernel without its work. The
// TPU file asks what one sequential grid step costs; the question on this
// card is what one CTA costs to schedule and retire, and what the per-tile
// list reads of the sweep add to it.
//
// One CTA per tile of `tile` rows: `tile` stays the rows a CTA holds, so
// the probe goes on measuring what a CTA of a tile-per-CTA kernel (K1, K2)
// costs. Its threads (probes/launch_overhead.py::copy_plan: one per
// 16-byte piece of the tile's best rows, two per row, at most 1,024) take
// pieces k * threads + x. Where a thread has one piece (tiles up to 512
// rows), that is all: one plain load of best and one of rayfeat, the add,
// the store. Where it has more, it takes them BATCH at a time, every load
// of a batch issued before the first add, the loads allocating no L1 line
// and the stores evict-first: at tile 8,192 the 16 CTAs on 16 SMs keep
// BATCH pieces per thread in flight instead of waiting for each in turn.
// A tile's span and entry-distance rows are read first, SPAN_BATCH
// entries of each per thread at once (one round trip for C <= 4 x
// threads), and folded into a guard that valid inputs (cluster ids >= 0,
// distances >= 0) never take, so the reads are real and the output stays
// best + rayfeat[:, :8].
//
// What bounds it: bytes, each row reading 32 B of rayfeat's 64 B row and
// 32 B of best and writing 32 B (a span row adds 8 B per cluster). Two
// costs sit outside that bound on the card, measured by chip_smoke.py
// (PERF.md, NVIDIA H100 80GB HBM3 at 700 W): a read of half a row costs
// the whole row (`whole`, which also loads the unused half of every row,
// takes the same time), and a grid of one CTA per 128 rows costs its
// dispatch (probe_smem.cu's empty kernel on the same grid).

#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int BATCH = 4;        // pieces a thread loads before it adds
constexpr int SPAN_BATCH = 4;   // span entries a thread loads at once

// Streaming access for a thread's batch of loads: the inputs are read
// once, so their loads allocate no L1 line, and the output is stored
// evict-first. With one piece per thread the plain load and store were
// faster (PERF.md).
__device__ __forceinline__ float4 load_once(const float4* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

// Load the 16 bytes at p and discard them; volatile, so the load is issued
// although nothing reads its value.
__device__ __forceinline__ void touch(const float4* p) {
  float4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
}

// out piece = best piece + rayfeat piece, unless the guard (never taken
// for valid span rows) says otherwise.
__device__ __forceinline__ float4 add(float4 a, float4 r, int bits) {
  float4 o = make_float4(a.x + r.x, a.y + r.y, a.z + r.z, a.w + r.w);
  if (bits < 0) o.x = 0.0f;   // never: ids and distances are >= 0
  return o;
}

// A tile's piece i is half i & 1 of row row0 + (i >> 1); rayfeat rows are
// 16 floats, best and out rows 8.
template <int BATCH, bool WHOLE>
__global__ void probe_copy_kernel(const float* __restrict__ rayfeat,
                                  const float* __restrict__ best,
                                  const int* __restrict__ spans,
                                  const float* __restrict__ tnear,
                                  float* __restrict__ out, int n_rows,
                                  int tile, int n_cols) {
  const long long row0 = static_cast<long long>(blockIdx.x) * tile;
  int bits = 0;
  if (n_cols > 0) {   // this tile's span and entry-distance rows
    const int* s = spans + static_cast<size_t>(blockIdx.x) * n_cols;
    const float* t = tnear + static_cast<size_t>(blockIdx.x) * n_cols;
    for (int i0 = threadIdx.x; i0 < n_cols; i0 += SPAN_BATCH * blockDim.x) {
      int id[SPAN_BATCH];
      float dist[SPAN_BATCH];
#pragma unroll
      for (int k = 0; k < SPAN_BATCH; ++k) {
        const int i = i0 + k * blockDim.x;
        id[k] = i < n_cols ? s[i] : 0;
        dist[k] = i < n_cols ? t[i] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < SPAN_BATCH; ++k)
        bits |= id[k] | __float_as_int(dist[k]);
    }
  }
  const float4* rf4 = reinterpret_cast<const float4*>(rayfeat);
  const float4* b4 = reinterpret_cast<const float4*>(best);
  float4* o4 = reinterpret_cast<float4*>(out);
  if (BATCH == 1) {   // one piece per thread: the loop runs once
    for (int i = threadIdx.x; i < 2 * tile; i += blockDim.x) {
      const long long row = row0 + (i >> 1);
      if (row >= n_rows) break;
      const int half = i & 1;
      const float4 a = b4[row * 2 + half];
      const float4 r = rf4[row * 4 + half];
      if (WHOLE) touch(rf4 + row * 4 + 2 + half);
      o4[row * 2 + half] = add(a, r, bits);
    }
    return;
  }
  for (int base = threadIdx.x; base < 2 * tile; base += BATCH * blockDim.x) {
    float4 a[BATCH], r[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = base + k * blockDim.x;
      const long long row = row0 + (i >> 1);
      if (i < 2 * tile && row < n_rows) {
        a[k] = load_once(b4 + row * 2 + (i & 1));
        r[k] = load_once(rf4 + row * 4 + (i & 1));
        if (WHOLE) touch(rf4 + row * 4 + 2 + (i & 1));
      }
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = base + k * blockDim.x;
      const long long row = row0 + (i >> 1);
      if (i < 2 * tile && row < n_rows)
        __stcs(o4 + row * 2 + (i & 1), add(a[k], r[k], bits));
    }
  }
}

}  // namespace

// rayfeat (R, 16) f32; best, out (R, 8) f32; spans (G, C) i32 and tnear
// (G, C) f32 with G = ceil(R / tile), or n_cols = 0 and both null. One CTA
// of `threads` (1..1,024, copy_plan's) per tile; whole != 0 also loads the
// unused half of every rayfeat row. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for a thread count out of
// range).
extern "C" int probe_copy_launch(const float* rayfeat, const float* best,
                                 const int* spans, const float* tnear,
                                 float* out, int n_rows, int tile, int n_cols,
                                 int threads, int whole, void* stream) {
  if (threads < 1 || threads > MAX_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows > 0) {
    const int n_tiles = (n_rows + tile - 1) / tile;
    const bool one = 2 * tile <= threads;   // one piece per thread
    auto kernel = one ? (whole ? probe_copy_kernel<1, true>
                               : probe_copy_kernel<1, false>)
                      : (whole ? probe_copy_kernel<BATCH, true>
                               : probe_copy_kernel<BATCH, false>);
    kernel<<<n_tiles, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        rayfeat, best, spans, tnear, out, n_rows, tile, n_cols);
  }
  return static_cast<int>(cudaGetLastError());
}
