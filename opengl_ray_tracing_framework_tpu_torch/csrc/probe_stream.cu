// Block-streaming sum probe for Hopper (sm_90a).
//
// Replaces exp/pallas_perf_probe.py::probe_dynslice_stream (the column sums
// of 64 dynamically addressed (128, 128) blocks of an (8192, 128) VMEM
// table, the cluster-triangle fetch of a traversal kernel):
//   out[g, j] = sum over b, r < 128 of table[starts[g, b] + r, j].
// The TPU runs it as one program on one core. What bounds it on this card
// is bytes: 4 MiB of blocks for the TPU's own row of starts (1.25 us at the
// HBM rate), and for 132 rows of starts 553 MB of re-reads, which come
// from L2 (the table is 4 MiB). A first design, the TPU's loop transcribed
// (one CTA per row of starts copying each block into shared memory, two
// barriers per block), ran the TPU's own row on 1 of 132 SMs at 20 GB/s.
//
// This design spreads every row over the card as a split reduction:
//   * the grid is G x P CTAs of 8 warps: the host (probes/card_perf.py::
//     stream_plan) picks P so that even G = 1 puts two CTAs on every SM,
//     and CTA p of row g sums the rows [p * V / P, (p + 1) * V / P) of the
//     row's V = 128 B virtual rows (block v / 128, row v % 128);
//   * loads go straight from global memory into registers, no shared
//     memory: a warp reads one 512-B table row as 32 float4 loads, each
//     thread has UNROLL independent loads in flight, and a float4
//     accumulator per thread sums columns 4 * lane .. 4 * lane + 3;
//   * the 8 warps' accumulators meet in shared memory, warp 0 sums them in
//     warp order, and the CTA writes a (128,) partial;
//   * a second kernel sums each row's P partials in a fixed order: a warp
//     per float4 column, lane l the partials l, l + 32, ... with all its
//     loads in flight, then a shuffle tree across the lanes. Chosen over
//     the last CTA of a row summing them (an atomic counter behind a
//     __threadfence): that CTA's fence, atomic and 135 KB of reads on one
//     SM cost more at G = 1 than the second launch, and the second kernel
//     needs no counters kept at zero between launches. The fixed order
//     keeps the result independent of the schedule. It is launched as a
//     programmatic dependent launch, so its launch overlaps the first
//     kernel's run.
// Float sums are taken in another order than the plain version's: equal
// exactly for integer-valued tables, to float32 rounding otherwise.

#include <cuda_runtime.h>

namespace {

constexpr int LANES = 128;          // table width, floats
constexpr int BLOCK_ROWS = 128;     // rows per block of starts
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int UNROLL = 8;           // independent row loads per thread
constexpr int SUM_WARPS = 4;        // warps of a CTA of the second kernel
constexpr int SUM_UNROLL = 16;      // its independent loads per lane

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

__global__ void __launch_bounds__(THREADS)
probe_stream_kernel(const float* __restrict__ table,
                    const int* __restrict__ starts, float* __restrict__ out,
                    int n_blocks) {
  __shared__ float4 red[WARPS][32];
  const int g = blockIdx.y, p = blockIdx.x, parts = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long n_rows = static_cast<long long>(n_blocks) * BLOCK_ROWS;
  const int v0 = static_cast<int>(n_rows * p / parts);
  const int v1 = static_cast<int>(n_rows * (p + 1) / parts);
  const int* my_starts = starts + static_cast<size_t>(g) * n_blocks;
  const float4* table4 = reinterpret_cast<const float4*>(table);

  // the sum kernel may start; it waits for this grid's partials
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int v = v0 + warp; v < v1; v += WARPS * UNROLL) {
    float4 x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int vv = v + u * WARPS;
      x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (vv < v1) {
        const int row = __ldg(my_starts + vv / BLOCK_ROWS) + vv % BLOCK_ROWS;
        x[u] = __ldg(table4 + static_cast<size_t>(row) * (LANES / 4) + lane);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) add4(acc, x[u]);
  }
  red[warp][lane] = acc;
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < WARPS; ++w) add4(acc, red[w][lane]);
  // the partial of CTA p, or the row's sums when it has one CTA
  reinterpret_cast<float4*>(out)[
      (static_cast<size_t>(g) * parts + p) * (LANES / 4) + lane] = acc;
}

// out[g] = the sum of partials[g, 0 .. parts - 1] in a fixed order. Grid
// (LANES / 4 / SUM_WARPS, g) CTAs of SUM_WARPS warps, a warp per float4
// column.
__global__ void __launch_bounds__(SUM_WARPS * 32)
probe_stream_sum_kernel(const float* __restrict__ partials,
                        float* __restrict__ out, int parts) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");   // the partials
  const int lane = threadIdx.x % 32;
  const int k = blockIdx.x * SUM_WARPS + threadIdx.x / 32;   // float4 column
  const float4* part4 = reinterpret_cast<const float4*>(partials) +
                        static_cast<size_t>(blockIdx.y) * parts * (LANES / 4) +
                        k;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int q = lane; q < parts; q += 32 * SUM_UNROLL) {
    float4 x[SUM_UNROLL];
#pragma unroll
    for (int u = 0; u < SUM_UNROLL; ++u) {
      const int qq = q + u * 32;
      x[u] = qq < parts
                 ? __ldcg(part4 + static_cast<size_t>(qq) * (LANES / 4))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < SUM_UNROLL; ++u) add4(acc, x[u]);
  }
#pragma unroll
  for (int d = 16; d > 0; d /= 2) {
    acc.x += __shfl_down_sync(0xffffffffu, acc.x, d);
    acc.y += __shfl_down_sync(0xffffffffu, acc.y, d);
    acc.z += __shfl_down_sync(0xffffffffu, acc.z, d);
    acc.w += __shfl_down_sync(0xffffffffu, acc.w, d);
  }
  if (lane == 0)
    reinterpret_cast<float4*>(out)[
        static_cast<size_t>(blockIdx.y) * (LANES / 4) + k] = acc;
}

}  // namespace

// table (n_rows, 128) f32, 16-byte aligned; starts (g, n_blocks) i32 first
// rows, each in [0, n_rows - 128]; out (g, 128) f32; partials (g, parts,
// 128) f32 scratch (unused when parts is 1). Returns the first CUDA error
// (0 = launched).
extern "C" int probe_stream_launch(const float* table, const int* starts,
                                   float* out, float* partials, int g,
                                   int n_blocks, int parts, void* stream) {
  if (g <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  probe_stream_kernel<<<dim3(parts, g), THREADS, 0, s>>>(
      table, starts, parts == 1 ? out : partials, n_blocks);
  if (parts > 1) {
    // a programmatic dependent launch: the sum kernel's launch overlaps
    // the first kernel, and griddepcontrol.wait holds it until the
    // partials are written
    cudaLaunchAttribute attr = {};
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(LANES / 4 / SUM_WARPS, g);
    cfg.blockDim = dim3(SUM_WARPS * 32);
    cfg.stream = s;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    const cudaError_t rc = cudaLaunchKernelEx(
        &cfg, probe_stream_sum_kernel, static_cast<const float*>(partials),
        out, parts);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return static_cast<int>(cudaGetLastError());
}
