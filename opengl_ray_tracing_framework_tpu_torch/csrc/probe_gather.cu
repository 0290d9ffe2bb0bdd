// Gather throughput probe for Hopper (sm_90a).
//
// Replaces the gather kernels of exp/pallas_gather_probe.py (out =
// table[idx], seven Mosaic lowerings of one function) and of
// exp/pallas_perf_probe.py::probe_axis0_gather (8 dependent lookups
// acc = (int(tab[acc, j]) + 1) % s). The TPU files ask which gather forms
// lower at all and how fast a VMEM table lookup is; on this card every
// thread can load any address, so the question is the rate: from global
// memory (L1/L2/HBM as the table grows) and from a copy staged in shared
// memory first, the choice a traversal kernel has for its node and span
// tables.
//
// One thread per index, grid-stride. The table is (n_table, cols) row
// major and index e looks up column e % cols (cols = 1 is the plain 1-D
// table; cols = 128 is the TPU probe's lane-replicated layout). steps = 0
// is the plain gather out[e] = table[idx[e]]; steps > 0 chains `steps`
// dependent lookups and writes the last index as a float. What bounds it:
// bytes, 4 B of index in, 4 B out and one 32 B sector per random lookup
// that misses; the chained form is bound by the latency of one lookup
// times `steps`.
//
// STAGED copies the whole table into each CTA's dynamic shared memory
// before the lookups. A first design (a float4 loop per CTA, one CTA of 8
// warps per SM) lost 3.7x to the global form on a 16 KB table: with one
// CTA per SM an SM had 8 warps to hide each index load and store, an eighth
// of what the global form's launch gives it. This design stages the table
// by one cp.async.bulk on an mbarrier (the 16-byte multiple; a thread loop
// for the rest), launches as many CTAs as fit per SM with the table's
// shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor), and
// moves four indices per thread as one int4 load and one float4 store
// where the plain gather's n_idx is a multiple of 4.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The table into shared memory: one thread starts one bulk copy of its
// 16-byte-aligned prefix of whole 16-byte units, the CTA copies the rest,
// and every thread waits for the copy's barrier.
__device__ __forceinline__ void stage_table(float* staged, const float* table,
                                            int n, uint64_t* bar) {
  const bool aligned = (reinterpret_cast<uintptr_t>(table) & 15) == 0;
  const int n_bulk = aligned ? n / 4 * 4 : 0;   // floats of the bulk copy
  if (n_bulk > 0 && threadIdx.x == 0) {
    const uint32_t b = smem_addr(bar);
    const uint32_t bytes = static_cast<uint32_t>(n_bulk) * sizeof(float);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
        "r"(bytes)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(staged)),
        "l"(table), "r"(bytes), "r"(b)
        : "memory");
  }
  for (int i = n_bulk + threadIdx.x; i < n; i += THREADS) staged[i] = table[i];
  __syncthreads();   // the barrier is initialised, the rest is written
  if (n_bulk > 0) {
    const uint32_t b = smem_addr(bar);
    uint32_t done;
    do {
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          "selp.u32 %0, 1, 0, p;\n"
          "}\n"
          : "=r"(done)
          : "r"(b)
          : "memory");
    } while (!done);
  }
}

template <bool STAGED>
__global__ void __launch_bounds__(THREADS)
probe_gather_kernel(const float* __restrict__ table,
                    const int* __restrict__ idx, float* __restrict__ out,
                    int n_table, int cols, long long n_idx, int steps,
                    int vec4) {
  extern __shared__ float4 smem4[];
  __shared__ uint64_t bar;
  const float* tab = table;
  if (STAGED) {
    float* staged = reinterpret_cast<float*>(smem4);
    stage_table(staged, table, n_table * cols, &bar);
    tab = staged;
  }
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long e0 = static_cast<long long>(blockIdx.x) * THREADS +
                       threadIdx.x;
  if (STAGED && vec4) {   // plain 1-D gather, n_idx % 4 == 0
    const int4* idx4 = reinterpret_cast<const int4*>(idx);
    float4* out4 = reinterpret_cast<float4*>(out);
    for (long long e = e0; e < n_idx / 4; e += stride) {
      const int4 a = __ldcs(idx4 + e);
      __stcs(out4 + e, make_float4(tab[a.x], tab[a.y], tab[a.z], tab[a.w]));
    }
    return;
  }
  for (long long e = e0; e < n_idx; e += stride) {
    const int col = static_cast<int>(e % cols);
    int acc = idx[e];
    if (steps == 0) {
      out[e] = tab[static_cast<size_t>(acc) * cols + col];
    } else {
      for (int s = 0; s < steps; ++s)
        acc = (static_cast<int>(tab[static_cast<size_t>(acc) * cols + col]) +
               1) % n_table;
      out[e] = static_cast<float>(acc);
    }
  }
}

}  // namespace

// table (n_table, cols) f32; idx, out (n_idx,) i32 / f32, every index in
// [0, n_table). The global form runs on n_ctas CTAs of 256 threads. staged
// != 0 needs n_table * cols * 4 bytes of shared memory (the caller keeps
// it within the card's opt-in limit) and launches as many CTAs as fit on
// the card with it, at most one per 256 work items (an item is four
// indices where they move as int4). Returns the first CUDA error (0 =
// launched).
extern "C" int probe_gather_launch(const float* table, const int* idx,
                                   float* out, int n_table, int cols,
                                   long long n_idx, int steps, int staged,
                                   int n_ctas, void* stream) {
  if (n_idx <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (staged) {
    const size_t bytes = static_cast<size_t>(n_table) * cols * sizeof(float);
    cudaError_t rc = cudaFuncSetAttribute(
        probe_gather_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    int per_sm = 0, n_sms = 0, device = 0;
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, probe_gather_kernel<true>, THREADS, bytes);
    if (rc == cudaSuccess) rc = cudaGetDevice(&device);
    if (rc == cudaSuccess)
      rc = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount,
                                  device);
    if (rc != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(rc);
    }
    const bool vec4 =
        steps == 0 && cols == 1 && n_idx % 4 == 0 &&
        ((reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(out))
         & 15) == 0;
    const long long items = vec4 ? n_idx / 4 : n_idx;
    const long long fit = static_cast<long long>(per_sm > 0 ? per_sm : 1)
                          * n_sms;
    const long long want = (items + THREADS - 1) / THREADS;
    const int ctas = static_cast<int>(want < fit ? want : fit);
    probe_gather_kernel<true><<<ctas, THREADS, bytes, s>>>(
        table, idx, out, n_table, cols, n_idx, steps, vec4 ? 1 : 0);
  } else {
    probe_gather_kernel<false><<<n_ctas, THREADS, 0, s>>>(
        table, idx, out, n_table, cols, n_idx, steps, 0);
  }
  return static_cast<int>(cudaGetLastError());
}
