// Gather probes for Hopper (sm_90a): two kernels.
//
// K4b replaces the gather kernels of exp/pallas_gather_probe.py (out =
// table[idx], seven Mosaic lowerings of one function). The TPU file asks
// which gather forms lower at all and how fast a VMEM table lookup is; on
// this card every thread can load any address, so the question is the
// rate: from global memory (L1/L2/HBM as the table grows) and from a copy
// staged in shared memory first, the choice a traversal kernel has for its
// node and span tables. One thread per index, grid-stride. The table is
// (n_table, cols) row major and index e looks up column e % cols (cols = 1
// is the plain 1-D table). What bounds it: bytes, 4 B of index in, 4 B out
// and one 32 B sector per random lookup that misses.
//
// K4b's STAGED form copies the whole table into each CTA's dynamic shared
// memory before the lookups. A first design (a float4 loop per CTA, one CTA
// of 8 warps per SM) lost 3.7x to the global form on a 16 KB table: with
// one CTA per SM an SM had 8 warps to hide each index load and store, an
// eighth of what the global form's launch gives it. This design stages the
// table by one cp.async.bulk on an mbarrier (the 16-byte multiple; a thread
// loop for the rest), launches as many CTAs as fit per SM with the table's
// shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor), and moves
// four indices per thread as one int4 load and one float4 store where
// n_idx is a multiple of 4.
//
// K4c-2 (probe_chain_kernel) replaces exp/pallas_perf_probe.py::
// probe_axis0_gather: on an (S, C) f32 table and (R, C) i32 indices,
//   out[i, j] = acc after `steps` times acc = (int(table[acc, j]) + 1) % S,
// starting from acc = idx[i, j], as float32 (% is a floor modulo, as in
// jnp and torch). Each lookup waits for the one before it. A first design
// (one thread per chain, lookups from global memory) made the 32 lanes of
// a warp read 32 different 512-byte rows of the table, one L2 round trip
// per step. What bounds the function is the bytes of idx, out and the
// table once (1.9 us at S = 4,096); what bounds the chains is the latency
// of each lookup. This design runs every lookup in shared memory:
//   * a CTA owns c columns and a range of idx rows (the host's
//     probes/gather.py::chained_plan picks c and the row split from S, C,
//     the opt-in shared-memory limit and the SM count: c = 8 columns are
//     one 32-byte sector a row, 128 KB at S = 4,096, one CTA per SM);
//   * it stages the column slice table[:, c0:c0 + c] into shared memory by
//     cp.async (16-byte copies where C is a multiple of 4, 4-byte ones
//     otherwise) while its first indices load;
//   * the slice is row major, c floats a row, and lane l of a warp runs a
//     chain of column l % c: with c dividing 32, the random rows that a
//     warp reads for one column fall on 32 / c banks of their own, so a
//     step costs the worst of 32 / c lanes on 32 / c banks (c = 8: 4 on 4)
//     where an unpartitioned layout gives the worst of 32 on 32;
//   * each thread runs CHAINS independent chains side by side, so the
//     latency of one shared-memory lookup hides behind the others.
// Only idx and out touch global memory after the staging. What is left is
// the staging and the index traffic: each SM fetches S 32-byte pieces of
// table rows (the card's CTAs together 8 times the table, each row piece
// for each of the 8 row splits), then reads and writes its indices with
// one CTA of 8 warps to hide the latency. Tensor-map copies of the slice,
// and a cluster multicast of it to the 8 CTAs of a column group, were no
// faster than cp.async: the pieces an SM takes in are the limit, not the
// L2's reads. 0 steps times the staging and the index traffic alone
// (probes/probe_seconds.py).

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
                    int n_table, int cols, long long n_idx, int vec4) {
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
    out[e] = tab[static_cast<size_t>(idx[e]) * cols + col];
  }
}

// ---- K4c-2: chained lookups in a column slice staged in shared memory

constexpr int CHAINS = 8;   // independent chains a thread runs side by side

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src)
               : "memory");
}

// Grid (column groups, row splits). VEC = 4: 16-byte staging copies (C and
// c multiples of 4, table 16-byte aligned); VEC = 1: 4-byte ones.
template <int VEC>
__global__ void __launch_bounds__(THREADS)
probe_chain_kernel(const float* __restrict__ table,
                   const int* __restrict__ idx, float* __restrict__ out, int s, int cols, int rows,
                   int steps, int c) {
  extern __shared__ float4 smem4[];
  float* slice = reinterpret_cast<float*>(smem4);   // (s, c) row major
  const int c0 = blockIdx.x * c;
  const int w = min(c, cols - c0);                   // this group's columns
  const int r0 = static_cast<int>(static_cast<long long>(rows) * blockIdx.y /
                                  gridDim.y);
  const int r1 = static_cast<int>(static_cast<long long>(rows) *
                                  (blockIdx.y + 1) / gridDim.y);
  const int per_row = w / VEC;                       // copies per table row
  for (int i = threadIdx.x; i < s * per_row; i += THREADS) {
    const int r = i / per_row, k = (i - r * per_row) * VEC;
    float* dst = slice + static_cast<size_t>(r) * c + k;
    const float* src = table + static_cast<size_t>(r) * cols + c0 + k;
    if (VEC == 4) cp_async16(dst, src); else cp_async4(dst, src);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // element e of this CTA: idx row r0 + e / w, column c0 + e % w
  const int n = (r1 - r0) * w;
  auto at = [&](int e) {
    const int r = e / w;
    return static_cast<size_t>(r0 + r) * cols + c0 + (e - r * w);
  };
  int acc[CHAINS];
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) {   // the first indices under the copies
    const int e = threadIdx.x + k * THREADS;
    acc[k] = e < n ? __ldcs(idx + at(e)) : 0;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  for (int e0 = threadIdx.x; e0 < n; e0 += THREADS * CHAINS) {
    // CHAINS chains side by side with no test per chain (a test splits
    // them into dependent blocks); a chain past n runs on index 0 unstored
    int col[CHAINS];
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) col[k] = (e0 + k * THREADS) % w;
    for (int step = 0; step < steps; ++step) {
#pragma unroll
      for (int k = 0; k < CHAINS; ++k) {
        const int a =
            (static_cast<int>(slice[acc[k] * c + col[k]]) + 1) % s;
        acc[k] = a < 0 ? a + s : a;   // a floor modulo, as jnp's and torch's
      }
    }
    const int next = e0 + THREADS * CHAINS;
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) {
      const int e = e0 + k * THREADS;
      if (e < n) __stcs(out + at(e), static_cast<float>(acc[k]));
      acc[k] = next + k * THREADS < n ? __ldcs(idx + at(next + k * THREADS))
                                      : 0;
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
                                   long long n_idx, int staged,
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
        cols == 1 && n_idx % 4 == 0 &&
        ((reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(out))
         & 15) == 0;
    const long long items = vec4 ? n_idx / 4 : n_idx;
    const long long fit = static_cast<long long>(per_sm > 0 ? per_sm : 1)
                          * n_sms;
    const long long want = (items + THREADS - 1) / THREADS;
    const int ctas = static_cast<int>(want < fit ? want : fit);
    probe_gather_kernel<true><<<ctas, THREADS, bytes, s>>>(
        table, idx, out, n_table, cols, n_idx, vec4 ? 1 : 0);
  } else {
    probe_gather_kernel<false><<<n_ctas, THREADS, 0, s>>>(
        table, idx, out, n_table, cols, n_idx, 0);
  }
  return static_cast<int>(cudaGetLastError());
}

// table (s, cols) f32; idx, out (rows, cols) i32 / f32, every index in
// [0, s); c columns per CTA (the last group may be narrower) and `splits`
// row ranges: a grid of ceil(cols / c) x splits CTAs, each with s * c * 4
// bytes of dynamic shared memory (the caller keeps it within the card's
// opt-in limit). vec16 != 0 needs cols and c multiples of 4 and a 16-byte
// aligned table. Returns the first CUDA error (0 = launched).
extern "C" int probe_chain_launch(const float* table, const int* idx,
                                  float* out, int s, int cols, int rows,
                                  int steps, int c, int splits, int vec16,
                                  void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const size_t bytes = static_cast<size_t>(s) * c * sizeof(float);
  auto kernel = vec16 ? probe_chain_kernel<4> : probe_chain_kernel<1>;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (rc != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(rc);
  }
  const dim3 grid((cols + c - 1) / c, splits);
  kernel<<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      table, idx, out, s, cols, rows, steps, c);
  return static_cast<int>(cudaGetLastError());
}
