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
// dependent lookups and writes the last index as a float. STAGED copies
// the whole table into dynamic shared memory per CTA (float4) before the
// lookups. What bounds it: bytes, 4 B of index in, 4 B out and one 32 B
// sector per random lookup that misses; the chained form is bound by the
// latency of one lookup times `steps`.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <bool STAGED>
__global__ void __launch_bounds__(THREADS)
probe_gather_kernel(const float* __restrict__ table,
                    const int* __restrict__ idx, float* __restrict__ out,
                    int n_table, int cols, long long n_idx, int steps) {
  extern __shared__ float4 smem4[];
  const float* tab = table;
  if (STAGED) {
    float* staged = reinterpret_cast<float*>(smem4);
    const int n = n_table * cols;
    const int n4 = n / 4;
    const float4* src4 = reinterpret_cast<const float4*>(table);
    for (int i = threadIdx.x; i < n4; i += THREADS) smem4[i] = src4[i];
    for (int i = 4 * n4 + threadIdx.x; i < n; i += THREADS)
      staged[i] = table[i];
    __syncthreads();
    tab = staged;
  }
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long e = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       e < n_idx; e += stride) {
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
// [0, n_table). staged != 0 needs n_table * cols * 4 bytes of shared
// memory (the caller keeps it within the card's opt-in limit). n_ctas
// CTAs of 256 threads. Returns the first CUDA error (0 = launched).
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
    if (rc != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(rc);
    }
    probe_gather_kernel<true><<<n_ctas, THREADS, bytes, s>>>(
        table, idx, out, n_table, cols, n_idx, steps);
  } else {
    probe_gather_kernel<false><<<n_ctas, THREADS, 0, s>>>(
        table, idx, out, n_table, cols, n_idx, steps);
  }
  return static_cast<int>(cudaGetLastError());
}
