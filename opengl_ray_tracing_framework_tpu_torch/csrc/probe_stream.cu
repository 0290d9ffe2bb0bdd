// Span-copy streaming probe for Hopper (sm_90a).
//
// Replaces exp/pallas_perf_probe.py::probe_dynslice_stream (the sum over
// rows of 64 dynamically addressed (128, 128) blocks of a VMEM table, the
// cluster-triangle fetch of a traversal kernel). On this card it is the
// span copy of the cluster kernels (mt_span.cuh::load_span): a CTA of 128
// threads copies each 64 KB block from global into shared memory with
// float4 loads, synchronises, and thread j sums column j of the block top
// to bottom; one CTA per row of `starts`, so one CTA measures the rate a
// single walking tile sees and one CTA per SM the rate the card gives all
// of them. What bounds it: bytes (64 blocks x 64 KB read once per CTA, 512
// B written); per CTA the latency of a synchronous copy-then-read loop,
// which is exactly what the span walk pays today.

#include <cuda_runtime.h>

namespace {

constexpr int LANES = 128;                 // block width = threads per CTA
constexpr int BLOCK_ROWS = 128;            // rows per streamed block
constexpr int BLOCK_FLOATS = BLOCK_ROWS * LANES;

__global__ void __launch_bounds__(LANES)
probe_stream_kernel(const float* __restrict__ table,
                    const int* __restrict__ starts, float* __restrict__ out,
                    int n_blocks) {
  extern __shared__ float4 smem4[];
  const float* tf = reinterpret_cast<const float*>(smem4);
  const int tid = threadIdx.x;
  const int* my_starts = starts + static_cast<size_t>(blockIdx.x) * n_blocks;
  float acc = 0.0f;
  for (int b = 0; b < n_blocks; ++b) {
    const float4* src4 = reinterpret_cast<const float4*>(
        table + static_cast<size_t>(my_starts[b]) * LANES);
    __syncthreads();   // the previous block is no longer read
    for (int i = tid; i < BLOCK_FLOATS / 4; i += LANES) smem4[i] = src4[i];
    __syncthreads();
    for (int r = 0; r < BLOCK_ROWS; ++r) acc += tf[r * LANES + tid];
  }
  out[static_cast<size_t>(blockIdx.x) * LANES + tid] = acc;
}

}  // namespace

// table (n_rows, 128) f32; starts (n_ctas, n_blocks) i32 first rows, each
// in [0, n_rows - 128]; out (n_ctas, 128) f32. Returns the first CUDA
// error (0 = launched).
extern "C" int probe_stream_launch(const float* table, const int* starts,
                                   float* out, int n_ctas, int n_blocks,
                                   void* stream) {
  if (n_ctas <= 0) return 0;
  const int bytes = BLOCK_FLOATS * static_cast<int>(sizeof(float));
  cudaError_t rc = cudaFuncSetAttribute(
      probe_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (rc != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(rc);
  }
  probe_stream_kernel<<<n_ctas, LANES, bytes,
                        static_cast<cudaStream_t>(stream)>>>(table, starts,
                                                              out, n_blocks);
  return static_cast<int>(cudaGetLastError());
}
