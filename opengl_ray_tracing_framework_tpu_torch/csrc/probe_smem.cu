// Shared-memory capacity probe for Hopper (sm_90a).
//
// Replaces exp/pallas_perf_probe.py::probe_vmem (the largest VMEM scratch
// that allocates: 8-120 MB, write one row, read 8 back). On this card the
// fast memory a block can claim is dynamic shared memory: 48 KB by
// default, more only after cudaFuncSetAttribute(...,
// MaxDynamicSharedMemorySize, bytes), up to the card's opt-in limit (227 KB
// on H100). The probe asks for `bytes`, and one CTA of 128 threads writes
// the LAST 128-float row of the (bytes / 512, 128) scratch (so the whole
// allocation is addressed), thread j writing j + bytes / 1024, and reads
// it back mirrored (thread j reads column 127 - j, another thread's
// write). It is a yes/no probe, one launch per size, and what bounds it
// is that launch, not its 512 bytes: probe_floor_kernel, an empty kernel
// of CTAs of the same 128 threads without shared memory, measures the
// card's launch floor, the least time the same work could take.
//
// The reservation and the launch are separate C functions so the caller
// can tell the expected refusal (cudaErrorInvalidValue from the
// reservation above the limit) from any other failure.

#include <cuda_runtime.h>

namespace {

constexpr int LANES = 128;

__global__ void __launch_bounds__(LANES)
probe_smem_kernel(float* __restrict__ out, int n_rows, float tag) {
  extern __shared__ float scratch[];
  float* row = scratch + static_cast<size_t>(n_rows - 1) * LANES;
  row[threadIdx.x] = static_cast<float>(threadIdx.x) + tag;
  __syncthreads();
  out[threadIdx.x] = row[LANES - 1 - threadIdx.x];
}

__global__ void __launch_bounds__(LANES) probe_floor_kernel() {}

}  // namespace

// The card's opt-in limit of dynamic + static shared memory per block.
extern "C" int probe_smem_optin_limit(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

// Ask for `bytes` of dynamic shared memory. Returns the CUDA error of the
// request (cudaErrorInvalidValue = 1 above the limit) and clears it.
extern "C" int probe_smem_reserve(int bytes) {
  cudaError_t rc = cudaFuncSetAttribute(
      probe_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) cudaGetLastError();
  return static_cast<int>(rc);
}

// out (128,) f32. One CTA with `bytes` of dynamic shared memory (a
// multiple of 512, reserved before). Returns cudaGetLastError().
extern "C" int probe_smem_launch(float* out, int bytes, void* stream) {
  probe_smem_kernel<<<1, LANES, bytes, static_cast<cudaStream_t>(stream)>>>(
      out, bytes / (LANES * 4), static_cast<float>(bytes / 1024));
  return static_cast<int>(cudaGetLastError());
}

// `ctas` CTAs of the empty kernel (128 threads, no shared memory): one is
// the card's launch floor. Returns cudaGetLastError().
extern "C" int probe_floor_launch(int ctas, void* stream) {
  probe_floor_kernel<<<ctas, LANES, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
