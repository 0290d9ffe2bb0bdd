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
// One CTA per tile of `tile` rows; a thread moves one float4 (half a row of
// the 8-float record), and a CTA of at most 1,024 threads loops where the
// tile holds more float4s than that. What bounds it: bytes (each row reads
// 32 B of rayfeat's 64 B row and 32 B of best and writes 32 B; a span row
// adds 8 B per cluster), so at large tiles it runs at the memory rate and
// at small tiles the CTA launch rate shows. The span rows are folded into
// a guard that valid inputs (cluster ids >= 0, distances >= 0) never take,
// so the reads are real and the output stays best + rayfeat[:, :8].

#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 1024;

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
    for (int i = threadIdx.x; i < n_cols; i += blockDim.x)
      bits |= s[i] | __float_as_int(t[i]);
  }
  const float4* rf4 = reinterpret_cast<const float4*>(rayfeat);
  const float4* b4 = reinterpret_cast<const float4*>(best);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (int i = threadIdx.x; i < 2 * tile; i += blockDim.x) {
    const long long row = row0 + (i >> 1);
    if (row >= n_rows) break;
    const int half = i & 1;
    const float4 a = b4[row * 2 + half];
    const float4 r = rf4[row * 4 + half];   // rayfeat rows are 16 floats
    float4 o = make_float4(a.x + r.x, a.y + r.y, a.z + r.z, a.w + r.w);
    if (bits < 0) o.x = 0.0f;   // never: ids and distances are >= 0
    o4[row * 2 + half] = o;
  }
}

}  // namespace

// rayfeat (R, 16) f32; best, out (R, 8) f32; spans (G, C) i32 and tnear
// (G, C) f32 with G = ceil(R / tile), or n_cols = 0 and both null.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int probe_copy_launch(const float* rayfeat, const float* best,
                                 const int* spans, const float* tnear,
                                 float* out, int n_rows, int tile, int n_cols,
                                 void* stream) {
  if (n_rows > 0) {
    const int n_tiles = (n_rows + tile - 1) / tile;
    const int threads = 2 * tile < MAX_THREADS ? 2 * tile : MAX_THREADS;
    probe_copy_kernel<<<n_tiles, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        rayfeat, best, spans, tnear, out, n_rows, tile, n_cols);
  }
  return static_cast<int>(cudaGetLastError());
}
