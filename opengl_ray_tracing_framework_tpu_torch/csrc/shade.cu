// The forward BSDF bounce's shading for Hopper (sm_90a) in two kernels,
// one thread per live lane:
//
//   shade_bsdf: all of ops/integrator.py::_bounce's rt.shade.bsdf span
//   (ops/shade.py::shade_bsdf_plain): the three uniforms of salts
//   8b+2..8b+4 (sampling.rand01's splitmix32 chain in native uint32), the
//   bounce's Sobol pair with its Cranley-Patterson shifts, disney_sample,
//   alive, the three media (ABSORB, EMISSIVE with its radiance term, SCATTER
//   with its Henyey-Greenstein direction and pdf), the throughput, the next
//   ray and the MIS pdf of its direction (disney_eval's, or the phase
//   function's on a phase-sampled lane).
//
//   shade_nee: the post-cast half of rt.shade.light
//   (ops/shade.py::shade_nee_plain): the shadow test's visibility,
//   disney_eval of the light direction, the power heuristic (or 1 without
//   MIS) and the contribution added to the radiance.
//
// Replaces no TPU kernel: XLA fuses these elementwise chains on the TPU,
// while eager PyTorch launches some 2,300 kernels a bounce for them, each
// on at most 131,072 lanes, so the host's launches bounded the pass.
// What bounds the kernels on this card: bytes. shade_bsdf moves 202 bytes
// a lane (218 on a phase-sampled one) against at most 2,366 FP32
// operations, shade_nee 146 bytes on a visible lane (26 on another)
// against at most 1,011 (ops/shade.py LANE_BYTES; the operations are the
// kernel's FP32 SASS instructions, FFMA as two: with no loop a lane runs
// each at most once): 12 and 7 operations a byte, below the card's 20.
// The design keeps every intermediate in registers, reads each input once
// and, where PyTorch computes every lobe and selects with torch.where,
// computes only the one each lane selects, which gives the same values.
//
// Same values as the plain versions (csrc/disney.cuh says how): this
// source is built with -fmad=false (registered in ops/shade.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "disney.cuh"

// The kernels' argument blocks, which ops/shade.py's ctypes structures
// mirror field for field. They stay outside the unnamed namespace, so the
// launch functions that take them keep external linkage.
//
// The per-lane material fields, each a contiguous (R,) or (R, 3) tensor
struct MatPtrs {
  const float *base_color, *subsurface, *metallic, *specular_tint, *roughness,
      *anisotropic, *sheen, *sheen_tint, *clearcoat, *clearcoat_gloss, *ior,
      *transmission, *medium_color, *medium_density, *medium_anisotropy;
  const int* medium_type;
};

// lobe and uniforms are optional outputs (null: not written) that the
// card tests read.
struct BsdfArgs {
  MatPtrs mat;
  const long long* pid;
  const float* sobol;   // (8,) the frame's Sobol point
  const float *v, *n, *hit_point, *direction, *t, *history, *lo;
  float *lo_out, *new_history, *new_org, *new_dir, *pdf_for_mis;
  bool *alive, *med_sampled;
  signed char* lobe;
  float* uniforms;      // (R, 3)
  unsigned int frame;
  int bounce, n_lanes;
};

struct NeeArgs {
  MatPtrs mat;
  const float *v, *n, *l_dir, *light_pdf, *light_fr, *history, *lo;
  const bool *facing, *shadow_hit;
  float* lo_out;
  int enable_mis, n_lanes;
};

namespace {

using disney::F3;
using disney::Mat;

constexpr int THREADS = 128;
constexpr int MEDIUM_ABSORB = 1;    // models/material.py
constexpr int MEDIUM_SCATTER = 2;
constexpr int MEDIUM_EMISSIVE = 3;
constexpr float EPS_PDF = static_cast<float>(1e-10);

__device__ __forceinline__ F3 load3(const float* p, int i) {
  return F3{p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

__device__ __forceinline__ void store3(float* p, int i, F3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

__device__ __forceinline__ Mat load_mat(const MatPtrs& m, int i) {
  return Mat{load3(m.base_color, i), m.subsurface[i], m.metallic[i],
             m.specular_tint[i], m.roughness[i], m.anisotropic[i],
             m.sheen[i], m.sheen_tint[i], m.clearcoat[i],
             m.clearcoat_gloss[i], m.ior[i], m.transmission[i]};
}

// sampling.py mix32 / rand01, in uint32
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float rand01(uint32_t pid, uint32_t frame,
                                        uint32_t salt) {
  const uint32_t h = mix32(pid + mix32(frame + mix32(salt + 0x9E3779B9u)));
  return __uint2float_rn(h) * static_cast<float>(1.0 / 4294967296.0);
}

__device__ __forceinline__ float cranley_patterson(float u, float shift) {
  const float v = u + shift;
  return v - floorf(v);
}

// torch.minimum: a NaN in either passes through
__device__ __forceinline__ float minimum(float a, float b) {
  return (a != a || a < b) ? a : b;
}

// sampling.py sample_hg / phase_hg
__device__ __forceinline__ F3 sample_hg(F3 v, float g, float r1, float r2) {
  const bool iso = fabsf(g) < static_cast<float>(0.001);
  const float gs = iso ? 0.5f : g;
  const float sqr_term = (1.0f - gs * gs) / ((1.0f + gs) - (2.0f * gs) * r2);
  const float cos_aniso =
      -((1.0f + gs * gs) - sqr_term * sqr_term) / (2.0f * gs);
  const float cos_t = iso ? 1.0f - 2.0f * r2 : cos_aniso;
  const float phi = r1 * disney::TWO_PI;
  const float sin_t = disney::clamp01(disney::safe_sqrt(1.0f - cos_t * cos_t));
  const disney::Frame f = disney::onb(v);
  return ((sin_t * cosf(phi)) * f.t + (sin_t * sinf(phi)) * f.b) + cos_t * v;
}

__device__ __forceinline__ float phase_hg(float cos_theta, float g) {
  const float denom = (1.0f + g * g) + (2.0f * g) * cos_theta;
  return (disney::INV_4_PI * (1.0f - g * g))
         / (denom * disney::safe_sqrt(denom));
}

__device__ __forceinline__ float safe_rcp(float x, float eps) {
  return 1.0f / disney::clamp_min(x, eps);
}

__global__ void __launch_bounds__(THREADS)
shade_bsdf_kernel(const BsdfArgs a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.n_lanes) return;

  // the three uniforms and the bounce's Sobol pair, shifted
  const uint32_t pid = static_cast<uint32_t>(a.pid[i]);
  const uint32_t salt = 8u * static_cast<uint32_t>(a.bounce);
  const float x2 = rand01(pid, a.frame, salt + 2u);
  const float x3 = rand01(pid, a.frame, salt + 3u);
  const float xi3 = rand01(pid, a.frame, salt + 4u);
  if (a.uniforms != nullptr) store3(a.uniforms, i, F3{x2, x3, xi3});
  const float xi1 = cranley_patterson(a.sobol[(2 * a.bounce) % 8], x2);
  const float xi2 = cranley_patterson(a.sobol[(2 * a.bounce + 1) % 8], x3);

  const Mat m = load_mat(a.mat, i);
  const F3 v = load3(a.v, i);
  const F3 n = load3(a.n, i);
  const disney::Sample s = disney::disney_sample(m, v, n, xi1, xi2, xi3);
  if (a.lobe != nullptr) a.lobe[i] = s.lobe;
  const bool alive = s.pdf > EPS_PDF;

  // media on refraction (glsl:1429-1458)
  const bool refract = alive && s.is_refract;
  const int medium = a.mat.medium_type[i];
  const float t = a.t[i];
  const float dens = a.mat.medium_density[i];
  const F3 mc = load3(a.mat.medium_color, i);
  const F3 history = load3(a.history, i);
  F3 lo = load3(a.lo, i);
  if (refract && medium == MEDIUM_EMISSIVE) {
    lo = lo + (mc * (t * dens)) * history;
  }
  const float scatter_dist = minimum(
      -logf(disney::clamp_min(xi3, static_cast<float>(1e-12)))
          * safe_rcp(dens, static_cast<float>(1e-6)),
      t);
  const bool med_sampled =
      refract && medium == MEDIUM_SCATTER && scatter_dist < t;

  // throughput, the next ray and the MIS pdf of its direction
  const F3 hit = load3(a.hit_point, i);
  F3 mult, new_dir, new_org;
  float pdf_for_mis;
  if (med_sampled) {
    const float g = a.mat.medium_anisotropy[i];
    new_dir = sample_hg(v, g, xi1, xi2);
    pdf_for_mis = phase_hg(disney::dot(v, new_dir), g);
    mult = mc * expf(-scatter_dist);
    // glsl:1450 marches straight through the surface to the scatter point
    new_org = hit + load3(a.direction, i) * scatter_dist;
  } else {
    mult = s.f * safe_rcp(s.pdf, EPS_PDF);
    if (refract && medium == MEDIUM_ABSORB) {
      mult = mult * F3{expf((-(1.0f - mc.x) * t) * dens),
                       expf((-(1.0f - mc.y) * t) * dens),
                       expf((-(1.0f - mc.z) * t) * dens)};
    }
    new_dir = s.direction;
    new_org = hit;
    pdf_for_mis = disney::disney_eval(m, v, n, new_dir).pdf;
  }

  store3(a.lo_out, i, lo);
  store3(a.new_history, i, alive ? history * mult : history);
  store3(a.new_org, i, new_org);
  store3(a.new_dir, i, new_dir);
  a.alive[i] = alive;
  a.med_sampled[i] = med_sampled;
  a.pdf_for_mis[i] = pdf_for_mis;
}

__global__ void __launch_bounds__(THREADS)
shade_nee_kernel(const NeeArgs a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.n_lanes) return;
  F3 lo = load3(a.lo, i);
  if (a.facing[i] && !a.shadow_hit[i]) {
    const disney::FPdf e = disney::disney_eval(
        load_mat(a.mat, i), load3(a.v, i), load3(a.n, i), load3(a.l_dir, i));
    const float light_pdf = a.light_pdf[i];
    float w = 1.0f;
    if (a.enable_mis) {   // the power heuristic, mis_weight
      const float sq = light_pdf * light_pdf;
      w = sq / disney::clamp_min(sq + e.pdf * e.pdf,
                                 static_cast<float>(1e-20));
    }
    const float k = w * safe_rcp(light_pdf, EPS_PDF);
    lo = lo + ((k * load3(a.history, i)) * load3(a.light_fr, i)) * e.f;
  }
  store3(a.lo_out, i, lo);
}

}  // namespace

extern "C" int shade_threads() { return THREADS; }

// sizeof the argument blocks, which ops/shade.py's ctypes structures match
extern "C" int shade_bsdf_args_bytes() { return sizeof(BsdfArgs); }
extern "C" int shade_nee_args_bytes() { return sizeof(NeeArgs); }

// Launch on `stream` over args->n_lanes lanes; returns the CUDA error of
// the launch (0: none). n_lanes 0 launches nothing.
extern "C" int shade_bsdf_launch(const BsdfArgs* args, void* stream) {
  const int n = args->n_lanes;
  if (n > 0) {
    shade_bsdf_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(*args);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int shade_nee_launch(const NeeArgs* args, void* stream) {
  const int n = args->n_lanes;
  if (n > 0) {
    shade_nee_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(*args);
  }
  return static_cast<int>(cudaGetLastError());
}
