// The forward BSDF bounce's shading for Hopper (sm_90a) in three kernels,
// one launch at each site of ops/integrator.py::_bounce and one thread per
// live lane. Each reads the scene's tables by index: a lane's triangle
// from tri_attr, its material by id from the packed material table
// (models/material.py MaterialTable.packed), its environment texel from
// env_fetch.
//
//   shade_light: before the cast, all of ops/shade.py::shade_light_plain:
//   intersect.py's surface_attributes (the hit point, the forward value of
//   its straight-through t; the interpolated, flipped shading normal; the
//   material id), the two uniforms of salts 8b, 8b+1, the nearest-texel
//   light sample (envmap.py env_sample_nearest) with its radiance times
//   env_intensity, and whether it faces the normal.
//
//   shade_bsdf: the rt.shade.bsdf span (ops/shade.py::shade_bsdf_plain):
//   the three uniforms of salts 8b+2..8b+4 (sampling.rand01's splitmix32
//   chain in native uint32), the bounce's Sobol pair with its
//   Cranley-Patterson shifts, disney_sample, alive, the three media
//   (ABSORB, EMISSIVE with its radiance term, SCATTER with its
//   Henyey-Greenstein direction and pdf), the throughput, the next ray and
//   the MIS pdf of its direction (disney_eval's, or the phase function's on
//   a phase-sampled lane).
//
//   shade_env: after the cast, all of ops/shade.py::shade_env_plain, in its
//   order of additions: the shadow-tested, power-heuristic NEE contribution
//   (shade_nee_plain), then on a bounce miss the MIS-weighted environment
//   (env_radiance_pdf_nearest, mis_weight, the enable_mis and med_sampled
//   rules), then on a bounce hit the emissive pickup, read by the next
//   hit's material id.
//
// Replaces no TPU kernel: XLA fuses these elementwise chains on the TPU,
// while eager PyTorch launched some 320 kernels a bounce for them, each on
// at most 131,072 lanes, so the host's launches bounded the pass. What
// bounds the kernels on this card: bytes (probes/shade_kernels.py
// LANE_BYTES). shade_light moves 198 bytes a lane, most of them the hit
// triangle's 19 floats of tri_attr, one from each of 19 rows; shade_bsdf
// 206 (210 on a phase-sampled lane) against at most 2,366 FP32 operations;
// shade_env 34 on every lane, 124 more on a lane whose light sample is
// visible, 45 on a bounce miss and 28 on a bounce hit. Each design keeps
// every intermediate in registers, reads each input once, writes nothing
// the next kernel can compute (V = -direction), and where PyTorch computes
// every lobe or branch and selects with torch.where, computes only the one
// each lane selects, which gives the same values.
//
// Same values as the plain versions (csrc/disney.cuh says how): this
// source is built with -fmad=false (registered in ops/shade.py). A
// division of a tensor by a Python float is, on the card, a product with
// the float32 reciprocal (ATen's div_true_kernel_cuda), so INV_TWO_PI_F
// and INV_PI_F below are that reciprocal, rounded in float32.

#include <cuda_runtime.h>

#include <cstdint>

#include "disney.cuh"

// The packed material table's columns (models/material.py
// PACKED_COLUMNS): the Material fields in order, colors three wide.
enum MatCol {
  MC_EMISSIVE = 0,
  MC_BASE_COLOR = 3,
  MC_SUBSURFACE = 6,
  MC_METALLIC = 7,
  MC_SPECULAR = 8,
  MC_SPECULAR_TINT = 9,
  MC_ROUGHNESS = 10,
  MC_ANISOTROPIC = 11,
  MC_SHEEN = 12,
  MC_SHEEN_TINT = 13,
  MC_CLEARCOAT = 14,
  MC_CLEARCOAT_GLOSS = 15,
  MC_IOR = 16,
  MC_TRANSMISSION = 17,
  MC_MEDIUM_COLOR = 18,
  MC_MEDIUM_TYPE = 21,
  MC_MEDIUM_DENSITY = 22,
  MC_MEDIUM_ANISOTROPY = 23,
  MAT_COLS = 24
};

// The kernels' argument blocks, which ops/shade.py's ctypes structures
// mirror field for field. They stay outside the unnamed namespace, so the
// launch functions that take them keep external linkage.
//
// The scene's tables, each contiguous on the lanes' device
struct SceneTabs {
  const float* tri_attr;       // (20, n_tri): p1 p2 p3 n1 n2 n3 mat_idx pad
  const float* env_fetch;      // (env_h * env_w, 16), models/hdr.py
  const float* materials;      // (n_mat, MAT_COLS)
  const float* env_angle;      // 0-dim
  const float* env_intensity;  // 0-dim
  long long n_tri;
  int n_mat, env_h, env_w;
};

struct LightArgs {
  SceneTabs scene;
  const long long* pid;
  const float *origin, *direction, *t;
  const int* tri;
  const bool* inside;
  float *hit_point, *n, *l_dir, *light_pdf, *light_fr;
  int* mat_id;
  bool* facing;
  unsigned int frame;
  int bounce, n_lanes;
};

// lobe and uniforms are optional outputs (null: not written) that the
// card tests read.
struct BsdfArgs {
  const float* materials;   // (n_mat, MAT_COLS)
  const int* mat_id;
  const long long* pid;
  const float* sobol;       // (8,) the frame's Sobol point
  const float *n, *hit_point, *direction, *t, *history, *lo;
  float *lo_out, *new_history, *new_org, *new_dir, *pdf_for_mis;
  bool *alive, *med_sampled;
  signed char* lobe;
  float* uniforms;          // (R, 3)
  unsigned int frame;
  int bounce, n_lanes, n_mat;
};

// history is the throughput before the bounce, new_history after it;
// lo is the radiance shade_bsdf wrote. texel is an optional output (null:
// not written) that the card tests read: the env_fetch row of a bounce
// miss, -1 on every other lane.
struct EnvArgs {
  SceneTabs scene;
  const int* mat_id;
  const float *direction, *n, *l_dir, *light_pdf, *light_fr, *history;
  const bool* facing;
  const int* shadow_tri;
  const float *lo, *new_history, *new_dir, *pdf_for_mis;
  const bool *alive, *med_sampled;
  const int* nxt_tri;
  float* lo_out;
  int* texel;
  int enable_mis, n_lanes;
};

namespace {

using disney::F3;
using disney::Mat;

constexpr int THREADS = 128;
constexpr int MEDIUM_ABSORB = 1;    // models/material.py
constexpr int MEDIUM_SCATTER = 2;
constexpr int MEDIUM_EMISSIVE = 3;
constexpr int ENV_COLS = 16;        // models/hdr.py build_env_fetch
constexpr float EPS_PDF = static_cast<float>(1e-10);
constexpr float INV_TWO_PI_F = 1.0f / disney::TWO_PI;
constexpr float INV_PI_F = 1.0f / disney::PI;
constexpr float TWO_PI_PI = static_cast<float>(2.0 * disney::PI_D
                                               * disney::PI_D);

__device__ __forceinline__ F3 load3(const float* p, int i) {
  return F3{p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

__device__ __forceinline__ void store3(float* p, int i, F3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

__device__ __forceinline__ F3 row3(const float* row, int col) {
  return F3{row[col], row[col + 1], row[col + 2]};
}

template <typename T>
__device__ __forceinline__ T clamp_to(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// A material row of the packed table (MaterialTable.gather's clamp)
__device__ __forceinline__ const float* mat_row(const float* table, int id,
                                                int n_mat) {
  return table + static_cast<long long>(clamp_to(id, 0, n_mat - 1)) * MAT_COLS;
}

__device__ __forceinline__ Mat load_mat(const float* row) {
  return Mat{row3(row, MC_BASE_COLOR), row[MC_SUBSURFACE], row[MC_METALLIC],
             row[MC_SPECULAR_TINT], row[MC_ROUGHNESS], row[MC_ANISOTROPIC],
             row[MC_SHEEN], row[MC_SHEEN_TINT], row[MC_CLEARCOAT],
             row[MC_CLEARCOAT_GLOSS], row[MC_IOR], row[MC_TRANSMISSION]};
}

// SceneData.material_of's slot: tri_attr row 18 of the clamped triangle,
// truncated to an integer and clamped to the table
__device__ __forceinline__ int material_id(const SceneTabs& s, int tri) {
  const long long safe = clamp_to<long long>(tri, 0, s.n_tri - 1);
  const long long id =
      static_cast<long long>(s.tri_attr[18 * s.n_tri + safe]);
  return static_cast<int>(clamp_to<long long>(id, 0, s.n_mat - 1));
}

// torch.sum(a * b, dim=-1) where the product's last dimension is not its
// fastest-moving one (the column-major shading normal of
// surface_attributes is the first operand): one thread of ATen's reduction
// adds the three in order to its identity, then its empty fourth
// accumulator (ATen/native/cuda/Reduce.cuh thread_reduce). disney::dot is
// the order of a contiguous last dimension.
__device__ __forceinline__ float dot_serial(F3 a, F3 b) {
  return ((a.x * b.x + a.y * b.y) + a.z * b.z) + 0.0f;
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

// shade.py mis_weight, the power heuristic
__device__ __forceinline__ float mis_weight(float a, float b) {
  const float sq = a * a;
  return sq / disney::clamp_min(sq + b * b, static_cast<float>(1e-20));
}

// envmap.py _texel_index: the row of env_fetch under uv
__device__ __forceinline__ long long texel_index(float u, float v, int h,
                                                 int w) {
  float ur = fmodf(u, 1.0f);   // torch.remainder(u, 1.0)
  if (ur < 0.0f) ur += 1.0f;
  const long long x = static_cast<long long>(ur * static_cast<float>(w));
  const long long y = static_cast<long long>(v * static_cast<float>(h));
  return clamp_to<long long>(y, 0, h - 1) * w + clamp_to<long long>(x, 0, w - 1);
}

// envmap.py env_radiance_pdf_nearest on a bounce-miss direction: the
// radiance (before env_intensity) and the solid-angle pdf of its texel
__device__ __forceinline__ float env_miss(const SceneTabs& s, F3 d,
                                          F3* radiance, long long* texel) {
  const float u = (atan2f(d.z, d.x) * INV_TWO_PI_F + 0.5f) + *s.env_angle;
  const float vv =
      1.0f - (asinf(clamp_to(d.y, -1.0f, 1.0f)) * INV_PI_F + 0.5f);
  *texel = texel_index(u, vv, s.env_h, s.env_w);
  const float* g = s.env_fetch + *texel * ENV_COLS;
  *radiance = row3(g, 0);
  const float sin_theta = disney::clamp_min(sinf(disney::PI * vv),
                                            static_cast<float>(1e-10));
  return (g[3] * static_cast<float>(s.env_w * s.env_h))
         / (TWO_PI_PI * sin_theta);
}

__global__ void __launch_bounds__(THREADS)
shade_light_kernel(const LightArgs a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.n_lanes) return;
  const SceneTabs& s = a.scene;

  // the hit triangle (surface_attributes' clamp)
  const long long tri = clamp_to<long long>(a.tri[i], 0, s.n_tri - 1);
  const float* ta = s.tri_attr + tri;
  const auto col = [&](int row) { return ta[row * s.n_tri]; };
  const F3 p1{col(0), col(1), col(2)}, p2{col(3), col(4), col(5)},
      p3{col(6), col(7), col(8)};
  const F3 n1{col(9), col(10), col(11)}, n2{col(12), col(13), col(14)},
      n3{col(15), col(16), col(17)};
  const long long id = static_cast<long long>(col(18));
  a.mat_id[i] = static_cast<int>(clamp_to<long long>(id, 0, s.n_mat - 1));

  // the hit point at the forward value of the straight-through t
  const F3 o = load3(a.origin, i);
  const F3 d = load3(a.direction, i);
  const F3 n_geo = disney::cross(p2 - p1, p3 - p1);
  float denom = disney::dot(n_geo, d);
  if (fabsf(denom) < static_cast<float>(1e-12)) {
    denom = denom < 0.0f ? static_cast<float>(-1e-12)
                         : static_cast<float>(1e-12);
  }
  const float t_diff =
      disney::dot(n_geo, p1 - o) / denom - static_cast<float>(1e-5);
  const float t = a.t[i] + (t_diff - t_diff);
  const F3 hit = o + d * t;
  store3(a.hit_point, i, hit);

  // intersect.py shading_normal: areal barycentrics, flipped inside
  const float area2 =
      disney::clamp_min(disney::dot(n_geo, n_geo), static_cast<float>(1e-30));
  const float w1 = disney::dot(disney::cross(p3 - p2, hit - p2), n_geo) / area2;
  const float w2 = disney::dot(disney::cross(p1 - p3, hit - p3), n_geo) / area2;
  const float w3 = (1.0f - w1) - w2;
  const F3 ns = (w1 * n1 + w2 * n2) + w3 * n3;
  const float len =
      sqrtf(disney::clamp_min(dot_serial(ns, ns), static_cast<float>(1e-30)));
  F3 n{ns.x / len, ns.y / len, ns.z / len};
  if (a.inside[i]) n = -n;
  store3(a.n, i, n);

  // the light sample of the nearest texel (env_sample_nearest)
  const uint32_t pid = static_cast<uint32_t>(a.pid[i]);
  const uint32_t salt = 8u * static_cast<uint32_t>(a.bounce);
  const float xl1 = rand01(pid, a.frame, salt);
  const float xl2 = rand01(pid, a.frame, salt + 1u);
  const float* g =
      s.env_fetch + texel_index(xl1, xl2, s.env_h, s.env_w) * ENV_COLS;
  const float x = g[4], y = g[5];
  const float phi = disney::TWO_PI * ((x - *s.env_angle) - 0.5f);
  const float theta = disney::PI * ((1.0f - y) - 0.5f);
  const float cos_t = cosf(theta);
  const F3 l{cos_t * cosf(phi), sinf(theta), cos_t * sinf(phi)};
  store3(a.l_dir, i, l);
  const float sin_col = disney::clamp_min(sinf(disney::PI * y),
                                          static_cast<float>(1e-10));
  a.light_pdf[i] = (g[6] * static_cast<float>(s.env_w * s.env_h))
                   / (TWO_PI_PI * sin_col);
  store3(a.light_fr, i, row3(g, 7) * *s.env_intensity);
  a.facing[i] = dot_serial(n, l) > 0.0f;
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

  const float* row = mat_row(a.materials, a.mat_id[i], a.n_mat);
  const Mat m = load_mat(row);
  const F3 direction = load3(a.direction, i);
  const F3 v = -direction;
  const F3 n = load3(a.n, i);
  const disney::Sample s = disney::disney_sample(m, v, n, xi1, xi2, xi3);
  if (a.lobe != nullptr) a.lobe[i] = s.lobe;
  const bool alive = s.pdf > EPS_PDF;

  // media on refraction (glsl:1429-1458)
  const bool refract = alive && s.is_refract;
  const int medium = static_cast<int>(row[MC_MEDIUM_TYPE]);
  const float t = a.t[i];
  const float dens = row[MC_MEDIUM_DENSITY];
  const F3 mc = row3(row, MC_MEDIUM_COLOR);
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
    const float g = row[MC_MEDIUM_ANISOTROPY];
    new_dir = sample_hg(v, g, xi1, xi2);
    pdf_for_mis = phase_hg(disney::dot(v, new_dir), g);
    mult = mc * expf(-scatter_dist);
    // glsl:1450 marches straight through the surface to the scatter point
    new_org = hit + direction * scatter_dist;
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
shade_env_kernel(const EnvArgs a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.n_lanes) return;
  const SceneTabs& s = a.scene;
  const F3 zero{0.0f, 0.0f, 0.0f};
  F3 lo = load3(a.lo, i);

  // the NEE contribution where the light faces the surface, unshadowed
  F3 nee = zero;
  if (a.facing[i] && a.shadow_tri[i] < 0) {
    const disney::FPdf e = disney::disney_eval(
        load_mat(mat_row(s.materials, a.mat_id[i], s.n_mat)),
        -load3(a.direction, i), load3(a.n, i), load3(a.l_dir, i));
    const float light_pdf = a.light_pdf[i];
    const float w = a.enable_mis ? mis_weight(light_pdf, e.pdf) : 1.0f;
    const float k = w * safe_rcp(light_pdf, EPS_PDF);
    nee = ((k * load3(a.history, i)) * load3(a.light_fr, i)) * e.f;
  }
  lo = lo + nee;

  // the bounce ray: the MIS-weighted environment on a miss, the emission
  // of the surface it hit otherwise
  const bool alive = a.alive[i];
  const int nxt = a.nxt_tri[i];
  F3 env = zero, emitted = zero;
  long long texel = -1;
  if (alive && nxt < 0) {
    F3 radiance;
    const float light_pdf =
        env_miss(s, load3(a.new_dir, i), &radiance, &texel);
    float w = a.enable_mis ? mis_weight(a.pdf_for_mis[i], light_pdf) : 1.0f;
    if (a.med_sampled[i]) w = 1.0f;   // no competing NEE
    env = (w * load3(a.new_history, i)) * (radiance * *s.env_intensity);
  } else if (alive) {
    const float* row = s.materials
                       + static_cast<long long>(material_id(s, nxt)) * MAT_COLS;
    emitted = load3(a.new_history, i) * row3(row, MC_EMISSIVE);
  }
  store3(a.lo_out, i, (lo + env) + emitted);
  if (a.texel != nullptr) a.texel[i] = static_cast<int>(texel);
}

template <typename Args, typename Kernel>
int launch(const Args* args, void* stream, Kernel kernel) {
  const int n = args->n_lanes;
  if (n > 0) {
    kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
             static_cast<cudaStream_t>(stream)>>>(*args);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int shade_threads() { return THREADS; }

// sizeof the argument blocks, which ops/shade.py's ctypes structures match
extern "C" int shade_light_args_bytes() { return sizeof(LightArgs); }
extern "C" int shade_bsdf_args_bytes() { return sizeof(BsdfArgs); }
extern "C" int shade_env_args_bytes() { return sizeof(EnvArgs); }

// The first column of each Material field in the packed table, in the
// fields' order, into out[0..17]; returns the table's width. ops/shade.py
// holds them to models/material.py's PACKED_COLUMNS.
extern "C" int shade_material_columns(int* out) {
  const int cols[] = {MC_EMISSIVE, MC_BASE_COLOR, MC_SUBSURFACE, MC_METALLIC,
                      MC_SPECULAR, MC_SPECULAR_TINT, MC_ROUGHNESS,
                      MC_ANISOTROPIC, MC_SHEEN, MC_SHEEN_TINT, MC_CLEARCOAT,
                      MC_CLEARCOAT_GLOSS, MC_IOR, MC_TRANSMISSION,
                      MC_MEDIUM_COLOR, MC_MEDIUM_TYPE, MC_MEDIUM_DENSITY,
                      MC_MEDIUM_ANISOTROPY};
  for (int k = 0; k < 18; ++k) out[k] = cols[k];
  return MAT_COLS;
}

// Launch on `stream` over args->n_lanes lanes; returns the CUDA error of
// the launch (0: none). n_lanes 0 launches nothing.
extern "C" int shade_light_launch(const LightArgs* args, void* stream) {
  return launch(args, stream, shade_light_kernel);
}

extern "C" int shade_bsdf_launch(const BsdfArgs* args, void* stream) {
  return launch(args, stream, shade_bsdf_kernel);
}

extern "C" int shade_env_launch(const EnvArgs* args, void* stream) {
  return launch(args, stream, shade_env_kernel);
}
