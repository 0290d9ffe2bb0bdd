// The Disney-principled BSDF on one lane: evaluation and sampling, as
// ops/disney.py, ops/microfacet.py and ops/sampling.py compute them
// (DisneyEval / DisneySample, glsl:1002-1161, and what they call), for
// csrc/shade.cu's two kernels.
//
// The PyTorch functions are the specification, operation for operation:
// float32 throughout, the same guards and cut-offs (_COS_EPS, _DENOM_EPS,
// _mask1's substitutions before a division, the clamps), the JAX module's
// documented deviations (dot(V,H) for the sample Fresnel, the decorrelated
// clearcoat sampler), every lobe of the evaluation summed in the same
// order. Each PyTorch operation rounds once, so shade.cu is built with
// -fmad=false (registered in ops/shade.py): no product is contracted into
// an FMA except where torch's own kernel contracts one (torch.linalg.cross,
// below).
// Sums and products keep PyTorch's left-to-right order. No fast-math
// intrinsic: expf, logf, powf, sinf, cosf, sqrtf and IEEE division.
//
// A constant is the float32 that PyTorch rounds the Python double to, so
// each is written as static_cast<float>(double): a float literal of the
// same decimal could round otherwise.
//
// disney_sample computes only the lobe it picks: PyTorch evaluates all four
// and selects with torch.where, which gives the same value.

#pragma once

namespace disney {

#define DEV __device__ __forceinline__

constexpr double PI_D = 3.14159265358979323;
constexpr float PI = static_cast<float>(PI_D);
constexpr float INV_PI = static_cast<float>(1.0 / PI_D);
constexpr float TWO_PI = static_cast<float>(2.0 * PI_D);
constexpr float INV_4_PI = static_cast<float>(1.0 / (4.0 * PI_D));
constexpr float COS_EPS = static_cast<float>(1e-4);
constexpr float DENOM_EPS = static_cast<float>(1e-3);
constexpr float EPS = static_cast<float>(1e-10);
constexpr float EPS6 = static_cast<float>(1e-6);
constexpr float EPS12 = static_cast<float>(1e-12);
constexpr float EPS20 = static_cast<float>(1e-20);
constexpr float ALPHA_MIN = static_cast<float>(0.001);

struct F3 {
  float x, y, z;
};

DEV F3 f3(float x, float y, float z) { return F3{x, y, z}; }
DEV F3 operator+(F3 a, F3 b) { return F3{a.x + b.x, a.y + b.y, a.z + b.z}; }
DEV F3 operator-(F3 a, F3 b) { return F3{a.x - b.x, a.y - b.y, a.z - b.z}; }
DEV F3 operator-(F3 a) { return F3{-a.x, -a.y, -a.z}; }
DEV F3 operator*(F3 a, float s) { return F3{a.x * s, a.y * s, a.z * s}; }
DEV F3 operator*(float s, F3 a) { return F3{s * a.x, s * a.y, s * a.z}; }
DEV F3 operator*(F3 a, F3 b) { return F3{a.x * b.x, a.y * b.y, a.z * b.z}; }

// torch.clamp / torch.minimum: a NaN passes through
DEV float clamp_min(float x, float lo) { return x < lo ? lo : x; }
DEV float clamp01(float x) {
  const float y = x < 0.0f ? 0.0f : x;
  return y > 1.0f ? 1.0f : y;
}
DEV float sqr(float x) { return x * x; }
DEV float safe_sqrt(float x) { return sqrtf(clamp_min(x, EPS12)); }

// torch.sum(a * b, dim=-1) over a last dimension of 3 on the card: its
// reduction adds element 2 to element 0, then element 1 (on an H100 it
// equalled this order on 2^20 of 2^20 random vectors, the other two orders
// on 70%).
DEV float dot(F3 a, F3 b) {
  const float p0 = a.x * b.x, p1 = a.y * b.y, p2 = a.z * b.z;
  return (p0 + p2) + p1;
}

// torch.linalg.cross: fma(a_i, b_j, -(a_j * b_i)), as its kernel contracts
DEV F3 cross(F3 a, F3 b) {
  return F3{__fmaf_rn(a.y, b.z, -(a.z * b.y)),
            __fmaf_rn(a.z, b.x, -(a.x * b.z)),
            __fmaf_rn(a.x, b.y, -(a.y * b.x))};
}

DEV F3 normalize(F3 v) {
  return v * (1.0f / sqrtf(clamp_min(dot(v, v), EPS12)));
}

DEV float luminance(F3 c) {
  return (static_cast<float>(0.212671) * c.x
          + static_cast<float>(0.715160) * c.y)
         + static_cast<float>(0.072169) * c.z;
}

DEV float mix(float a, float b, float t) { return a + t * (b - a); }

// Orthonormal basis (sampling.py onb): helper (1,0,0) unless |n.x| > 0.999
struct Frame {
  F3 t, b, n;
};

DEV Frame onb(F3 n) {
  const F3 helper = fabsf(n.x) > static_cast<float>(0.999)
                        ? f3(0.0f, 0.0f, 1.0f) : f3(1.0f, 0.0f, 0.0f);
  const F3 b = normalize(cross(n, helper));
  const F3 t = normalize(cross(n, b));
  return Frame{t, b, n};
}

DEV F3 to_local(const Frame& f, F3 v) {
  return f3(dot(v, f.t), dot(v, f.b), dot(v, f.n));
}

DEV F3 to_world(const Frame& f, F3 v) {
  return (v.x * f.t + v.y * f.b) + v.z * f.n;
}

// The per-lane material fields the BSDF reads (models/material.py)
struct Mat {
  F3 base_color;
  float subsurface, metallic, specular_tint, roughness, anisotropic, sheen,
      sheen_tint, clearcoat, clearcoat_gloss, ior, transmission;
};

struct Alpha {
  float x, y;
};

DEV Alpha alpha_xy(const Mat& m) {
  const float aspect = sqrtf(1.0f - m.anisotropic * static_cast<float>(0.9));
  const float r2 = m.roughness * m.roughness;
  return Alpha{clamp_min(r2 / aspect, ALPHA_MIN),
               clamp_min(r2 * aspect, ALPHA_MIN)};
}

// microfacet.py

DEV float gtr1(float ndoth, float alpha) {
  alpha = clamp_min(alpha, ALPHA_MIN);
  const float a2 = sqr(alpha);
  const float t = 1.0f + (a2 - 1.0f) * sqr(ndoth);
  const float safe_a2 = clamp_min(a2 >= 1.0f ? 0.5f : a2, EPS6);
  const float d = (safe_a2 - 1.0f) / ((PI * logf(safe_a2)) * t);
  return alpha >= 1.0f ? INV_PI : d;
}

DEV float gtr2_aniso(float ndoth, float hdotx, float hdoty, Alpha a) {
  const float c = (sqr(hdotx / a.x) + sqr(hdoty / a.y)) + sqr(ndoth);
  return 1.0f / (((PI * a.x) * a.y) * sqr(c) + EPS20);
}

DEV float smith_g_ggx_quarter(float ndotv) {   // smith_g_ggx(., 0.25)
  constexpr float a = static_cast<float>(0.25 * 0.25);
  const float b = sqr(ndotv);
  return (2.0f * ndotv) / ((ndotv + safe_sqrt((a + b) - a * b)) + EPS20);
}

DEV float smith_g_ggx_aniso(float ndotv, float vdotx, float vdoty, Alpha al) {
  const float a = vdotx * al.x;
  const float b = vdoty * al.y;
  return (2.0f * ndotv)
         / ((ndotv + safe_sqrt((sqr(a) + sqr(b)) + sqr(ndotv))) + EPS20);
}

DEV float schlick_fresnel(float u) {
  const float m = clamp01(1.0f - u);
  return sqr(sqr(m)) * m;
}

// dielectric_fresnel(cos_i, eta) with eta and sqr(eta) as PyTorch has them:
// both rounded from the tensor (eta2 = eta * eta in float) or, for a
// Python scalar, sqr(eta) taken in double and rounded once.
DEV float dielectric_fresnel(float ci, float eta, float eta2) {
  const float sin2_t = eta2 * (1.0f - sqr(ci));
  const float cos_t = safe_sqrt(1.0f - sin2_t);
  const float rs = (eta * cos_t - ci) / ((eta * cos_t + ci) + EPS20);
  const float rp = (eta * ci - cos_t) / ((eta * ci + cos_t) + EPS20);
  const float f = 0.5f * (sqr(rs) + sqr(rp));
  return sin2_t > 1.0f ? 1.0f : f;
}

DEV float disney_fresnel(float metallic, float eta, float ldoth, float vdoth) {
  const float fm = schlick_fresnel(ldoth);
  const float fd = dielectric_fresnel(fabsf(vdoth), eta, eta * eta);
  return fd + metallic * (fm - fd);
}

struct Colors {
  F3 spec, sheen;
};

DEV Colors spec_and_sheen_color(const Mat& m, float eta) {
  const float lum = luminance(m.base_color);
  const float den = clamp_min(lum, EPS12);
  const F3 ctint = lum > 0.0f
      ? f3(m.base_color.x / den, m.base_color.y / den, m.base_color.z / den)
      : f3(1.0f, 1.0f, 1.0f);
  const float f0 = sqr((1.0f - eta) / (1.0f + eta));
  const F3 d = ctint - f3(1.0f, 1.0f, 1.0f);
  const F3 tinted = f3(1.0f + m.specular_tint * d.x,
                       1.0f + m.specular_tint * d.y,
                       1.0f + m.specular_tint * d.z);
  F3 spec = f0 * tinted;
  spec = spec + m.metallic * (m.base_color - spec);
  const F3 sheen = f3(1.0f + m.sheen_tint * d.x, 1.0f + m.sheen_tint * d.y,
                      1.0f + m.sheen_tint * d.z);
  return Colors{spec, sheen};
}

// disney.py

struct Lobes {
  float diff, refl, refr, coat;
};

DEV Lobes lobe_weights(const Mat& m, F3 spec_col, float fresnel) {
  const float lum_base = luminance(m.base_color);
  const float one_m_metal = 1.0f - m.metallic;
  const float r_diffuse = (one_m_metal * (1.0f - m.transmission)) * lum_base;
  const float r_specular = luminance(f3(
      spec_col.x + fresnel * (1.0f - spec_col.x),
      spec_col.y + fresnel * (1.0f - spec_col.y),
      spec_col.z + fresnel * (1.0f - spec_col.z)));
  const float r_clearcoat = (one_m_metal * 0.25f) * m.clearcoat;
  const float r_refract =
      ((one_m_metal * m.transmission) * lum_base) * (1.0f - fresnel);
  const float inv_sum = 1.0f / clamp_min(
      ((r_diffuse + r_specular) + r_clearcoat) + r_refract, EPS);
  return Lobes{r_diffuse * inv_sum, r_specular * inv_sum,
               r_refract * inv_sum, r_clearcoat * inv_sum};
}

struct FPdf {
  F3 f;
  float pdf;
};

DEV FPdf zero_lobe() { return FPdf{f3(0.0f, 0.0f, 0.0f), 0.0f}; }

DEV FPdf eval_diffuse(const Mat& m, F3 sheen_col, F3 v, F3 l, F3 h) {
  const bool valid = l.z > COS_EPS;
  const float lz = valid ? l.z : 1.0f;
  const float vz = v.z;
  const float ldoth = dot(l, h);
  const float fl = schlick_fresnel(lz);
  const float fv = schlick_fresnel(vz);
  const float fh = schlick_fresnel(ldoth);
  const float fd90 = 0.5f + (2.0f * sqr(ldoth)) * m.roughness;
  const float fd = mix(1.0f, fd90, fl) * mix(1.0f, fd90, fv);
  const float fss90 = sqr(ldoth) * m.roughness;
  const float fss = mix(1.0f, fss90, fl) * mix(1.0f, fss90, fv);
  const float ss =
      1.25f * (fss * (1.0f / clamp_min(lz + vz, COS_EPS) - 0.5f) + 0.5f);
  const F3 f_sheen = (fh * m.sheen) * sheen_col;
  const float scale = (1.0f - m.metallic) * (1.0f - m.transmission);
  const float k = INV_PI * mix(fd, ss, m.subsurface);
  const F3 f = scale * (k * m.base_color + f_sheen);
  if (!valid) return zero_lobe();
  return FPdf{f, lz * INV_PI};
}

DEV FPdf eval_spec_reflection(const Mat& m, float eta, F3 spec_col, F3 v,
                              F3 l, F3 h) {
  const bool valid = (l.z > COS_EPS) && (v.z > COS_EPS);
  const float lz = valid ? l.z : 1.0f;
  const float vz = valid ? v.z : 1.0f;
  const Alpha a = alpha_xy(m);
  const float fm = disney_fresnel(m.metallic, eta, dot(l, h), dot(v, h));
  const F3 f_col = f3(spec_col.x + fm * (1.0f - spec_col.x),
                      spec_col.y + fm * (1.0f - spec_col.y),
                      spec_col.z + fm * (1.0f - spec_col.z));
  const float d = gtr2_aniso(h.z, h.x, h.y, a);
  const float g1 = smith_g_ggx_aniso(vz, v.x, v.y, a);
  const float g2 = g1 * smith_g_ggx_aniso(lz, l.x, l.y, a);
  const float pdf = (g1 * d) / (4.0f * vz);
  const F3 f = f_col * ((d * g2) / ((4.0f * lz) * vz));
  if (!valid) return zero_lobe();
  return FPdf{f, pdf};
}

DEV FPdf eval_spec_refraction(const Mat& m, float eta, F3 v, F3 l, F3 h) {
  const float vdoth = dot(v, h);
  const float ldoth = dot(l, h);
  const float denom_raw = ldoth + vdoth * eta;
  const bool valid = (l.z < -COS_EPS) && (v.z > COS_EPS)
                     && (fabsf(denom_raw) > DENOM_EPS);
  const float lz = valid ? l.z : -1.0f;
  const float vz = valid ? v.z : 1.0f;
  const float denom = sqr(valid ? denom_raw : 1.0f);
  const Alpha a = alpha_xy(m);
  const float fr = dielectric_fresnel(fabsf(vdoth), eta, eta * eta);
  const float d = gtr2_aniso(h.z, h.x, h.y, a);
  const float g1 = smith_g_ggx_aniso(fabsf(vz), v.x, v.y, a);
  const float g2 = g1 * smith_g_ggx_aniso(fabsf(lz), l.x, l.y, a);
  const float jacobian = fabsf(ldoth) / denom;
  const float pdf = (((g1 * clamp_min(vdoth, 0.0f)) * d) * jacobian) / vz;
  const float scale =
      ((((((((1.0f - m.metallic) * m.transmission) * (1.0f - fr)) * d) * g2)
          * fabsf(vdoth)) * jacobian) * sqr(eta))
      / fabsf(lz * vz);
  const F3 f = f3(safe_sqrt(m.base_color.x), safe_sqrt(m.base_color.y),
                  safe_sqrt(m.base_color.z)) * scale;
  if (!valid) return zero_lobe();
  return FPdf{f, pdf};
}

DEV FPdf eval_clearcoat(const Mat& m, F3 v, F3 l, F3 h) {
  const float vdoth_raw = dot(v, h);
  const bool valid = (l.z > COS_EPS) && (v.z > COS_EPS)
                     && (fabsf(vdoth_raw) > COS_EPS);
  const float lz = valid ? l.z : 1.0f;
  const float vz = valid ? v.z : 1.0f;
  const float vdoth = valid ? vdoth_raw : 1.0f;
  // dielectric_fresnel(vdoth, 1.0 / 1.5): a Python eta, squared in double
  const float fh = dielectric_fresnel(vdoth, static_cast<float>(1.0 / 1.5),
                                      static_cast<float>((1.0 / 1.5)
                                                         * (1.0 / 1.5)));
  const float f_c = static_cast<float>(0.04)
                    + fh * static_cast<float>(1.0 - 0.04);
  const float d = gtr1(h.z, m.clearcoat_gloss);
  const float g = smith_g_ggx_quarter(lz) * smith_g_ggx_quarter(vz);
  const float jacobian = 1.0f / (4.0f * vdoth);
  const float pdf = (d * h.z) * jacobian;
  const float c = ((((0.25f * m.clearcoat) * f_c) * d) * g)
                  / ((4.0f * lz) * vz);
  if (!valid) return zero_lobe();
  return FPdf{f3(c, c, c), pdf};
}

DEV float eta_of(const Mat& m, F3 v_world, F3 n) {
  return dot(v_world, n) > 0.0f ? 1.0f / m.ior : m.ior;
}

// disney_eval: (f * |cos|, pdf) of world direction l_world
DEV FPdf disney_eval(const Mat& m, F3 v_world, F3 n, F3 l_world) {
  const float eta = eta_of(m, v_world, n);
  const Frame fr = onb(n);
  const F3 v = to_local(fr, v_world);
  const F3 l = to_local(fr, l_world);
  const float lz = l.z;
  F3 h = normalize(lz > 0.0f ? l + v : l + v * eta);
  if (h.z < 0.0f) h = -h;

  const Colors col = spec_and_sheen_color(m, eta);
  const float fresnel = disney_fresnel(m.metallic, eta, dot(l, h), dot(v, h));
  const Lobes w = lobe_weights(m, col.spec, fresnel);

  F3 f = f3(0.0f, 0.0f, 0.0f);
  float pdf = 0.0f;
  if (w.diff > 0.0f && lz > 0.0f) {
    const FPdf e = eval_diffuse(m, col.sheen, v, l, h);
    f = f + e.f;
    pdf = pdf + e.pdf * w.diff;
  }
  if (w.refl > 0.0f && lz > 0.0f && v.z > 0.0f) {
    const FPdf e = eval_spec_reflection(m, eta, col.spec, v, l, h);
    f = f + e.f;
    pdf = pdf + e.pdf * w.refl;
  }
  if (w.refr > 0.0f && lz < 0.0f) {
    const FPdf e = eval_spec_refraction(m, eta, v, l, h);
    f = f + e.f;
    pdf = pdf + e.pdf * w.refr;
  }
  if (w.coat > 0.0f && lz > 0.0f && v.z > 0.0f) {
    const FPdf e = eval_clearcoat(m, v, l, h);
    f = f + e.f;
    pdf = pdf + e.pdf * w.coat;
  }
  return FPdf{f * fabsf(lz), pdf};
}

// sampling.py's local-frame samplers

DEV F3 cosine_sample_hemisphere(float r1, float r2) {
  const float r = safe_sqrt(r1);
  const float phi = TWO_PI * r2;
  const float x = r * cosf(phi);
  const float y = r * sinf(phi);
  return f3(x, y, safe_sqrt((1.0f - x * x) - y * y));
}

DEV F3 sample_gtr1(float roughness, float r1, float r2) {
  const float a = clamp_min(roughness, ALPHA_MIN);
  const float a2 = a * a;
  const float phi = r1 * TWO_PI;
  const float cos_t =
      sqrtf((1.0f - powf(a2, 1.0f - r2)) / clamp_min(1.0f - a2, EPS12));
  const float sin_t = clamp01(safe_sqrt(1.0f - cos_t * cos_t));
  return f3(sin_t * cosf(phi), sin_t * sinf(phi), cos_t);
}

DEV F3 sample_ggx_vndf(F3 v, Alpha a, float r1, float r2) {
  const F3 vh = normalize(f3(a.x * v.x, a.y * v.y, v.z));
  const float lensq = sqr(vh.x) + sqr(vh.y);
  const float inv_len = 1.0f / sqrtf(clamp_min(lensq, EPS12));
  const F3 t1 = lensq > 0.0f
      ? f3(-vh.y * inv_len, vh.x * inv_len, 0.0f * inv_len)
      : f3(1.0f, 0.0f, 0.0f);
  const F3 t2 = cross(vh, t1);
  const float r = safe_sqrt(r1);
  const float phi = TWO_PI * r2;
  const float p1 = r * cosf(phi);
  float p2 = r * sinf(phi);
  const float s = 0.5f * (1.0f + vh.z);
  p2 = (1.0f - s) * safe_sqrt(1.0f - p1 * p1) + s * p2;
  const F3 nh = (p1 * t1 + p2 * t2)
                + safe_sqrt((1.0f - p1 * p1) - p2 * p2) * vh;
  return normalize(f3(a.x * nh.x, a.y * nh.y, clamp_min(nh.z, 0.0f)));
}

DEV F3 reflect(F3 i, F3 n) { return i - (2.0f * dot(n, i)) * n; }

DEV F3 refract(F3 i, F3 n, float eta) {
  const float cos_i = -dot(i, n);
  const float k = 1.0f - (eta * eta) * (1.0f - cos_i * cos_i);
  const F3 r = eta * i + (eta * cos_i - safe_sqrt(k)) * n;
  return k < 0.0f ? f3(0.0f, 0.0f, 0.0f) : r;
}

// disney_sample's lobes, in the order of its selection
enum Lobe : signed char {
  DIFFUSE = 0, CLEARCOAT = 1, REFLECT = 2, REFRACT = 3
};

struct Sample {
  F3 f;           // f * |cos|
  F3 direction;   // world
  float pdf;
  Lobe lobe;
  bool is_refract;
};

DEV Sample disney_sample(const Mat& m, F3 v_world, F3 n, float r1, float r2,
                         float r3) {
  const float eta = eta_of(m, v_world, n);
  const Frame fr = onb(n);
  const F3 v = to_local(fr, v_world);
  const Colors col = spec_and_sheen_color(m, eta);
  const float approx_fresnel = disney_fresnel(m.metallic, eta, v.z, v.z);
  const Lobes w = lobe_weights(m, col.spec, approx_fresnel);
  const float cdf0 = w.diff;
  const float cdf1 = cdf0 + w.coat;

  F3 l, f;
  float pdf;
  Lobe lobe;
  bool is_refract = false;
  if (r1 < cdf0) {
    const float r1_d = r1 / clamp_min(cdf0, EPS6);
    l = cosine_sample_hemisphere(clamp01(r1_d), r2);
    const FPdf e = eval_diffuse(m, col.sheen, v, l, normalize(l + v));
    f = e.f;
    pdf = e.pdf * w.diff;
    lobe = DIFFUSE;
  } else if (r1 < cdf1) {
    const float r1_c = (r1 - cdf0) / clamp_min(cdf1 - cdf0, EPS6);
    F3 h = sample_gtr1(m.clearcoat_gloss, clamp01(r1_c), r2);
    if (h.z < 0.0f) h = -h;
    l = normalize(reflect(-v, h));
    const FPdf e = eval_clearcoat(m, v, l, h);
    f = e.f;
    pdf = e.pdf * w.coat;
    lobe = CLEARCOAT;
  } else {
    const float r1_s = (r1 - cdf1) / clamp_min(1.0f - cdf1, EPS6);
    F3 h = sample_ggx_vndf(v, alpha_xy(m), clamp01(r1_s), r2);
    if (h.z < 0.0f) h = -h;
    const float vdoth = dot(v, h);
    const float fresnel_s = disney_fresnel(m.metallic, eta, vdoth, vdoth);
    const float f_pick =
        1.0f - (((1.0f - fresnel_s) * m.transmission) * (1.0f - m.metallic));
    const float spec_mass = w.refl + w.refr;
    if (r3 < f_pick) {
      l = normalize(reflect(-v, h));
      const FPdf e = eval_spec_reflection(m, eta, col.spec, v, l, h);
      f = e.f;
      pdf = (e.pdf * f_pick) * spec_mass;
      lobe = REFLECT;
    } else {   // torch.where's last branch: also a NaN f_pick
      l = normalize(refract(-v, h, eta));
      const FPdf e = eval_spec_refraction(m, eta, v, l, h);
      f = e.f;
      pdf = (e.pdf * (1.0f - f_pick)) * spec_mass;
      lobe = REFRACT;
    }
    is_refract = r3 >= f_pick;
  }
  return Sample{f * fabsf(l.z), to_world(fr, l), pdf, lobe, is_refract};
}

#undef DEV

}  // namespace disney
