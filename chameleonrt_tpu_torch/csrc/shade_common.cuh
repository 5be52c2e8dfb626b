// The per-lane body of S1 (csrc/shade.cu): the shading stage of one bounce
// for one live lane, the plain version's _shade_bounce
// (chameleonrt_tpu_torch/engine/path_tracer.py) with its ops/bsdf.py,
// lights.py, rng.py, math.py and texture.py written out for one lane.
//
// Every function is __host__ __device__, so the host tests build this header
// with g++ against a shim of the CUDA qualifiers and hold it against the
// plain version on the CPU (tests/test_torch_shade_host.py).
//
// Parity rules, so that the card's S1 rounds as torch's ops round there:
//   - operand order of every sum, product and quotient as in ops/*.py
//     (dot as a0*b0 + a1*b1 + a2*b2, left to right); built with
//     -fmad=false (g++: -ffp-contract=off), so nothing is contracted;
//   - a Python float constant is the float32 it casts to (F32 of the
//     double), as torch casts a scalar for a float32 op;
//   - `c / t` with c a Python float is torch's reciprocal(t) * c
//     (Tensor.__rdiv__): rdiv below;
//   - `t / c` with c a Python float is t * float(1 / c) in torch's CUDA
//     kernel and t / c on the CPU: div_const;
//   - clamp, where and the reductions propagate NaN as torch's do;
//   - the RNG draws in the plain version's order: light pick, light u v,
//     the bsdf-branch sample (component, u1, u2), the continuation sample
//     (component, u1, u2), the roulette draw after bounce 3.
// Where torch evaluates every branch and selects with where, a lane here
// evaluates only the branch it takes (the sampled component, the
// anisotropic lobe only where anisotropy != 0, transmission only where
// specular_transmission > 0): the selected value is the same computation.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace crt {
namespace shade {

#define CRT_HD __host__ __device__ __forceinline__
#define F32(x) static_cast<float>(x)

constexpr double kPi = 3.14159265358979323846;     // ops/math.py M_PI
constexpr double k1Pi = 0.318309886183790671538;   // M_1_PI
constexpr float kEps = F32(1e-4);                  // EPSILON
constexpr float kAlphaMin = F32(0.001);            // ops/bsdf.py _ALPHA_MIN
constexpr float kTiny = F32(1e-20);

// The scene tables S1 reads (engine/device_scene.py FlatScene, SceneMeta).
// ops/shade_cuda.py mirrors this struct and Lanes field for field.
struct Scene {
  const float* shade_rows;      // (T, 32)
  int num_tris;
  const float* mat_rows;        // (M, 16)
  int num_mats;
  const float* inst_inv;        // (I, 4, 4)
  const int* inst_mat_table;    // (I, G)
  int num_instances;
  int g_max;
  const float* emission;        // (L, 3), as position, normal, v_x, v_y
  const float* position;
  const float* normal;
  const float* v_x;
  const float* v_y;
  const float* width;           // (L,), as height
  const float* height;
  int num_lights;
  const uint8_t* atlas;         // (P, 16) bilinear quad rows
  const int* atlas_table;       // (N, 4): offset, width, height, flags
  int num_textures;
  int textured;                 // bit k: field k may hold a texture handle
};

// One bounce's lanes: the inputs of _shade_bounce, and ShadeOut's 12 fields.
struct Lanes {
  const int64_t* state;
  const float* dir;
  const float* throughput;
  const uint8_t* active;
  const float* hit_p;
  const int* hit_tri;
  const int* hit_inst;
  const float* hit_u;
  const float* hit_v;
  int64_t* state_out;
  float* c1;
  float* c2;
  uint8_t* shoot1;
  float* light_dir;
  float* light_dist;
  uint8_t* shoot2;
  float* w_i2;
  float* t_light;
  float* new_tp;
  float* cont_dir;
  uint8_t* new_active;
};

struct V3 {
  float x, y, z;
};

CRT_HD V3 load3(const float* p) { return V3{p[0], p[1], p[2]}; }
CRT_HD void store3(float* p, V3 v) { p[0] = v.x; p[1] = v.y; p[2] = v.z; }
CRT_HD V3 add(V3 a, V3 b) { return V3{a.x + b.x, a.y + b.y, a.z + b.z}; }
CRT_HD V3 sub(V3 a, V3 b) { return V3{a.x - b.x, a.y - b.y, a.z - b.z}; }
CRT_HD V3 mul(V3 a, V3 b) { return V3{a.x * b.x, a.y * b.y, a.z * b.z}; }
CRT_HD V3 scale(V3 a, float s) { return V3{a.x * s, a.y * s, a.z * s}; }
CRT_HD V3 neg(V3 a) { return V3{-a.x, -a.y, -a.z}; }
CRT_HD V3 zero3() { return V3{0.0f, 0.0f, 0.0f}; }
CRT_HD bool nonzero(V3 a) { return a.x != 0.0f || a.y != 0.0f || a.z != 0.0f; }

// torch's clamp family: NaN passes through, then max / min
CRT_HD float clamp_min(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }
CRT_HD float saturate(float x) { return isnan(x) ? x : fminf(fmaxf(x, 0.0f), 1.0f); }
CRT_HD float sqr(float x) { return x * x; }
// c / t for a Python float c: reciprocal(t) * c
CRT_HD float rdiv(float c, float t) { return (1.0f / t) * c; }
// t / c for a Python float c: torch's CUDA kernel multiplies by the
// reciprocal of a CPU scalar divisor, taken in double and rounded to float
// (1 / 1.055 is not 1.0f / 1.055f), its CPU kernel divides
CRT_HD float div_const(float t, double c) {
#ifdef __CUDA_ARCH__
  return t * F32(1.0 / c);
#else
  return t / F32(c);
#endif
}
CRT_HD float lerp(float x, float y, float s) { return x * (1.0f - s) + y * s; }
CRT_HD float nan_max(float a, float b) { return (isnan(a) || a > b) ? a : b; }

// ops/math.py
CRT_HD float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
CRT_HD float length(V3 v) { return sqrtf(clamp_min(dot(v, v), 0.0f)); }
CRT_HD V3 normalize(V3 v) {
  const float l = sqrtf(clamp_min(dot(v, v), kTiny));
  return V3{v.x / l, v.y / l, v.z / l};
}
CRT_HD V3 cross(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
CRT_HD float luminance(V3 c) {
  return F32(0.2126) * c.x + F32(0.7152) * c.y + F32(0.0722) * c.z;
}
// i - 2 n (i . n)
CRT_HD V3 reflect(V3 i, V3 n) {
  const float d = dot(i, n);
  return V3{i.x - (2.0f * n.x) * d, i.y - (2.0f * n.y) * d, i.z - (2.0f * n.z) * d};
}
CRT_HD V3 refract(V3 i, V3 n, float eta) {
  const float n_dot_i = dot(n, i);
  float k = 1.0f - (eta * eta) * (1.0f - n_dot_i * n_dot_i);
  if (k < 0.0f) return zero3();
  k = clamp_min(k, 0.0f);
  const float s = eta * n_dot_i + sqrtf(k);
  return V3{eta * i.x - s * n.x, eta * i.y - s * n.y, eta * i.z - s * n.z};
}
CRT_HD void ortho_basis(V3 n, V3* v_x, V3* v_y) {
  const bool ax = fabsf(n.x) < F32(0.6), ay = fabsf(n.y) < F32(0.6), az = fabsf(n.z) < F32(0.6);
  const V3 h{(ax || (!ax && !ay && !az)) ? 1.0f : 0.0f, (!ax && ay) ? 1.0f : 0.0f,
             (!ax && !ay && az) ? 1.0f : 0.0f};
  *v_x = normalize(cross(h, n));
  *v_y = normalize(cross(n, *v_x));
}
CRT_HD float power_heuristic(float pdf_f, float pdf_g) {
  const float f = 1.0f * pdf_f, g = 1.0f * pdf_g;
  return sqr(f) / clamp_min(sqr(f) + sqr(g), kTiny);
}

// ops/rng.py: the LCG on the low 32 bits of the state
CRT_HD float lcg_randomf(uint32_t* state) {
  *state = *state * 1664525u + 1013904223u;
  return F32(*state) * F32(2.3283064365386962890625e-10);  // 2**-32
}

// ops/texture.py
CRT_HD float srgb_to_linear(float f) {
  return f <= F32(0.04045) ? div_const(f, 12.92)
                           : powf(div_const(f + F32(0.055), 1.055), F32(2.4));
}

struct Quad {
  const uint8_t* row;
  float tx, ty;
  int flags;
};

// _quad_setup: the bilinear footprint of texture tex_id at uv
CRT_HD Quad quad_setup(const Scene& s, int tex_id, float u, float v) {
  tex_id = tex_id < 0 ? 0 : (tex_id > s.num_textures - 1 ? s.num_textures - 1 : tex_id);
  const int* rec = s.atlas_table + 4 * tex_id;
  const int off = rec[0], w = rec[1], h = rec[2];
  const float ux = u * F32(w) - F32(0.5);
  const float uy = v * F32(h) - F32(0.5);
  const int xi = static_cast<int>(ux), yi = static_cast<int>(uy);
  const int wm = w < 1 ? 1 : w, hm = h < 1 ? 1 : h;
  int x0 = xi % wm, y0 = yi % hm;  // torch.remainder: the sign of the divisor
  if (x0 != 0 && ((x0 < 0) != (wm < 0))) x0 += wm;
  if (y0 != 0 && ((y0 < 0) != (hm < 0))) y0 += hm;
  Quad q;
  q.row = s.atlas + 16 * static_cast<int64_t>(off + y0 * w + x0);
  q.tx = ux - floorf(ux);
  q.ty = uy - floorf(uy);
  q.flags = rec[3];
  return q;
}

CRT_HD float texel(const Quad& q, int k, bool srgb) {
  const float f = F32(q.row[k]) * F32(1.0 / 255.0);
  return srgb ? srgb_to_linear(f) : f;
}

CRT_HD float bilinear(const Quad& q, float p0, float p4, float p8, float p12) {
  return p0 * (1.0f - q.tx) * (1.0f - q.ty) + p4 * q.tx * (1.0f - q.ty) +
         p8 * (1.0f - q.tx) * q.ty + p12 * q.tx * q.ty;
}

CRT_HD uint32_t bits_of(float x) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(x);
#else
  uint32_t b;
  memcpy(&b, &x, 4);
  return b;
#endif
}

// textured_scalar_param
CRT_HD float textured_scalar(const Scene& s, float x, float u, float v) {
  const uint32_t b = bits_of(x);
  if (!(b & 0x80000000u)) return x;
  const Quad q = quad_setup(s, static_cast<int>(b & 0x1FFFFFFFu), u, v);
  const int c = static_cast<int>((b >> 29) & 0x3u);
  const bool srgb = (c == 3 ? (q.flags & 2) : (q.flags & 1)) != 0;
  return bilinear(q, texel(q, c, srgb), texel(q, 4 + c, srgb), texel(q, 8 + c, srgb),
                  texel(q, 12 + c, srgb));
}

// textured_color_param: the red slot may carry an all-channel handle
CRT_HD V3 textured_color(const Scene& s, V3 rgb, float u, float v) {
  const uint32_t b = bits_of(rgb.x);
  if (!(b & 0x80000000u)) return rgb;
  const Quad q = quad_setup(s, static_cast<int>(b & 0x1FFFFFFFu), u, v);
  const bool srgb = (q.flags & 1) != 0;
  float out[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    out[c] = bilinear(q, texel(q, c, srgb), texel(q, 4 + c, srgb), texel(q, 8 + c, srgb),
                      texel(q, 12 + c, srgb));
  return V3{out[0], out[1], out[2]};
}

// ops/bsdf.py MaterialBatch, one lane
struct Material {
  V3 base_color;
  float metallic, specular, roughness, specular_tint, anisotropy, sheen, sheen_tint, clearcoat,
      clearcoat_gloss, ior, specular_transmission;
};

// unpack_material_row: the packed record, texture handles resolved for the
// fields the scene textures
CRT_HD Material unpack_material(const Scene& s, const float* row, float u, float v) {
  V3 base = V3{row[0], row[1], row[2]};
  float f[11];
#pragma unroll
  for (int k = 0; k < 11; ++k) f[k] = row[3 + k];
  if (s.textured) {
    if (s.textured & 1) base = textured_color(s, base, u, v);
#pragma unroll
    for (int k = 0; k < 11; ++k)
      if (s.textured & (2 << k)) f[k] = textured_scalar(s, f[k], u, v);
  }
  return Material{base, f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9], f[10]};
}

CRT_HD bool same_hemisphere(V3 w_o, V3 w_i, V3 n) { return dot(w_o, n) * dot(w_i, n) > 0.0f; }

CRT_HD float schlick_weight(float cos_theta) {
  const float x = saturate(1.0f - cos_theta);
  const float x2 = x * x;
  return x2 * x2 * x;
}

CRT_HD float fresnel_dielectric(float cos_i, float eta_i, float eta_t) {
  const float g2 = sqr(eta_t) / clamp_min(sqr(eta_i), kTiny) - 1.0f + sqr(cos_i);
  if (g2 < 0.0f) return 1.0f;
  const float g = sqrtf(clamp_min(g2, 0.0f));
  float d1 = g + cos_i;
  if (fabsf(d1) < kTiny) d1 = 1.0f;
  float d2 = cos_i * (g - cos_i) + 1.0f;
  if (fabsf(d2) < kTiny) d2 = 1.0f;
  return F32(0.5) * sqr(g - cos_i) / sqr(d1) *
         (1.0f + sqr(cos_i * (g + cos_i) - 1.0f) / sqr(d2));
}

CRT_HD float gtr_1(float cos_theta_h, float alpha) {
  if (alpha >= 1.0f) return F32(k1Pi);
  const float a2 = sqr(alpha);
  float log_a = logf(clamp_min(a2, kTiny));
  if (log_a == 0.0f) log_a = 1.0f;
  return F32(k1Pi) * (a2 - 1.0f) / (log_a * (1.0f + (a2 - 1.0f) * sqr(cos_theta_h)));
}

CRT_HD float gtr_2(float cos_theta_h, float alpha) {
  const float a2 = sqr(alpha);
  return F32(k1Pi) * a2 / clamp_min(sqr(1.0f + (a2 - 1.0f) * sqr(cos_theta_h)), kTiny);
}

CRT_HD float gtr_2_aniso(float h_dot_n, float h_dot_x, float h_dot_y, float ax, float ay) {
  const float denom = ax * ay * sqr(sqr(h_dot_x / ax) + sqr(h_dot_y / ay) + sqr(h_dot_n));
  return rdiv(F32(k1Pi), clamp_min(denom, kTiny));
}

CRT_HD float smith_ggx(float n_dot_o, float alpha_g) {
  const float a = sqr(alpha_g), b = sqr(n_dot_o);
  return rdiv(1.0f, clamp_min(n_dot_o + sqrtf(clamp_min(a + b - a * b, 0.0f)), F32(1e-10)));
}

// smith_shadowing_ggx at alpha_g = 0.25 (the clearcoat's): a = 0.0625 exactly
CRT_HD float smith_ggx_quarter(float n_dot_o) {
  const float a = F32(0.0625), b = sqr(n_dot_o);
  return rdiv(1.0f, clamp_min(n_dot_o + sqrtf(clamp_min(a + b - a * b, 0.0f)), F32(1e-10)));
}

CRT_HD float smith_ggx_aniso(float n_dot_o, float o_dot_x, float o_dot_y, float ax, float ay) {
  return rdiv(1.0f, clamp_min(n_dot_o + sqrtf(clamp_min(sqr(o_dot_x * ax) + sqr(o_dot_y * ay) +
                                                             sqr(n_dot_o),
                                                         0.0f)),
                              F32(1e-10)));
}

CRT_HD V3 to_world(V3 h, V3 n, V3 v_x, V3 v_y) {
  return V3{h.x * v_x.x + h.y * v_y.x + h.z * n.x, h.x * v_x.y + h.y * v_y.y + h.z * n.y,
            h.x * v_x.z + h.y * v_y.z + h.z * n.z};
}

CRT_HD V3 cos_sample_hemisphere(float u0, float u1) {
  const float sx = 2.0f * u0 - 1.0f, sy = 2.0f * u1 - 1.0f;
  const bool use_x = fabsf(sx) > fabsf(sy);
  float radius, theta;
  if (use_x) {
    radius = sx;
    theta = F32(kPi / 4.0) * (sy / (sx == 0.0f ? 1.0f : sx));
  } else {
    radius = sy;
    theta = F32(kPi / 2.0) - F32(kPi / 4.0) * (sx / (sy == 0.0f ? 1.0f : sy));
  }
  if (sx == 0.0f && sy == 0.0f) radius = 0.0f;
  const float dx = radius * cosf(theta), dy = radius * sinf(theta);
  return V3{dx, dy, sqrtf(clamp_min(1.0f - dx * dx - dy * dy, 0.0f))};
}

CRT_HD V3 spherical_dir(float sin_t, float cos_t, float phi) {
  return V3{sin_t * cosf(phi), sin_t * sinf(phi), cos_t};
}

CRT_HD V3 sample_gtr_1_h(V3 n, V3 v_x, V3 v_y, float alpha, float s0, float s1) {
  const float phi = F32(2.0 * kPi) * s0;
  const float a2 = clamp_min(sqr(alpha), F32(1e-8));
  const float c2 = (1.0f - powf(a2, 1.0f - s1)) / (a2 == 1.0f ? 1.0f : 1.0f - a2);
  const float cos_t = sqrtf(clamp_min(c2, 0.0f)), sin_t = sqrtf(clamp_min(1.0f - c2, 0.0f));
  return to_world(normalize(spherical_dir(sin_t, cos_t, phi)), n, v_x, v_y);
}

CRT_HD V3 sample_gtr_2_h(V3 n, V3 v_x, V3 v_y, float alpha, float s0, float s1) {
  const float phi = F32(2.0 * kPi) * s0;
  const float c2 = (1.0f - s1) / clamp_min(1.0f + (sqr(alpha) - 1.0f) * s1, kTiny);
  const float cos_t = sqrtf(clamp_min(c2, 0.0f)), sin_t = sqrtf(clamp_min(1.0f - c2, 0.0f));
  return to_world(normalize(spherical_dir(sin_t, cos_t, phi)), n, v_x, v_y);
}

CRT_HD V3 sample_gtr_2_aniso_h(V3 n, V3 v_x, V3 v_y, float ax, float ay, float s0, float s1) {
  const float x = F32(2.0 * kPi) * s0;
  const float sc = sqrtf(s1 / clamp_min(1.0f - s1, kTiny));
  const float cx = ax * cosf(x), sy = ay * sinf(x);
  return normalize(V3{sc * (cx * v_x.x + sy * v_y.x) + n.x, sc * (cx * v_x.y + sy * v_y.y) + n.y,
                      sc * (cx * v_x.z + sy * v_y.z) + n.z});
}

// the shared shape of the half-vector pdfs, at w_h = normalize(w_i + w_o)
// and its d = D(n . w_h); the caller applies same_hemisphere
CRT_HD float half_vector_pdf(V3 w_o, V3 w_h, float d, float cos_theta_h) {
  float o_dot_h = dot(w_o, w_h);
  if (fabsf(o_dot_h) < F32(1e-10)) o_dot_h = F32(1e-10);
  return d * cos_theta_h / (4.0f * o_dot_h);
}

CRT_HD void aniso_alphas(const Material& m, float a, float* ax, float* ay) {
  const float aspect = sqrtf(clamp_min(1.0f - m.anisotropy * F32(0.9), F32(1e-8)));
  *ax = clamp_min(a / aspect, kAlphaMin);
  *ay = clamp_min(a * aspect, kAlphaMin);
}

CRT_HD float clearcoat_alpha(const Material& m) {
  return lerp(F32(0.1), F32(0.001), m.clearcoat_gloss);
}

CRT_HD V3 tint(const Material& m) {
  const float lum = luminance(m.base_color);
  if (!(lum > 0.0f)) return V3{1.0f, 1.0f, 1.0f};
  const float l = clamp_min(lum, kTiny);
  return V3{m.base_color.x / l, m.base_color.y / l, m.base_color.z / l};
}

CRT_HD float gtr_2_transmission_pdf(V3 w_o, V3 w_i, V3 n, float alpha, float ior) {
  if (same_hemisphere(w_o, w_i, n)) return 0.0f;
  const bool entering = dot(w_o, n) > 0.0f;
  const float eta_o = entering ? 1.0f : ior, eta_i = entering ? ior : 1.0f;
  const float r = eta_i / eta_o;
  const V3 w_h = normalize(V3{w_o.x + w_i.x * r, w_o.y + w_i.y * r, w_o.z + w_i.z * r});
  const float cos_theta_h = fabsf(dot(n, w_h));
  const float i_dot_h = dot(w_i, w_h), o_dot_h = dot(w_o, w_h);
  const float d = gtr_2(cos_theta_h, alpha);
  const float denom = sqr(eta_o * o_dot_h + eta_i * i_dot_h);
  const float dwh_dwi = o_dot_h * sqr(eta_o) / clamp_min(denom, kTiny);
  return d * cos_theta_h * fabsf(dwh_dwi);
}

// disney_pdf: the mixture pdf over the sampled components
CRT_HD float disney_pdf(const Material& m, V3 n, V3 w_o, V3 w_i, V3 v_x, V3 v_y) {
  const float alpha = clamp_min(sqr(m.roughness), kAlphaMin);
  const bool has_trans = m.specular_transmission > 0.0f;
  const float wi_n = dot(w_i, n);
  const float diffuse = wi_n > 0.0f ? wi_n * F32(k1Pi) : 0.0f;
  float clear_coat = 0.0f, microfacet = 0.0f;
  if (same_hemisphere(w_o, w_i, n)) {
    const V3 w_h = normalize(add(w_i, w_o));
    const float cos_theta_h = dot(n, w_h);
    clear_coat = half_vector_pdf(w_o, w_h, gtr_1(cos_theta_h, clearcoat_alpha(m)), cos_theta_h);
    float d;
    if (m.anisotropy == 0.0f) {
      d = gtr_2(cos_theta_h, alpha);
    } else {
      float ax, ay;
      aniso_alphas(m, alpha, &ax, &ay);
      d = gtr_2_aniso(cos_theta_h, fabsf(dot(w_h, v_x)), fabsf(dot(w_h, v_y)), ax, ay);
    }
    microfacet = half_vector_pdf(w_o, w_h, d, cos_theta_h);
  }
  const float micro_trans = has_trans ? gtr_2_transmission_pdf(w_o, w_i, n, alpha, m.ior) : 0.0f;
  return (diffuse + microfacet + micro_trans + clear_coat) / (has_trans ? 4.0f : 3.0f);
}

CRT_HD V3 specular_color(const Material& m) {
  const V3 t = tint(m);
  const float s = m.specular * F32(0.08);
  const V3 c{s * lerp(1.0f, t.x, m.specular_tint), s * lerp(1.0f, t.y, m.specular_tint),
             s * lerp(1.0f, t.z, m.specular_tint)};
  return V3{lerp(c.x, m.base_color.x, m.metallic), lerp(c.y, m.base_color.y, m.metallic),
            lerp(c.z, m.base_color.z, m.metallic)};
}

// disney_microfacet_transmission_isotropic
CRT_HD V3 microfacet_transmission(const Material& m, V3 n, V3 w_o, V3 w_i) {
  const float o_dot_n = dot(w_o, n), i_dot_n = dot(w_i, n);
  if (o_dot_n == 0.0f || i_dot_n == 0.0f) return zero3();
  const bool entering = o_dot_n > 0.0f;
  const float eta_o = entering ? 1.0f : m.ior, eta_i = entering ? m.ior : 1.0f;
  const float r = eta_i / eta_o;
  const V3 w_h = normalize(V3{w_o.x + w_i.x * r, w_o.y + w_i.y * r, w_o.z + w_i.z * r});
  const float alpha = clamp_min(sqr(m.roughness), kAlphaMin);
  const float d = gtr_2(fabsf(dot(n, w_h)), alpha);
  const float f = fresnel_dielectric(fabsf(dot(w_i, n)), eta_o, eta_i);
  const float g = smith_ggx(fabsf(dot(n, w_i)), alpha) * smith_ggx(fabsf(dot(n, w_o)), alpha);
  const float i_dot_h = dot(w_i, w_h), o_dot_h = dot(w_o, w_h);
  const float c = fabsf(o_dot_h) / clamp_min(fabsf(o_dot_n), F32(1e-10)) * fabsf(i_dot_h) /
                  clamp_min(fabsf(i_dot_n), F32(1e-10)) * sqr(eta_o) /
                  clamp_min(sqr(eta_o * o_dot_h + eta_i * i_dot_h), kTiny);
  const float k = c * (1.0f - f) * g * d;
  return scale(m.base_color, k);
}

// disney_brdf: the reflection lobes where w_o and w_i share a hemisphere,
// else transmission
CRT_HD V3 disney_brdf(const Material& m, V3 n, V3 w_o, V3 w_i, V3 v_x, V3 v_y) {
  if (!same_hemisphere(w_o, w_i, n)) {
    if (!(m.specular_transmission > 0.0f)) return zero3();
    return scale(microfacet_transmission(m, n, w_o, w_i),
                 (1.0f - m.metallic) * m.specular_transmission);
  }
  const V3 w_h = normalize(add(w_i, w_o));
  const float n_dot_wh = dot(n, w_h), i_dot_h = dot(w_i, w_h);
  const float n_dot_i = dot(n, w_i), n_dot_o = dot(n, w_o);
  const float schlick_ih = schlick_weight(i_dot_h);
  const float schlick_in = schlick_weight(n_dot_i);  // dot(w_i, n)

  // disney_clear_coat
  const float coat = F32(0.25) * m.clearcoat * gtr_1(n_dot_wh, clearcoat_alpha(m)) *
                     lerp(F32(0.04), 1.0f, schlick_in) * (smith_ggx_quarter(n_dot_i) *
                                                          smith_ggx_quarter(n_dot_o));
  // disney_sheen
  const V3 t = tint(m);
  const float fs = schlick_in * m.sheen;
  const V3 sheen{fs * lerp(1.0f, t.x, m.sheen_tint), fs * lerp(1.0f, t.y, m.sheen_tint),
                 fs * lerp(1.0f, t.z, m.sheen_tint)};
  // disney_diffuse
  const float fd90 = F32(0.5) + 2.0f * m.roughness * sqr(i_dot_h);
  const float kd = F32(k1Pi) * lerp(1.0f, fd90, schlick_weight(fabsf(n_dot_i))) *
                   lerp(1.0f, fd90, schlick_weight(fabsf(n_dot_o)));
  const V3 diffuse = scale(m.base_color, kd);
  // disney_microfacet_isotropic / _anisotropic
  const V3 spec = specular_color(m);
  float dg;
  if (m.anisotropy == 0.0f) {
    const float alpha = clamp_min(sqr(m.roughness), kAlphaMin);
    dg = gtr_2(n_dot_wh, alpha) * (smith_ggx(n_dot_i, alpha) * smith_ggx(n_dot_o, alpha));
  } else {
    float ax, ay;
    aniso_alphas(m, sqr(m.roughness), &ax, &ay);
    const float d = gtr_2_aniso(n_dot_wh, fabsf(dot(w_h, v_x)), fabsf(dot(w_h, v_y)), ax, ay);
    dg = d * (smith_ggx_aniso(n_dot_i, fabsf(dot(w_i, v_x)), fabsf(dot(w_i, v_y)), ax, ay) *
              smith_ggx_aniso(n_dot_o, fabsf(dot(w_o, v_x)), fabsf(dot(w_o, v_y)), ax, ay));
  }
  const V3 gloss{dg * lerp(spec.x, 1.0f, schlick_ih), dg * lerp(spec.y, 1.0f, schlick_ih),
                 dg * lerp(spec.z, 1.0f, schlick_ih)};
  const float kr = (1.0f - m.metallic) * (1.0f - m.specular_transmission);
  return V3{(diffuse.x + sheen.x) * kr + gloss.x + coat, (diffuse.y + sheen.y) * kr + gloss.y + coat,
            (diffuse.z + sheen.z) * kr + gloss.z + coat};
}

struct Sample {
  V3 f, w_i;
  float pdf;
};

// sample_disney_brdf: one component drawn, its direction alone computed;
// an invalid sample gives f = 0, w_i = 0, pdf = 0
CRT_HD Sample sample_disney_brdf(const Material& m, V3 n, V3 w_o, V3 v_x, V3 v_y,
                                 uint32_t* state) {
  const bool has_trans = m.specular_transmission > 0.0f;
  const float u_comp = lcg_randomf(state);
  int component = static_cast<int>(u_comp * (has_trans ? 4.0f : 3.0f));
  component = component < 0 ? 0 : component;
  component = component < (has_trans ? 3 : 2) ? component : (has_trans ? 3 : 2);
  const float s0 = lcg_randomf(state);
  const float s1 = lcg_randomf(state);
  const float alpha = clamp_min(sqr(m.roughness), kAlphaMin);
  const V3 in = neg(w_o);
  V3 w_i;
  bool valid;
  if (component == 0) {
    w_i = to_world(normalize(cos_sample_hemisphere(s0, s1)), n, v_x, v_y);
    valid = true;
  } else if (component == 1) {
    V3 w_h;
    if (m.anisotropy == 0.0f) {
      w_h = sample_gtr_2_h(n, v_x, v_y, alpha, s0, s1);
    } else {
      float ax, ay;
      aniso_alphas(m, alpha, &ax, &ay);
      w_h = sample_gtr_2_aniso_h(n, v_x, v_y, ax, ay, s0, s1);
    }
    w_i = reflect(in, w_h);
    valid = same_hemisphere(w_o, w_i, n);
  } else if (component == 2) {
    w_i = reflect(in, sample_gtr_1_h(n, v_x, v_y, clearcoat_alpha(m), s0, s1));
    valid = same_hemisphere(w_o, w_i, n);
  } else {
    V3 w_h = sample_gtr_2_h(n, v_x, v_y, alpha, s0, s1);
    if (dot(w_o, w_h) < 0.0f) w_h = neg(w_h);
    const float eta = dot(w_o, n) > 0.0f ? rdiv(1.0f, m.ior) : m.ior;
    w_i = refract(in, w_h, eta);
    valid = dot(w_i, w_i) > 0.0f;
  }
  if (!valid) return Sample{zero3(), zero3(), 0.0f};
  return Sample{disney_brdf(m, n, w_o, w_i, v_x, v_y), w_i,
                disney_pdf(m, n, w_o, w_i, v_x, v_y)};
}

struct Light {
  V3 emission, position, normal, v_x, v_y;
  float width, height;
};

CRT_HD Light load_light(const Scene& s, int k) {
  return Light{load3(s.emission + 3 * k), load3(s.position + 3 * k), load3(s.normal + 3 * k),
               load3(s.v_x + 3 * k), load3(s.v_y + 3 * k), s.width[k], s.height[k]};
}

// quad_light_pdf, with the reference's `p - dir` distance
CRT_HD float quad_light_pdf(const Light& l, V3 p, V3 dir) {
  const float area = l.width * l.height;
  const V3 to_pt = sub(p, dir);
  const float n_dot_w = dot(l.normal, neg(dir));
  if (n_dot_w < kEps) return 0.0f;
  return dot(to_pt, to_pt) / clamp_min(n_dot_w * area, kTiny);
}

// the shading of lane i (_shade_bounce)
CRT_HD void shade_lane(const Scene& s, const Lanes& l, int bounce, int i) {
  const V3 dir = load3(l.dir + 3 * i);
  const V3 w_o = neg(dir);
  const V3 hit_p = load3(l.hit_p + 3 * i);
  const bool active = l.active[i] != 0;
  uint32_t state = static_cast<uint32_t>(l.state[i]);

  // the hit's frame and material
  int tri = l.hit_tri[i];
  const int t_hi = s.num_tris - 1 > 0 ? s.num_tris - 1 : 0;
  tri = tri < 0 ? 0 : (tri > t_hi ? t_hi : tri);
  float row[32];
  {
    const float4* row4 = reinterpret_cast<const float4*>(s.shade_rows + 32 * static_cast<int64_t>(tri));
#pragma unroll
    for (int q = 0; q < 8; ++q) {
#ifdef __CUDA_ARCH__
      const float4 x = __ldg(row4 + q);
#else
      const float4 x = row4[q];
#endif
      row[4 * q] = x.x; row[4 * q + 1] = x.y; row[4 * q + 2] = x.z; row[4 * q + 3] = x.w;
    }
  }
  const V3 ng_obj = cross(V3{row[0], row[1], row[2]}, V3{row[3], row[4], row[5]});
  const float w = l.hit_u[i], wv = l.hit_v[i];
  const float b0 = 1.0f - w - wv;
  const float u = b0 * row[6] + w * row[8] + wv * row[10];
  const float v = b0 * row[7] + w * row[9] + wv * row[11];
  const float* inv;
  Material m;
  if (s.num_instances == 1) {
    inv = s.inst_inv;
    m = unpack_material(s, row + 16, u, v);
  } else {
    int inst = l.hit_inst[i];
    inst = inst < 0 ? 0 : (inst > s.num_instances - 1 ? s.num_instances - 1 : inst);
    inv = s.inst_inv + 16 * inst;
    int geom_slot;
    memcpy(&geom_slot, row + 12, 4);
    int mat_id = s.inst_mat_table[static_cast<int64_t>(inst) * s.g_max + geom_slot];
    mat_id = mat_id < 0 ? 0 : (mat_id > s.num_mats - 1 ? s.num_mats - 1 : mat_id);
    m = unpack_material(s, s.mat_rows + 16 * static_cast<int64_t>(mat_id), u, v);
  }
  // world normal = ng_obj @ inv3, term by term
  const V3 normal = normalize(V3{ng_obj.x * inv[0] + ng_obj.y * inv[4] + ng_obj.z * inv[8],
                                 ng_obj.x * inv[1] + ng_obj.y * inv[5] + ng_obj.z * inv[9],
                                 ng_obj.x * inv[2] + ng_obj.y * inv[6] + ng_obj.z * inv[10]});
  // face-forward for non-transmissive materials
  const V3 n = (m.specular_transmission == 0.0f && dot(w_o, normal) < 0.0f) ? neg(normal) : normal;
  V3 v_x, v_y;
  ortho_basis(n, &v_x, &v_y);

  // next-event estimation with MIS over {light sample, bsdf sample}
  const float u_l = lcg_randomf(&state);
  int light_id = 0;
  if (s.num_lights != 1) {
    const int64_t k = static_cast<int64_t>(u_l * F32(s.num_lights));
    light_id = static_cast<int>(k < s.num_lights - 1 ? k : s.num_lights - 1);
  }
  const Light lt = load_light(s, light_id);

  // light-sampling branch
  const float s20 = lcg_randomf(&state);
  const float s21 = lcg_randomf(&state);
  const V3 light_pos{s20 * lt.v_x.x * lt.width + s21 * lt.v_y.x * lt.height + lt.position.x,
                     s20 * lt.v_x.y * lt.width + s21 * lt.v_y.y * lt.height + lt.position.y,
                     s20 * lt.v_x.z * lt.width + s21 * lt.v_y.z * lt.height + lt.position.z};
  const V3 to_light = sub(light_pos, hit_p);
  const float light_dist = length(to_light);
  const V3 light_dir = normalize(to_light);
  const float light_pdf = quad_light_pdf(lt, light_pos, light_dir);
  const float b_pdf = disney_pdf(m, n, w_o, light_dir, v_x, v_y);

  // bsdf-sampling branch
  const Sample b = sample_disney_brdf(m, n, w_o, v_x, v_y, &state);
  // quad_intersect of the light along the bsdf sample
  const float denom = dot(b.w_i, lt.normal);
  const float t_light = dot(sub(lt.position, hit_p), lt.normal) / (denom == 0.0f ? 1.0f : denom);
  const V3 light_pos2 = add(hit_p, scale(b.w_i, t_light));
  const V3 hit_v = sub(light_pos2, lt.position);
  const bool qhit = denom != 0.0f && t_light >= 0.0f && fabsf(dot(hit_v, lt.v_x)) < lt.width &&
                    fabsf(dot(hit_v, lt.v_y)) < lt.height;
  const float light_pdf2 = quad_light_pdf(lt, light_pos2, b.w_i);
  const bool shoot2 = active && nonzero(b.f) && b.pdf >= kEps && qhit && light_pdf2 >= kEps;
  // a provably zero MIS weight skips the shadow ray
  const bool shoot1 = active && light_pdf >= kEps && b_pdf >= kEps;

  const V3 f1 = disney_brdf(m, n, w_o, light_dir, v_x, v_y);
  const float k1 = power_heuristic(light_pdf, b_pdf) / clamp_min(light_pdf, kTiny);
  const float a1 = fabsf(dot(light_dir, n));
  const V3 c1 = scale(scale(mul(f1, lt.emission), a1), k1);
  const float k2 = power_heuristic(b.pdf, light_pdf2) / clamp_min(b.pdf, kTiny);
  const float a2 = fabsf(dot(b.w_i, n));
  const V3 c2 = scale(scale(mul(b.f, lt.emission), a2), k2);

  // continuation
  const Sample c = sample_disney_brdf(m, n, w_o, v_x, v_y, &state);
  const bool cont_ok = c.pdf != 0.0f && nonzero(c.f);
  const V3 tp = load3(l.throughput + 3 * i);
  V3 new_tp = tp;
  if (active) new_tp = scale(mul(tp, c.f), fabsf(dot(c.w_i, n)) / (c.pdf == 0.0f ? 1.0f : c.pdf));
  bool new_active = active && cont_ok;

  // Russian roulette after bounce 3
  if (bounce + 1 > 3) {
    const float u_rr = lcg_randomf(&state);
    const float q = clamp_min(1.0f - nan_max(nan_max(new_tp.x, new_tp.y), new_tp.z), F32(0.05));
    new_active = new_active && !(u_rr < q);
    if (new_active) {
      const float keep = clamp_min(1.0f - q, F32(1e-6));
      new_tp = V3{new_tp.x / keep, new_tp.y / keep, new_tp.z / keep};
    }
  }

  l.state_out[i] = static_cast<int64_t>(state);
  store3(l.c1 + 3 * i, c1);
  store3(l.c2 + 3 * i, c2);
  l.shoot1[i] = shoot1;
  store3(l.light_dir + 3 * i, light_dir);
  l.light_dist[i] = light_dist;
  l.shoot2[i] = shoot2;
  store3(l.w_i2 + 3 * i, b.w_i);
  l.t_light[i] = t_light;
  store3(l.new_tp + 3 * i, new_tp);
  store3(l.cont_dir + 3 * i, c.w_i);
  l.new_active[i] = new_active;
}

#undef CRT_HD

}  // namespace shade
}  // namespace crt
