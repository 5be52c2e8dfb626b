// Device helpers shared by the traversal kernels (traverse_flat.cu: B1, B2;
// traverse_unified.cu: B3, B4; traverse_stream.cu: B5a, B5b, B5c, B5d).
//
// Semantics shared with the plain torch version
// (chameleonrt_tpu_torch/ops/traverse.py):
//   - node rows (n, 32) f32: child c's box at [6c, 6c+6), child codes at
//     [24, 28) (bitcast int32; code < 0 is leaf -(code+1)); empty slots
//     have lo = hi = 1e30 and never pass the slab test;
//   - leaf rows (n_leaves, 10L) f32, component-major v0 e1 e2 prim;
//   - hit children are sorted by entry distance with the Bose-Nelson
//     network (strict >), the nearest is visited next and the others are
//     pushed far-first; a push onto a full stack (depth - 1 entries) is an
//     overflow;
//   - Moller-Trumbore with det eps 1e-9 and barycentric band 4e-6.
// Every file is built with -fmad=false so every product and sum rounds as
// in the plain version.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace crt {

constexpr int kArity = 4;
constexpr int kRow = 8 * kArity;  // floats per node row
constexpr int kMaxStack = 64;     // _build.MAX_STACK
constexpr int kMaxLeaf = 16;      // _build.MAX_LEAF
constexpr int kThreads = 128;
constexpr int kDone = 0x7FFFFFFF;
constexpr float kTMax = 1e20f;
constexpr float kBig = 1e30f;
constexpr float kMtEps = 1e-9f;
constexpr float kUvEps = 4e-6f;
constexpr float kOnePlusUvEps = 1.0f + 4e-6f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tmin;
};

// min / max that treat a NaN operand as an unbounded slab side, as the
// oracle's NaN-propagating minimum followed by NaN -> -inf / +inf does.
__device__ __forceinline__ float near_of(float a, float b) {
  return (isnan(a) || isnan(b)) ? -INFINITY : fminf(a, b);
}
__device__ __forceinline__ float far_of(float a, float b) {
  return (isnan(a) || isnan(b)) ? INFINITY : fmaxf(a, b);
}

template <typename K, typename C>
__device__ __forceinline__ void cswap(K* k, C* c, int i, int j) {
  if (k[i] > k[j]) {
    K tk = k[i]; k[i] = k[j]; k[j] = tk;
    C tc = c[i]; c[i] = c[j]; c[j] = tc;
  }
}

// One node row into registers, 16 bytes a load.
__device__ __forceinline__ void load_row(const float* __restrict__ nodes, int cur, float* row) {
  const float4* row4 = reinterpret_cast<const float4*>(nodes + (size_t)cur * kRow);
#pragma unroll
  for (int q = 0; q < kRow / 4; ++q) {
    float4 x = __ldg(row4 + q);
    row[4 * q] = x.x; row[4 * q + 1] = x.y; row[4 * q + 2] = x.z; row[4 * q + 3] = x.w;
  }
}

// Slab test of the four children of a row already in registers or shared
// memory against one ray: keys[c] = entry distance of child c, kBig on a
// miss; codes[c] its child code. Unsorted.
__device__ __forceinline__ void slab_children(const float* row, const Ray& r, float tmax,
                                              float* keys, int* codes) {
#pragma unroll
  for (int c = 0; c < kArity; ++c) {
    const float* b = row + 6 * c;
    float tx0 = (b[0] - r.ox) * r.ix, tx1 = (b[3] - r.ox) * r.ix;
    float ty0 = (b[1] - r.oy) * r.iy, ty1 = (b[4] - r.oy) * r.iy;
    float tz0 = (b[2] - r.oz) * r.iz, tz1 = (b[5] - r.oz) * r.iz;
    float entry = fmaxf(fmaxf(near_of(tx0, tx1), near_of(ty0, ty1)),
                        fmaxf(near_of(tz0, tz1), r.tmin));
    float exit_ = fminf(fminf(far_of(tx0, tx1), far_of(ty0, ty1)),
                        fminf(far_of(tz0, tz1), tmax));
    keys[c] = (entry <= exit_) ? entry : kBig;
    codes[c] = __float_as_int(row[6 * kArity + c]);
  }
}

// The plain version's Bose-Nelson network (_SORT_NETS[4]): (keys, codes)
// ascending by key.
template <typename K, typename C>
__device__ __forceinline__ void sort_children(K* keys, C* codes) {
  cswap(keys, codes, 0, 1);
  cswap(keys, codes, 2, 3);
  cswap(keys, codes, 0, 2);
  cswap(keys, codes, 1, 3);
  cswap(keys, codes, 1, 2);
}

// One internal row: keys[c] = entry distance of hit child c (kBig on a
// miss), codes[c] its child code, both sorted ascending by key.
__device__ __forceinline__ void node_step(const float* __restrict__ nodes, int cur,
                                          const Ray& r, float tmax, float* keys,
                                          int* codes) {
  float row[kRow];
  load_row(nodes, cur, row);
  slab_children(row, r, tmax, keys, codes);
  sort_children(keys, codes);
}

// One triangle slot of a leaf row: v0, e1, e2 and the prim id.
struct Tri {
  float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
  int prim;
};

// Slot j of a component-major leaf row in device memory (read-only path).
__device__ __forceinline__ Tri load_tri(const float* __restrict__ lrow, int L, int j) {
  Tri s;
  s.v0x = __ldg(lrow + 0 * L + j); s.v0y = __ldg(lrow + 1 * L + j); s.v0z = __ldg(lrow + 2 * L + j);
  s.e1x = __ldg(lrow + 3 * L + j); s.e1y = __ldg(lrow + 4 * L + j); s.e1z = __ldg(lrow + 5 * L + j);
  s.e2x = __ldg(lrow + 6 * L + j); s.e2y = __ldg(lrow + 7 * L + j); s.e2z = __ldg(lrow + 8 * L + j);
  s.prim = __float_as_int(__ldg(lrow + 9 * L + j));
  return s;
}

// Slot j of a component-major leaf row already in shared memory.
__device__ __forceinline__ Tri shared_tri(const float* lrow, int L, int j) {
  Tri s;
  s.v0x = lrow[0 * L + j]; s.v0y = lrow[1 * L + j]; s.v0z = lrow[2 * L + j];
  s.e1x = lrow[3 * L + j]; s.e1y = lrow[4 * L + j]; s.e1z = lrow[5 * L + j];
  s.e2x = lrow[6 * L + j]; s.e2y = lrow[7 * L + j]; s.e2z = lrow[8 * L + j];
  s.prim = __float_as_int(lrow[9 * L + j]);
  return s;
}

// Moller-Trumbore for one slot; the operation order is the plain
// version's, term by term.
__device__ __forceinline__ bool mt_tri(const Tri& s, const Ray& r, float tmax, float* t_out,
                                       float* u_out, float* v_out, int* prim_out) {
  const float v0x = s.v0x, v0y = s.v0y, v0z = s.v0z;
  const float e1x = s.e1x, e1y = s.e1y, e1z = s.e1z;
  const float e2x = s.e2x, e2y = s.e2y, e2z = s.e2z;
  const int prim = s.prim;
  float px = r.dy * e2z - r.dz * e2y;
  float py = r.dz * e2x - r.dx * e2z;
  float pz = r.dx * e2y - r.dy * e2x;
  float det = e1x * px + e1y * py + e1z * pz;
  bool small = fabsf(det) < kMtEps;
  float inv = 1.0f / (small ? 1.0f : det);
  float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  float u = (tx * px + ty * py + tz * pz) * inv;
  float qx = ty * e1z - tz * e1y;
  float qy = tz * e1x - tx * e1z;
  float qz = tx * e1y - ty * e1x;
  float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
  float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  *t_out = t; *u_out = u; *v_out = v; *prim_out = prim;
  return !small && prim >= 0 && u >= -kUvEps && v >= -kUvEps && u + v <= kOnePlusUvEps &&
         t > r.tmin && t < tmax;
}

// Moller-Trumbore for slot j of one leaf row in device memory.
__device__ __forceinline__ bool mt_slot(const float* __restrict__ lrow, int L, int j,
                                        const Ray& r, float tmax, float* t_out,
                                        float* u_out, float* v_out, int* prim_out) {
  return mt_tri(load_tri(lrow, L, j), r, tmax, t_out, u_out, v_out, prim_out);
}

// Two-level tables (B3, B4, B5c, B5d): an instance-entry row holds the 3x4
// world-to-object matrix at cols 0-11 (row-major), the BLAS root row at
// col 12 and the instance id at col 13 (both bitcast int32).
constexpr int kEntryCols = 14;

// The object-space ray of an instance: the world ray w through the matrix
// m (an entry row's cols 0-11, in registers or shared memory), each sum
// left to right as in the plain version. Directions are not renormalized,
// so object t is world t.
__device__ __forceinline__ Ray enter_instance(const float* m, const Ray& w) {
  Ray r;
  r.ox = m[0] * w.ox + m[1] * w.oy + m[2] * w.oz + m[3];
  r.oy = m[4] * w.ox + m[5] * w.oy + m[6] * w.oz + m[7];
  r.oz = m[8] * w.ox + m[9] * w.oy + m[10] * w.oz + m[11];
  r.dx = m[0] * w.dx + m[1] * w.dy + m[2] * w.dz;
  r.dy = m[4] * w.dx + m[5] * w.dy + m[6] * w.dz;
  r.dz = m[8] * w.dx + m[9] * w.dy + m[10] * w.dz;
  r.ix = 1.0f / r.dx; r.iy = 1.0f / r.dy; r.iz = 1.0f / r.dz;
  r.tmin = w.tmin;
  return r;
}

// True where the walk at `cur` runs in world space: a TLAS row or an
// instance-entry leaf (or the end, where it does not matter). Whenever the
// next step is such a row, the world ray comes back: the stack is LIFO, so
// an instance's BLAS entries all pop before the TLAS entries beneath them.
__device__ __forceinline__ bool in_world(int cur, int n_tri, int tlas_lo) {
  return cur >= tlas_lo || (cur < 0 && -cur - 1 >= n_tri);
}

__device__ __forceinline__ Ray load_ray(const float* orig, const float* dir,
                                        const float* t_min, int i) {
  Ray r;
  r.ox = orig[3 * i]; r.oy = orig[3 * i + 1]; r.oz = orig[3 * i + 2];
  r.dx = dir[3 * i]; r.dy = dir[3 * i + 1]; r.dz = dir[3 * i + 2];
  r.ix = 1.0f / r.dx; r.iy = 1.0f / r.dy; r.iz = 1.0f / r.dz;
  r.tmin = t_min[i];
  return r;
}

}  // namespace crt
