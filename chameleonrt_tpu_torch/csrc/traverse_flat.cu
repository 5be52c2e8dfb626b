// Flat BVH traversal kernels for Hopper (sm_90a): B1 closest hit, B2 any hit.
//
// Replaces the Pallas slot-lane kernels of chameleonrt_tpu/ops/traverse_slotlane.py
// (_make_slotlane_kernel, unified=False, stream=False): B1 = the closest-hit
// variant reached through _closest_call_slotlane / traverse_closest_slotlane,
// B2 = the any-hit variant reached through _any_call_slotlane /
// traverse_any_slotlane. The slot-lane kernel's deferred leaf FIFO, group
// barrier and VMEM gates exist for the TPU's lockstep vector unit and are
// not carried over: here one thread walks one ray, depth first, visiting
// leaves as it meets them. That is the per-lane order of the XLA oracle
// chameleonrt_tpu/ops/traverse.py:traverse_closest/traverse_any and of the
// plain torch version chameleonrt_tpu_torch/ops/traverse.py, which the
// kernels are held against.
//
// Semantics shared with the plain version:
//   - node rows (n, 32) f32: child c's box at [6c, 6c+6), child codes at
//     [24, 28) (bitcast int32; code < 0 is leaf -(code+1)); empty slots
//     have lo = hi = 1e30 and never pass the slab test;
//   - leaf rows (n_leaves, 10L) f32, component-major v0 e1 e2 prim;
//   - hit children are sorted by entry distance with the Bose-Nelson
//     network (strict >), the nearest is visited next and the others are
//     pushed far-first; a push onto a full stack (depth - 1 entries) is an
//     overflow: B1 reports prim = -2, t = 1e20; B2 reports occluded;
//   - Moller-Trumbore with det eps 1e-9 and barycentric band 4e-6; B1
//     keeps a hit on t < best (ties inside a leaf go to the highest slot);
//     B2 stops at the first t_min < t < t_max;
//   - a miss or inactive lane is (1e20, -1, 0, 0); B2 writes occluded & mask.
// Built with -fmad=false so every product and sum rounds as in the plain
// version and t agrees bit for bit.
//
// What bounds it on the H100: dependent row fetches. Each step of a ray
// waits on one 128-byte node row or one 160-byte leaf row whose address
// came from the previous fetch, so the kernel is latency bound; the hall's
// tables (224K triangles, a few MB) stay resident in the 50 MB L2, so the
// fetches are L2 hits, not HBM traffic. Rays diverge inside a warp, so a
// warp pays the union of its rays' steps.
// Later work: warp-coherent packets (one row fetch shared by a warp on
// the sorted wavefront), FMA contraction, persistent threads pulling rays
// from an atomic counter, and the stack in shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kArity = 4;
constexpr int kRow = 8 * kArity;  // floats per node row
constexpr int kMaxStack = 64;
constexpr int kMaxLeaf = 16;
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

__device__ __forceinline__ void cswap(float* k, int* c, int i, int j) {
  if (k[i] > k[j]) {
    float tk = k[i]; k[i] = k[j]; k[j] = tk;
    int tc = c[i]; c[i] = c[j]; c[j] = tc;
  }
}

// One internal row: keys[c] = entry distance of hit child c (kBig on a
// miss), codes[c] its child code, both sorted ascending by key.
__device__ __forceinline__ void node_step(const float* __restrict__ nodes, int cur,
                                          const Ray& r, float tmax, float* keys,
                                          int* codes) {
  const float4* row4 = reinterpret_cast<const float4*>(nodes + (size_t)cur * kRow);
  float row[kRow];
#pragma unroll
  for (int q = 0; q < kRow / 4; ++q) {
    float4 x = __ldg(row4 + q);
    row[4 * q] = x.x; row[4 * q + 1] = x.y; row[4 * q + 2] = x.z; row[4 * q + 3] = x.w;
  }
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
  cswap(keys, codes, 0, 1);
  cswap(keys, codes, 2, 3);
  cswap(keys, codes, 0, 2);
  cswap(keys, codes, 1, 3);
  cswap(keys, codes, 1, 2);
}

// Moller-Trumbore for slot j of one leaf row; the operation order is the
// plain version's, term by term.
__device__ __forceinline__ bool mt_slot(const float* __restrict__ lrow, int L, int j,
                                        const Ray& r, float tmax, float* t_out,
                                        float* u_out, float* v_out, int* prim_out) {
  float v0x = __ldg(lrow + 0 * L + j), v0y = __ldg(lrow + 1 * L + j), v0z = __ldg(lrow + 2 * L + j);
  float e1x = __ldg(lrow + 3 * L + j), e1y = __ldg(lrow + 4 * L + j), e1z = __ldg(lrow + 5 * L + j);
  float e2x = __ldg(lrow + 6 * L + j), e2y = __ldg(lrow + 7 * L + j), e2z = __ldg(lrow + 8 * L + j);
  int prim = __float_as_int(__ldg(lrow + 9 * L + j));
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

__device__ __forceinline__ Ray load_ray(const float* orig, const float* dir,
                                        const float* t_min, int i) {
  Ray r;
  r.ox = orig[3 * i]; r.oy = orig[3 * i + 1]; r.oz = orig[3 * i + 2];
  r.dx = dir[3 * i]; r.dy = dir[3 * i + 1]; r.dz = dir[3 * i + 2];
  r.ix = 1.0f / r.dx; r.iy = 1.0f / r.dy; r.iz = 1.0f / r.dz;
  r.tmin = t_min[i];
  return r;
}

__global__ void __launch_bounds__(kThreads)
closest_kernel(const float* __restrict__ nodes, const float* __restrict__ leaf_rows,
               int n_leaves, int L, int depth, const float* __restrict__ orig,
               const float* __restrict__ dir, const float* __restrict__ t_min,
               const float* __restrict__ t_max, const uint8_t* __restrict__ active,
               float* __restrict__ t_out, int* __restrict__ prim_out,
               float* __restrict__ u_out, float* __restrict__ v_out, int R) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  float best = fminf(kTMax, t_max[i]);
  int best_prim = -1;
  float best_u = 0.0f, best_v = 0.0f;
  if (active[i]) {
    Ray r = load_ray(orig, dir, t_min, i);
    int stack[kMaxStack];
    int sp = 0;
    bool overflow = false;
    int cur = n_leaves == 1 ? -1 : 0;  // a one-leaf table starts at leaf 0
    while (cur != kDone) {
      if (cur >= 0) {
        float keys[kArity];
        int codes[kArity];
        node_step(nodes, cur, r, best, keys, codes);
        for (int k = kArity - 1; k >= 1; --k) {
          if (keys[k] < kBig) {
            if (sp >= depth - 1) { overflow = true; break; }
            stack[sp++] = codes[k];
          }
        }
        if (overflow) break;
        if (keys[0] < kBig) { cur = codes[0]; continue; }
      } else {
        const float* lrow = leaf_rows + (size_t)(-cur - 1) * 10 * L;
        float lt = best, lu = 0.0f, lv = 0.0f;
        int lp = -1;
        for (int j = 0; j < L; ++j) {
          float t, u, v;
          int prim;
          if (mt_slot(lrow, L, j, r, best, &t, &u, &v, &prim) && t <= lt) {
            lt = t; lu = u; lv = v; lp = prim;
          }
        }
        if (lp >= 0) {  // some slot hit, so lt < best
          best = lt; best_prim = lp; best_u = lu; best_v = lv;
        }
      }
      cur = sp > 0 ? stack[--sp] : kDone;
    }
    if (overflow) best_prim = -2;
  }
  t_out[i] = best_prim < 0 ? kTMax : best;
  prim_out[i] = best_prim;
  u_out[i] = best_u;
  v_out[i] = best_v;
}

__global__ void __launch_bounds__(kThreads)
any_kernel(const float* __restrict__ nodes, const float* __restrict__ leaf_rows,
           int n_leaves, int L, int depth, const float* __restrict__ orig,
           const float* __restrict__ dir, const float* __restrict__ t_min,
           const float* __restrict__ t_max, const uint8_t* __restrict__ mask,
           uint8_t* __restrict__ occluded, int R) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  bool occ = false;
  if (mask[i]) {
    Ray r = load_ray(orig, dir, t_min, i);
    float tmax = t_max[i];
    int stack[kMaxStack];
    int sp = 0;
    int cur = n_leaves == 1 ? -1 : 0;
    while (cur != kDone && !occ) {
      if (cur >= 0) {
        float keys[kArity];
        int codes[kArity];
        node_step(nodes, cur, r, tmax, keys, codes);
        for (int k = kArity - 1; k >= 1 && !occ; --k) {
          if (keys[k] < kBig) {
            if (sp >= depth - 1) occ = true;  // overflow reports occluded
            else stack[sp++] = codes[k];
          }
        }
        if (occ) break;
        if (keys[0] < kBig) { cur = codes[0]; continue; }
      } else {
        const float* lrow = leaf_rows + (size_t)(-cur - 1) * 10 * L;
        for (int j = 0; j < L && !occ; ++j) {
          float t, u, v;
          int prim;
          occ = mt_slot(lrow, L, j, r, tmax, &t, &u, &v, &prim);
        }
        if (occ) break;
      }
      cur = sp > 0 ? stack[--sp] : kDone;
    }
  }
  occluded[i] = occ ? 1 : 0;
}

}  // namespace

extern "C" {

int crt_max_stack() { return kMaxStack; }
int crt_max_leaf() { return kMaxLeaf; }

// Launch B1 on `stream`. Returns the cudaError_t of the launch.
int crt_traverse_closest(const float* nodes, const float* leaf_rows, int n_leaves, int L,
                         int depth, const float* orig, const float* dir, const float* t_min,
                         const float* t_max, const uint8_t* active, float* t_out,
                         int* prim_out, float* u_out, float* v_out, int R, void* stream) {
  if (R <= 0) return 0;
  dim3 grid((R + kThreads - 1) / kThreads);
  closest_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      nodes, leaf_rows, n_leaves, L, depth, orig, dir, t_min, t_max, active, t_out,
      prim_out, u_out, v_out, R);
  return static_cast<int>(cudaGetLastError());
}

// Launch B2 on `stream`. Returns the cudaError_t of the launch.
int crt_traverse_any(const float* nodes, const float* leaf_rows, int n_leaves, int L,
                     int depth, const float* orig, const float* dir, const float* t_min,
                     const float* t_max, const uint8_t* mask, uint8_t* occluded, int R,
                     void* stream) {
  if (R <= 0) return 0;
  dim3 grid((R + kThreads - 1) / kThreads);
  any_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      nodes, leaf_rows, n_leaves, L, depth, orig, dir, t_min, t_max, mask, occluded, R);
  return static_cast<int>(cudaGetLastError());
}

const char* crt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
