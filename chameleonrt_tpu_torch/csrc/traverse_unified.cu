// Two-level (TLAS + BLAS) traversal kernels for Hopper (sm_90a): B3 closest
// hit, B4 any hit, over one fused table per scene.
//
// Replaces the Pallas slot-lane kernels of chameleonrt_tpu/ops/traverse_slotlane.py
// (_make_slotlane_kernel, unified=True): B3 = the closest-hit variant reached
// through _closest_unified_call_slotlane / traverse_closest_unified_slotlane,
// B4 = the any-hit variant reached through _any_unified_call_slotlane /
// traverse_any_unified_slotlane. As in B1/B2 (traverse_flat.cu), one thread
// walks one ray depth first, visiting leaves as it meets them: the per-lane
// order of the XLA oracle chameleonrt_tpu/ops/traverse.py:
// traverse_closest_unified / traverse_any_unified and of the plain torch
// version in chameleonrt_tpu_torch/ops/traverse.py, which the kernels are
// held against.
//
// The table (chameleonrt_tpu_torch/engine/device_scene.py UnifiedBvh):
// every mesh's BLAS rows, then the TLAS rows from row tlas_lo; every
// triangle leaf, then from leaf n_tri one instance-entry row per instance
// (cols 0-11 the world-to-object 3x4 matrix row-major, col 12 the BLAS
// root row, col 13 the instance id, both bitcast; prim slots -1). A ray
// starts at the TLAS root in world space. At an entry leaf it takes the
// WORLD ray through the matrix (directions not renormalized, so object t
// is world t), recomputes 1/d and jumps to the BLAS root; an entry row
// never runs Moller-Trumbore. Whenever the next row is a TLAS row or an
// entry leaf, the world ray comes back: the stack is LIFO, so an
// instance's BLAS entries all pop before the TLAS entries beneath them.
// Rules shared with the flat kernels, and the instance-entry transform and
// world-space test shared with B5c/B5d, are in traverse_common.cuh. Here:
//   - B3 keeps a hit on t < best (ties inside a leaf go to the highest
//     slot) with the instance of the current object space; a stack
//     overflow reports prim = -2;
//   - B4 stops at the first t_min < t < t_max; an overflow is occluded;
//   - a miss, inactive or overflowed lane is (1e20, prim, -1, 0, 0) with
//     prim -1 or -2; B4 writes occluded & mask.
// Built with -fmad=false, so the object-space transform and t agree with
// the plain version bit for bit.
//
// What bounds it on the H100: dependent row fetches, as in B1/B2, plus the
// longer walk of two levels (a ray descends the TLAS, then one BLAS per
// instance box it enters). The San Miguel proxy's BVH4 table (57K node rows
// of 128 bytes, 120K leaf rows of 160 bytes, 27 MB) fits in the 50 MB L2.
// Divergence is worse than in a flat scene: neighbouring rays enter
// different instances and their object-space rays differ.
// Later work: the same as B1/B2 (warp packets on the sorted wavefront, the
// stack in shared memory, FMA), and a TLAS that is walked once per warp.

#include "traverse_common.cuh"

namespace {

using namespace crt;

// The object-space ray of the instance whose entry row is erow (the matrix
// through the read-only path, then traverse_common.cuh's enter_instance).
__device__ __forceinline__ Ray enter_instance_row(const float* __restrict__ erow, const Ray& w) {
  float m[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) m[k] = __ldg(erow + k);
  return enter_instance(m, w);
}

__global__ void __launch_bounds__(kThreads)
closest_unified_kernel(const float* __restrict__ nodes, const float* __restrict__ leaf_rows,
                       int n_tri, int tlas_lo, int L, int depth,
                       const float* __restrict__ orig, const float* __restrict__ dir,
                       const float* __restrict__ t_min, const float* __restrict__ t_max,
                       const uint8_t* __restrict__ active, float* __restrict__ t_out,
                       int* __restrict__ prim_out, int* __restrict__ inst_out,
                       float* __restrict__ u_out, float* __restrict__ v_out, int R) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  float best = fminf(kTMax, t_max[i]);
  int best_prim = -1, best_inst = -1;
  float best_u = 0.0f, best_v = 0.0f;
  if (active[i]) {
    const Ray w = load_ray(orig, dir, t_min, i);
    Ray r = w;
    int inst = 0;  // the instance whose object space r holds
    int stack[kMaxStack];
    int sp = 0;
    bool overflow = false;
    int cur = tlas_lo;
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
        cur = keys[0] < kBig ? codes[0] : (sp > 0 ? stack[--sp] : kDone);
      } else if (-cur - 1 < n_tri) {
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
          best = lt; best_prim = lp; best_inst = inst; best_u = lu; best_v = lv;
        }
        cur = sp > 0 ? stack[--sp] : kDone;
      } else {
        const float* erow = leaf_rows + (size_t)(-cur - 1) * 10 * L;
        r = enter_instance_row(erow, w);
        cur = __float_as_int(__ldg(erow + 12));  // a BLAS row: stay in object space
        inst = __float_as_int(__ldg(erow + 13));
        continue;
      }
      if (in_world(cur, n_tri, tlas_lo)) r = w;
    }
    if (overflow) best_prim = -2;
  }
  bool miss = best_prim < 0;
  t_out[i] = miss ? kTMax : best;
  prim_out[i] = best_prim;
  inst_out[i] = miss ? -1 : best_inst;
  u_out[i] = miss ? 0.0f : best_u;
  v_out[i] = miss ? 0.0f : best_v;
}

__global__ void __launch_bounds__(kThreads)
any_unified_kernel(const float* __restrict__ nodes, const float* __restrict__ leaf_rows,
                   int n_tri, int tlas_lo, int L, int depth,
                   const float* __restrict__ orig, const float* __restrict__ dir,
                   const float* __restrict__ t_min, const float* __restrict__ t_max,
                   const uint8_t* __restrict__ mask, uint8_t* __restrict__ occluded, int R) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  bool occ = false;
  if (mask[i]) {
    const Ray w = load_ray(orig, dir, t_min, i);
    Ray r = w;
    float tmax = t_max[i];
    int stack[kMaxStack];
    int sp = 0;
    int cur = tlas_lo;
    while (cur != kDone) {
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
        cur = keys[0] < kBig ? codes[0] : (sp > 0 ? stack[--sp] : kDone);
      } else if (-cur - 1 < n_tri) {
        const float* lrow = leaf_rows + (size_t)(-cur - 1) * 10 * L;
        for (int j = 0; j < L && !occ; ++j) {
          float t, u, v;
          int prim;
          occ = mt_slot(lrow, L, j, r, tmax, &t, &u, &v, &prim);
        }
        if (occ) break;
        cur = sp > 0 ? stack[--sp] : kDone;
      } else {
        const float* erow = leaf_rows + (size_t)(-cur - 1) * 10 * L;
        r = enter_instance_row(erow, w);
        cur = __float_as_int(__ldg(erow + 12));
        continue;
      }
      if (in_world(cur, n_tri, tlas_lo)) r = w;
    }
  }
  occluded[i] = occ ? 1 : 0;
}

}  // namespace

extern "C" {

// Launch B3 on `stream`. Returns the cudaError_t of the launch.
int crt_traverse_closest_unified(const float* nodes, const float* leaf_rows, int n_tri,
                                 int tlas_lo, int L, int depth, const float* orig,
                                 const float* dir, const float* t_min, const float* t_max,
                                 const uint8_t* active, float* t_out, int* prim_out,
                                 int* inst_out, float* u_out, float* v_out, int R,
                                 void* stream) {
  if (R <= 0) return 0;
  dim3 grid((R + kThreads - 1) / kThreads);
  closest_unified_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      nodes, leaf_rows, n_tri, tlas_lo, L, depth, orig, dir, t_min, t_max, active, t_out,
      prim_out, inst_out, u_out, v_out, R);
  return static_cast<int>(cudaGetLastError());
}

// Launch B4 on `stream`. Returns the cudaError_t of the launch.
int crt_traverse_any_unified(const float* nodes, const float* leaf_rows, int n_tri,
                             int tlas_lo, int L, int depth, const float* orig,
                             const float* dir, const float* t_min, const float* t_max,
                             const uint8_t* mask, uint8_t* occluded, int R, void* stream) {
  if (R <= 0) return 0;
  dim3 grid((R + kThreads - 1) / kThreads);
  any_unified_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      nodes, leaf_rows, n_tri, tlas_lo, L, depth, orig, dir, t_min, t_max, mask, occluded, R);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
