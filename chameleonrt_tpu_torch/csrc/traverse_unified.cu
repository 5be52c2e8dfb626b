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
// Rules shared with the flat kernels are in traverse_common.cuh, and so
// are the walks themselves (closest_two_level, any_two_level), which B5c/B5d
// run too over their own row source; here they read every row from global
// memory (GlobalRows). As there, each kernel is a template on the node
// rows' arity A (2, 4 or 8) and its stack capacity S (64 or 128), and its
// C entry switches on both. The rules:
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
// different instances and their object-space rays differ. So B3's walk
// (closest_two_level) takes node rows in a loop of their own that a warp
// leaves once fewer than kNodeLanes of its lanes are in it, and GlobalRows
// reads a leaf's slots two at a time and an entry row 16 bytes at a time.
// On an H100 80GB HBM3 at 700 W that took 15-20% off B3 on San Miguel's
// and the large proxy's sorted 921,600-ray wavefronts (scripts/
// kernel_turns.py, PERF.md section 6). Measured and left out: a register
// cap for 10 or 12 blocks an SM (48 or 40 registers spill; 5-16% slower),
// the node loop run to its end (faster on primary rays, 3-4% slower on
// bounce rays), four slots a leaf batch (16 more registers, slower on
// bounce rays), and the same node loop in B4's walk (any_two_level), which
// moved B4 within the spread of duplicate trees on those wavefronts and on
// San Miguel's first-bounce shadow rays, and cost B5d and B6d 1-2% on
// primary rays.

#include "traverse_common.cuh"

namespace {

using namespace crt;

template <int A, int S>
__global__ void __launch_bounds__(kThreads)
closest_unified_kernel(const float* __restrict__ nodes, const float* __restrict__ leaf_rows,
                       int n_tri, int tlas_lo, int L, int depth,
                       const float* __restrict__ orig, const float* __restrict__ dir,
                       const float* __restrict__ t_min, const float* __restrict__ t_max,
                       const uint8_t* __restrict__ active, float* __restrict__ t_out,
                       int* __restrict__ prim_out, int* __restrict__ inst_out,
                       float* __restrict__ u_out, float* __restrict__ v_out, int R) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const GlobalRows<A> t{nodes, leaf_rows, n_tri, tlas_lo, L};
  closest_ray<A, S>(t, depth, orig, dir, t_min, t_max, active, t_out, prim_out, inst_out, u_out,
                    v_out, i);
}

template <int A, int S>
__global__ void __launch_bounds__(kThreads)
any_unified_kernel(const float* __restrict__ nodes, const float* __restrict__ leaf_rows,
                   int n_tri, int tlas_lo, int L, int depth,
                   const float* __restrict__ orig, const float* __restrict__ dir,
                   const float* __restrict__ t_min, const float* __restrict__ t_max,
                   const uint8_t* __restrict__ mask, uint8_t* __restrict__ occluded, int R) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const GlobalRows<A> t{nodes, leaf_rows, n_tri, tlas_lo, L};
  any_ray<A, S>(t, depth, orig, dir, t_min, t_max, mask, occluded, i);
}

}  // namespace

extern "C" {

// Launch B3 on `stream` over node rows of `arity` children with a stack of
// `cap` entries (kSmallStack or kMaxStack, at least depth). Returns the
// cudaError_t of the launch.
int crt_traverse_closest_unified(const float* nodes, const float* leaf_rows, int n_tri,
                                 int tlas_lo, int arity, int L, int depth, int cap,
                                 const float* orig,
                                 const float* dir, const float* t_min, const float* t_max,
                                 const uint8_t* active, float* t_out, int* prim_out,
                                 int* inst_out, float* u_out, float* v_out, int R,
                                 void* stream) {
  if (R <= 0) return 0;
  dim3 grid((R + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CRT_BY_ARITY_STACK(arity, cap, depth, closest_unified_kernel<A, S><<<grid, kThreads, 0, s>>>(
      nodes, leaf_rows, n_tri, tlas_lo, L, depth, orig, dir, t_min, t_max, active, t_out,
      prim_out, inst_out, u_out, v_out, R));
}

// Launch B4 on `stream` over node rows of `arity` children with a stack of
// `cap` entries. Returns the cudaError_t of the launch.
int crt_traverse_any_unified(const float* nodes, const float* leaf_rows, int n_tri,
                             int tlas_lo, int arity, int L, int depth, int cap, const float* orig,
                             const float* dir, const float* t_min, const float* t_max,
                             const uint8_t* mask, uint8_t* occluded, int R, void* stream) {
  if (R <= 0) return 0;
  dim3 grid((R + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CRT_BY_ARITY_STACK(arity, cap, depth, any_unified_kernel<A, S><<<grid, kThreads, 0, s>>>(
      nodes, leaf_rows, n_tri, tlas_lo, L, depth, orig, dir, t_min, t_max, mask, occluded, R));
}

}  // extern "C"
