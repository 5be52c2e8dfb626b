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
// kernels are held against. The row layouts and the rules shared with the
// plain version are in traverse_common.cuh; each kernel is a template on
// the node rows' arity A (2, 4 or 8), as the Pallas kernel takes any arity
// of its sorting networks (traverse_slotlane.py:994), and on its stack
// capacity S (64 or 128); its C entry switches on both.
//   - B1 is closest_ray over FlatRows (traverse_common.cuh), the walk of B5a
//     and B7a under its own name, so that launch counts and profiles tell
//     the tiers apart: node rows in a loop the warp leaves once fewer than
//     kNodeLanes of its lanes are in it, a leaf's slots two at a time, and
//     the top kShortStack = 8 stack entries in shared memory ([slot][thread],
//     older entries spilled to the local array of S). It is bit-equal to
//     the plain walk: a hit is kept on t < best, ties inside a leaf go to
//     the highest slot, a stack overflow drops the pushes that do not fit
//     and reports prim = -2, t = 1e20 with the walk's u, v, and a miss or
//     inactive lane is (1e20, -1, 0, 0);
//   - B2 is any_ray over FlatRows, the walk of B5b and B7b under its own
//     name: one loop over node rows and leaves (at A = 2 node rows in a
//     loop of their own, as B1's), 16-byte node loads, a leaf's slots two
//     at a time and a local stack of S entries. It is bit-equal to the
//     plain walk: it stops at the first t_min < t < t_max, reports an
//     overflow occluded at the push that does not fit, and writes
//     occluded & mask.
// Built with -fmad=false, so t agrees with the plain version bit for bit.
//
// What bounds them on the H100: dependent row fetches. Each step of a ray
// waits on one node row (64, 128 or 256 bytes at A = 2, 4, 8) or one
// 160-byte leaf row whose address came from the previous fetch, so the
// kernels are latency bound; the hall's tables (224K triangles, 13.8 MB)
// stay resident in the 50 MB L2, so the fetches are L2 hits, not HBM
// traffic. Rays diverge inside a warp, so a warp pays the union of its
// rays' steps. On an H100 80GB HBM3 at 700 W (scripts/kernel_turns.py,
// PERF.md section 6), on the hall's BVH4 table, B1's own walk took 0.227 /
// 0.353 ms on the sorted primary / bounce wavefronts; B3's walk over
// FlatRows 0.223 / 0.340 with its stack in local memory, and 0.208 / 0.284
// with its top 8 entries in shared memory, which also took 16-17% off the
// later closest-hit wavefronts of a hall frame (a pop feeds the next row's
// address; the likely cause, not measured, is that shared memory answers
// it sooner than the L1, where the local stack sat beside the rows). 16
// shared entries read within the
// spread of duplicate trees of 8 and take twice the shared memory; the
// two-level walk (B3, B5c, B6c) measured 4-11% slower with either and keeps
// its local stack. B2's own walk (a leaf slot by slot) took 0.173 / 0.191
// ms there and 0.967 ms over the 10 shadow wavefronts of a hall frame; the
// any walk over FlatRows 0.165 / 0.184 and 0.917 (and 0.84x / 0.89x on the
// city's primary / bounce rays; on the binary hall's bounce rays, which no
// main path traces with B2, 1.08x). The closest walk's shared stack
// entries, given to the any walk, cost it 0-4% on the same rays and were
// not kept (traverse_common.cuh, any_two_level).
// Persistent warps pulling rays from an atomic counter are B6a-B6d
// (traverse_persistent.cu), the same per-lane walks fed from a work queue.

#include "traverse_common.cuh"

namespace {

using namespace crt;

// B1: ray i walks the flat table alone, in the plain walk's order
// (closest_ray over FlatRows: B3's walk with the two-level branches
// compiled away; B5a's code under B1's name).
template <int A, int S>
__global__ void __launch_bounds__(kThreads)
closest_kernel(const float* __restrict__ nodes, const float* __restrict__ leaf_rows,
               int n_leaves, int L, int depth, const float* __restrict__ orig,
               const float* __restrict__ dir, const float* __restrict__ t_min,
               const float* __restrict__ t_max, const uint8_t* __restrict__ active,
               float* __restrict__ t_out, int* __restrict__ prim_out,
               float* __restrict__ u_out, float* __restrict__ v_out, int R) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const FlatRows<A> t{{nodes, leaf_rows, n_leaves, 0, L}};
  closest_ray<A, S>(t, depth, orig, dir, t_min, t_max, active, t_out, prim_out, nullptr, u_out,
                    v_out, i);
}

// B2: ray i walks the flat table alone, in the plain walk's order
// (any_ray over FlatRows: B4's walk with the two-level branches compiled
// away; B5b's code under B2's name).
template <int A, int S>
__global__ void __launch_bounds__(kThreads)
any_kernel(const float* __restrict__ nodes, const float* __restrict__ leaf_rows,
           int n_leaves, int L, int depth, const float* __restrict__ orig,
           const float* __restrict__ dir, const float* __restrict__ t_min,
           const float* __restrict__ t_max, const uint8_t* __restrict__ mask,
           uint8_t* __restrict__ occluded, int R) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const FlatRows<A> t{{nodes, leaf_rows, n_leaves, 0, L}};
  any_ray<A, S>(t, depth, orig, dir, t_min, t_max, mask, occluded, i);
}

}  // namespace

extern "C" {

int crt_max_stack() { return kMaxStack; }
int crt_max_leaf() { return kMaxLeaf; }

// Launch B1 on `stream` over node rows of `arity` children with a stack of
// `cap` entries (kSmallStack or kMaxStack, at least depth). Returns the
// cudaError_t of the launch.
int crt_traverse_closest(const float* nodes, const float* leaf_rows, int n_leaves, int arity,
                         int L, int depth, int cap, const float* orig, const float* dir,
                         const float* t_min, const float* t_max, const uint8_t* active,
                         float* t_out, int* prim_out, float* u_out, float* v_out, int R,
                         void* stream) {
  if (R <= 0) return 0;
  dim3 grid((R + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CRT_BY_ARITY_STACK(arity, cap, depth, closest_kernel<A, S><<<grid, kThreads, 0, s>>>(
      nodes, leaf_rows, n_leaves, L, depth, orig, dir, t_min, t_max, active, t_out,
      prim_out, u_out, v_out, R));
}

// Launch B2 on `stream` over node rows of `arity` children with a stack of
// `cap` entries. Returns the cudaError_t of the launch.
int crt_traverse_any(const float* nodes, const float* leaf_rows, int n_leaves, int arity, int L,
                     int depth, int cap, const float* orig, const float* dir, const float* t_min,
                     const float* t_max, const uint8_t* mask, uint8_t* occluded, int R,
                     void* stream) {
  if (R <= 0) return 0;
  dim3 grid((R + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CRT_BY_ARITY_STACK(arity, cap, depth, any_kernel<A, S><<<grid, kThreads, 0, s>>>(
      nodes, leaf_rows, n_leaves, L, depth, orig, dir, t_min, t_max, mask, occluded, R));
}

const char* crt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
