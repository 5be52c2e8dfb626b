// Streamed-tier BVH traversal for Hopper (sm_90a) over a flat table: B5a
// closest hit and B5b any hit, one lane per ray. The two-level streamed
// tier, B5c and B5d, is traverse_unified_stream.cu.
//
// Replaces the stream=True variants of the Pallas slot-lane kernels in
// chameleonrt_tpu/ops/traverse_slotlane.py: B5a = _closest_call_slotlane
// (pallas_call :771) and B5b = _any_call_slotlane (:835) with stream=True,
// which chameleonrt_tpu/engine/trace_bvh.py reaches at :652-666 (closest)
// and :845-858 (any) when a scene's tables fail the VMEM gate. There the
// tables stay in HBM, every step DMAs one row per packet slot (:324-343
// node rows, :530-539 leaf rows), and a packet is STREAM_S = 32 sorted
// rays. Here the tables stay in device memory behind the L2, and each ray
// walks alone: no packet, no shared row slot, no warp vote a step.
//
// B5a: ray i walks in the plain walk's order with B3's closest walk
// (closest_ray over FlatRows, traverse_common.cuh: node rows in a loop the
// warp leaves once fewer than kNodeLanes of its lanes are in it, a leaf's
// slots two at a time, a stack of S = 64 or 128 entries whose top
// kShortStack = 8 sit in shared memory, as B1's). B5b: ray i walks with
// B4's any walk (any_ray over FlatRows: one loop over node rows and leaves,
// 16-byte node loads, a leaf's slots two at a time, a local stack of S
// entries, and at A = 2 node rows in a loop of their own as in B5a; it
// stops at its first t_min < t < t_max). FlatRows has no
// TLAS and no instance entries, so the world-ray restore and the entry
// branch compile away, and a one-leaf table starts at leaf 0. Both kernels
// are templates on the arity A (2, 4, 8) and S; their C entries switch on
// both. Both are bit-equal to the plain walk (ops/traverse.py):
//   - B5a (traverse_closest): a hit is kept on t < best, ties inside a
//     leaf go to the highest slot; a stack overflow drops the pushes that
//     do not fit and reports prim = -2, t = 1e20 with the walk's u, v, as
//     the plain walk does; a miss or inactive lane is (1e20, -1, 0, 0);
//   - B5b (traverse_any): a push onto a full stack reports the ray
//     occluded, as the plain walk's overflow does; B5b writes occluded &
//     mask.
//
// What bounds them on the H100: the dependent row fetch of every step, from
// HBM. The Rungholt-class city's tables (524 MB) are ten times the 50 MB
// L2, so below the top levels a step waits on a miss. On an H100 80GB HBM3
// at 700 W (scripts/kernel_turns.py, PERF.md section 6) the per-lane B5a
// took 0.33 / 0.26 ms on the city's sorted primary / bounce wavefronts,
// where the packet B5a it replaced took 0.77 / 0.74 ms and B1 on the same
// rays 0.34 / 0.27: a warp packet pays the union of its rays' steps and a
// dependent load between two __syncwarp() at each. Likewise the per-lane
// B5b took 0.22 / 0.15 ms there and 0.10 / 0.08 ms on the first-bounce
// light / bsdf shadow rays of a city frame, where the packet B5b took 0.49
// / 0.42 and 0.27 / 0.14 ms, and B2's own walk then (a leaf's slots one at
// a time) 0.26 / 0.17 and 0.11 / 0.09 on the same rays. The top 8 stack
// entries in shared memory took 7-8% off B5a there (0.318 / 0.246 ms with a
// local stack, 0.297 / 0.226 with them; traverse_flat.cu). Measured and left
// out: persistent warps that fetch 32 sorted rays at a time (B5a: 1-3%
// faster on the city's primary rays, inside the spread of duplicate
// trees), the L2 prefetch-size qualifier on the row loads (B5a:
// ld.global.nc.L2::128B within the spread, L2::256B 1-3% slower), and the
// any walk's node loop at A = 4 (B5b: 4% slower on the city's bounce rays;
// any_two_level keeps it for binary rows), and the top 8 stack entries in
// shared memory in the any walk too (B5b: 3-8% slower on the city's rays).
// Built with -fmad=false, like B1/B2.
// B1 and B6a run B5a's walk too, B2 and B6b B5b's, under their own names.

#include "traverse_common.cuh"

namespace {

using namespace crt;

// B5a: ray i walks the flat table alone, in the plain walk's order
// (closest_ray over FlatRows: B3's walk with the two-level branches
// compiled away, its top kShortStack stack entries in shared memory).
template <int A, int S>
__global__ void __launch_bounds__(kThreads)
closest_stream_kernel(const float* __restrict__ nodes, const float* __restrict__ leaf_rows,
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

// B5b: ray i walks the flat table alone, in the plain walk's order
// (any_ray over FlatRows: B4's walk with the two-level branches compiled
// away).
template <int A, int S>
__global__ void __launch_bounds__(kThreads)
any_stream_kernel(const float* __restrict__ nodes, const float* __restrict__ leaf_rows,
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

// Launch B5a on `stream` over node rows of `arity` children with a stack
// of `cap` entries (kSmallStack or kMaxStack, at least depth). Returns the
// cudaError_t of the launch.
int crt_traverse_closest_stream(const float* nodes, const float* leaf_rows, int n_leaves,
                                int arity, int L, int depth, int cap, const float* orig,
                                const float* dir, const float* t_min, const float* t_max,
                                const uint8_t* active, float* t_out, int* prim_out, float* u_out,
                                float* v_out, int R, void* stream) {
  if (R <= 0) return 0;
  dim3 grid((R + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CRT_BY_ARITY_STACK(arity, cap, depth, closest_stream_kernel<A, S><<<grid, kThreads, 0, s>>>(
      nodes, leaf_rows, n_leaves, L, depth, orig, dir, t_min, t_max, active, t_out,
      prim_out, u_out, v_out, R));
}

// Launch B5b on `stream` over node rows of `arity` children with a stack
// of `cap` entries (kSmallStack or kMaxStack, at least depth). Returns the
// cudaError_t of the launch.
int crt_traverse_any_stream(const float* nodes, const float* leaf_rows, int n_leaves, int arity,
                            int L, int depth, int cap, const float* orig, const float* dir,
                            const float* t_min, const float* t_max, const uint8_t* mask,
                            uint8_t* occluded, int R, void* stream) {
  if (R <= 0) return 0;
  dim3 grid((R + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CRT_BY_ARITY_STACK(arity, cap, depth, any_stream_kernel<A, S><<<grid, kThreads, 0, s>>>(
      nodes, leaf_rows, n_leaves, L, depth, orig, dir, t_min, t_max, mask, occluded, R));
}

}  // extern "C"
