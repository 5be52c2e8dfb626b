// Two-level (TLAS + BLAS) traversal of the streamed tier for Hopper
// (sm_90a): B5c closest hit and B5d any hit over a fused table larger than
// the L2.
//
// Replaces the stream=True variants of the Pallas unified slot-lane
// kernels in chameleonrt_tpu/ops/traverse_slotlane.py: B5c =
// _closest_unified_call_slotlane (:1016, pallas_call :1025) and B5d =
// _any_unified_call_slotlane (:1076, pallas_call :1085) with stream=True,
// which chameleonrt_tpu/engine/trace_bvh.py reaches at :759-771 (closest)
// and :931-946 (any) when a two-level table fails the VMEM gate. There one
// slot holds one ray, the tables stay in HBM, and each step issues K
// independent row DMAs on one semaphore and waits for them once (:324-343
// node rows, :530-539 leaf rows): its speed comes from many per-ray row
// fetches in flight.
//
// What it computes is B3/B4's, by the same code: the per-ray bodies
// closest_ray / any_ray of traverse_common.cuh, which run closest_two_level
// / any_two_level over GlobalRows (traverse_unified.cu has the table's
// layout and the rules): the plain walk's per-lane order, the instance
// entry from the world ray, the world ray back wherever in_world holds,
// -fmad=false, a stack of the certified bound + 1 in a local array of S
// entries (64 or 128), an overflow reported as prim = -2 (B5c) or occluded
// (B5d). So both are bit-equal to the plain version (ops/traverse.py:
// traverse_closest_unified / traverse_any_unified): t, prim, instance, u
// and v, ties included. Outputs as B3/B4. They stay kernels of their own so
// that launch counts and profiles tell the tiers apart.
//
// What bounds it on the H100: dependent row fetches beyond the L2. The
// large San Miguel proxy's BVH4 table is 162 MB, node rows 44 MB and
// triangle leaf rows 118 MB, against a 50 MB L2; every step of a ray waits
// on a row whose address came from the step before. The operations that
// chip_smoke._bound counts (a slab test per live child, a Moller-Trumbore
// per valid slot, a transform per instance entry) take a few percent of
// that wait. The design: one thread walks one ray, so each warp has 32
// independent row fetches in flight, the TPU kernel's K DMAs on one
// semaphore, and no packet pays for the union of its lanes' walks, as the
// warp packets of the first design did; the walks and the row loads are
// B3's and B4's (traverse_unified.cu says what they took off); the grid is
// one block of kThreads per kThreads rays, which the block scheduler hands
// out as blocks end. Measured slower and left out (PERF.md section 6 has the ablations):
// L2 eviction policies on the row loads, a grid of the card's resident
// blocks, and the TLAS and instance-entry rows copied into shared memory by
// a TMA bulk copy at block start (no gain on the large proxy, 30-45% slower
// on a 576-instance grid, whose 64 KB a block the copy had to fill; H100
// 80GB HBM3 at 700 W).
// Each kernel is a template on the arity A (2, 4 or 8) and the stack
// capacity S; its C entry switches on both.

#include "traverse_common.cuh"

namespace {

using namespace crt;

template <int A, int S>
__global__ void __launch_bounds__(kThreads)
closest_unified_stream_kernel(const float* __restrict__ nodes, const float* __restrict__ leaf_rows,
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
any_unified_stream_kernel(const float* __restrict__ nodes, const float* __restrict__ leaf_rows,
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

// Launch B5c on `stream` over node rows of `arity` children with a stack of
// `cap` entries (kSmallStack or kMaxStack, at least depth). Returns the
// cudaError_t of the launch.
int crt_traverse_closest_unified_stream(const float* nodes, const float* leaf_rows, int n_tri,
                                        int tlas_lo, int arity, int L, int depth, int cap,
                                        const float* orig, const float* dir, const float* t_min,
                                        const float* t_max, const uint8_t* active, float* t_out,
                                        int* prim_out, int* inst_out, float* u_out, float* v_out,
                                        int R, void* stream) {
  if (R <= 0) return 0;
  dim3 grid((R + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CRT_BY_ARITY_STACK(arity, cap, depth, closest_unified_stream_kernel<A, S><<<grid, kThreads, 0, s>>>(
      nodes, leaf_rows, n_tri, tlas_lo, L, depth, orig, dir, t_min, t_max, active, t_out,
      prim_out, inst_out, u_out, v_out, R));
}

// Launch B5d on `stream`, as B5c.
int crt_traverse_any_unified_stream(const float* nodes, const float* leaf_rows, int n_tri,
                                    int tlas_lo, int arity, int L, int depth, int cap,
                                    const float* orig, const float* dir, const float* t_min,
                                    const float* t_max, const uint8_t* mask, uint8_t* occluded,
                                    int R, void* stream) {
  if (R <= 0) return 0;
  dim3 grid((R + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CRT_BY_ARITY_STACK(arity, cap, depth, any_unified_stream_kernel<A, S><<<grid, kThreads, 0, s>>>(
      nodes, leaf_rows, n_tri, tlas_lo, L, depth, orig, dir, t_min, t_max, mask, occluded, R));
}

}  // extern "C"
