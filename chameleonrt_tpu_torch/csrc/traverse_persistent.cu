// Work-queue persistent traversal kernels for Hopper (sm_90a): B6a flat
// closest hit, B6b flat any hit, B6c two-level closest hit, B6d two-level
// any hit.
//
// Replaces the Pallas work-queue kernels of chameleonrt_tpu/ops/traverse_packet.py
// (_make_persistent_kernel, both `stream` values): B6a = the closest-hit
// variant reached through _closest_call_persistent / traverse_closest_persistent,
// B6b = the any-hit variant through _any_call_persistent /
// traverse_any_persistent, B6c and B6d = the unified variants through
// _closest_unified_call_persistent / _any_unified_call_persistent. On the TPU
// K resident slots each walk a packet of sorted rays with one shared stack
// and pull the next packet id from a queue when theirs retires; stream=True
// only moves the tables from VMEM to HBM. Here that is persistent threads
// fed from a global work queue (Aila and Laine, "Understanding the
// Efficiency of Ray Traversal on GPUs", HPG 2009):
//   - the grid is as many blocks as the card keeps resident at once
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SMs,
//     computed once per kernel), whatever the number of rays;
//   - a device counter, reset in stream order before each launch, hands out
//     ray indices, kFetch consecutive ones to a warp with one atomic;
//   - each lane walks its own ray in the plain walk's per-lane order
//     (near-first through the sorting network, leaves as it meets them).
//   - each warp fetches (per_warp), as the TPU kernel's slot pulls its next
//     packet: its 32 lanes take 32 consecutive sorted rays, each walks its
//     ray to the end with the walk of B1, B2, B3 or B4 (traverse_common.cuh:
//     closest_ray / any_ray over FlatRows for B6a / B6b, the closest walk
//     with the top kShortStack = 8 stack entries in shared memory, the any
//     walk with a local stack; closest_ray / any_ray over GlobalRows for
//     B6c / B6d, with local stacks; leaf slots two at a time, node rows 16
//     bytes at a time, and for closest hit (and any hit on binary rows)
//     node rows in a loop the warp leaves once most of its lanes wait),
//     and the warp meets at __syncwarp() before its next fetch. A warp's
//     lanes always hold neighbours in the sorted wavefront, and no ballot
//     or refill runs between two row steps.
// The TPU kernel's phase alternation, deferred leaf FIFO, merged phase,
// pinned tree top and VMEM gates schedule a lockstep vector unit and are
// not carried over. Every table sits in global memory behind the L2, so one
// kernel per variant serves both `stream` values. Results keep the plain
// version's contract (chameleonrt_tpu_torch/ops/traverse.py) and are written
// by ray index:
//   - B6a (t, prim, u, v), B6c (t, prim, inst, u, v): bit-equal to the plain
//     walk, as B1/B3: a miss or inactive lane is (1e20, -1, [-1,] 0, 0), a
//     stack overflow prim = -2 (B6a with the u, v of the hits its walk finds
//     on, as the plain flat walk);
//   - B6b, B6d: occluded & mask; the walk stops at the first
//     t_min < t < t_max, and an overflow is occluded, as B2/B4.
// Like B1-B4, each kernel is a template on the node rows' arity A (2, 4
// or 8; the Pallas kernels take 2, 4 or 8, traverse_packet.py:2340-2345)
// and on its stack capacity S (64 or 128), its C entry switches on both,
// and each instantiation sizes its own grid.
// Built with -fmad=false, so t agrees with the plain version bit for bit.
//
// What bounds it on the H100: as B1-B4, dependent row fetches (latency, not
// bytes: a wavefront's distinct rows are a few MB). The kernels first
// refilled per lane: a lane whose ray ended took the next index of its
// warp's batch at once, which keeps every lane busy until the queue is
// empty, where a B1 warp waits for its longest ray; the price was
// coherence (a warp's lanes soon held rays from far-apart parts of the
// sorted wavefront) and a ballot, an any-vote and the refill's bookkeeping
// each row step. On an H100 80GB HBM3 at 700 W the price was the larger:
// the refilling B6a-B6d took 0.97-1.37x the time of B1-B4 on the same
// 921,600-ray wavefronts (chip_smoke.py, phase 3). Fetching per warp took
// 17-20% off B6c and 9-22% off B6d on the same walks, shadow rays
// included, 12-21% off B6a on the hall's BVH4 table (0.302 / 0.401 ms on
// its primary / bounce rays with the refill, 0.237 / 0.352 per warp over
// B1's walk), where the shared stack entries took a further 5-17% (0.215 /
// 0.285 ms), and 15-21% off B6b there (0.218 / 0.221 ms with the refill
// and B2's own walk, 0.172 / 0.187 per warp over the flat any walk; 1.126
// -> 1.002-1.019 ms over the 10 shadow wavefronts of a hall frame;
// scripts/kernel_turns.py, PERF.md section 6). Measured for B6d and left
// out: packing a batch's masked-in rays into lanes, up to 2 or 4 fetches a
// round, which lost 5-20% to the plain per-warp fetch on the main path's
// shadow rays and 0-3% on the others (lanes then hold rays further apart,
// and a sparse wavefront's time is that of its longest walks); for B6b,
// the closest walk's shared stack entries in the any walk, 2-11% slower.

#include "traverse_common.cuh"

namespace {

using namespace crt;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFetch = 32;  // ray indices a warp takes with one atomic

struct Params {
  const float* nodes;
  const float* leaf_rows;
  int n_tri;    // flat: the number of leaves; two-level: n_tri_leaves
  int tlas_lo;  // two-level only
  int L, depth;
  const float* orig;
  const float* dir;
  const float* t_min;
  const float* t_max;
  const uint8_t* flag;  // closest hit: active; any hit: mask
  float* t_out;
  int* prim_out;
  int* inst_out;
  float* u_out;
  float* v_out;
  uint8_t* occluded;
  int* counter;
  int R;
};

// Persistent warps (B6a-B6d): lane 0 takes kFetch consecutive ray indices
// with one atomic and the warp shares them by a shuffle; each lane runs
// walk(i) on its index, and the warp meets at __syncwarp() and fetches again
// until the counter passes R. Every lane reaches each fetch; a lane past R
// at the queue's ragged end does not walk.
template <typename WalkRay>
__device__ __forceinline__ void per_warp(const Params& p, WalkRay walk) {
  const unsigned lane = threadIdx.x & 31u;
  while (true) {
    int base = 0;
    if (lane == 0) base = atomicAdd(p.counter, kFetch);
    base = __shfl_sync(kFull, base, 0);
    if (base >= p.R) return;  // warp-uniform
    const int i = base + static_cast<int>(lane);
    if (i < p.R) walk(i);
    __syncwarp();
  }
}

// B6a: persistent warps over B1's walk (closest_ray over FlatRows).
template <int A, int S>
__global__ void __launch_bounds__(kThreads) closest_persistent_kernel(const Params p) {
  const FlatRows<A> t{{p.nodes, p.leaf_rows, p.n_tri, 0, p.L}};
  per_warp(p, [&](int i) {
    closest_ray<A, S>(t, p.depth, p.orig, p.dir, p.t_min, p.t_max, p.flag, p.t_out, p.prim_out,
                      nullptr, p.u_out, p.v_out, i);
  });
}

// B6b: persistent warps over B2's walk (any_ray over FlatRows).
template <int A, int S>
__global__ void __launch_bounds__(kThreads) any_persistent_kernel(const Params p) {
  const FlatRows<A> t{{p.nodes, p.leaf_rows, p.n_tri, 0, p.L}};
  per_warp(p, [&](int i) {
    any_ray<A, S>(t, p.depth, p.orig, p.dir, p.t_min, p.t_max, p.flag, p.occluded, i);
  });
}

// B6c: persistent warps over B3's walk (closest_ray over GlobalRows).
template <int A, int S>
__global__ void __launch_bounds__(kThreads) closest_unified_persistent_kernel(const Params p) {
  const GlobalRows<A> t{p.nodes, p.leaf_rows, p.n_tri, p.tlas_lo, p.L};
  per_warp(p, [&](int i) {
    closest_ray<A, S>(t, p.depth, p.orig, p.dir, p.t_min, p.t_max, p.flag, p.t_out, p.prim_out,
                      p.inst_out, p.u_out, p.v_out, i);
  });
}

// B6d: persistent warps over B4's walk (any_ray over GlobalRows).
template <int A, int S>
__global__ void __launch_bounds__(kThreads) any_unified_persistent_kernel(const Params p) {
  const GlobalRows<A> t{p.nodes, p.leaf_rows, p.n_tri, p.tlas_lo, p.L};
  per_warp(p, [&](int i) {
    any_ray<A, S>(t, p.depth, p.orig, p.dir, p.t_min, p.t_max, p.flag, p.occluded, i);
  });
}

// Blocks of kThreads that the current card keeps resident at once running
// `kernel`: its SMs times the kernel's occupancy. Computed on the first
// launch of each instantiation and kept.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int* cached) {
  if (*cached > 0) return cudaSuccess;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err == cudaSuccess && sms * per_sm <= 0) err = cudaErrorInvalidConfiguration;
  if (err == cudaSuccess) *cached = sms * per_sm;
  return err;
}

// Reset the queue in stream order, then launch. Returns the cudaError_t.
template <typename Kernel>
int launch(Kernel kernel, int* cached_blocks, const Params& p, void* stream) {
  if (p.R <= 0) return 0;
  cudaError_t err = resident_blocks(kernel, cached_blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(p.counter, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<*cached_blocks, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// resident blocks of B6a, B6b, B6c, B6d (first index) at arity 2, 4, 8
// (second index, arity_slot) and stack capacity 64, 128 (third index,
// stack_slot)
int g_blocks[4][3][2] = {};

constexpr int arity_slot(int arity) { return arity == 2 ? 0 : arity == 4 ? 1 : 2; }
constexpr int stack_slot(int cap) { return cap == kSmallStack ? 0 : 1; }

}  // namespace

extern "C" {

// The grid of B6a, B6b, B6c or B6d (variant 0-3) at `arity` (2, 4 or 8)
// and stack capacity `cap` (64 or 128): resident blocks of kThreads
// threads, 0 before that instantiation's first launch or for any other
// variant, arity or capacity.
int crt_persistent_blocks(int variant, int arity, int cap) {
  if (variant < 0 || variant >= 4 || (arity != 2 && arity != 4 && arity != 8) ||
      (cap != kSmallStack && cap != kMaxStack))
    return 0;
  return g_blocks[variant][arity_slot(arity)][stack_slot(cap)];
}

// Launch B6a on `stream` over node rows of `arity` children with a stack of
// `cap` entries (kSmallStack or kMaxStack, at least depth); counter is one
// int of device memory for the queue.
int crt_traverse_closest_persistent(const float* nodes, const float* leaf_rows, int n_leaves,
                                    int arity, int L, int depth, int cap, const float* orig,
                                    const float* dir, const float* t_min, const float* t_max,
                                    const uint8_t* active, float* t_out, int* prim_out,
                                    float* u_out, float* v_out, int* counter, int R,
                                    void* stream) {
  Params p{nodes, leaf_rows, n_leaves, 0, L, depth, orig, dir, t_min, t_max, active,
           t_out, prim_out, nullptr, u_out, v_out, nullptr, counter, R};
  CRT_BY_ARITY_STACK(arity, cap, depth, return launch(closest_persistent_kernel<A, S>,
                                    &g_blocks[0][arity_slot(A)][stack_slot(S)], p, stream));
}

// Launch B6b on `stream` over node rows of `arity` children.
int crt_traverse_any_persistent(const float* nodes, const float* leaf_rows, int n_leaves,
                                int arity, int L, int depth, int cap, const float* orig,
                                const float* dir, const float* t_min, const float* t_max,
                                const uint8_t* mask, uint8_t* occluded, int* counter, int R,
                                void* stream) {
  Params p{nodes, leaf_rows, n_leaves, 0, L, depth, orig, dir, t_min, t_max, mask,
           nullptr, nullptr, nullptr, nullptr, nullptr, occluded, counter, R};
  CRT_BY_ARITY_STACK(arity, cap, depth, return launch(any_persistent_kernel<A, S>,
                                    &g_blocks[1][arity_slot(A)][stack_slot(S)], p, stream));
}

// Launch B6c on `stream` over node rows of `arity` children.
int crt_traverse_closest_unified_persistent(const float* nodes, const float* leaf_rows,
                                            int n_tri, int tlas_lo, int arity, int L, int depth,
                                            int cap, const float* orig, const float* dir,
                                            const float* t_min, const float* t_max,
                                            const uint8_t* active, float* t_out,
                                            int* prim_out, int* inst_out, float* u_out,
                                            float* v_out, int* counter, int R, void* stream) {
  Params p{nodes, leaf_rows, n_tri, tlas_lo, L, depth, orig, dir, t_min, t_max, active,
           t_out, prim_out, inst_out, u_out, v_out, nullptr, counter, R};
  CRT_BY_ARITY_STACK(arity, cap, depth, return launch(closest_unified_persistent_kernel<A, S>,
                                    &g_blocks[2][arity_slot(A)][stack_slot(S)], p, stream));
}

// Launch B6d on `stream` over node rows of `arity` children.
int crt_traverse_any_unified_persistent(const float* nodes, const float* leaf_rows, int n_tri,
                                        int tlas_lo, int arity, int L, int depth, int cap,
                                        const float* orig, const float* dir,
                                        const float* t_min, const float* t_max,
                                        const uint8_t* mask, uint8_t* occluded, int* counter,
                                        int R, void* stream) {
  Params p{nodes, leaf_rows, n_tri, tlas_lo, L, depth, orig, dir, t_min, t_max, mask,
           nullptr, nullptr, nullptr, nullptr, nullptr, occluded, counter, R};
  CRT_BY_ARITY_STACK(arity, cap, depth, return launch(any_unified_persistent_kernel<A, S>,
                                    &g_blocks[3][arity_slot(A)][stack_slot(S)], p, stream));
}

}  // extern "C"
