// Streamed-tier BVH traversal for Hopper (sm_90a) over a flat table: B5a
// closest hit, one lane per ray, and B5b any hit, one warp per packet of 32
// sorted rays. The two-level streamed tier, B5c and B5d, is
// traverse_unified_stream.cu.
//
// Replaces the stream=True variants of the Pallas slot-lane kernels in
// chameleonrt_tpu/ops/traverse_slotlane.py: B5a = _closest_call_slotlane
// (pallas_call :771) and B5b = _any_call_slotlane (:835) with stream=True,
// which chameleonrt_tpu/engine/trace_bvh.py reaches at :652-666 (closest)
// and :845-858 (any) when a scene's tables fail the VMEM gate. There the
// tables stay in HBM, every step DMAs one row per packet slot (:324-343
// node rows, :530-539 leaf rows), and a packet is STREAM_S = 32 sorted
// rays. Here the tables stay in device memory behind the L2.
//
// B5a: ray i walks alone in the plain walk's order, with B3's closest walk
// (closest_ray over FlatRows, traverse_common.cuh: node rows in a loop the
// warp leaves once fewer than kNodeLanes of its lanes are in it, a leaf's
// slots two at a time, a local stack of S = 64 or 128 entries). FlatRows
// has no TLAS and no instance entries, so the world-ray restore and the
// entry branch compile away. B5a is a template on the arity A (2, 4, 8)
// and S; its C entry switches on both. It is bit-equal to the plain walk
// (ops/traverse.py traverse_closest): a hit is kept on t < best, ties
// inside a leaf go to the highest slot; a stack overflow drops the pushes
// that do not fit and reports prim = -2, t = 1e20 with the walk's u, v, as
// the plain walk does; a miss or inactive lane is (1e20, -1, 0, 0).
//
// B5b, a packet of rays [32p, 32p + 32) of the sorted wavefront (the TPU's
// packet membership at S = 32, _pack_sl), a template on A:
//   - node: lane k loads float k of the 8A-float row (one coalesced load
//     for the warp; two at A = 8) into the warp's row slot in shared
//     memory; each lane in the step's mask slab-tests the A children with
//     its own ray and its t_max; __ballot_sync gives each child's lane mask
//     and a warp min its packet entry key. The children are ordered by that
//     key, as _reduce_min_sl orders them; the packet descends into the
//     nearest with its mask and pushes the others far-first, each with its
//     own mask, onto the warp's stack in shared memory;
//   - leaf: the warp loads the 10L-float row in ceil(10L / 32) coalesced
//     loads; each masked lane runs Moller-Trumbore on every slot and stops
//     at its first t_min < t < t_max;
//   - a lane leaves every mask once it is occluded, and the packet stops
//     once all its lanes are. A lane enters a child only where its own ray
//     hits the child's box, so its occlusion flag equals the plain
//     version's (traverse_any);
//   - the stack holds depth - 1 entries, depth being the SAH build's
//     certified bound plus one, in a warp's kMaxStack (128) entries of
//     shared memory, 4 KB a block. A push onto a full stack reports that
//     child's lanes occluded, as B2 does; B5b writes occluded & mask.
// Not carried over from the TPU kernel: the deferred leaf FIFO and the
// group barrier over 128 packets, which keep the TPU's lockstep vector
// unit busy.
//
// What bounds it on the H100: the dependent row fetch of every step, from
// HBM. The Rungholt-class city's tables (524 MB) are ten times the 50 MB
// L2, so below the top levels a step waits on a miss. On an H100 80GB HBM3
// at 700 W (scripts/kernel_turns.py, PERF.md section 6) the per-lane B5a
// took 0.33 / 0.26 ms on the city's sorted primary / bounce wavefronts,
// where the packet B5a it replaced took 0.77 / 0.74 ms and B1 on the same
// rays 0.34 / 0.27: a warp packet pays the union of its rays' steps and a
// dependent load between two __syncwarp() at each. Measured and left out:
// persistent warps that fetch 32 sorted rays at a time (1-3% faster on
// the city's primary rays, inside the spread of duplicate trees) and the
// L2 prefetch-size qualifier on the row loads (ld.global.nc.L2::128B
// within the spread, L2::256B 1-3% slower). Built with -fmad=false, like
// B1/B2.
// Later work (ROADMAP queue D): B5b as a per-lane any-hit walk.

#include "traverse_common.cuh"

namespace {

using namespace crt;

constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr unsigned kNoKey = 0xFFFFFFFFu;
// floats of a warp's row slot: the widest leaf row or node row of arity A
template <int A>
__host__ __device__ constexpr int slot_floats() {
  return 10 * kMaxLeaf > row_floats<A>() ? 10 * kMaxLeaf : row_floats<A>();
}

// A subtree the packet has still to visit: its child code and the lanes
// that enter it.
struct Entry {
  int code;
  unsigned mask;
};

// One node step of the packet: row cur of arity A into the warp's slot,
// each lane in mask slab-tests the children with its own cap, and
// kids[0, n) are the children some lane hits, nearest packet entry first.
// Returns n.
template <int A>
__device__ __forceinline__ int packet_children(const float* __restrict__ nodes, int cur,
                                               unsigned mask, const Ray& r, float cap,
                                               int lane, float* slot, Entry* kids) {
  constexpr int kRow = row_floats<A>();
  __syncwarp();
  for (int q = lane; q < kRow; q += kWarp) slot[q] = __ldg(nodes + (size_t)cur * kRow + q);
  __syncwarp();
  float keys[A];
  int codes[A];
  slab_children<A>(slot, r, cap, keys, codes);
  const bool in = (mask >> lane) & 1u;
  unsigned pkey[A];
  int n = 0;
#pragma unroll
  for (int c = 0; c < A; ++c) {
    const bool hit = in && keys[c] < kBig;
    kids[c].code = codes[c];
    kids[c].mask = __ballot_sync(kAll, hit);
    pkey[c] = __reduce_min_sync(kAll, hit ? ordered(keys[c]) : kNoKey);
    n += kids[c].mask != 0u;
  }
  sort_children<A>(pkey, kids);
  return n;
}

// Leaf row `leaf` into the warp's slot, in coalesced loads.
__device__ __forceinline__ void load_leaf(const float* __restrict__ leaf_rows, int leaf, int L,
                                          int lane, float* slot) {
  const float* lrow = leaf_rows + (size_t)leaf * 10 * L;
  __syncwarp();
  for (int q = lane; q < 10 * L; q += kWarp) slot[q] = __ldg(lrow + q);
  __syncwarp();
}

// B5a: ray i walks the flat table alone, in the plain walk's order
// (closest_ray over FlatRows: B3's walk with the two-level branches
// compiled away).
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

template <int A>
__global__ void __launch_bounds__(kThreads)
any_stream_kernel(const float* __restrict__ nodes, const float* __restrict__ leaf_rows,
                  int n_leaves, int L, int depth, const float* __restrict__ orig,
                  const float* __restrict__ dir, const float* __restrict__ t_min,
                  const float* __restrict__ t_max, const uint8_t* __restrict__ mask,
                  uint8_t* __restrict__ occluded, int R) {
  __shared__ Entry s_stack[kWarps][kMaxStack];
  __shared__ float s_slot[kWarps][slot_floats<A>()];
  const int lane = threadIdx.x % kWarp;
  Entry* stack = s_stack[threadIdx.x / kWarp];
  float* slot = s_slot[threadIdx.x / kWarp];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < R && mask[i];
  Ray r = {};
  float tmax = 0.0f;
  if (live) {
    r = load_ray(orig, dir, t_min, i);
    tmax = t_max[i];
  }
  const unsigned start = __ballot_sync(kAll, live);
  unsigned occ = 0u;  // occluded lanes, and lanes a full-stack push dropped
  int sp = 0;
  Entry cur = {n_leaves == 1 ? -1 : 0, start};
  while ((start & ~occ) != 0u) {
    cur.mask &= ~occ;
    if (cur.mask != 0u) {
      if (cur.code >= 0) {
        Entry kids[A];
        const int n = packet_children<A>(nodes, cur.code, cur.mask, r, tmax, lane, slot, kids);
        for (int k = n - 1; k >= 1; --k) {
          if (sp >= depth - 1) {
            occ |= kids[k].mask;  // an overflow reports occluded
          } else {
            if (lane == 0) stack[sp] = kids[k];
            ++sp;
          }
        }
        if (n > 0) { cur = kids[0]; continue; }
      } else {
        load_leaf(leaf_rows, -cur.code - 1, L, lane, slot);
        bool hit = false;
        if ((cur.mask >> lane) & 1u) {
          for (int j = 0; j < L && !hit; ++j) {
            float t, u, v;
            int prim;
            hit = mt_tri(shared_tri(slot, L, j), r, tmax, &t, &u, &v, &prim);
          }
        }
        occ |= __ballot_sync(kAll, hit);
      }
    }
    if (sp == 0) break;
    __syncwarp();
    cur = stack[--sp];
  }
  if (i < R) occluded[i] = ((occ >> lane) & 1u) ? 1 : 0;
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

// Launch B5b on `stream` over node rows of `arity` children. Returns the
// cudaError_t of the launch.
int crt_traverse_any_stream(const float* nodes, const float* leaf_rows, int n_leaves, int arity,
                            int L, int depth, const float* orig, const float* dir,
                            const float* t_min, const float* t_max, const uint8_t* mask,
                            uint8_t* occluded, int R, void* stream) {
  if (R <= 0) return 0;
  dim3 grid((R + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CRT_BY_ARITY(arity, any_stream_kernel<A><<<grid, kThreads, 0, s>>>(
      nodes, leaf_rows, n_leaves, L, depth, orig, dir, t_min, t_max, mask, occluded, R));
}

}  // extern "C"
