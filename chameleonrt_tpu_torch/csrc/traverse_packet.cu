// Grid-packet BVH traversal for Hopper (sm_90a) over binary node rows: B7a
// closest hit and B7b any hit, one warp per packet of 32 consecutive
// sorted rays that share one stack.
//
// Replaces the Pallas grid-packet kernels of chameleonrt_tpu/ops/traverse_packet.py:
// B7a = _closest_kernel (:281), launched by _closest_call (pallas_call
// :627) through traverse_closest_packet (:2383); B7b = _any_kernel (:437),
// launched by _any_call (pallas_call :660) through traverse_any_packet
// (:2432). The JAX engine reaches them for a flat scene with the slot-lane
// tier off once both persistent VMEM gates fail (engine/trace_bvh.py
// :680-688, :871-879); the port reaches them with grid_packet=True.
//
// What they compute, step by step (traverse_packet.py:331-427, :486-575),
// on binary rows (n, 16) f32: child boxes at cols 0-11, child codes at
// cols 12-13 (traverse_common.cuh has the layouts):
//   - B7a, node row: every live lane slab-tests both children against its
//     own best t; the ballots give the lanes that hit each child. The
//     packet descends first into the child with the smaller packet-minimum
//     entry t (a warp min over the lanes that hit it; min_l <= min_r picks
//     the left child, :343-347), not in each ray's own order, and pushes
//     the other where both are hit. At a leaf every live lane runs
//     Moller-Trumbore on all L slots and keeps a hit on t < its best, slot
//     by slot (ties inside a leaf go to the lowest slot): the leaf is not
//     culled by the lane's own box test, as the TPU kernel does not cull
//     there. A pop from an empty stack ends the packet.
//   - B7b: a lane that is occluded slab-tests with cap -1e30 (:494), so it
//     enters nothing; children are pushed unordered (left visited next,
//     right pushed, :518); at a leaf each lane that is not occluded runs
//     Moller-Trumbore against its t_max; the packet ends as soon as every
//     lane is occluded (__all_sync; :501, :534, :557).
//   - Inactive lanes (and the padding past R) take part in no vote. The
//     JAX wrapper parks them at origin 1e30 (:2395-2400) and gives them
//     t_max = -1 in B7b (:2448-2452), so they count as occluded there. B7a
//     writes (1e20, -1, 0, 0) for them and for a miss; B7b writes
//     occluded & mask.
//   - The stack of a packet holds depth - 1 entries, depth being the
//     builder's certified binary depth plus one, at most kMaxStack as in
//     B1-B6d. A push onto a full stack drops that child: the lanes that
//     hit it report prim = -2 (B7a) or occluded (B7b), as B1/B2 do; a
//     certified depth never reaches it.
// Against the plain version (ops/traverse.py traverse_closest /
// traverse_any on the same binary table): a prim may differ on an exact
// tie in t, since the packet visits in another order and takes a leaf's
// lowest tied slot, and a lane may find a nearer hit (B7a) or an occluder
// (B7b) that the plain walk culls, where the lane's own slab test rejects a
// box by rounding at its faces while Moller-Trumbore hits a triangle on
// that face.
//
// Not carried over from the TPU kernel: K = 64 resident packets of 256
// rays interleaved across sublanes (_pack_rays), the node/leaf phase
// alternation by LEAF_THRESH and the stale-row leaf re-tests. They
// schedule the TPU's lockstep vector unit and VMEM; a warp that owns its
// packet needs none of them.
//
// Hopper design: one warp per packet, reusing B5a/B5b's machinery
// (traverse_stream.cu): the 64-byte node row comes in one coalesced load
// by lanes 0-15 into the warp's node slot in shared memory, a leaf row in
// ceil(10L / 32) coalesced loads into its leaf slot, and the descent comes
// from ballots and warp mins. The stack, the node slot and the leaf slot
// of each warp sit in shared memory. Built with -fmad=false, like B1-B6d.
//
// What bounds it on the H100: the dependent row fetch of every packet
// step, as in B5a/B5b, and the packet's union of its lanes' walks: a warp
// visits every node that some lane enters, and every live lane runs
// Moller-Trumbore at every leaf the packet visits. The binary table
// doubles the node steps of BVH4 for half the bytes a row.

#include "traverse_common.cuh"

namespace {

using namespace crt;

constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr int kBinRow = row_floats<2>();  // floats per binary node row

// Binary row cur into the warp's node slot, one coalesced load by lanes 0-15.
__device__ __forceinline__ void load_node(const float* __restrict__ nodes, int cur, int lane,
                                          float* slot) {
  __syncwarp();
  if (lane < kBinRow) slot[lane] = __ldg(nodes + (size_t)cur * kBinRow + lane);
  __syncwarp();
}

// Leaf row `leaf` into the warp's leaf slot, in coalesced loads.
__device__ __forceinline__ void load_leaf(const float* __restrict__ leaf_rows, int leaf, int L,
                                          int lane, float* slot) {
  const float* lrow = leaf_rows + (size_t)leaf * 10 * L;
  __syncwarp();
  for (int q = lane; q < 10 * L; q += kWarp) slot[q] = __ldg(lrow + q);
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads)
closest_packet_kernel(const float* __restrict__ nodes, const float* __restrict__ leaf_rows,
                      int n_leaves, int L, int depth, const float* __restrict__ orig,
                      const float* __restrict__ dir, const float* __restrict__ t_min,
                      const float* __restrict__ t_max, const uint8_t* __restrict__ active,
                      float* __restrict__ t_out, int* __restrict__ prim_out,
                      float* __restrict__ u_out, float* __restrict__ v_out, int R) {
  __shared__ int s_stack[kWarps][kMaxStack];
  __shared__ float s_node[kWarps][kBinRow];
  __shared__ float s_leaf[kWarps][10 * kMaxLeaf];
  const int lane = threadIdx.x % kWarp;
  int* stack = s_stack[threadIdx.x / kWarp];
  float* node = s_node[threadIdx.x / kWarp];
  float* leaf = s_leaf[threadIdx.x / kWarp];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < R && active[i];
  Ray r = {};
  float best = kTMax;
  if (i < R) best = fminf(kTMax, t_max[i]);
  if (live) r = load_ray(orig, dir, t_min, i);
  int best_prim = -1;
  float best_u = 0.0f, best_v = 0.0f;
  bool ended = false;  // a push onto the full stack dropped a child this lane hit
  int sp = 0;
  // a one-leaf table starts at leaf 0; a packet with no live lane at once ends
  int cur = __any_sync(kAll, live) ? (n_leaves == 1 ? -1 : 0) : kDone;
  while (cur != kDone) {
    if (cur >= 0) {
      load_node(nodes, cur, lane, node);
      const float kl = live ? slab_child(node, 0, r, best) : kBig;
      const float kr = live ? slab_child(node, 1, r, best) : kBig;
      const unsigned any_l = __ballot_sync(kAll, kl < kBig);
      const unsigned any_r = __ballot_sync(kAll, kr < kBig);
      const int lc = __float_as_int(node[12]), rc = __float_as_int(node[13]);
      if (any_l != 0u && any_r != 0u) {
        // the lanes that miss a child hold kBig, above every hit's entry
        const bool l_near = __reduce_min_sync(kAll, ordered(kl)) <=
                            __reduce_min_sync(kAll, ordered(kr));
        if (sp >= depth - 1) {
          ended |= (l_near ? kr : kl) < kBig;
        } else {
          if (lane == 0) stack[sp] = l_near ? rc : lc;
          ++sp;
        }
        cur = l_near ? lc : rc;
        continue;
      }
      if ((any_l | any_r) != 0u) {
        cur = any_l != 0u ? lc : rc;
        continue;
      }
    } else {
      load_leaf(leaf_rows, -cur - 1, L, lane, leaf);
      if (live) {
        for (int j = 0; j < L; ++j) {
          float t, u, v;
          int prim;
          if (mt_tri(shared_tri(leaf, L, j), r, best, &t, &u, &v, &prim)) {  // t < best
            best = t; best_prim = prim; best_u = u; best_v = v;
          }
        }
      }
    }
    if (sp == 0) break;
    __syncwarp();
    cur = stack[--sp];
  }
  if (i < R) {
    const int p = !live ? -1 : ended ? -2 : best_prim;
    t_out[i] = p < 0 ? kTMax : best;
    prim_out[i] = p;
    u_out[i] = p < 0 ? 0.0f : best_u;
    v_out[i] = p < 0 ? 0.0f : best_v;
  }
}

__global__ void __launch_bounds__(kThreads)
any_packet_kernel(const float* __restrict__ nodes, const float* __restrict__ leaf_rows,
                  int n_leaves, int L, int depth, const float* __restrict__ orig,
                  const float* __restrict__ dir, const float* __restrict__ t_min,
                  const float* __restrict__ t_max, const uint8_t* __restrict__ mask,
                  uint8_t* __restrict__ occluded, int R) {
  __shared__ int s_stack[kWarps][kMaxStack];
  __shared__ float s_node[kWarps][kBinRow];
  __shared__ float s_leaf[kWarps][10 * kMaxLeaf];
  const int lane = threadIdx.x % kWarp;
  int* stack = s_stack[threadIdx.x / kWarp];
  float* node = s_node[threadIdx.x / kWarp];
  float* leaf = s_leaf[threadIdx.x / kWarp];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < R && mask[i];
  Ray r = {};
  float tmax = 0.0f;
  if (live) {
    r = load_ray(orig, dir, t_min, i);
    tmax = t_max[i];
  }
  bool occ = !live;  // masked lanes and the padding count as occluded
  int sp = 0;
  int cur = n_leaves == 1 ? -1 : 0;
  while (!__all_sync(kAll, occ)) {
    if (cur >= 0) {
      load_node(nodes, cur, lane, node);
      const float cap = occ ? -kBig : tmax;
      const bool hit_l = !occ && slab_child(node, 0, r, cap) < kBig;
      const bool hit_r = !occ && slab_child(node, 1, r, cap) < kBig;
      const unsigned any_l = __ballot_sync(kAll, hit_l);
      const unsigned any_r = __ballot_sync(kAll, hit_r);
      const int lc = __float_as_int(node[12]), rc = __float_as_int(node[13]);
      if (any_l != 0u && any_r != 0u) {
        if (sp >= depth - 1) {
          occ |= hit_r;  // an overflow reports occluded
        } else {
          if (lane == 0) stack[sp] = rc;
          ++sp;
        }
        cur = lc;
        continue;
      }
      if ((any_l | any_r) != 0u) {
        cur = any_l != 0u ? lc : rc;
        continue;
      }
    } else {
      load_leaf(leaf_rows, -cur - 1, L, lane, leaf);
      for (int j = 0; j < L && !occ; ++j) {
        float t, u, v;
        int prim;
        occ = mt_tri(shared_tri(leaf, L, j), r, tmax, &t, &u, &v, &prim);
      }
    }
    if (sp == 0) break;
    __syncwarp();
    cur = stack[--sp];
  }
  if (i < R) occluded[i] = (live && occ) ? 1 : 0;
}

}  // namespace

extern "C" {

// Launch B7a on `stream` over binary node rows. Returns the cudaError_t of
// the launch.
int crt_traverse_closest_packet(const float* nodes, const float* leaf_rows, int n_leaves, int L,
                                int depth, const float* orig, const float* dir,
                                const float* t_min, const float* t_max, const uint8_t* active,
                                float* t_out, int* prim_out, float* u_out, float* v_out, int R,
                                void* stream) {
  if (R <= 0) return 0;
  dim3 grid((R + kThreads - 1) / kThreads);
  closest_packet_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      nodes, leaf_rows, n_leaves, L, depth, orig, dir, t_min, t_max, active, t_out, prim_out,
      u_out, v_out, R);
  return static_cast<int>(cudaGetLastError());
}

// Launch B7b on `stream` over binary node rows. Returns the cudaError_t of
// the launch.
int crt_traverse_any_packet(const float* nodes, const float* leaf_rows, int n_leaves, int L,
                            int depth, const float* orig, const float* dir, const float* t_min,
                            const float* t_max, const uint8_t* mask, uint8_t* occluded, int R,
                            void* stream) {
  if (R <= 0) return 0;
  dim3 grid((R + kThreads - 1) / kThreads);
  any_packet_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      nodes, leaf_rows, n_leaves, L, depth, orig, dir, t_min, t_max, mask, occluded, R);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
