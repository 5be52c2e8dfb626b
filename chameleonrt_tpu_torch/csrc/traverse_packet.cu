// Grid-packet BVH traversal for Hopper (sm_90a) over binary node rows: B7a
// closest hit, one lane per ray, and B7b any hit, one warp per packet of 32
// consecutive sorted rays that share one stack.
//
// Replaces the Pallas grid-packet kernels of chameleonrt_tpu/ops/traverse_packet.py:
// B7a = _closest_kernel (:281), launched by _closest_call (pallas_call
// :627) through traverse_closest_packet (:2383); B7b = _any_kernel (:437),
// launched by _any_call (pallas_call :660) through traverse_any_packet
// (:2432). The JAX engine reaches them for a flat scene with the slot-lane
// tier off once both persistent VMEM gates fail (engine/trace_bvh.py
// :680-688, :871-879); the port reaches them with grid_packet=True.
// Binary rows (n, 16) f32: child boxes at cols 0-11, child codes at cols
// 12-13 (traverse_common.cuh has the layouts).
//
// B7a computes the TPU kernel's function, closest hit over the binary
// rows, in the plain walk's per-lane order: closest_ray over FlatRows at A
// = 2 (traverse_common.cuh), B5a's walk (traverse_stream.cu), a template on
// its stack capacity S (64 or 128) whose C entry switches on it. It is
// bit-equal to the plain version (ops/traverse.py traverse_closest on the
// same binary table): a hit is kept on t < best, ties inside a leaf go to
// the highest slot, a stack overflow reports prim = -2 as there, a miss or
// inactive lane is (1e20, -1, 0, 0). The TPU kernel's packet (:331-427)
// descends into the child of smaller packet-minimum entry t and tests every
// leaf the packet visits with every live lane, keeping a leaf's lowest tied
// slot, so it can differ from the plain walk on exact ties in t and on hits
// that a lane's own slab test culls by rounding at a box face.
//
// B7b, what it computes step by step (traverse_packet.py:486-575): a lane
// that is occluded slab-tests with cap -1e30 (:494), so it enters nothing;
// children are pushed unordered (left visited next, right pushed, :518); at
// a leaf each lane that is not occluded runs Moller-Trumbore against its
// t_max; the packet ends as soon as every lane is occluded (__all_sync;
// :501, :534, :557). Inactive lanes (and the padding past R) take part in
// no vote; the JAX wrapper gives them t_max = -1 (:2448-2452), so they count
// as occluded there. B7b writes occluded & mask. Its stack holds depth - 1
// entries, depth being the SAH build's certified binary depth plus one, in
// kMaxStack entries a warp of shared memory; a push onto a full stack
// reports the lanes that hit the dropped child occluded, as B2 does. A lane
// may find an occluder that its own walk culls by rounding at a box face,
// since every lane tests every leaf the packet visits. The 64-byte node row
// comes in one coalesced load by lanes 0-15 into the warp's node slot in
// shared memory, a leaf row in ceil(10L / 32) coalesced loads into its
// leaf slot. Not carried over from the TPU kernel: K = 64 resident packets
// of 256 rays interleaved across sublanes (_pack_rays), the node/leaf phase
// alternation by LEAF_THRESH and the stale-row leaf re-tests, which
// schedule the TPU's lockstep vector unit and VMEM.
//
// What bounds them on the H100: dependent row fetches (the hall's binary
// table, 4 MB of nodes, stays in the L2), and for B7b the packet's union of
// its lanes' walks: a warp visits every node that some lane enters, and
// every live lane runs Moller-Trumbore at every leaf the packet visits. The
// binary table doubles the node steps of BVH4 for half the bytes a row. On
// an H100 80GB HBM3 at 700 W (scripts/kernel_turns.py, PERF.md section 6)
// the per-lane B7a took 0.24 / 0.40 ms on the hall's sorted primary /
// bounce wavefronts, as B1 on the same binary table, where the packet B7a
// took 0.37 / 1.11 ms. Measured and left out: a packet with per-lane masks
// on its stack entries, each lane testing only the leaves its own box test
// entered, the row read by every lane as broadcast 16-byte loads (no shared
// slot, no __syncwarp a step) and subtrees of fewer than kNodeLanes lanes
// walked per lane: 1.3x / 2.0x the per-lane walk's time there. Built with
// -fmad=false, like B1-B6d.
// Later work (ROADMAP queue D): B7b as a per-lane any-hit walk.

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

// B7a: ray i walks the binary table alone, in the plain walk's order
// (closest_ray over FlatRows at A = 2, B5a's walk).
template <int S>
__global__ void __launch_bounds__(kThreads)
closest_packet_kernel(const float* __restrict__ nodes, const float* __restrict__ leaf_rows,
                      int n_leaves, int L, int depth, const float* __restrict__ orig,
                      const float* __restrict__ dir, const float* __restrict__ t_min,
                      const float* __restrict__ t_max, const uint8_t* __restrict__ active,
                      float* __restrict__ t_out, int* __restrict__ prim_out,
                      float* __restrict__ u_out, float* __restrict__ v_out, int R) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const FlatRows<2> t{{nodes, leaf_rows, n_leaves, 0, L}};
  closest_ray<2, S>(t, depth, orig, dir, t_min, t_max, active, t_out, prim_out, nullptr, u_out,
                    v_out, i);
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

// Launch B7a on `stream` over binary node rows with a stack of `cap`
// entries (kSmallStack or kMaxStack, at least depth). Returns the
// cudaError_t of the launch.
int crt_traverse_closest_packet(const float* nodes, const float* leaf_rows, int n_leaves, int L,
                                int depth, int cap, const float* orig, const float* dir,
                                const float* t_min, const float* t_max, const uint8_t* active,
                                float* t_out, int* prim_out, float* u_out, float* v_out, int R,
                                void* stream) {
  if (R <= 0) return 0;
  dim3 grid((R + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CRT_BY_STACK(cap, depth, closest_packet_kernel<S><<<grid, kThreads, 0, s>>>(
      nodes, leaf_rows, n_leaves, L, depth, orig, dir, t_min, t_max, active, t_out, prim_out,
      u_out, v_out, R));
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
