// Streamed-tier BVH traversal for Hopper (sm_90a), one warp per packet of
// 32 sorted rays: B5a closest hit and B5b any hit over a flat table, B5c
// closest hit and B5d any hit over a two-level (TLAS + BLAS) table.
//
// Replaces the stream=True variants of the Pallas slot-lane kernels in
// chameleonrt_tpu/ops/traverse_slotlane.py: B5a = _closest_call_slotlane
// (pallas_call :771) and B5b = _any_call_slotlane (:835) with stream=True,
// which chameleonrt_tpu/engine/trace_bvh.py reaches at :652-666 (closest)
// and :845-858 (any) when a scene's tables fail the VMEM gate. There the
// tables stay in HBM, every step DMAs one row per packet slot (:324-343
// node rows, :530-539 leaf rows), and a packet is STREAM_S = 32 sorted
// rays. Here the tables stay in device memory and one warp walks one
// packet: rays [32p, 32p + 32) of the sorted wavefront, the TPU's packet
// membership at S = 32 (_pack_sl).
//
// A step of the packet:
//   - node: lane k loads float k of the 128-byte row (one coalesced load
//     for the warp) into the warp's row slot in shared memory; each lane
//     in the step's mask slab-tests the four children with its own ray and
//     its own cap (its best t in B5a, its t_max in B5b); __ballot_sync
//     gives each child's lane mask and a warp min its packet entry key.
//     The children are ordered by that key, as _reduce_min_sl orders them;
//     the packet descends into the nearest with its mask and pushes the
//     others far-first, each with its own mask, onto the warp's stack in
//     shared memory;
//   - leaf: the warp loads the 10L-float row in ceil(10L / 32) coalesced
//     loads; each masked lane runs Moller-Trumbore on every slot with B1's
//     rule (a hit is kept on t < best; ties inside a leaf go to the highest
//     slot).
// A lane enters a child only where its own ray hits the child's box, so
// each lane culls as its own depth-first walk would; only the order of
// visits differs (the packet's nearest child first). So t and the
// occlusion flags equal the plain version's (ops/traverse.py:
// traverse_closest / traverse_any, which the kernels are held against),
// and a prim may differ only where two hits tie exactly in t. Further:
//   - B5b drops a lane from every mask once it is occluded, and the packet
//     stops once all its lanes are;
//   - the stack holds depth - 1 entries, depth being the builder's
//     certified bound plus one: a packet, like one ray, leaves at most
//     n - 1 children of each node on its path. A push onto a full stack
//     ends that child's lanes: prim = -2 (B5a) or occluded (B5b), as in
//     B1/B2;
//   - a miss or inactive lane is (1e20, -1, 0, 0); B5b writes occluded & mask.
// Not carried over from the TPU kernel: the deferred leaf FIFO and the
// group barrier over 128 packets, which keep the TPU's lockstep vector
// unit busy; a warp that owns its packet needs neither.
//
// What bounds it on the H100: the dependent row fetch of every step, now
// from HBM. The Rungholt-class tables (~520 MB) are ten times the 50 MB
// L2, so below the top levels each step waits on a miss. One coalesced
// warp load per step replaces up to 32 scattered row loads; in exchange a
// packet pays the union of its rays' steps. Later work: prefetch of the
// next row (cp.async or TMA), the stack in registers, persistent warps.
// Built with -fmad=false, like B1/B2.
//
// B5c / B5d replace the stream=True variants of the unified slot-lane
// kernels: _closest_unified_call_slotlane (pallas_call :1025) and
// _any_unified_call_slotlane (:1085) with stream=True, which
// chameleonrt_tpu/engine/trace_bvh.py reaches at :759-771 (closest) and
// :931-946 (any) when a two-level table fails the VMEM gate. They keep
// B5a/B5b's packet design and walk the fused UnifiedBvh table of B3/B4
// (traverse_unified.cu has its layout):
//   - each lane keeps its world ray w in registers beside its working ray
//     r, and the walk starts at the TLAS root, row tlas_lo;
//   - at an instance-entry leaf the warp loads the entry row's 14 floats
//     into its slot in one coalesced load, each lane in the mask builds
//     its object ray from that copy (traverse_common.cuh enter_instance),
//     and the packet continues at the BLAS root (col 12) with the same
//     mask and the instance id of col 13; an entry row never runs
//     Moller-Trumbore;
//   - whenever the next row is a TLAS row or an entry leaf every lane takes
//     its world ray back (in_world); cur belongs to the packet, so that
//     test is warp-uniform, and since the stack is LIFO an instance's BLAS
//     entries all pop before the TLAS entries beneath them, so one
//     instance id per packet holds the space of every lane in the mask;
//   - B5c keeps a hit on t < best per lane with that instance id; an
//     overflow is prim = -2; a miss, an overflow or an inactive lane is
//     (1e20, prim, -1, 0, 0) with prim -1 or -2;
//   - B5d drops occluded lanes from every mask and stops once all are
//     occluded; an overflow reports occluded; it writes occluded & mask.
// What bounds them on the H100: dependent row fetches from HBM, since the
// large San Miguel proxy's two-level BVH4 table (~160 MB) is about three
// times the 50 MB L2, plus the instance-entry transform (twelve products
// per lane at every entry). The design answers with one coalesced row
// load per packet step, and one entry-row load per packet instead of 32
// per-lane loads of the matrix. Later work: as for B5a/B5b.

#include "traverse_common.cuh"

namespace {

using namespace crt;

constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr unsigned kNoKey = 0xFFFFFFFFu;
constexpr int kSlot = 10 * kMaxLeaf;  // floats of the widest leaf row

// A subtree the packet has still to visit: its child code and the lanes
// that enter it.
struct Entry {
  int code;
  unsigned mask;
};

// Order-preserving map of a float onto unsigned bits.
__device__ __forceinline__ unsigned ordered(float x) {
  unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// One node step of the packet: row cur into the warp's slot, each lane in
// mask slab-tests the children with its own cap, and kids[0, n) are the
// children some lane hits, nearest packet entry first. Returns n.
__device__ __forceinline__ int packet_children(const float* __restrict__ nodes, int cur,
                                               unsigned mask, const Ray& r, float cap,
                                               int lane, float* slot, Entry* kids) {
  __syncwarp();
  slot[lane] = __ldg(nodes + (size_t)cur * kRow + lane);
  __syncwarp();
  float keys[kArity];
  int codes[kArity];
  slab_children(slot, r, cap, keys, codes);
  const bool in = (mask >> lane) & 1u;
  unsigned pkey[kArity];
  int n = 0;
#pragma unroll
  for (int c = 0; c < kArity; ++c) {
    const bool hit = in && keys[c] < kBig;
    kids[c].code = codes[c];
    kids[c].mask = __ballot_sync(kAll, hit);
    pkey[c] = __reduce_min_sync(kAll, hit ? ordered(keys[c]) : kNoKey);
    n += kids[c].mask != 0u;
  }
  sort_children(pkey, kids);
  return n;
}

// Cols 0-13 of instance-entry row `leaf` (matrix, BLAS root, instance id)
// into the warp's slot, in one coalesced load.
__device__ __forceinline__ void load_entry(const float* __restrict__ leaf_rows, int leaf, int L,
                                           int lane, float* slot) {
  __syncwarp();
  if (lane < kEntryCols) slot[lane] = __ldg(leaf_rows + (size_t)leaf * 10 * L + lane);
  __syncwarp();
}

// Leaf row `leaf` into the warp's slot, in coalesced loads.
__device__ __forceinline__ void load_leaf(const float* __restrict__ leaf_rows, int leaf, int L,
                                          int lane, float* slot) {
  const float* lrow = leaf_rows + (size_t)leaf * 10 * L;
  __syncwarp();
  for (int q = lane; q < 10 * L; q += kWarp) slot[q] = __ldg(lrow + q);
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads)
closest_stream_kernel(const float* __restrict__ nodes, const float* __restrict__ leaf_rows,
                      int n_leaves, int L, int depth, const float* __restrict__ orig,
                      const float* __restrict__ dir, const float* __restrict__ t_min,
                      const float* __restrict__ t_max, const uint8_t* __restrict__ active,
                      float* __restrict__ t_out, int* __restrict__ prim_out,
                      float* __restrict__ u_out, float* __restrict__ v_out, int R) {
  __shared__ Entry s_stack[kWarps][kMaxStack];
  __shared__ float s_slot[kWarps][kSlot];
  const int lane = threadIdx.x % kWarp;
  Entry* stack = s_stack[threadIdx.x / kWarp];
  float* slot = s_slot[threadIdx.x / kWarp];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < R && active[i];
  Ray r = {};
  float best = kTMax;
  if (i < R) best = fminf(kTMax, t_max[i]);
  if (live) r = load_ray(orig, dir, t_min, i);
  int best_prim = -1;
  float best_u = 0.0f, best_v = 0.0f;
  unsigned ended = 0u;  // lanes a push onto the full stack dropped
  int sp = 0;
  Entry cur = {n_leaves == 1 ? -1 : 0, __ballot_sync(kAll, live)};
  while (true) {
    cur.mask &= ~ended;
    if (cur.mask != 0u) {
      if (cur.code >= 0) {
        Entry kids[kArity];
        const int n = packet_children(nodes, cur.code, cur.mask, r, best, lane, slot, kids);
        for (int k = n - 1; k >= 1; --k) {
          if (sp >= depth - 1) {
            ended |= kids[k].mask;
          } else {
            if (lane == 0) stack[sp] = kids[k];
            ++sp;
          }
        }
        if (n > 0) { cur = kids[0]; continue; }
      } else {
        load_leaf(leaf_rows, -cur.code - 1, L, lane, slot);
        if ((cur.mask >> lane) & 1u) {
          float lt = best, lu = 0.0f, lv = 0.0f;
          int lp = -1;
          for (int j = 0; j < L; ++j) {
            float t, u, v;
            int prim;
            if (mt_tri(shared_tri(slot, L, j), r, best, &t, &u, &v, &prim) && t <= lt) {
              lt = t; lu = u; lv = v; lp = prim;
            }
          }
          if (lp >= 0) {  // some slot hit, so lt < best
            best = lt; best_prim = lp; best_u = lu; best_v = lv;
          }
        }
      }
    }
    if (sp == 0) break;
    __syncwarp();
    cur = stack[--sp];
  }
  if (i < R) {
    const int p = ((ended >> lane) & 1u) ? -2 : best_prim;
    t_out[i] = p < 0 ? kTMax : best;
    prim_out[i] = p;
    u_out[i] = best_u;
    v_out[i] = best_v;
  }
}

__global__ void __launch_bounds__(kThreads)
any_stream_kernel(const float* __restrict__ nodes, const float* __restrict__ leaf_rows,
                  int n_leaves, int L, int depth, const float* __restrict__ orig,
                  const float* __restrict__ dir, const float* __restrict__ t_min,
                  const float* __restrict__ t_max, const uint8_t* __restrict__ mask,
                  uint8_t* __restrict__ occluded, int R) {
  __shared__ Entry s_stack[kWarps][kMaxStack];
  __shared__ float s_slot[kWarps][kSlot];
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
        Entry kids[kArity];
        const int n = packet_children(nodes, cur.code, cur.mask, r, tmax, lane, slot, kids);
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

__global__ void __launch_bounds__(kThreads)
closest_unified_stream_kernel(const float* __restrict__ nodes,
                              const float* __restrict__ leaf_rows, int n_tri, int tlas_lo,
                              int L, int depth, const float* __restrict__ orig,
                              const float* __restrict__ dir, const float* __restrict__ t_min,
                              const float* __restrict__ t_max,
                              const uint8_t* __restrict__ active, float* __restrict__ t_out,
                              int* __restrict__ prim_out, int* __restrict__ inst_out,
                              float* __restrict__ u_out, float* __restrict__ v_out, int R) {
  __shared__ Entry s_stack[kWarps][kMaxStack];
  __shared__ float s_slot[kWarps][kSlot];
  const int lane = threadIdx.x % kWarp;
  Entry* stack = s_stack[threadIdx.x / kWarp];
  float* slot = s_slot[threadIdx.x / kWarp];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < R && active[i];
  Ray w = {};
  float best = kTMax;
  if (i < R) best = fminf(kTMax, t_max[i]);
  if (live) w = load_ray(orig, dir, t_min, i);
  Ray r = w;
  int inst = 0;  // the instance whose object space r holds (the packet's)
  int best_prim = -1, best_inst = -1;
  float best_u = 0.0f, best_v = 0.0f;
  unsigned ended = 0u;  // lanes a push onto the full stack dropped
  int sp = 0;
  Entry cur = {tlas_lo, __ballot_sync(kAll, live)};
  while (true) {
    cur.mask &= ~ended;
    if (cur.mask != 0u) {
      if (cur.code >= 0) {
        Entry kids[kArity];
        const int n = packet_children(nodes, cur.code, cur.mask, r, best, lane, slot, kids);
        for (int k = n - 1; k >= 1; --k) {
          if (sp >= depth - 1) {
            ended |= kids[k].mask;
          } else {
            if (lane == 0) stack[sp] = kids[k];
            ++sp;
          }
        }
        if (n > 0) {
          cur = kids[0];
          if (in_world(cur.code, n_tri, tlas_lo)) r = w;
          continue;
        }
      } else if (-cur.code - 1 < n_tri) {
        load_leaf(leaf_rows, -cur.code - 1, L, lane, slot);
        if ((cur.mask >> lane) & 1u) {
          float lt = best, lu = 0.0f, lv = 0.0f;
          int lp = -1;
          for (int j = 0; j < L; ++j) {
            float t, u, v;
            int prim;
            if (mt_tri(shared_tri(slot, L, j), r, best, &t, &u, &v, &prim) && t <= lt) {
              lt = t; lu = u; lv = v; lp = prim;
            }
          }
          if (lp >= 0) {  // some slot hit, so lt < best
            best = lt; best_prim = lp; best_inst = inst; best_u = lu; best_v = lv;
          }
        }
      } else {
        load_entry(leaf_rows, -cur.code - 1, L, lane, slot);
        if ((cur.mask >> lane) & 1u) r = enter_instance(slot, w);
        cur.code = __float_as_int(slot[12]);  // a BLAS row: stay in object space
        inst = __float_as_int(slot[13]);
        continue;
      }
    }
    if (sp == 0) break;
    __syncwarp();
    cur = stack[--sp];
    if (in_world(cur.code, n_tri, tlas_lo)) r = w;
  }
  if (i < R) {
    const int p = ((ended >> lane) & 1u) ? -2 : best_prim;
    const bool miss = p < 0;
    t_out[i] = miss ? kTMax : best;
    prim_out[i] = p;
    inst_out[i] = miss ? -1 : best_inst;
    u_out[i] = miss ? 0.0f : best_u;
    v_out[i] = miss ? 0.0f : best_v;
  }
}

__global__ void __launch_bounds__(kThreads)
any_unified_stream_kernel(const float* __restrict__ nodes, const float* __restrict__ leaf_rows,
                          int n_tri, int tlas_lo, int L, int depth,
                          const float* __restrict__ orig, const float* __restrict__ dir,
                          const float* __restrict__ t_min, const float* __restrict__ t_max,
                          const uint8_t* __restrict__ mask, uint8_t* __restrict__ occluded,
                          int R) {
  __shared__ Entry s_stack[kWarps][kMaxStack];
  __shared__ float s_slot[kWarps][kSlot];
  const int lane = threadIdx.x % kWarp;
  Entry* stack = s_stack[threadIdx.x / kWarp];
  float* slot = s_slot[threadIdx.x / kWarp];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < R && mask[i];
  Ray w = {};
  float tmax = 0.0f;
  if (live) {
    w = load_ray(orig, dir, t_min, i);
    tmax = t_max[i];
  }
  Ray r = w;
  const unsigned start = __ballot_sync(kAll, live);
  unsigned occ = 0u;  // occluded lanes, and lanes a full-stack push dropped
  int sp = 0;
  Entry cur = {tlas_lo, start};
  while ((start & ~occ) != 0u) {
    cur.mask &= ~occ;
    if (cur.mask != 0u) {
      if (cur.code >= 0) {
        Entry kids[kArity];
        const int n = packet_children(nodes, cur.code, cur.mask, r, tmax, lane, slot, kids);
        for (int k = n - 1; k >= 1; --k) {
          if (sp >= depth - 1) {
            occ |= kids[k].mask;  // an overflow reports occluded
          } else {
            if (lane == 0) stack[sp] = kids[k];
            ++sp;
          }
        }
        if (n > 0) {
          cur = kids[0];
          if (in_world(cur.code, n_tri, tlas_lo)) r = w;
          continue;
        }
      } else if (-cur.code - 1 < n_tri) {
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
      } else {
        load_entry(leaf_rows, -cur.code - 1, L, lane, slot);
        if ((cur.mask >> lane) & 1u) r = enter_instance(slot, w);
        cur.code = __float_as_int(slot[12]);
        continue;
      }
    }
    if (sp == 0) break;
    __syncwarp();
    cur = stack[--sp];
    if (in_world(cur.code, n_tri, tlas_lo)) r = w;
  }
  if (i < R) occluded[i] = ((occ >> lane) & 1u) ? 1 : 0;
}

}  // namespace

extern "C" {

// Launch B5a on `stream`. Returns the cudaError_t of the launch.
int crt_traverse_closest_stream(const float* nodes, const float* leaf_rows, int n_leaves, int L,
                                int depth, const float* orig, const float* dir,
                                const float* t_min, const float* t_max, const uint8_t* active,
                                float* t_out, int* prim_out, float* u_out, float* v_out, int R,
                                void* stream) {
  if (R <= 0) return 0;
  dim3 grid((R + kThreads - 1) / kThreads);
  closest_stream_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      nodes, leaf_rows, n_leaves, L, depth, orig, dir, t_min, t_max, active, t_out,
      prim_out, u_out, v_out, R);
  return static_cast<int>(cudaGetLastError());
}

// Launch B5b on `stream`. Returns the cudaError_t of the launch.
int crt_traverse_any_stream(const float* nodes, const float* leaf_rows, int n_leaves, int L,
                            int depth, const float* orig, const float* dir, const float* t_min,
                            const float* t_max, const uint8_t* mask, uint8_t* occluded, int R,
                            void* stream) {
  if (R <= 0) return 0;
  dim3 grid((R + kThreads - 1) / kThreads);
  any_stream_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      nodes, leaf_rows, n_leaves, L, depth, orig, dir, t_min, t_max, mask, occluded, R);
  return static_cast<int>(cudaGetLastError());
}

// Launch B5c on `stream`. Returns the cudaError_t of the launch.
int crt_traverse_closest_unified_stream(const float* nodes, const float* leaf_rows, int n_tri,
                                        int tlas_lo, int L, int depth, const float* orig,
                                        const float* dir, const float* t_min,
                                        const float* t_max, const uint8_t* active,
                                        float* t_out, int* prim_out, int* inst_out,
                                        float* u_out, float* v_out, int R, void* stream) {
  if (R <= 0) return 0;
  dim3 grid((R + kThreads - 1) / kThreads);
  closest_unified_stream_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      nodes, leaf_rows, n_tri, tlas_lo, L, depth, orig, dir, t_min, t_max, active, t_out,
      prim_out, inst_out, u_out, v_out, R);
  return static_cast<int>(cudaGetLastError());
}

// Launch B5d on `stream`. Returns the cudaError_t of the launch.
int crt_traverse_any_unified_stream(const float* nodes, const float* leaf_rows, int n_tri,
                                    int tlas_lo, int L, int depth, const float* orig,
                                    const float* dir, const float* t_min, const float* t_max,
                                    const uint8_t* mask, uint8_t* occluded, int R,
                                    void* stream) {
  if (R <= 0) return 0;
  dim3 grid((R + kThreads - 1) / kThreads);
  any_unified_stream_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      nodes, leaf_rows, n_tri, tlas_lo, L, depth, orig, dir, t_min, t_max, mask, occluded, R);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
