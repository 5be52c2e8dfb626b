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
// capacity S (64 or 128); its C entry switches on both. Here:
//   - B1 keeps a hit on t < best (ties inside a leaf go to the highest
//     slot); on a stack overflow it reports prim = -2, t = 1e20;
//   - B2 stops at the first t_min < t < t_max; an overflow is occluded;
//   - a miss or inactive lane is (1e20, -1, 0, 0); B2 writes occluded & mask.
// Built with -fmad=false, so t agrees with the plain version bit for bit.
//
// What bounds it on the H100: dependent row fetches. Each step of a ray
// waits on one node row (64, 128 or 256 bytes at A = 2, 4, 8) or one
// 160-byte leaf row whose address
// came from the previous fetch, so the kernel is latency bound; the hall's
// tables (224K triangles, a few MB) stay resident in the 50 MB L2, so the
// fetches are L2 hits, not HBM traffic. Rays diverge inside a warp, so a
// warp pays the union of its rays' steps.
// Later work: warp-coherent packets (one row fetch shared by a warp on
// the sorted wavefront), FMA contraction and the stack in shared memory.
// Persistent threads pulling rays from an atomic counter are B6a-B6d
// (traverse_persistent.cu), the same per-lane walk fed from a work queue.

#include "traverse_common.cuh"

namespace {

using namespace crt;

template <int A, int S>
__global__ void __launch_bounds__(kThreads)
closest_kernel(const float* __restrict__ nodes, const float* __restrict__ leaf_rows,
               int n_leaves, int L, int depth, const float* __restrict__ orig,
               const float* __restrict__ dir, const float* __restrict__ t_min,
               const float* __restrict__ t_max, const uint8_t* __restrict__ active,
               float* __restrict__ t_out, int* __restrict__ prim_out,
               float* __restrict__ u_out, float* __restrict__ v_out, int R) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  float best = fminf(kTMax, t_max[i]);
  int best_prim = -1;
  float best_u = 0.0f, best_v = 0.0f;
  if (active[i]) {
    Ray r = load_ray(orig, dir, t_min, i);
    int stack[S];
    int sp = 0;
    bool overflow = false;
    int cur = n_leaves == 1 ? -1 : 0;  // a one-leaf table starts at leaf 0
    while (cur != kDone) {
      if (cur >= 0) {
        float keys[A];
        int codes[A];
        node_step<A>(nodes, cur, r, best, keys, codes);
        for (int k = A - 1; k >= 1; --k) {
          if (keys[k] < kBig) {
            if (sp >= depth - 1) { overflow = true; break; }
            stack[sp++] = codes[k];
          }
        }
        if (overflow) break;
        if (keys[0] < kBig) { cur = codes[0]; continue; }
      } else {
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
          best = lt; best_prim = lp; best_u = lu; best_v = lv;
        }
      }
      cur = sp > 0 ? stack[--sp] : kDone;
    }
    if (overflow) best_prim = -2;
  }
  t_out[i] = best_prim < 0 ? kTMax : best;
  prim_out[i] = best_prim;
  u_out[i] = best_u;
  v_out[i] = best_v;
}

template <int A, int S>
__global__ void __launch_bounds__(kThreads)
any_kernel(const float* __restrict__ nodes, const float* __restrict__ leaf_rows,
           int n_leaves, int L, int depth, const float* __restrict__ orig,
           const float* __restrict__ dir, const float* __restrict__ t_min,
           const float* __restrict__ t_max, const uint8_t* __restrict__ mask,
           uint8_t* __restrict__ occluded, int R) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  bool occ = false;
  if (mask[i]) {
    Ray r = load_ray(orig, dir, t_min, i);
    float tmax = t_max[i];
    int stack[S];
    int sp = 0;
    int cur = n_leaves == 1 ? -1 : 0;
    while (cur != kDone && !occ) {
      if (cur >= 0) {
        float keys[A];
        int codes[A];
        node_step<A>(nodes, cur, r, tmax, keys, codes);
        for (int k = A - 1; k >= 1 && !occ; --k) {
          if (keys[k] < kBig) {
            if (sp >= depth - 1) occ = true;  // overflow reports occluded
            else stack[sp++] = codes[k];
          }
        }
        if (occ) break;
        if (keys[0] < kBig) { cur = codes[0]; continue; }
      } else {
        const float* lrow = leaf_rows + (size_t)(-cur - 1) * 10 * L;
        for (int j = 0; j < L && !occ; ++j) {
          float t, u, v;
          int prim;
          occ = mt_slot(lrow, L, j, r, tmax, &t, &u, &v, &prim);
        }
        if (occ) break;
      }
      cur = sp > 0 ? stack[--sp] : kDone;
    }
  }
  occluded[i] = occ ? 1 : 0;
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
