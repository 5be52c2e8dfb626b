// Grid-packet BVH traversal for Hopper (sm_90a) over binary node rows: B7a
// closest hit and B7b any hit, one lane per ray.
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
// Both compute the TPU kernel's function over the binary rows in the plain
// walk's per-lane order, over FlatRows at A = 2 (traverse_common.cuh), each
// a template on its stack capacity S (64 or 128) whose C entry switches on
// it:
//   - B7a, closest hit: closest_ray, B5a's walk (traverse_stream.cu; the
//     top kShortStack stack entries in shared memory). It is
//     bit-equal to ops/traverse.py traverse_closest on the same binary
//     table: a hit is kept on t < best, ties inside a leaf go to the
//     highest slot, a stack overflow reports prim = -2 as there, a miss or
//     inactive lane is (1e20, -1, 0, 0);
//   - B7b, any hit: any_ray, B5b's walk with node rows in a loop of their
//     own, as B7a's are (any_two_level at A = 2). It is bit-equal to
//     ops/traverse.py traverse_any on the same binary table: a push onto a
//     full stack reports the ray occluded, and B7b writes occluded & mask,
//     so a masked lane is never occluded.
// The TPU kernels walk a packet of rays with one stack. B7a's packet
// (:331-427) descends into the child of smaller packet-minimum entry t;
// B7b's (:486-575) pushes children unordered (:518) and ends once every
// lane is occluded. Both test every leaf the packet visits with every live
// lane. So they can differ from the plain walk on exact ties in t (B7a),
// on hits that a lane's own slab test culls by rounding at a box face, and
// on which lanes overflow. Not carried over: K = 64 resident packets of 256
// rays interleaved across sublanes (_pack_rays), the node/leaf phase
// alternation by LEAF_THRESH and the stale-row leaf re-tests, which
// schedule the TPU's lockstep vector unit and VMEM.
//
// What bounds them on the H100: dependent row fetches (the hall's binary
// table, 4 MB of nodes, stays in the L2). The binary table doubles the node
// steps of BVH4 for half the bytes a row. On an H100 80GB HBM3 at 700 W
// (scripts/kernel_turns.py, PERF.md section 6) the per-lane B7a took 0.24 /
// 0.40 ms on the hall's sorted primary / bounce wavefronts, as B1 on the
// same binary table, where the packet B7a took 0.37 / 1.11 ms; the top 8
// stack entries in shared memory took 11% / 21% off it (0.229 / 0.382 ms
// with a local stack, 0.205 / 0.304 with them). The per-lane
// B7b took 0.19 / 0.21 ms there and 0.15 / 0.11 ms on the first-bounce
// light / bsdf shadow rays of a grid_packet=True frame, where the packet
// B7b took 0.28 / 0.48 and 0.25 / 0.13 ms, and B2's own walk then on the
// same binary table 0.18 / 0.20 and 0.14 / 0.10; taking node rows in a loop
// of their own, as B7a does (any_two_level at A = 2), took a further
// 4.6-6% off the primary rays and moved the others within the spread of
// duplicate trees. Measured
// and left out: a B7a packet with per-lane masks on its stack entries, each
// lane testing only the leaves its own box test entered, the row read by
// every lane as broadcast 16-byte loads (no shared slot, no __syncwarp a
// step) and subtrees of fewer than kNodeLanes lanes walked per lane: 1.3x /
// 2.0x the per-lane B7a's time there; and B7a's top 8 stack entries in
// shared memory in B7b's walk too, 3.5% slower on the bounce rays. Built
// with -fmad=false, like B1-B6d. B1 and B6a run B7a's walk, B2 and B6b
// B7b's, at every arity.

#include "traverse_common.cuh"

namespace {

using namespace crt;

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

// B7b: ray i walks the binary table alone, in the plain walk's order
// (any_ray over FlatRows at A = 2, B5b's walk).
template <int S>
__global__ void __launch_bounds__(kThreads)
any_packet_kernel(const float* __restrict__ nodes, const float* __restrict__ leaf_rows,
                  int n_leaves, int L, int depth, const float* __restrict__ orig,
                  const float* __restrict__ dir, const float* __restrict__ t_min,
                  const float* __restrict__ t_max, const uint8_t* __restrict__ mask,
                  uint8_t* __restrict__ occluded, int R) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const FlatRows<2> t{{nodes, leaf_rows, n_leaves, 0, L}};
  any_ray<2, S>(t, depth, orig, dir, t_min, t_max, mask, occluded, i);
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

// Launch B7b on `stream` over binary node rows with a stack of `cap`
// entries (kSmallStack or kMaxStack, at least depth). Returns the
// cudaError_t of the launch.
int crt_traverse_any_packet(const float* nodes, const float* leaf_rows, int n_leaves, int L,
                            int depth, int cap, const float* orig, const float* dir,
                            const float* t_min, const float* t_max, const uint8_t* mask,
                            uint8_t* occluded, int R, void* stream) {
  if (R <= 0) return 0;
  dim3 grid((R + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CRT_BY_STACK(cap, depth, any_packet_kernel<S><<<grid, kThreads, 0, s>>>(
      nodes, leaf_rows, n_leaves, L, depth, orig, dir, t_min, t_max, mask, occluded, R));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
