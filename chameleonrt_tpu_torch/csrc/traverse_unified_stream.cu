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
// What it computes is B3/B4's, by the same walks (traverse_common.cuh
// closest_two_level / any_two_level; traverse_unified.cu has the table's
// layout and the rules): the plain walk's per-lane order, the instance entry
// from the world ray, the world ray back wherever in_world holds,
// -fmad=false, a stack of the certified bound + 1 in a local array of S
// entries (64 or 128), an overflow reported as prim = -2 (B5c) or occluded
// (B5d). So both are bit-equal to the plain version (ops/traverse.py:
// traverse_closest_unified / traverse_any_unified): t, prim, instance, u
// and v, ties included. Outputs as B3/B4. Only the row source differs
// (StreamRows below).
//
// What bounds it on the H100: dependent row fetches beyond the L2. The
// large San Miguel proxy's BVH4 table is 162 MB, node rows 44 MB and
// triangle leaf rows 118 MB, against a 50 MB L2; every step of a ray waits
// on a row whose address came from the step before. The operations that
// chip_smoke._bound counts (a slab test per live child, a Moller-Trumbore
// per valid slot, a transform per instance entry) take a few percent of
// that wait. The design, in order of weight:
//   (1) one thread walks one ray, so each warp has 32 independent row
//       fetches in flight, the TPU kernel's K DMAs on one semaphore; no
//       packet pays for the union of its lanes' walks, as the warp packets
//       of the first design did (PERF.md section 6 has both designs' times);
//   (2) every ray's walk starts in the TLAS rows [tlas_lo, n_nodes) and the
//       instance-entry rows [n_tri, n_leaves), two contiguous ranges, and
//       in_world already names them. At block start one thread copies the
//       first n_tlas TLAS rows and the first n_ent entry rows into dynamic
//       shared memory with two 1-D bulk copies (TMA,
//       cp.async.bulk ... mbarrier::complete_tx, no tensor map), while
//       every thread loads its ray; each waits on the mbarrier before its
//       first step. Rows in shared memory are read there, the rest from
//       global memory. The wrapper picks the counts (traverse_cuda.
//       shared_rows): as many TLAS rows, then entry rows, as fit in 64 KB,
//       each range starting on 16 bytes; an entry range that starts 8
//       bytes past 16 (40L-byte rows at odd L) is copied from 8 bytes
//       before it, and its last 8 bytes, past the bulk copy's multiple of
//       16, by plain loads;
//   (3) the grid is B3's, one block of kThreads per kThreads rays, which
//       the block scheduler hands out as blocks end.
// Rows outside shared memory load through the read-only path, node rows
// 16 bytes a load, leaf rows four slots a batch of 16-byte loads where L
// is a multiple of 4. A grid of the card's resident blocks, each copying
// once, and L2 eviction policies on these loads (node and entry rows
// evict_last, leaf rows evict_first) were measured slower and are left out
// (PERF.md section 6 has the ablation).
// Each kernel is a template on the arity A (2, 4 or 8) and the stack
// capacity S; its C entry switches on both and allows the instantiation
// kSharedBudget bytes of dynamic shared memory on its first launch.

#include "traverse_common.cuh"

namespace {

using namespace crt;

constexpr int kSharedBudget = 64 * 1024;  // traverse_cuda.SHARED_BUDGET

struct Params {
  const float* nodes;
  const float* leaf_rows;
  int n_tri, tlas_lo, L, depth;
  int n_tlas, n_ent;  // TLAS and entry rows held in shared memory
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
  int R;
};

// Where the shared rows sit: the TLAS range at byte 0, the entry range
// from byte tlas_bytes, its first row ent_off (0 or 8) bytes in. The same
// arithmetic as traverse_cuda.shared_rows.
struct Layout {
  int tlas_bytes;  // n_tlas whole node rows of 32A bytes
  int ent_off;     // global start of the entry range mod 16
  int ent_bulk;    // bytes of the entry range's bulk copy, a multiple of 16
  int ent_bytes;   // shared bytes of the entry range, a multiple of 16
};

__host__ __device__ inline Layout shared_layout(int A, int L, int n_tri, int n_tlas, int n_ent) {
  Layout s;
  s.tlas_bytes = n_tlas * 32 * A;
  const int row = 40 * L;
  s.ent_off = n_ent > 0 ? static_cast<int>((static_cast<long long>(n_tri) * row) % 16) : 0;
  const int span = n_ent > 0 ? s.ent_off + n_ent * row : 0;
  s.ent_bulk = span / 16 * 16;
  s.ent_bytes = (span + 15) / 16 * 16;
  return s;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Thread 0 starts the copy of the shared rows; every thread must reach it
// (it holds a __syncthreads). Returns whether there is a copy to wait for.
template <int A>
__device__ __forceinline__ bool start_copy(const Params& p, const Layout& lay, unsigned char* smem,
                                           uint64_t* bar) {
  if (lay.tlas_bytes + lay.ent_bytes == 0) return false;  // block-uniform
  const uint32_t b = smem_addr(bar);
  const float* ent_src = p.leaf_rows + static_cast<size_t>(p.n_tri) * 10 * p.L;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(b), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    // the entry range's tail past the bulk copy (0 or 8 bytes), by plain loads
    const int tail = lay.ent_off + p.n_ent * 40 * p.L - lay.ent_bulk;
    float* dst = reinterpret_cast<float*>(smem + lay.tlas_bytes + lay.ent_bulk);
    const float* src = reinterpret_cast<const float*>(
        reinterpret_cast<const unsigned char*>(ent_src) - lay.ent_off + lay.ent_bulk);
    for (int k = 0; k < tail / 4; ++k) dst[k] = __ldg(src + k);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(b), "r"(lay.tlas_bytes + lay.ent_bulk) : "memory");
    if (lay.tlas_bytes > 0) {
      const float* src = p.nodes + static_cast<size_t>(p.tlas_lo) * row_floats<A>();
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
          :: "r"(smem_addr(smem)), "l"(src), "r"(lay.tlas_bytes), "r"(b) : "memory");
    }
    if (lay.ent_bulk > 0) {
      const unsigned char* src = reinterpret_cast<const unsigned char*>(ent_src) - lay.ent_off;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
          :: "r"(smem_addr(smem + lay.tlas_bytes)), "l"(src), "r"(lay.ent_bulk), "r"(b)
          : "memory");
    }
  }
  return true;
}

// Wait until the bulk copies have landed (phase 0 of the mbarrier).
__device__ __forceinline__ void wait_copy(uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(b), "r"(0) : "memory");
  } while (!done);
}

__device__ __forceinline__ float lane_of(const float4& x, int j) {
  return j == 0 ? x.x : j == 1 ? x.y : j == 2 ? x.z : x.w;
}

// A block's view of the table for the walks of traverse_common.cuh: the
// shared rows first, the rest in global memory.
template <int A>
struct StreamRows {
  const float* nodes;
  const float* leaf_rows;
  const float* s_tlas;  // TLAS rows [tlas_lo, tlas_lo + n_tlas)
  const float* s_ent;   // entry rows [n_tri, n_tri + n_ent)
  int n_tri, tlas_lo, n_tlas, n_ent, L;

  // Node row cur into registers, 16 bytes a load.
  __device__ __forceinline__ void node_row(int cur, float* row) const {
    constexpr int kRow = row_floats<A>();
    const int k = cur - tlas_lo;
    if (k >= 0 && k < n_tlas) {
      const float4* s = reinterpret_cast<const float4*>(s_tlas + k * kRow);
#pragma unroll
      for (int q = 0; q < kRow / 4; ++q) {
        const float4 x = s[q];
        row[4 * q] = x.x; row[4 * q + 1] = x.y; row[4 * q + 2] = x.z; row[4 * q + 3] = x.w;
      }
    } else {
      load_row<A>(nodes, cur, row);
    }
  }

  __device__ __forceinline__ void entry(int leaf, float* m) const {
    const int k = leaf - n_tri;
    if (k < n_ent) {
      const float* e = s_ent + k * 10 * L;
#pragma unroll
      for (int c = 0; c < kEntryCols; ++c) m[c] = e[c];
    } else {
      const float* e = leaf_rows + static_cast<size_t>(leaf) * 10 * L;
#pragma unroll
      for (int c = 0; c < kEntryCols; ++c) m[c] = __ldg(e + c);
    }
  }

  template <typename Visit>
  __device__ __forceinline__ void leaf_slots(int leaf, Visit visit) const {
    const float* lrow = leaf_rows + static_cast<size_t>(leaf) * 10 * L;
    if (L % 4 == 0) {  // rows and components start on 16 bytes: four slots a batch
      for (int j0 = 0; j0 < L; j0 += 4) {
        float4 c[10];
#pragma unroll
        for (int k = 0; k < 10; ++k) c[k] = __ldg(reinterpret_cast<const float4*>(lrow + k * L + j0));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          Tri s;
          s.v0x = lane_of(c[0], j); s.v0y = lane_of(c[1], j); s.v0z = lane_of(c[2], j);
          s.e1x = lane_of(c[3], j); s.e1y = lane_of(c[4], j); s.e1z = lane_of(c[5], j);
          s.e2x = lane_of(c[6], j); s.e2y = lane_of(c[7], j); s.e2z = lane_of(c[8], j);
          s.prim = __float_as_int(lane_of(c[9], j));
          if (visit(s)) return;
        }
      }
    } else {
      for (int j = 0; j < L; ++j)
        if (visit(load_tri(lrow, L, j))) return;
    }
  }
};

template <int A>
__device__ __forceinline__ StreamRows<A> block_rows(const Params& p, const Layout& lay,
                                                    const unsigned char* smem) {
  return {p.nodes, p.leaf_rows, reinterpret_cast<const float*>(smem),
          reinterpret_cast<const float*>(smem + lay.tlas_bytes + lay.ent_off),
          p.n_tri, p.tlas_lo, p.n_tlas, p.n_ent, p.L};
}

template <int A, int S>
__global__ void __launch_bounds__(kThreads) closest_unified_stream_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bar;
  const Layout lay = shared_layout(A, p.L, p.n_tri, p.n_tlas, p.n_ent);
  const bool copying = start_copy<A>(p, lay, smem, &bar);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < p.R && p.flag[i];
  Ray w = {};
  if (live) w = load_ray(p.orig, p.dir, p.t_min, i);  // while the copy is in flight
  if (copying) wait_copy(&bar);  // every thread, so no block ends under its copy
  if (i >= p.R) return;
  float best = fminf(kTMax, p.t_max[i]), best_u = 0.0f, best_v = 0.0f;
  int best_prim = -1, best_inst = -1;
  if (live)
    closest_two_level<A, S>(block_rows<A>(p, lay, smem), p.depth, w, best, best_prim, best_inst,
                            best_u, best_v);
  const bool miss = best_prim < 0;
  p.t_out[i] = miss ? kTMax : best;
  p.prim_out[i] = best_prim;
  p.inst_out[i] = miss ? -1 : best_inst;
  p.u_out[i] = miss ? 0.0f : best_u;
  p.v_out[i] = miss ? 0.0f : best_v;
}

template <int A, int S>
__global__ void __launch_bounds__(kThreads) any_unified_stream_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bar;
  const Layout lay = shared_layout(A, p.L, p.n_tri, p.n_tlas, p.n_ent);
  const bool copying = start_copy<A>(p, lay, smem, &bar);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < p.R && p.flag[i];
  Ray w = {};
  if (live) w = load_ray(p.orig, p.dir, p.t_min, i);
  if (copying) wait_copy(&bar);
  if (i >= p.R) return;
  p.occluded[i] =
      live && any_two_level<A, S>(block_rows<A>(p, lay, smem), p.depth, w, p.t_max[i]) ? 1 : 0;
}

// Whether each instantiation may take kSharedBudget bytes of dynamic shared
// memory yet: B5c, B5d (first index) at arity 2, 4, 8 and stack capacity
// 64, 128.
bool g_allowed[2][3][2] = {};

// Allow the instantiation its shared memory on first use, then launch one
// block of kThreads per kThreads rays. Returns the cudaError_t.
template <typename Kernel>
int launch(Kernel kernel, int A, bool* allowed, const Params& p, void* stream) {
  if (p.R <= 0) return 0;
  if (p.n_tlas < 0 || p.n_ent < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay = shared_layout(A, p.L, p.n_tri, p.n_tlas, p.n_ent);
  const int bytes = lay.tlas_bytes + lay.ent_bytes;
  if (bytes > kSharedBudget) return static_cast<int>(cudaErrorInvalidValue);
  if (!*allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSharedBudget);
    if (err != cudaSuccess) return static_cast<int>(err);
    *allowed = true;
  }
  const int grid = (p.R + kThreads - 1) / kThreads;
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

constexpr int arity_slot(int arity) { return arity == 2 ? 0 : arity == 4 ? 1 : 2; }
constexpr int stack_slot(int cap) { return cap == kSmallStack ? 0 : 1; }

}  // namespace

extern "C" {

// Launch B5c on `stream` over node rows of `arity` children with a stack of
// `cap` entries (kSmallStack or kMaxStack, at least depth), holding TLAS
// rows [tlas_lo, tlas_lo + n_tlas) and entry rows [n_tri, n_tri + n_ent)
// in shared memory. Returns the cudaError_t of the launch.
int crt_traverse_closest_unified_stream(const float* nodes, const float* leaf_rows, int n_tri,
                                        int tlas_lo, int arity, int L, int depth, int cap,
                                        int n_tlas, int n_ent, const float* orig,
                                        const float* dir, const float* t_min,
                                        const float* t_max, const uint8_t* active, float* t_out,
                                        int* prim_out, int* inst_out, float* u_out, float* v_out,
                                        int R, void* stream) {
  const Params p{nodes, leaf_rows, n_tri, tlas_lo, L, depth, n_tlas, n_ent, orig, dir, t_min,
                 t_max, active, t_out, prim_out, inst_out, u_out, v_out, nullptr, R};
  CRT_BY_ARITY_STACK(arity, cap, depth, return launch(closest_unified_stream_kernel<A, S>, A,
                                                      &g_allowed[0][arity_slot(A)][stack_slot(S)],
                                                      p, stream));
}

// Launch B5d on `stream`, as B5c.
int crt_traverse_any_unified_stream(const float* nodes, const float* leaf_rows, int n_tri,
                                    int tlas_lo, int arity, int L, int depth, int cap, int n_tlas,
                                    int n_ent, const float* orig, const float* dir,
                                    const float* t_min, const float* t_max, const uint8_t* mask,
                                    uint8_t* occluded, int R, void* stream) {
  const Params p{nodes, leaf_rows, n_tri, tlas_lo, L, depth, n_tlas, n_ent, orig, dir, t_min,
                 t_max, mask, nullptr, nullptr, nullptr, nullptr, nullptr, occluded, R};
  CRT_BY_ARITY_STACK(arity, cap, depth, return launch(any_unified_stream_kernel<A, S>, A,
                                                      &g_allowed[1][arity_slot(A)][stack_slot(S)],
                                                      p, stream));
}

}  // extern "C"
