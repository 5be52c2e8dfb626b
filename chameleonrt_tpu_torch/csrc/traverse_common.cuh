// Device helpers shared by the traversal kernels (traverse_flat.cu: B1, B2;
// traverse_unified.cu: B3, B4; traverse_stream.cu: B5a, B5b;
// traverse_unified_stream.cu: B5c, B5d; traverse_persistent.cu: B6a, B6b,
// B6c, B6d; traverse_packet.cu: B7a, B7b, on binary rows only).
//
// Semantics shared with the plain torch version
// (chameleonrt_tpu_torch/ops/traverse.py):
//   - node rows (n, 8A) f32 for an arity A of 2 (the binary table), 4
//     (BVH4) or 8 (BVH8): child c's box at [6c, 6c+6), child codes at
//     [6A, 7A) (bitcast int32; code < 0 is leaf -(code+1)); empty wide
//     slots have lo = hi = 1e30 and never pass the slab test. Every helper
//     that reads a row takes A as a template parameter, and each kernel is
//     instantiated for the three arities; its C entry takes the arity and
//     switches on it (CRT_BY_ARITY);
//   - leaf rows (n_leaves, 10L) f32, component-major v0 e1 e2 prim;
//   - hit children are sorted by entry distance with the plain version's
//     sorting network for A (_SORT_NETS, strict >), the nearest is visited
//     next and the others are pushed far-first; a push onto a full stack
//     (depth - 1 entries) is an overflow;
//   - Moller-Trumbore with det eps 1e-9 and barycentric band 4e-6.
// Every file is built with -fmad=false so every product and sum rounds as
// in the plain version.
//
// The two-level walks (B3/B4, B5c/B5d, B6c/B6d) are closest_two_level and
// any_two_level below, templates on a row source (GlobalRows). The closest
// walk runs node rows in a loop of their own that the warp leaves once most
// of its lanes wait at a leaf; the any walk is one loop over node rows,
// triangle leaves and instance entries (any_two_level says why). B1, B5a,
// B6a and B7a run the same closest walk, B2, B5b, B6b and B7b the same any
// walk, over a flat table (FlatRows: no TLAS, no instance entries, so the
// world-ray restore and the entry branch compile away).
//
// Stacks: depth, the SAH build's certified bound + 1, reaches 76 on BVH8
// tables of the main-path scenes. Every kernel walks one ray a lane and
// keeps a local array of S entries, S a template parameter instantiated at
// kSmallStack and kMaxStack; its C entry switches on the capacity the
// wrapper picks (CRT_BY_STACK), the smallest that holds depth, so a BVH4
// table keeps the 64-entry array. The closest walk over a flat table (B1,
// B5a, B6a, B7a) keeps its top kShortStack entries in shared memory
// instead, 4 KB a block of kThreads (closest_two_level says why only there;
// any_two_level why not the any walk).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace crt {

constexpr int kSmallStack = 64;   // _build.STACK_CAPACITIES[0]
constexpr int kMaxStack = 128;    // _build.MAX_STACK
constexpr int kMaxLeaf = 16;      // _build.MAX_LEAF
constexpr int kThreads = 128;
constexpr int kNodeLanes = 8;  // the walks' node loops: lanes that keep one going
// the top stack entries that the closest walk keeps in shared memory over a
// flat table (ring_column; B1, B5a, B6a, B7a)
constexpr int kShortStack = 8;
constexpr int kDone = 0x7FFFFFFF;
constexpr float kTMax = 1e20f;
constexpr float kBig = 1e30f;
constexpr float kMtEps = 1e-9f;
constexpr float kUvEps = 4e-6f;
constexpr float kOnePlusUvEps = 1.0f + 4e-6f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tmin;
};

// min / max that treat a NaN operand as an unbounded slab side, as the
// oracle's NaN-propagating minimum followed by NaN -> -inf / +inf does.
__device__ __forceinline__ float near_of(float a, float b) {
  return (isnan(a) || isnan(b)) ? -INFINITY : fminf(a, b);
}
__device__ __forceinline__ float far_of(float a, float b) {
  return (isnan(a) || isnan(b)) ? INFINITY : fmaxf(a, b);
}

template <typename K, typename C>
__device__ __forceinline__ void cswap(K* k, C* c, int i, int j) {
  if (k[i] > k[j]) {
    K tk = k[i]; k[i] = k[j]; k[j] = tk;
    C tc = c[i]; c[i] = c[j]; c[j] = tc;
  }
}

// Floats per node row of arity A.
template <int A>
__host__ __device__ constexpr int row_floats() {
  static_assert(A == 2 || A == 4 || A == 8, "node rows are binary, BVH4 or BVH8");
  return 8 * A;
}

// One node row into registers, 16 bytes a load.
template <int A>
__device__ __forceinline__ void load_row(const float* __restrict__ nodes, int cur, float* row) {
  constexpr int kRow = row_floats<A>();
  const float4* row4 = reinterpret_cast<const float4*>(nodes + (size_t)cur * kRow);
#pragma unroll
  for (int q = 0; q < kRow / 4; ++q) {
    float4 x = __ldg(row4 + q);
    row[4 * q] = x.x; row[4 * q + 1] = x.y; row[4 * q + 2] = x.z; row[4 * q + 3] = x.w;
  }
}

// Slab test of child c of a row already in registers or shared memory
// against one ray: its entry distance, kBig on a miss.
__device__ __forceinline__ float slab_child(const float* row, int c, const Ray& r, float tmax) {
  const float* b = row + 6 * c;
  float tx0 = (b[0] - r.ox) * r.ix, tx1 = (b[3] - r.ox) * r.ix;
  float ty0 = (b[1] - r.oy) * r.iy, ty1 = (b[4] - r.oy) * r.iy;
  float tz0 = (b[2] - r.oz) * r.iz, tz1 = (b[5] - r.oz) * r.iz;
  float entry = fmaxf(fmaxf(near_of(tx0, tx1), near_of(ty0, ty1)),
                      fmaxf(near_of(tz0, tz1), r.tmin));
  float exit_ = fminf(fminf(far_of(tx0, tx1), far_of(ty0, ty1)),
                      fminf(far_of(tz0, tz1), tmax));
  return (entry <= exit_) ? entry : kBig;
}

// Slab test of the A children of a row already in registers or shared
// memory against one ray: keys[c] = entry distance of child c, kBig on a
// miss; codes[c] its child code. Unsorted.
template <int A>
__device__ __forceinline__ void slab_children(const float* row, const Ray& r, float tmax,
                                              float* keys, int* codes) {
#pragma unroll
  for (int c = 0; c < A; ++c) {
    keys[c] = slab_child(row, c, r, tmax);
    codes[c] = __float_as_int(row[6 * A + c]);
  }
}

// The plain version's sorting network for arity A (ops/traverse.py
// _SORT_NETS: one compare-exchange for 2, Bose-Nelson for 4, Batcher's
// odd-even merge for 8), each compare-exchange swapping on strict >, so
// ties keep the plain walk's order: (keys, codes) ascending by key.
template <int A, typename K, typename C>
__device__ __forceinline__ void sort_children(K* keys, C* codes) {
  if constexpr (A == 2) {
    cswap(keys, codes, 0, 1);
  } else if constexpr (A == 4) {
    cswap(keys, codes, 0, 1);
    cswap(keys, codes, 2, 3);
    cswap(keys, codes, 0, 2);
    cswap(keys, codes, 1, 3);
    cswap(keys, codes, 1, 2);
  } else {
    static_assert(A == 8, "node rows are binary, BVH4 or BVH8");
    cswap(keys, codes, 0, 1); cswap(keys, codes, 2, 3);
    cswap(keys, codes, 4, 5); cswap(keys, codes, 6, 7);
    cswap(keys, codes, 0, 2); cswap(keys, codes, 1, 3);
    cswap(keys, codes, 4, 6); cswap(keys, codes, 5, 7);
    cswap(keys, codes, 1, 2); cswap(keys, codes, 5, 6);
    cswap(keys, codes, 0, 4); cswap(keys, codes, 1, 5);
    cswap(keys, codes, 2, 6); cswap(keys, codes, 3, 7);
    cswap(keys, codes, 2, 4); cswap(keys, codes, 3, 5);
    cswap(keys, codes, 1, 2); cswap(keys, codes, 3, 4); cswap(keys, codes, 5, 6);
  }
}

// One triangle slot of a leaf row: v0, e1, e2 and the prim id.
struct Tri {
  float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
  int prim;
};

// Slot j of a component-major leaf row in device memory (read-only path).
__device__ __forceinline__ Tri load_tri(const float* __restrict__ lrow, int L, int j) {
  Tri s;
  s.v0x = __ldg(lrow + 0 * L + j); s.v0y = __ldg(lrow + 1 * L + j); s.v0z = __ldg(lrow + 2 * L + j);
  s.e1x = __ldg(lrow + 3 * L + j); s.e1y = __ldg(lrow + 4 * L + j); s.e1z = __ldg(lrow + 5 * L + j);
  s.e2x = __ldg(lrow + 6 * L + j); s.e2y = __ldg(lrow + 7 * L + j); s.e2z = __ldg(lrow + 8 * L + j);
  s.prim = __float_as_int(__ldg(lrow + 9 * L + j));
  return s;
}

// Moller-Trumbore for one slot; the operation order is the plain
// version's, term by term.
__device__ __forceinline__ bool mt_tri(const Tri& s, const Ray& r, float tmax, float* t_out,
                                       float* u_out, float* v_out, int* prim_out) {
  const float v0x = s.v0x, v0y = s.v0y, v0z = s.v0z;
  const float e1x = s.e1x, e1y = s.e1y, e1z = s.e1z;
  const float e2x = s.e2x, e2y = s.e2y, e2z = s.e2z;
  const int prim = s.prim;
  float px = r.dy * e2z - r.dz * e2y;
  float py = r.dz * e2x - r.dx * e2z;
  float pz = r.dx * e2y - r.dy * e2x;
  float det = e1x * px + e1y * py + e1z * pz;
  bool small = fabsf(det) < kMtEps;
  float inv = 1.0f / (small ? 1.0f : det);
  float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  float u = (tx * px + ty * py + tz * pz) * inv;
  float qx = ty * e1z - tz * e1y;
  float qy = tz * e1x - tx * e1z;
  float qz = tx * e1y - ty * e1x;
  float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
  float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  *t_out = t; *u_out = u; *v_out = v; *prim_out = prim;
  return !small && prim >= 0 && u >= -kUvEps && v >= -kUvEps && u + v <= kOnePlusUvEps &&
         t > r.tmin && t < tmax;
}

// Two-level tables (B3, B4, B5c, B5d, B6c, B6d): an instance-entry row holds the 3x4
// world-to-object matrix at cols 0-11 (row-major), the BLAS root row at
// col 12 and the instance id at col 13 (both bitcast int32).
constexpr int kEntryCols = 14;

// The object-space ray of an instance: the world ray w through the matrix
// m (an entry row's cols 0-11, in registers or shared memory), each sum
// left to right as in the plain version. Directions are not renormalized,
// so object t is world t.
__device__ __forceinline__ Ray enter_instance(const float* m, const Ray& w) {
  Ray r;
  r.ox = m[0] * w.ox + m[1] * w.oy + m[2] * w.oz + m[3];
  r.oy = m[4] * w.ox + m[5] * w.oy + m[6] * w.oz + m[7];
  r.oz = m[8] * w.ox + m[9] * w.oy + m[10] * w.oz + m[11];
  r.dx = m[0] * w.dx + m[1] * w.dy + m[2] * w.dz;
  r.dy = m[4] * w.dx + m[5] * w.dy + m[6] * w.dz;
  r.dz = m[8] * w.dx + m[9] * w.dy + m[10] * w.dz;
  r.ix = 1.0f / r.dx; r.iy = 1.0f / r.dy; r.iz = 1.0f / r.dz;
  r.tmin = w.tmin;
  return r;
}

// True where the walk at `cur` runs in world space: a TLAS row or an
// instance-entry leaf (or the end, where it does not matter). Whenever the
// next step is such a row, the world ray comes back: the stack is LIFO, so
// an instance's BLAS entries all pop before the TLAS entries beneath them.
__device__ __forceinline__ bool in_world(int cur, int n_tri, int tlas_lo) {
  return cur >= tlas_lo || (cur < 0 && -cur - 1 >= n_tri);
}

// The C entries' switch onto a kernel's three instantiations: runs the
// statement given (a launch, or a return) with the constant A set to
// arity (2, 4 or 8), then returns cudaGetLastError(); any other arity
// returns cudaErrorInvalidValue and launches nothing.
#define CRT_BY_ARITY(arity, ...)                                  \
  switch (arity) {                                                \
    case 2: { constexpr int A = 2; __VA_ARGS__; } break;          \
    case 4: { constexpr int A = 4; __VA_ARGS__; } break;          \
    case 8: { constexpr int A = 8; __VA_ARGS__; } break;          \
    default: return static_cast<int>(cudaErrorInvalidValue);      \
  }                                                               \
  return static_cast<int>(cudaGetLastError())

// The kernels' switch onto their stack capacity, inside
// CRT_BY_ARITY: runs the statement given with the constant S set to cap
// (kSmallStack or kMaxStack); a depth outside [2, cap], or any other
// capacity, returns cudaErrorInvalidValue and launches nothing.
#define CRT_BY_STACK(cap, depth, ...)                                                  \
  do {                                                                                 \
    if ((depth) < 2 || (depth) > (cap)) return static_cast<int>(cudaErrorInvalidValue); \
    switch (cap) {                                                                     \
      case kSmallStack: { constexpr int S = kSmallStack; __VA_ARGS__; } break;         \
      case kMaxStack: { constexpr int S = kMaxStack; __VA_ARGS__; } break;             \
      default: return static_cast<int>(cudaErrorInvalidValue);                         \
    }                                                                                  \
  } while (0)

#define CRT_BY_ARITY_STACK(arity, cap, depth, ...) \
  CRT_BY_ARITY(arity, CRT_BY_STACK(cap, depth, __VA_ARGS__))

__device__ __forceinline__ Ray load_ray(const float* orig, const float* dir,
                                        const float* t_min, int i) {
  Ray r;
  r.ox = orig[3 * i]; r.oy = orig[3 * i + 1]; r.oz = orig[3 * i + 2];
  r.dx = dir[3 * i]; r.dy = dir[3 * i + 1]; r.dz = dir[3 * i + 2];
  r.ix = 1.0f / r.dx; r.iy = 1.0f / r.dy; r.iz = 1.0f / r.dz;
  r.tmin = t_min[i];
  return r;
}

// A two-level table's rows read from global memory through the read-only
// path: the row source of B3/B4, B5c/B5d and B6c/B6d for the walks below. A
// row source T of arity A holds n_tri and tlas_lo and reads
//   t.node_row(cur, row): node row cur into row[8A];
//   t.entry(leaf, m): instance-entry leaf's cols 0-13 into m[kEntryCols];
//   t.leaf_slots(leaf, visit): visit(Tri) on triangle leaf `leaf`'s slots
//     0, 1, ... until it returns true.
// Node rows load 16 bytes at a time. An entry row is three 16-byte loads
// and one of 8 where L is even (40L-byte rows then start on 16 bytes), else
// seven of 8 bytes. Where L is even a leaf's slots come two at a time, as
// ten 8-byte loads (one per component) in flight together; odd L read slot
// by slot. Four slots a batch (ten 16-byte loads) held 16 more registers
// and measured slower on bounce rays (PERF.md section 6).
template <int A>
struct GlobalRows {
  static constexpr bool kTwoLevel = true;
  const float* nodes;
  const float* leaf_rows;
  int n_tri, tlas_lo, L;

  // the walk's first row: the TLAS root
  __device__ __forceinline__ int root() const { return tlas_lo; }
  __device__ __forceinline__ void node_row(int cur, float* row) const {
    load_row<A>(nodes, cur, row);
  }
  __device__ __forceinline__ void entry(int leaf, float* m) const {
    const float* erow = leaf_rows + static_cast<size_t>(leaf) * 10 * L;
    if (L % 2 == 0) {
      const float4* e4 = reinterpret_cast<const float4*>(erow);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float4 x = __ldg(e4 + q);
        m[4 * q] = x.x; m[4 * q + 1] = x.y; m[4 * q + 2] = x.z; m[4 * q + 3] = x.w;
      }
      const float2 y = __ldg(reinterpret_cast<const float2*>(erow + 12));
      m[12] = y.x; m[13] = y.y;
    } else {
      const float2* e2 = reinterpret_cast<const float2*>(erow);
#pragma unroll
      for (int q = 0; q < kEntryCols / 2; ++q) {
        const float2 x = __ldg(e2 + q);
        m[2 * q] = x.x; m[2 * q + 1] = x.y;
      }
    }
  }
  template <typename Visit>
  __device__ __forceinline__ void leaf_slots(int leaf, Visit visit) const {
    const float* lrow = leaf_rows + static_cast<size_t>(leaf) * 10 * L;
    if (L % 2 != 0) {
      for (int j = 0; j < L; ++j)
        if (visit(load_tri(lrow, L, j))) return;
      return;
    }
    for (int j0 = 0; j0 < L; j0 += 2) {
      float2 c[10];
#pragma unroll
      for (int k = 0; k < 10; ++k) c[k] = __ldg(reinterpret_cast<const float2*>(lrow + k * L + j0));
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        Tri s;
        s.v0x = j ? c[0].y : c[0].x; s.v0y = j ? c[1].y : c[1].x; s.v0z = j ? c[2].y : c[2].x;
        s.e1x = j ? c[3].y : c[3].x; s.e1y = j ? c[4].y : c[4].x; s.e1z = j ? c[5].y : c[5].x;
        s.e2x = j ? c[6].y : c[6].x; s.e2y = j ? c[7].y : c[7].x; s.e2z = j ? c[8].y : c[8].x;
        s.prim = __float_as_int(j ? c[9].y : c[9].x);
        if (visit(s)) return;
      }
    }
  }
};

// A flat table's rows (B1, B2, B5a, B5b, B6a, B6b, B7a, B7b): GlobalRows
// with n_tri the number of leaves, every leaf a triangle leaf and no TLAS.
// The walk starts at the root row, or at leaf 0 where the table is a single
// leaf.
template <int A>
struct FlatRows : GlobalRows<A> {
  static constexpr bool kTwoLevel = false;
  __device__ __forceinline__ int root() const { return this->n_tri == 1 ? -1 : 0; }
};

// The closest walk's stack: a local array of S entries, of which depth - 1
// may be filled, pushed and popped in LIFO order (sp entries). With K > 0
// (a power of two) its top K entries sit in shared memory instead, in a
// ring of K slots a thread laid out [slot][threadIdx.x] (ring_column), so
// at kThreads = 128 every lane of a warp reads its own bank: entries
// [0, lo) are in the local array at their own index, [lo, sp) in the ring
// at slot index mod K. A push onto a full ring first spills the ring's
// oldest entry to the local array; a pop on an empty ring takes the local
// array's top. K = 0 is the local array alone.
template <int K>
__device__ __forceinline__ int* ring_column() {
  if constexpr (K > 0) {
    static_assert((K & (K - 1)) == 0, "the ring holds a power of two of entries");
    __shared__ int rings[K * kThreads];
    return rings + threadIdx.x;
  } else {
    return nullptr;
  }
}

template <int K>
__device__ __forceinline__ void push_entry(int* stack, int& sp, int& lo, int* ring, int code) {
  if constexpr (K > 0) {
    if (sp - lo == K) {
      stack[lo] = ring[(lo & (K - 1)) * kThreads];
      ++lo;
    }
    ring[(sp & (K - 1)) * kThreads] = code;
    ++sp;
  } else {
    stack[sp++] = code;
  }
}

// the top entry, or kDone on an empty stack
template <int K>
__device__ __forceinline__ int pop_entry(const int* stack, int& sp, int& lo, const int* ring) {
  if constexpr (K > 0) {
    if (sp == 0) return kDone;
    --sp;
    if (sp < lo) {
      lo = sp;
      return stack[sp];
    }
    return ring[(sp & (K - 1)) * kThreads];
  } else {
    return sp > 0 ? stack[--sp] : kDone;
  }
}

// The closest-hit walk of one live world ray w over the rows of t (B1, B3,
// B5a, B5c, B6a, B6c, B7a; over FlatRows B1, B5a, B6a and B7a): the rules
// of traverse_unified.cu's header, a stack of S entries of which depth - 1
// may be filled. Over FlatRows its top kShortStack entries sit in shared
// memory (ring_column): on an H100 80GB HBM3 at 700 W
// (scripts/kernel_turns.py, PERF.md section 6) that took 5-21% off the
// flat walks on the hall's and the city's wavefronts, where over
// GlobalRows it cost B3, B5c and B6c 4-11% on the San Miguel proxies', so the
// two-level walk keeps its stack in local memory.
// Updates (best, best_prim, best_inst, best_u, best_v) on each nearer hit.
// An overflow sets best_prim = -2: a two-level walk ends there (its result
// is then a miss, u = v = 0), a flat one drops the pushes that do not fit
// and walks on, as the plain walk does, whose u and v a flat overflow
// reports. Node rows run in a loop of their own (Aila and Laine's
// "while-while", HPG 2009), so the lanes of a warp that are descending take
// their node rows together, and a lane at a triangle leaf or an instance
// entry waits at the loop's end. The warp leaves the node loop once fewer
// than kNodeLanes of its lanes are still in it: the waiting lanes then take
// their leaves together, and the others resume their node rows after.
// Where the warp took the loop to its end, its lanes waited on a few long
// descents. Each lane visits its rows in the plain walk's order, one at a
// time, whenever it leaves the loop: no speculative step, no postponed
// leaf, so ties break as there.
template <int A, int S, typename T>
__device__ __forceinline__ void closest_two_level(const T& t, int depth, const Ray& w,
                                                  float& best, int& best_prim, int& best_inst,
                                                  float& best_u, float& best_v) {
  constexpr int K = T::kTwoLevel ? 0 : kShortStack;
  Ray r = w;
  int inst = 0;  // the instance whose object space r holds
  bool overflow = false;  // a flat walk's dropped push
  int stack[S];
  int sp = 0;
  [[maybe_unused]] int lo = 0;  // K > 0: entries below lo are in stack, the others in ring
  [[maybe_unused]] int* const ring = ring_column<K>();
  int cur = t.root();
  while (cur != kDone) {
    // 0 <= cur < kDone: a node row
    while (static_cast<unsigned>(cur) < static_cast<unsigned>(kDone)) {
      float row[row_floats<A>()];
      t.node_row(cur, row);
      float keys[A];
      int codes[A];
      slab_children<A>(row, r, best, keys, codes);
      sort_children<A>(keys, codes);
      for (int k = A - 1; k >= 1; --k) {
        if (keys[k] < kBig) {
          if (sp >= depth - 1) {  // overflow
            if constexpr (T::kTwoLevel) {
              best_prim = -2;
              return;
            }
            overflow = true;
          } else {
            push_entry<K>(stack, sp, lo, ring, codes[k]);
          }
        }
      }
      cur = keys[0] < kBig ? codes[0] : pop_entry<K>(stack, sp, lo, ring);
      if constexpr (T::kTwoLevel)
        if (in_world(cur, t.n_tri, t.tlas_lo)) r = w;  // a pop onto a TLAS row
      if (__popc(__activemask()) < kNodeLanes) break;  // most of the warp waits
    }
    if (cur >= 0) continue;  // a node row still, or kDone
    if (!T::kTwoLevel || -cur - 1 < t.n_tri) {
      float lt = best, lu = 0.0f, lv = 0.0f;
      int lp = -1;
      t.leaf_slots(-cur - 1, [&](const Tri& s) {
        float tt, u, v;
        int prim;
        if (mt_tri(s, r, best, &tt, &u, &v, &prim) && tt <= lt) {
          lt = tt; lu = u; lv = v; lp = prim;
        }
        return false;
      });
      if (lp >= 0) {  // some slot hit, so lt < best
        best = lt; best_prim = lp; best_inst = inst; best_u = lu; best_v = lv;
      }
      cur = pop_entry<K>(stack, sp, lo, ring);
      if constexpr (T::kTwoLevel)
        if (in_world(cur, t.n_tri, t.tlas_lo)) r = w;
    } else if constexpr (T::kTwoLevel) {
      float m[kEntryCols];
      t.entry(-cur - 1, m);
      r = enter_instance(m, w);
      cur = __float_as_int(m[12]);  // a BLAS row: stay in object space
      inst = __float_as_int(m[13]);
    }
  }
  if (overflow) best_prim = -2;
}

// The any-hit walk of one live world ray w over the rows of t (B4, B5d,
// B6d; over FlatRows B2, B5b, B6b and B7b): whether some t_min < t < tmax
// hit exists; an overflow is occluded at the push that does not fit, as
// the plain walk reports it. One loop over node rows, triangle leaves and
// instance entries; over FlatRows the world-ray restore and the entry
// branch compile away. Over binary FlatRows (A = 2: B7b, and the binary
// instantiations of B2, B5b and B6b) node rows run in a loop of their own
// that the warp leaves once fewer than kNodeLanes of its lanes are in it,
// as in closest_two_level: a binary leaf costs about twice the node steps
// of a BVH4 one. Measured on an H100 80GB HBM3 at 700 W
// (scripts/kernel_turns.py, PERF.md section 6), that loop took 4.6-6% off
// B7b on the hall's primary rays and moved its bounce and shadow rays
// within the spread of duplicate trees; at A = 4 it cost B5b 4% on the
// city's bounce rays, and on the two-level walk it cost B6d's and B5d's
// primary rays 1-2% (while taking 1-4% off B6d's bounce and shadow rays),
// so A = 4 and 8 and the two-level walk keep one loop. The stack is a
// local array of S entries. Measured and not shipped: the closest walk's
// ring (ring_column: the top kShortStack entries in shared memory) over
// FlatRows, which took 5-21% off the flat closest walks but made every
// flat any kernel slower beyond the spread of duplicate trees on some
// wavefront and faster on none (B2 1-3% on the hall's BVH4 and the city's
// rays, B5b 3-8% on the city's, B6b 2-11%, B7b 3.5% on the binary hall's
// bounce rays), for 2-4 more registers: an any walk stops at its first hit
// and pops less.
template <int A, int S, typename T>
__device__ __forceinline__ bool any_two_level(const T& t, int depth, const Ray& w, float tmax) {
  Ray r = w;
  int stack[S];
  int sp = 0;
  int cur = t.root();
  while (cur != kDone) {
    if (cur >= 0) {
      // 0 <= cur < kDone: a node row
      while (static_cast<unsigned>(cur) < static_cast<unsigned>(kDone)) {
        float row[row_floats<A>()];
        t.node_row(cur, row);
        float keys[A];
        int codes[A];
        slab_children<A>(row, r, tmax, keys, codes);
        sort_children<A>(keys, codes);
        for (int k = A - 1; k >= 1; --k) {
          if (keys[k] < kBig) {
            if (sp >= depth - 1) return true;  // overflow reports occluded
            stack[sp++] = codes[k];
          }
        }
        cur = keys[0] < kBig ? codes[0] : (sp > 0 ? stack[--sp] : kDone);
        if constexpr (T::kTwoLevel || A != 2) {
          break;  // one node row a pass
        } else if (__popc(__activemask()) < kNodeLanes) {
          break;  // most of the warp waits
        }
      }
    } else if (!T::kTwoLevel || -cur - 1 < t.n_tri) {
      bool occ = false;
      t.leaf_slots(-cur - 1, [&](const Tri& s) {
        float tt, u, v;
        int prim;
        occ = mt_tri(s, r, tmax, &tt, &u, &v, &prim);
        return occ;
      });
      if (occ) return true;
      cur = sp > 0 ? stack[--sp] : kDone;
    } else if constexpr (T::kTwoLevel) {
      float m[kEntryCols];
      t.entry(-cur - 1, m);
      r = enter_instance(m, w);
      cur = __float_as_int(m[12]);
      continue;
    }
    if constexpr (T::kTwoLevel)
      if (in_world(cur, t.n_tri, t.tlas_lo)) r = w;
  }
  return false;
}

// Ray i of a wavefront through closest_two_level over the rows of t, its
// result written at i (B3, B5c, B6c): a miss, an inactive lane or an
// overflow is (1e20, prim, -1, 0, 0) with prim -1 or -2. Over FlatRows (B1,
// B5a, B6a, B7a) there is no instance (inst_out is not written) and a flat
// overflow keeps the u and v of its walk's nearest hit, as the plain walk
// does.
template <int A, int S, typename T>
__device__ __forceinline__ void closest_ray(const T& t, int depth, const float* orig,
                                            const float* dir, const float* t_min,
                                            const float* t_max, const uint8_t* active,
                                            float* t_out, int* prim_out, int* inst_out,
                                            float* u_out, float* v_out, int i) {
  float best = fminf(kTMax, t_max[i]), best_u = 0.0f, best_v = 0.0f;
  int best_prim = -1, best_inst = -1;
  if (active[i])
    closest_two_level<A, S>(t, depth, load_ray(orig, dir, t_min, i), best, best_prim, best_inst,
                            best_u, best_v);
  const bool miss = best_prim < 0;
  t_out[i] = miss ? kTMax : best;
  prim_out[i] = best_prim;
  if constexpr (T::kTwoLevel) {
    inst_out[i] = miss ? -1 : best_inst;
    u_out[i] = miss ? 0.0f : best_u;
    v_out[i] = miss ? 0.0f : best_v;
  } else {
    u_out[i] = best_u;
    v_out[i] = best_v;
  }
}

// Ray i through any_two_level over the rows of t, occluded & mask written
// at i (B4, B5d, B6d; over FlatRows B2, B5b, B6b and B7b).
template <int A, int S, typename T>
__device__ __forceinline__ void any_ray(const T& t, int depth, const float* orig, const float* dir,
                                        const float* t_min, const float* t_max,
                                        const uint8_t* mask, uint8_t* occluded, int i) {
  occluded[i] =
      mask[i] && any_two_level<A, S>(t, depth, load_ray(orig, dir, t_min, i), t_max[i]) ? 1 : 0;
}

}  // namespace crt
