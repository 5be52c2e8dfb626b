// R1-R3: the wavefront re-sort's own kernels around an int32 stable sort
// (Hopper, sm_90a). R1 takes the origins' per-axis bounds over every lane,
// R2 writes each lane's 31-bit key, torch.sort(key, stable=True) orders
// the lanes, and R3 gathers the seven fields of the path state by the
// permutation (ops/sort_cuda.py drives the four steps).
//
// They replace no Pallas kernel: the JAX package's re-sort is plain
// jnp.argsort over an int64 key (chameleonrt_tpu/ops/traverse.py's
// ray_sort_perm_only) and seven gathers, which XLA fuses. Run as plain
// torch on the card (ops/traverse.py's ray_sort_key), the same re-sort is
// ~91 launches a bounce: the key's octant, bounds, quantisation and
// three bit spreads op by op over int64 lanes, an 8-pass radix sort of
// the 64-bit key, and seven x[perm] gathers.
//
// What they compute: exactly ray_sort_key's key, as an int32 (the key
// never reaches bit 31), so the stable sort gives the same permutation;
// and exactly x[perm] of each field. The key rounds as torch's separate
// float32 ops do, built with -fmad=false: d = max(hi - lo, 1e-20), then
// scale = (1 / d) * 511 (torch computes `511.0 / t` as
// `t.reciprocal() * 511.0`), q = trunc(clamp((x - lo) * scale, 0, 511)),
// NaN kept by the clamp and cast to 0 as torch's CUDA cast does. Min and
// max are exact, so R1's order of reduction cannot change the bounds; a
// NaN on an axis makes both of its bounds NaN, as torch's min and max do.
//
// What bounds them on the H100: bytes. A lane is read 12 bytes by R1, 25
// by R2 (which writes 4), and 8 + 65 by R3 (which writes 65); the radix
// sort of the int32 key with int64 indices moves ~96 bytes a lane over
// its 4 passes, half of the 8 passes an int64 key takes. At 8,294,400
// lanes a bounce that is ~2.3 GB, ~0.69 ms at 3.35 TB/s. The design keeps
// every intermediate of the key in registers (one thread a lane: one pass
// over the lanes where torch makes ~45), gives the sort the narrowest key
// it can take, and reads the permutation once for all seven fields.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// R1's block: a multiple of 3 and of 32, so that with a grid-stride loop
// over the flat (R, 3) origins each thread meets one axis only
constexpr int kBoundsThreads = 384;
// R1's most blocks: a few waves of the card's 132 SMs, enough to keep the
// reads in flight, few enough for the last block to reduce their partials
constexpr int kBoundsBlocks = 132 * 4;
constexpr int kLaneThreads = 256;

struct AxisBounds {
  float lo, hi;
  int nan;
};

__device__ __forceinline__ AxisBounds combine(AxisBounds a, AxisBounds b) {
  return {fminf(a.lo, b.lo), fmaxf(a.hi, b.hi), a.nan | b.nan};
}

// Reduce the block's per-thread bounds into s[0..2], one per axis: thread
// t holds axis t % 3, and every step pairs t with t + s for s a multiple
// of 3, so it pairs lanes of one axis.
__device__ __forceinline__ void block_reduce(AxisBounds* s, AxisBounds mine) {
  const int t = threadIdx.x;
  s[t] = mine;
  __syncthreads();
  for (int step = kBoundsThreads / 2; step >= 3; step /= 2) {
    if (t < step) s[t] = combine(s[t], s[t + step]);
    __syncthreads();
  }
}

// R1: bounds[0..2] = the per-axis min of orig (R, 3) over all R lanes,
// bounds[3..5] the max. Each block reduces its share to partial[block][3];
// the last block to finish (counter) reduces the partials, writes bounds
// and sets the counter back to 0 for the next launch.
__global__ void __launch_bounds__(kBoundsThreads)
sort_bounds_kernel(const float* __restrict__ orig, long long n, float4* partial,
                   unsigned int* counter, float* bounds) {
  static_assert(kBoundsThreads % 96 == 0, "a block must hold whole warps and whole rows");
  __shared__ AxisBounds s[kBoundsThreads];
  __shared__ bool last;
  const int t = threadIdx.x;
  AxisBounds mine{INFINITY, -INFINITY, 0};
  const long long stride = static_cast<long long>(gridDim.x) * kBoundsThreads;
  for (long long j = static_cast<long long>(blockIdx.x) * kBoundsThreads + t; j < n; j += stride) {
    const float v = orig[j];
    if (v != v) {
      mine.nan = 1;
    } else {
      mine.lo = fminf(mine.lo, v);
      mine.hi = fmaxf(mine.hi, v);
    }
  }
  block_reduce(s, mine);
  if (t < 3) {
    partial[blockIdx.x * 3 + t] = make_float4(s[t].lo, s[t].hi, __int_as_float(s[t].nan), 0.0f);
    __threadfence();  // the partial is visible to the last block before the count
  }
  __syncthreads();
  if (t == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  AxisBounds acc{INFINITY, -INFINITY, 0};
  for (int b = t / 3; b < static_cast<int>(gridDim.x); b += kBoundsThreads / 3) {
    const float4 p = __ldcg(&partial[b * 3 + t % 3]);  // from L2, where the other blocks wrote
    acc = combine(acc, {p.x, p.y, __float_as_int(p.z)});
  }
  block_reduce(s, acc);
  if (t < 3) {
    bounds[t] = s[t].nan ? NAN : s[t].lo;
    bounds[3 + t] = s[t].nan ? NAN : s[t].hi;
  }
  if (t == 0) *counter = 0u;
}

// ops/traverse.py's _expand_bits_10: the low 10 bits of v with two zero
// bits between each
__device__ __forceinline__ unsigned expand_bits_10(unsigned v) {
  v &= 0x3FFu;
  v = (v | (v << 16)) & 0x030000FFu;
  v = (v | (v << 8)) & 0x0300F00Fu;
  v = (v | (v << 4)) & 0x030C30C3u;
  v = (v | (v << 2)) & 0x09249249u;
  return v;
}

// R2: key[i] = ray_sort_key(orig, dir, active)[i] as an int32, from R1's
// bounds
__global__ void __launch_bounds__(kLaneThreads)
sort_key_kernel(const float* __restrict__ orig, const float* __restrict__ dir,
                const uint8_t* __restrict__ active, const float* __restrict__ bounds,
                int* __restrict__ key, int R) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  unsigned q[3];
  for (int a = 0; a < 3; ++a) {
    const float lo = bounds[a];
    float d = bounds[3 + a] - lo;
    d = d < 1e-20f ? 1e-20f : d;  // torch.clamp(min=): NaN stays NaN
    const float scale = (1.0f / d) * 511.0f;
    float v = (orig[3 * i + a] - lo) * scale;
    v = v != v ? v : fminf(fmaxf(v, 0.0f), 511.0f);  // torch.clamp: NaN stays NaN
    q[a] = v != v ? 0u : static_cast<unsigned>(v);  // torch's CUDA cast: NaN to 0
  }
  const unsigned morton = (expand_bits_10(q[0]) << 2) | (expand_bits_10(q[1]) << 1) |
                          expand_bits_10(q[2]);
  const unsigned octant = (dir[3 * i] < 0.0f ? 4u : 0u) | (dir[3 * i + 1] < 0.0f ? 2u : 0u) |
                          (dir[3 * i + 2] < 0.0f ? 1u : 0u);
  const unsigned dead = active[i] ? 0u : 1u;
  key[i] = static_cast<int>((dead << 30) | ((morton >> 9) << 12) | (octant << 9) |
                            (morton & 0x1FFu));
}

}  // namespace

namespace crt {
namespace sort {

// The seven fields of a wavefront, as ops/sort_cuda.py's Wave mirrors
// them: state and lane_pixel (R,) int64, orig, dir, throughput and illum
// (R, 3) float32, active (R,) bool.
struct Wave {
  int64_t* state;
  float* orig;
  float* dir;
  float* throughput;
  float* illum;
  uint8_t* active;
  int64_t* lane_pixel;
};

}  // namespace sort
}  // namespace crt

namespace {

__device__ __forceinline__ void copy3(float* out, const float* __restrict__ in, int i, int64_t p) {
  out[3 * i] = in[3 * p];
  out[3 * i + 1] = in[3 * p + 1];
  out[3 * i + 2] = in[3 * p + 2];
}

// R3: every field of out at lane i is the field of in at lane perm[i]
__global__ void __launch_bounds__(kLaneThreads)
sort_gather_kernel(const int64_t* __restrict__ perm, const crt::sort::Wave in,
                   const crt::sort::Wave out, int R) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const int64_t p = perm[i];
  out.state[i] = in.state[p];
  copy3(out.orig, in.orig, i, p);
  copy3(out.dir, in.dir, i, p);
  copy3(out.throughput, in.throughput, i, p);
  copy3(out.illum, in.illum, i, p);
  out.active[i] = in.active[p];
  out.lane_pixel[i] = in.lane_pixel[p];
}

}  // namespace

extern "C" {

// R1's grid for R lanes: at most kBoundsBlocks blocks; the wrapper sizes
// the partials (3 float4 a block) by it.
int crt_sort_bounds_blocks(int R) {
  const long long n = 3LL * R;
  const long long blocks = (n + kBoundsThreads - 1) / kBoundsThreads;
  return static_cast<int>(blocks < kBoundsBlocks ? (blocks < 1 ? 1 : blocks) : kBoundsBlocks);
}

// Launch R1 on `stream`: bounds (6 floats) of orig (R, 3). partial holds
// crt_sort_bounds_blocks(R) * 3 float4; counter is 0 and R1 leaves it 0.
// Returns the cudaError_t of the launch.
int crt_sort_bounds(const float* orig, int R, void* partial, unsigned int* counter,
                    float* bounds, void* stream) {
  if (R <= 0) return 0;
  sort_bounds_kernel<<<crt_sort_bounds_blocks(R), kBoundsThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      orig, 3LL * R, static_cast<float4*>(partial), counter, bounds);
  return static_cast<int>(cudaGetLastError());
}

// Launch R2 on `stream`: key (R,) int32 from orig, dir, active and R1's
// bounds. Returns the cudaError_t of the launch.
int crt_sort_key(const float* orig, const float* dir, const uint8_t* active, const float* bounds,
                 int* key, int R, void* stream) {
  if (R <= 0) return 0;
  sort_key_kernel<<<(R + kLaneThreads - 1) / kLaneThreads, kLaneThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(orig, dir, active, bounds, key, R);
  return static_cast<int>(cudaGetLastError());
}

// Launch R3 on `stream`: out's fields from in's by perm (R,) int64.
// Returns the cudaError_t of the launch.
int crt_sort_gather(const int64_t* perm, const crt::sort::Wave* in, const crt::sort::Wave* out,
                    int R, void* stream) {
  if (R <= 0) return 0;
  sort_gather_kernel<<<(R + kLaneThreads - 1) / kLaneThreads, kLaneThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(perm, *in, *out, R);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
