// S1: the shading stage of one bounce for the compacted live lanes, in one
// launch (Hopper, sm_90a).
//
// S1 replaces no Pallas kernel: the JAX package leaves its _shade_bounce
// (chameleonrt_tpu/engine/path_tracer.py) to XLA, which fuses the
// elementwise ops into a few loops. Run as plain torch on the card,
// _shade_bounce (chameleonrt_tpu_torch/engine/path_tracer.py) is ~3,560
// launches a bounce, each a pass over the lanes in device memory, with
// every unused branch of the Disney BSDF computed and then dropped by a
// torch.where: 72% of a 2880x2880 Cornell frame on the device, and the
// host's time to launch them the whole of a 960x960 frame. S1 computes
// the same function, one thread a lane, in one pass.
//
// What it computes (the body is shade_lane in shade_common.cuh, which the
// host tests build with g++): the hit's frame and material (the shade row,
// the instance's matrix and material table, texture handles decoded from
// the atlas's bilinear quads), a light sample with its MIS weight, a BSDF
// sample toward the lights with its own, the continuation sample and
// Russian roulette after bounce 3, drawing the LCG in the plain version's
// order, and ShadeOut's 12 fields. Built with -fmad=false, with CUDA's own
// math functions on both sides, so it rounds as torch's separate ops do.
//
// What bounds it on the H100: little. A lane reads 57 bytes of lane state
// (61 where the scene has instances: hit_inst) and a 128-byte shade row
// from a table the L2 holds, and writes 91 bytes; its arithmetic is of
// order 10^3 FP32 operations with a few dozen transcendentals. 3.6M lanes a
// bounce at 2880x2880 are ~0.53 GB, ~0.16 ms at 3.35 TB/s, and of the same
// order in FP32 work at 67 TFLOP/s. What keeps it above that is divergence
// and registers: lanes of one warp sample different BSDF components and hit
// different materials. The design does about divergence what a per-lane
// kernel can: a lane evaluates only the branch it takes (the sampled
// component's direction, the anisotropic lobe only where anisotropy != 0,
// transmission only where specular_transmission > 0, the reflection lobes
// only where w_o and w_i share a hemisphere), where torch evaluates all of
// them for every lane.

#include "shade_common.cuh"

namespace {

// 64 and 128 a block timed alike on an H100 on a 2880x2880 Cornell frame's
// lanes, 256 3% slower, and a register cap for 6 or 8 blocks an SM moved S1
// by under 4% either way
constexpr int kShadeThreads = 128;

__global__ void __launch_bounds__(kShadeThreads)
shade_bounce_kernel(const crt::shade::Scene s, const crt::shade::Lanes l, int bounce, int R) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  crt::shade::shade_lane(s, l, bounce, i);
}

}  // namespace

extern "C" {

// Launch S1 on `stream` over R lanes: the scene's tables and the lanes as
// ops/shade_cuda.py's Scene and Lanes mirror them. Returns the cudaError_t
// of the launch.
int crt_shade_bounce(const crt::shade::Scene* s, const crt::shade::Lanes* l, int R, int bounce,
                     void* stream) {
  if (R <= 0) return 0;
  dim3 grid((R + kShadeThreads - 1) / kShadeThreads);
  shade_bounce_kernel<<<grid, kShadeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *s, *l, bounce, R);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
