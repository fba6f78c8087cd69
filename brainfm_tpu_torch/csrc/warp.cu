// K1: coordinate warps of a channels-last volume, written for Hopper (sm_90a).
//
// Replaces brainfm_tpu/ops/pallas_warp_blocks.py::warp_blocks (the
// pl.pallas_call at :300), which ops/warp_auto.py routes for warp_volume
// (linear) and warp_labels (nearest). The TPU kernel streams source blocks
// and evaluates the warp as hat-weight matrix products because Mosaic
// cannot gather; Hopper gathers directly, so there is no block plan, no
// static patch and no overflow count here.
//
// Semantics are exactly brainfm_tpu_torch/ops/interp.py (the plain twins):
//  - linear: trilinear at float source coordinates (ii, jj, kk); wherever
//    ii <= 0 or ii > D-1 (likewise jj, kk) the output is the per-channel
//    default dflt[c]. Coordinates and accumulation are fp32, and the blend
//    is evaluated in the plain version's operation order; the library is
//    built with -fmad=false so no multiply-add is contracted and the
//    result equals the plain version bit for bit.
//  - nearest: round half to even (rintf, as jnp.round / torch.round), clip
//    to the volume, copy the int32 label.
//
// Design: one thread per output voxel. It computes the 8 corner offsets
// once, then loops over the C channels of the channels-last source, so each
// corner read is C contiguous values.
//
// Bound on the H100: bytes. The least traffic is the source read once,
// the three coordinate volumes read once and the output written once
// (for the fused target wall: 192^3 x 12 + 3 x 160^3 + 160^3 x 12 fp32,
// about 0.59 GB, 0.18 ms at 3.35 TB/s). The gather reads corners out of
// order, so the kernel moves more than that.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void warp_linear_kernel(const float* __restrict__ src,
                                   const float* __restrict__ ii,
                                   const float* __restrict__ jj,
                                   const float* __restrict__ kk,
                                   const float* __restrict__ dflt,
                                   float* __restrict__ out,
                                   int D, int H, int W, int C, int64_t n) {
  int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n) return;
  float x = ii[v], y = jj[v], z = kk[v];
  float* o = out + v * C;
  bool ok = (x > 0.f) && (y > 0.f) && (z > 0.f) && (x <= (float)(D - 1)) &&
            (y <= (float)(H - 1)) && (z <= (float)(W - 1));
  if (!ok) {
    for (int c = 0; c < C; ++c) o[c] = dflt[c];
    return;
  }
  // inside the bounds the clip to [0, D-1] is the identity
  int fx = (int)floorf(x), fy = (int)floorf(y), fz = (int)floorf(z);
  int cx = min(fx + 1, D - 1), cy = min(fy + 1, H - 1), cz = min(fz + 1, W - 1);
  float wcx = x - (float)fx, wcy = y - (float)fy, wcz = z - (float)fz;
  float wfx = 1.f - wcx, wfy = 1.f - wcy, wfz = 1.f - wcz;
  const int64_t sH = W, sD = (int64_t)H * W;
  const float* p000 = src + (fx * sD + fy * sH + fz) * C;
  const float* p100 = src + (cx * sD + fy * sH + fz) * C;
  const float* p010 = src + (fx * sD + cy * sH + fz) * C;
  const float* p110 = src + (cx * sD + cy * sH + fz) * C;
  const float* p001 = src + (fx * sD + fy * sH + cz) * C;
  const float* p101 = src + (cx * sD + fy * sH + cz) * C;
  const float* p011 = src + (fx * sD + cy * sH + cz) * C;
  const float* p111 = src + (cx * sD + cy * sH + cz) * C;
  for (int c = 0; c < C; ++c) {
    float c00 = p000[c] * wfx + p100[c] * wcx;
    float c01 = p001[c] * wfx + p101[c] * wcx;
    float c10 = p010[c] * wfx + p110[c] * wcx;
    float c11 = p011[c] * wfx + p111[c] * wcx;
    float c0 = c00 * wfy + c10 * wcy;
    float c1 = c01 * wfy + c11 * wcy;
    o[c] = c0 * wfz + c1 * wcz;
  }
}

__device__ __forceinline__ int64_t round_clip(float x, int hi) {
  return (int64_t)fminf(fmaxf(rintf(x), 0.f), (float)hi);
}

__global__ void warp_nearest_kernel(const int32_t* __restrict__ src,
                                    const float* __restrict__ ii,
                                    const float* __restrict__ jj,
                                    const float* __restrict__ kk,
                                    int32_t* __restrict__ out,
                                    int D, int H, int W, int C, int64_t n) {
  int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n) return;
  int64_t x = round_clip(ii[v], D - 1), y = round_clip(jj[v], H - 1),
          z = round_clip(kk[v], W - 1);
  const int32_t* p = src + ((x * H + y) * W + z) * C;
  int32_t* o = out + v * C;
  for (int c = 0; c < C; ++c) o[c] = p[c];
}

unsigned int blocks_for(int64_t n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int warp_linear_f32(const void* src, const void* ii, const void* jj,
                               const void* kk, const void* dflt, void* out,
                               int D, int H, int W, int C, long long n,
                               void* stream) {
  if (n > 0) {
    warp_linear_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)src, (const float*)ii, (const float*)jj,
        (const float*)kk, (const float*)dflt, (float*)out, D, H, W, C, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int warp_nearest_i32(const void* src, const void* ii, const void* jj,
                                const void* kk, void* out, int D, int H, int W,
                                int C, long long n, void* stream) {
  if (n > 0) {
    warp_nearest_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)src, (const float*)ii, (const float*)jj,
        (const float*)kk, (int32_t*)out, D, H, W, C, n);
  }
  return (int)cudaGetLastError();
}
