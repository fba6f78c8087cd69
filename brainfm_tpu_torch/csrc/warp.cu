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
//    ii < FLT_MIN or ii > D-1 (likewise jj, kk) the output is the
//    per-channel default dflt[c]. The reference tests ii > 0 under XLA,
//    which flushes denormals to zero; x >= FLT_MIN is that test without the
//    flush (this library keeps denormals). Coordinates and accumulation are
//    fp32, and the blend is evaluated in the plain version's operation
//    order; the library is built with -fmad=false so no multiply-add is
//    contracted and the result equals the plain version bit for bit.
//  - nearest: round half to even (rintf, as jnp.round / torch.round), clip
//    to the volume, copy the int32 label. A denormal rounds to 0 with or
//    without a flush, so nearest needs no such care.
//
// Bound on the H100: bytes. The least traffic is the source voxels that the
// corners touch, the three coordinate volumes and the output, each moved
// once (fused target wall of a flagship draw: about 0.39 GB, 0.12 ms at
// 3.35 TB/s). The gather reads corners out of order, so the kernel moves more
// than that through L1.
//
// Linear design: one thread per (voxel, unit), where a unit is a 16-B
// channel quad (C % 4 == 0 and source, defaults and output 16-B aligned) or
// else one channel. A block of (U, BW, BH) threads covers a 1 x BH x BW
// brick of the output grid (Do, Ho, Wo), U units a voxel (so C is at most
// 384 channels, or 384 quads), and:
//  - each corner is one float4 (or float) load and the output one store,
//    consecutive lanes on consecutive addresses; the lanes of a voxel
//    compute the same weights and share no memory and no barrier;
//  - the warps of a block read overlapping source rows out of L1.
// Shapes whose brick grid would not fit the launch limits take the flat view
// (1, 1, n). The path depends on C and the pointers' alignment only.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // nearest
constexpr int kMaxThreads = 384;
constexpr long long kMaxGridYZ = 65535;
// output bricks (BH x BW voxels) of the quad and the single-channel paths
constexpr int kQuadBH = 2, kQuadBW = 16;
constexpr int kWordBH = 8, kWordBW = 16;

struct Corner {
  bool ok;
  int64_t base;       // offset of corner (fx, fy, fz), in the path's units
  int dx, dy, dz;     // offset to the ceil corner along D, H, W (0 at the edge)
  float wcx, wcy, wcz, wfx, wfy, wfz;
};

// `unit` is the offset of one source voxel in units (floats or float4s).
__device__ __forceinline__ Corner corner(float x, float y, float z, int D,
                                         int H, int W, int unit) {
  Corner k;
  k.ok = (x >= FLT_MIN) && (y >= FLT_MIN) && (z >= FLT_MIN) &&
         (x <= (float)(D - 1)) && (y <= (float)(H - 1)) &&
         (z <= (float)(W - 1));
  if (!k.ok) return k;
  // inside the bounds the clip to [0, D-1] is the identity
  int fx = (int)floorf(x), fy = (int)floorf(y), fz = (int)floorf(z);
  k.base = (((int64_t)fx * H + fy) * W + fz) * unit;
  k.dx = fx + 1 < D ? H * W * unit : 0;
  k.dy = fy + 1 < H ? W * unit : 0;
  k.dz = fz + 1 < W ? unit : 0;
  k.wcx = x - (float)fx;
  k.wcy = y - (float)fy;
  k.wcz = z - (float)fz;
  k.wfx = 1.f - k.wcx;
  k.wfy = 1.f - k.wcy;
  k.wfz = 1.f - k.wcz;
  return k;
}

// the plain version's operation order; corners cXYZ along (D, H, W)
__device__ __forceinline__ float blend(const Corner& k, float c000, float c100,
                                       float c010, float c110, float c001,
                                       float c101, float c011, float c111) {
  float c00 = c000 * k.wfx + c100 * k.wcx;
  float c01 = c001 * k.wfx + c101 * k.wcx;
  float c10 = c010 * k.wfx + c110 * k.wcx;
  float c11 = c011 * k.wfx + c111 * k.wcx;
  float c0 = c00 * k.wfy + c10 * k.wcy;
  float c1 = c01 * k.wfy + c11 * k.wcy;
  return c0 * k.wfz + c1 * k.wcz;
}

template <typename T>
struct Eight {
  T v[8];
};

template <typename T>
__device__ __forceinline__ Eight<T> load8(const T* __restrict__ p,
                                         const Corner& k) {
  const T* a = p + k.base;
  Eight<T> e;
  e.v[0] = a[0];
  e.v[1] = a[k.dx];
  e.v[2] = a[k.dy];
  e.v[3] = a[k.dx + k.dy];
  e.v[4] = a[k.dz];
  e.v[5] = a[k.dx + k.dz];
  e.v[6] = a[k.dy + k.dz];
  e.v[7] = a[k.dx + k.dy + k.dz];
  return e;
}

__device__ __forceinline__ float blend8(const Corner& k,
                                        const Eight<float>& e) {
  return blend(k, e.v[0], e.v[1], e.v[2], e.v[3], e.v[4], e.v[5], e.v[6],
               e.v[7]);
}

#define K1_BLEND(f)                                                          \
  blend(k, e.v[0].f, e.v[1].f, e.v[2].f, e.v[3].f, e.v[4].f, e.v[5].f,       \
        e.v[6].f, e.v[7].f)

__device__ __forceinline__ float4 blend8(const Corner& k,
                                         const Eight<float4>& e) {
  return make_float4(K1_BLEND(x), K1_BLEND(y), K1_BLEND(z), K1_BLEND(w));
}

// block (U, BW, BH), grid (Wo / BW, Ho / BH, Do); V is float4 or float
template <typename V>
__global__ void __launch_bounds__(kMaxThreads)
    warp_linear_kernel(const V* __restrict__ src, const float* __restrict__ ii,
                       const float* __restrict__ jj,
                       const float* __restrict__ kk,
                       const V* __restrict__ dflt, V* __restrict__ out, int D,
                       int H, int W, int Ho, int64_t Wo) {
  const int U = blockDim.x, u = threadIdx.x;
  const int64_t z = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  const int y = blockIdx.y * blockDim.z + threadIdx.z;
  if (z >= Wo || y >= Ho) return;
  const int64_t v = ((int64_t)blockIdx.z * Ho + y) * Wo + z;
  const Corner k = corner(ii[v], jj[v], kk[v], D, H, W, U);
  V r;
  if (k.ok) {
    r = blend8(k, load8(src + u, k));
  } else {
    r = dflt[u];
  }
  out[v * U + u] = r;
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

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

template <typename V>
int launch_linear(const void* src, const void* ii, const void* jj,
                  const void* kk, const void* dflt, void* out, int D, int H,
                  int W, int U, long long Do, long long Ho, long long Wo,
                  int brick_h, int brick_w, cudaStream_t s) {
  const long long n = Do * Ho * Wo;
  if (cdiv(Ho, brick_h) > kMaxGridYZ || Do > kMaxGridYZ) {
    Do = 1, Ho = 1, Wo = n;   // the flat view
  }
  int bh = Ho < brick_h ? (int)Ho : brick_h;
  int bw = brick_w * (brick_h / bh);   // a short grid: the brick along W
  while (U * bw * bh > kMaxThreads && bw * bh > 1) (bw > 1 ? bw : bh) /= 2;
  if (U * bw * bh > kMaxThreads || cdiv(Wo, bw) > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  dim3 block(U, bw, bh),
      grid((unsigned)cdiv(Wo, bw), (unsigned)cdiv(Ho, bh), (unsigned)Do);
  warp_linear_kernel<V><<<grid, block, 0, s>>>(
      (const V*)src, (const float*)ii, (const float*)jj, (const float*)kk,
      (const V*)dflt, (V*)out, D, H, W, (int)Ho, Wo);
  return (int)cudaGetLastError();
}

}  // namespace

// The output grid is (Do, Ho, Wo) voxels of C channels: the coordinates'
// shape with its leading dimensions folded into Do.
extern "C" int warp_linear_f32(const void* src, const void* ii, const void* jj,
                               const void* kk, const void* dflt, void* out,
                               int D, int H, int W, int C, long long Do,
                               long long Ho, long long Wo, void* stream) {
  if (Do * Ho * Wo <= 0) return (int)cudaGetLastError();
  // corner offsets along D are int: one source slice must fit
  if ((long long)H * W * C > INT32_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (C % 4 == 0 && aligned16(src) && aligned16(dflt) && aligned16(out))
    return launch_linear<float4>(src, ii, jj, kk, dflt, out, D, H, W, C / 4,
                                 Do, Ho, Wo, kQuadBH, kQuadBW, s);
  return launch_linear<float>(src, ii, jj, kk, dflt, out, D, H, W, C, Do, Ho,
                              Wo, kWordBH, kWordBW, s);
}

extern "C" int warp_nearest_i32(const void* src, const void* ii, const void* jj,
                                const void* kk, void* out, int D, int H, int W,
                                int C, long long n, void* stream) {
  if (n > 0) {
    warp_nearest_kernel<<<(unsigned)cdiv(n, kThreads), kThreads, 0,
                          (cudaStream_t)stream>>>(
        (const int32_t*)src, (const float*)ii, (const float*)jj,
        (const float*)kk, (int32_t*)out, D, H, W, C, n);
  }
  return (int)cudaGetLastError();
}
