// The training criterion's segmentation losses, forward and backward, in
// two passes over the logits, written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves this chain to XLA
// (brainfm_tpu/models/criterion.py). It replaces the eager chain of
// brainfm_tpu_torch/models/criterion.py on the head's logits, which cast
// them to fp32, took softmax, and ran `ce` and `_dice` (clamp, log, the
// label-weight and target products, the sums over the voxels) and their
// backwards as about 20 full-size fp32 passes (ops/segloss.py's plain
// version is that chain):
//  - seg_loss_fwd: per voxel the softmax p of its L logits, and the sums
//    sum log(max(p_l, 1e-5)) * w_l * t_l (cross-entropy), per (sample,
//    label) I = sum p * t and P = sum p, and per label T = sum t (Dice's
//    union U = P + T). Stage 2 (`segloss_finish_kernel`) adds each sum's
//    per-block partials.
//  - seg_loss_bwd: the softmax again, then dL/dp_l = a[s, l] * t_l +
//    b[s, l] + [p_l >= 1e-5] * c[l] * t_l / p_l (the coefficients come from
//    I, U, the weights and the upstream gradients, ops/segloss.py
//    `_coefficients`), and dx = p * (dL/dp - sum_k p_k dL/dp_k), stored in
//    the logits' type.
//
// Operands: x, the logits of S samples, each V voxels of L labels, at
// element x[s * xs + v * xv + l] (the voxel stride xv is the head tensor's
// width: the logits are read where they lie in the NDHWC head output); t,
// the target, dense (V, L), shared by the S samples; dx dense (S, V, L).
// Types: bf16 or fp32 logits with fp32 targets, weights and arithmetic;
// fp64 logits with fp64 everything. The softmax is exp(x - max) times the
// reciprocal of its sum (PyTorch divides: they differ in the last bit).
//
// Bound on the H100: bytes by count. Pass 1 reads the logits' sectors and
// the target once; pass 2 reads both again and writes dx. In practice the
// work per value bounds them (an exp, a row's max and sum by shuffles, the
// addresses of four samples): at the flagship's shape each pass takes
// about 3.5 ms against a byte bound of 0.8 and 1.4 ms (PERF.md, section 6),
// and neither deeper copy pipelines nor larger tiles moved that.
//
// Design. A block walks its voxels in tiles of 16. Each tile's rows, the
// head tensor's rows of up to 4 samples (blockIdx.y picks which 4) and the
// target's, are contiguous runs of memory; the block copies them into
// shared memory as whole 16-B vectors (cp.async, from any alignment: a
// run is widened to the aligned 16-B vectors around it, up to 15 bytes
// before its first value and past its last; each such vector holds a byte
// of the run and so lies in that byte's page, so the reads stay in mapped
// memory whatever allocated the tensor, and the bytes outside the run are
// never used) while it computes on the tile before, so the loads are wide
// and always in flight. A tile's voxel takes 16 lanes, lane j labels j,
// j + 16, j + 32, j + 48 (L <= 64): a row's max and sum are 4 shuffles.
// The target row is read once for the block's samples. The sums of pass 1
// stay in each lane's registers over the block's voxels; the block then
// adds the two voxel groups of a warp by a shuffle and the 8 warps in
// order in shared memory and writes one partial a sum. Stage 2 adds each
// sum's partials with 32 lanes and a fixed tree: no float atomics, so two
// runs are bitwise equal. Both passes compute p with the same code, so the
// backward's p is the forward's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 16;                    // lanes of one voxel
constexpr int kSlots = 4;                     // labels a lane holds
constexpr int kMaxLabels = kLanes * kSlots;   // 64
constexpr int kSamples = 4;                   // samples a block covers
constexpr int kTile = kThreads / kLanes;      // voxels a tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRowBytes = 1024;            // voxel stride, in bytes
constexpr int kMaxGridY = 65535;

enum DType { kBF16 = 0, kF32 = 1, kF64 = 2 };

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ float up(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float up(float v) { return v; }
__device__ __forceinline__ double up(double v) { return v; }

__device__ __forceinline__ void down(float v, __nv_bfloat16& o) {
  o = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void down(float v, float& o) { o = v; }
__device__ __forceinline__ void down(double v, double& o) { o = v; }

__device__ __forceinline__ float exp_(float v) { return expf(v); }
__device__ __forceinline__ double exp_(double v) { return exp(v); }
__device__ __forceinline__ float log_(float v) { return logf(v); }
__device__ __forceinline__ double log_(double v) { return log(v); }

// torch.clamp(min=1e-5): a NaN stays NaN
template <typename A>
__device__ __forceinline__ A clamp_eps(A p) {
  const A eps = (A)1e-5;
  return p < eps ? eps : p;
}

// reductions over the 16 lanes of one voxel, in a fixed order; the whole
// warp takes part
template <typename A>
__device__ __forceinline__ A group_max(A v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) {
    const A u = __shfl_xor_sync(0xffffffffu, v, o, kLanes);
    v = u > v ? u : v;
  }
  return v;
}
template <typename A>
__device__ __forceinline__ A group_sum(A v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o, kLanes);
  return v;
}

// this lane's values of the softmax of one row of L logits; slots past L
// hold 0
template <typename A>
__device__ __forceinline__ void softmax_row(const A (&x)[kSlots], int lane,
                                            int L, A (&p)[kSlots]) {
  A m = -INFINITY;
#pragma unroll
  for (int k = 0; k < kSlots; ++k)
    if (lane + kLanes * k < L) m = x[k] > m ? x[k] : m;
  m = group_max(m);
  A z = 0;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    p[k] = lane + kLanes * k < L ? exp_(x[k] - m) : (A)0;
    z += p[k];
  }
  const A r = (A)1 / group_sum(z);
#pragma unroll
  for (int k = 0; k < kSlots; ++k) p[k] *= r;
}

// ---- the tiles in shared memory ----

__device__ __forceinline__ void cp_async16(char* dst, const char* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// bytes a tile's run of one operand can take in shared memory: kTile rows
// at a stride of `stride` elements of `es` bytes, L values each, widened
// to 16-B bounds
__host__ __device__ inline int span_bytes(int64_t stride, int L, int es) {
  return (int)((((kTile - 1) * stride + L) * es + 30 + 15) / 16 * 16);
}

// the offset in bytes of p[e] past its 16-B bound
template <typename E>
__device__ __forceinline__ int skew(const E* p, int64_t e) {
  return (int)((uintptr_t)(p + e) & 15);
}

// the block's copy of elements [e0, e1) of p, as the 16-B vectors around
// them, into dst
template <typename E>
__device__ __forceinline__ void stage(const E* p, int64_t e0, int64_t e1,
                                      char* dst) {
  const char* a0 = (const char*)(p + e0) - skew(p, e0);
  const char* a1 = (const char*)(p + e1);
  const int n = (int)((a1 - a0 + 15) / 16);
  for (int i = threadIdx.x; i < n; i += kThreads)
    cp_async16(dst + 16 * i, a0 + 16 * i);
}

// where a block's tiles lie: the logits of its ns samples and the target
template <typename T, typename A>
struct Tiles {
  const T* x;
  const A* t;
  int64_t xs, xv;
  int s0, ns, L, spanX, buf;
  char* smem;

  __device__ char* at(int b) const { return smem + b * buf; }

  // start copying the tile of nv voxels from vt into buffer b
  __device__ void fetch(int64_t vt, int nv, int b) const {
    char* d = at(b);
    for (int q = 0; q < ns; ++q) {
      const int64_t e0 = (int64_t)(s0 + q) * xs + vt * xv;
      stage(x, e0, e0 + (nv - 1) * xv + L, d + q * spanX);
    }
    stage(t, vt * L, (vt + nv) * L, d + kSamples * spanX);
    cp_async_commit();
  }

  // this lane's target values and sample q's logits of voxel g of the
  // tile from vt in buffer b (zeros past the tile's nv voxels)
  __device__ void target(int64_t vt, int b, int g, bool on, int lane,
                         A (&tk)[kSlots]) const {
    const A* r = (const A*)(at(b) + kSamples * spanX + skew(t, vt * L)) +
                 g * L;
#pragma unroll
    for (int k = 0; k < kSlots; ++k)
      tk[k] = on && lane + kLanes * k < L ? r[lane + kLanes * k] : (A)0;
  }
  __device__ void logits(int64_t vt, int b, int q, int g, bool on, int lane,
                         A (&xk)[kSlots]) const {
    const int64_t e0 = (int64_t)(s0 + q) * xs + vt * xv;
    const T* r = (const T*)(at(b) + q * spanX + skew(x, e0)) + g * xv;
#pragma unroll
    for (int k = 0; k < kSlots; ++k)
      xk[k] = on && lane + kLanes * k < L ? up(r[lane + kLanes * k]) : (A)0;
  }
};

template <typename T, typename A>
__device__ __forceinline__ Tiles<T, A> tiles_of(const T* x, const A* t,
                                                int S, int L, int64_t xs,
                                                int64_t xv, char* smem) {
  Tiles<T, A> tl;
  tl.x = x;
  tl.t = t;
  tl.xs = xs;
  tl.xv = xv;
  tl.s0 = blockIdx.y * kSamples;
  tl.ns = S - tl.s0 < kSamples ? S - tl.s0 : kSamples;
  tl.L = L;
  tl.spanX = span_bytes(xv, L, sizeof(T));
  tl.buf = kSamples * tl.spanX + span_bytes(L, L, sizeof(A));
  tl.smem = smem;
  return tl;
}

// run body(vt, nv, b) over the tiles of voxels [v0, v1), each copied into
// buffer b while the block works on the tile before
template <typename T, typename A, typename Body>
__device__ __forceinline__ void for_tiles(const Tiles<T, A>& tl, int64_t v0,
                                          int64_t v1, Body body) {
  const int64_t n = (v1 - v0 + kTile - 1) / kTile;
  auto count = [&](int64_t i) {
    const int64_t left = v1 - (v0 + i * kTile);
    return (int)(left < kTile ? left : kTile);
  };
  if (n > 0) tl.fetch(v0, count(0), 0);
  for (int64_t i = 0; i < n; ++i) {
    if (i + 1 < n) {
      tl.fetch(v0 + (i + 1) * kTile, count(i + 1), (int)((i + 1) & 1));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    body(v0 + i * kTile, count(i), (int)(i & 1));
    __syncthreads();
  }
}

// ---- the passes ----

// Pass 1, stage 1: block (k, g) covers voxels [k * vchunk, (k + 1) *
// vchunk) of samples [4 g, 4 g + 4) and writes one partial of each sum it
// holds at column k of part (rows x chunks): I at row s * L + l, P at
// S * L + s * L + l, T at 2 S L + l (blocks of g = 0), the cross-entropy
// at 2 S L + L + g.
template <typename T, typename A>
__global__ void __launch_bounds__(kThreads)
    segloss_fwd_kernel(const T* __restrict__ x, const A* __restrict__ t,
               const A* __restrict__ w, A* __restrict__ part, int S,
               int64_t V, int L, int64_t xs, int64_t xv, int64_t vchunk) {
  extern __shared__ __align__(16) char smem[];
  __shared__ A redI[kWarps][kSamples][kMaxLabels];
  __shared__ A redP[kWarps][kSamples][kMaxLabels];
  __shared__ A redT[kWarps][kMaxLabels];
  __shared__ A redC[kWarps];
  const int lane = threadIdx.x % kLanes;
  const int g = threadIdx.x / kLanes;
  const int warp = threadIdx.x / 32;
  const Tiles<T, A> tl = tiles_of(x, t, S, L, xs, xv, smem);
  const int64_t v0 = (int64_t)blockIdx.x * vchunk;
  const int64_t v1 = v0 + vchunk < V ? v0 + vchunk : V;
  const int chunks = gridDim.x;

  A sI[kSamples][kSlots], sP[kSamples][kSlots], sT[kSlots], wl[kSlots];
  A ce = 0;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int l = lane + kLanes * k;
    wl[k] = l < L ? w[l] : (A)0;
    sT[k] = 0;
#pragma unroll
    for (int q = 0; q < kSamples; ++q) sI[q][k] = sP[q][k] = 0;
  }
  for_tiles(tl, v0, v1, [&](int64_t vt, int nv, int b) {
    const bool on = g < nv;
    A tk[kSlots];
    tl.target(vt, b, g, on, lane, tk);
#pragma unroll
    for (int q = 0; q < kSamples; ++q) {
      if (q >= tl.ns) continue;
      A xk[kSlots], p[kSlots];
      tl.logits(vt, b, q, g, on, lane, xk);
      softmax_row(xk, lane, L, p);
      if (!on) continue;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        sI[q][k] += p[k] * tk[k];
        sP[q][k] += p[k];
        if (tk[k] != (A)0) ce += log_(clamp_eps(p[k])) * wl[k] * tk[k];
      }
    }
#pragma unroll
    for (int k = 0; k < kSlots; ++k) sT[k] += tk[k];
  });

  // the two voxel groups of a warp, then the warps in order
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    sT[k] += __shfl_down_sync(0xffffffffu, sT[k], 16);
#pragma unroll
    for (int q = 0; q < kSamples; ++q) {
      sI[q][k] += __shfl_down_sync(0xffffffffu, sI[q][k], 16);
      sP[q][k] += __shfl_down_sync(0xffffffffu, sP[q][k], 16);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ce += __shfl_xor_sync(0xffffffffu, ce, o);
  if ((threadIdx.x & 31) < kLanes) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int l = lane + kLanes * k;
      redT[warp][l] = sT[k];
#pragma unroll
      for (int q = 0; q < kSamples; ++q) {
        redI[warp][q][l] = sI[q][k];
        redP[warp][q][l] = sP[q][k];
      }
    }
  }
  if ((threadIdx.x & 31) == 0) redC[warp] = ce;
  __syncthreads();
  const int64_t SL = (int64_t)S * L;
  for (int i = threadIdx.x; i < tl.ns * L; i += kThreads) {
    const int q = i / L, l = i % L;
    A a1 = 0, a2 = 0;
    for (int r = 0; r < kWarps; ++r) {
      a1 += redI[r][q][l];
      a2 += redP[r][q][l];
    }
    const int64_t row = (int64_t)(tl.s0 + q) * L + l;
    part[row * chunks + blockIdx.x] = a1;
    part[(SL + row) * chunks + blockIdx.x] = a2;
  }
  if (blockIdx.y == 0)
    for (int l = threadIdx.x; l < L; l += kThreads) {
      A a = 0;
      for (int r = 0; r < kWarps; ++r) a += redT[r][l];
      part[(2 * SL + l) * chunks + blockIdx.x] = a;
    }
  if (threadIdx.x == 0) {
    A a = 0;
    for (int r = 0; r < kWarps; ++r) a += redC[r];
    part[(2 * SL + L + blockIdx.y) * chunks + blockIdx.x] = a;
  }
}

// Pass 1, stage 2: out[row] = sum over the chunks of part[row, :]; a warp
// a row, lane j adding chunks j, j + 32, ... in order, then a fixed tree
constexpr int kFinishRows = 32;

template <typename A>
__global__ void __launch_bounds__(32 * kFinishRows)
    segloss_finish_kernel(const A* __restrict__ part, A* __restrict__ out,
                  int64_t rows, int chunks) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kFinishRows + threadIdx.x / 32;
  if (row >= rows) return;   // whole warps leave together
  A a = 0;
  for (int k = lane; k < chunks; k += 32) a += part[row * chunks + k];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
  if (lane == 0) out[row] = a;
}

// Pass 2: dx of voxels [k * vchunk, (k + 1) * vchunk) of samples
// [4 g, 4 g + 4) for block (k, g); a and b are (S, L), c is (L,)
template <typename T, typename A>
__global__ void __launch_bounds__(kThreads)
    segloss_bwd_kernel(const T* __restrict__ x, const A* __restrict__ t,
               const A* __restrict__ a, const A* __restrict__ b,
               const A* __restrict__ c, T* __restrict__ dx, int S,
               int64_t V, int L, int64_t xs, int64_t xv, int64_t vchunk) {
  extern __shared__ __align__(16) char smem[];
  const int lane = threadIdx.x % kLanes;
  const int g = threadIdx.x / kLanes;
  const Tiles<T, A> tl = tiles_of(x, t, S, L, xs, xv, smem);
  const int64_t v0 = (int64_t)blockIdx.x * vchunk;
  const int64_t v1 = v0 + vchunk < V ? v0 + vchunk : V;

  A ca[kSamples][kSlots], cb[kSamples][kSlots], cc[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int l = lane + kLanes * k;
    cc[k] = l < L ? c[l] : (A)0;
#pragma unroll
    for (int q = 0; q < kSamples; ++q) {
      const bool on = q < tl.ns && l < L;
      ca[q][k] = on ? a[(int64_t)(tl.s0 + q) * L + l] : (A)0;
      cb[q][k] = on ? b[(int64_t)(tl.s0 + q) * L + l] : (A)0;
    }
  }
  for_tiles(tl, v0, v1, [&](int64_t vt, int nv, int bi) {
    const bool on = g < nv;
    A tk[kSlots];
    tl.target(vt, bi, g, on, lane, tk);
#pragma unroll
    for (int q = 0; q < kSamples; ++q) {
      if (q >= tl.ns) continue;
      A xk[kSlots], p[kSlots], pg[kSlots];
      tl.logits(vt, bi, q, g, on, lane, xk);
      softmax_row(xk, lane, L, p);
      A sum = 0;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        // p * dL/dp: the cross-entropy's c t / p times p is c t where the
        // clamp passes its gradient
        pg[k] = p[k] * (ca[q][k] * tk[k] + cb[q][k]) +
                (p[k] >= (A)1e-5 ? cc[k] * tk[k] : (A)0);
        sum += pg[k];
      }
      sum = group_sum(sum);
      if (!on) continue;
      T* row = dx + ((int64_t)(tl.s0 + q) * V + vt + g) * L;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int l = lane + kLanes * k;
        if (l < L) down(pg[k] - p[k] * sum, row[l]);
      }
    }
  });
}

bool args_ok(int S, long long V, int L, long long xv, int es,
             long long vchunk, int chunks) {
  return S > 0 && (S + kSamples - 1) / kSamples <= kMaxGridY && V > 0 &&
         L > 0 && L <= kMaxLabels && xv >= L && xv * es <= kMaxRowBytes &&
         vchunk > 0 && chunks > 0 && vchunk * chunks >= V;
}

// dynamic shared memory of a block: two buffers of tiles
template <typename T, typename K>
int tile_bytes(K kernel, int L, int64_t xv) {
  using A = typename Acc<T>::type;
  const int bytes = 2 * (kSamples * span_bytes(xv, L, sizeof(T)) +
                         span_bytes(L, L, sizeof(A)));
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess)
    return -1;
  return bytes;
}

template <typename T>
int launch_fwd(const void* x, const void* t, const void* w, void* part,
               void* out, int S, int64_t V, int L, int64_t xs, int64_t xv,
               int64_t vchunk, int chunks, cudaStream_t s) {
  using A = typename Acc<T>::type;
  const int groups = (S + kSamples - 1) / kSamples;
  const int smem = tile_bytes<T>(segloss_fwd_kernel<T, A>, L, xv);
  if (smem < 0) return (int)cudaGetLastError();
  segloss_fwd_kernel<T, A>
      <<<dim3((unsigned)chunks, (unsigned)groups), kThreads, smem, s>>>(
          (const T*)x, (const A*)t, (const A*)w, (A*)part, S, V, L, xs, xv,
          vchunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t rows = 2 * (int64_t)S * L + L + groups;
  segloss_finish_kernel<A>
      <<<(unsigned)((rows + kFinishRows - 1) / kFinishRows),
         32 * kFinishRows, 0, s>>>((const A*)part, (A*)out, rows, chunks);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* t, const void* a, const void* b,
               const void* c, void* dx, int S, int64_t V, int L, int64_t xs,
               int64_t xv, int64_t vchunk, int chunks, cudaStream_t s) {
  using A = typename Acc<T>::type;
  const int groups = (S + kSamples - 1) / kSamples;
  const int smem = tile_bytes<T>(segloss_bwd_kernel<T, A>, L, xv);
  if (smem < 0) return (int)cudaGetLastError();
  segloss_bwd_kernel<T, A>
      <<<dim3((unsigned)chunks, (unsigned)groups), kThreads, smem, s>>>(
          (const T*)x, (const A*)t, (const A*)a, (const A*)b, (const A*)c,
          (T*)dx, S, V, L, xs, xv, vchunk);
  return (int)cudaGetLastError();
}

int elem_bytes(int dtype) {
  return dtype == kBF16 ? 2 : dtype == kF32 ? 4 : dtype == kF64 ? 8 : 0;
}

}  // namespace

// Pass 1: out (2 S L + L + ceil(S / 4)) = I (S, L), P (S, L), T (L,), the
// cross-entropy sum of each group of 4 samples. part is scratch of
// rows * chunks accumulator values; each block covers vchunk voxels
// (chunks * vchunk >= V). The voxel stride xv is at least L and at most
// kMaxRowBytes bytes.
extern "C" int seg_loss_fwd(const void* x, const void* t, const void* w,
                            void* part, void* out, int dtype, int S,
                            long long V, int L, long long xs, long long xv,
                            long long vchunk, int chunks, void* stream) {
  if (!args_ok(S, V, L, xv, elem_bytes(dtype), vchunk, chunks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kBF16:
      return launch_fwd<__nv_bfloat16>(x, t, w, part, out, S, V, L, xs, xv,
                                       vchunk, chunks, s);
    case kF32:
      return launch_fwd<float>(x, t, w, part, out, S, V, L, xs, xv, vchunk,
                               chunks, s);
    case kF64:
      return launch_fwd<double>(x, t, w, part, out, S, V, L, xs, xv, vchunk,
                                chunks, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Pass 2: dx (S, V, L) dense in the logits' type from the coefficients a,
// b (S, L) and c (L,) in the accumulator type.
extern "C" int seg_loss_bwd(const void* x, const void* t, const void* a,
                            const void* b, const void* c, void* dx, int dtype,
                            int S, long long V, int L, long long xs,
                            long long xv, long long vchunk, int chunks,
                            void* stream) {
  if (!args_ok(S, V, L, xv, elem_bytes(dtype), vchunk, chunks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kBF16:
      return launch_bwd<__nv_bfloat16>(x, t, a, b, c, dx, S, V, L, xs, xv,
                                       vchunk, chunks, s);
    case kF32:
      return launch_bwd<float>(x, t, a, b, c, dx, S, V, L, xs, xv, vchunk,
                               chunks, s);
    case kF64:
      return launch_bwd<double>(x, t, a, b, c, dx, S, V, L, xs, xv, vchunk,
                                chunks, s);
  }
  return (int)cudaErrorInvalidValue;
}
