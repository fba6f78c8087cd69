// K3-K5: GroupNorm's heavy passes in sums-and-composite-affine form,
// written for Hopper (sm_90a).
//
// Replace the full-size work of brainfm_tpu/models/unet3d.py's
// jax.custom_vjp GroupNorms (_fgn_stats / _fused_groupnorm :289-388,
// _pair_groupnorm :184-286); the (B, C) -> (B, G) algebra between the
// passes stays in PyTorch (brainfm_tpu_torch/ops/groupnorm.py):
//  - K3 chan_sums:    per (sample, channel), sum(u) and sum(u * v) over
//                     the spatial extent. Forward u = v = x gives s1 and
//                     s2; backward u = dy, v = x gives s_dy and s_dyx.
//  - K4 chan_affine:  y = x * a[n, c] + b[n, c], computed in the
//                     statistics type and stored in x's type (the forward
//                     apply).
//  - K5 chan_affine3: dx = dy * P[n, c] + x * Q[n, c] + R[n, c] with P, Q,
//                     R in x's type, each operation rounded to x's type, as
//                     _fgn_bwd / _pgn_bwd combine in the activation dtype.
//
// Semantics are exactly ops/groupnorm.py's plain versions
// (chan_sums_plain, chan_affine_plain, chan_affine3_plain). K4 and K5 use
// the same operations in the same order without multiply-add contraction
// (__fmul_rn, __fadd_rn), so they are bitwise equal to them; K3 sums in
// another order, to within the statistics type's rounding.
//
// One layout: each of the N samples is (S, C) with C innermost and S the
// spatial extent (NDHWC, `torch.channels_last_3d`, the layout the 3-D
// network runs in on the card; NHWC in 2-D). The C entry points refuse
// any other extents with cudaErrorInvalidValue, and the wrapper refuses
// other strides. Types: bf16, fp32 and fp64 inputs, one template each;
// sums and the affine in fp32 (fp64 for fp64 inputs).
//
// Bound on the H100: bytes. K3 reads its inputs once and writes 2 numbers
// a (sample, channel); K4 reads x and writes y; K5 reads dy and x and
// writes dx. The coefficients are a few KB.
//
// Design. A voxel is C contiguous values, so a 16-B vector holds 8 bf16
// channels (4 fp32, 2 fp64) of one voxel. A block's threads form a tile of
// `rows` voxels by `ct` channel vectors (ct = C / V up to the block's 256
// threads, rows = 256 / ct): consecutive threads read consecutive vectors
// of consecutive voxels, and each thread keeps one channel vector for the
// whole block, so its coefficients sit in registers, loaded once. Wider
// voxels (C / V > 256) take passes of 256 vectors. K4 and K5 run on grids
// (voxel chunks, N). K3's stage 1 runs on (chunks, N): each thread
// accumulates its vector's V channels over the block's voxels, the block
// reduces its rows in shared memory in a fixed order and writes (C, 2)
// partials; stage 2 (`sums_finish`) adds each (sample, channel)'s chunks
// with 32 lanes and a fixed tree: no float atomics, so two runs are
// bitwise equal. Vectors need C a multiple of V and 16-B aligned pointers;
// otherwise V is one element (a one-channel input: one voxel a thread).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// about the elements a block of K4 / K5 covers: 4 vectors of 16 B a thread
// at bf16
constexpr int64_t kAffineChunk = (int64_t)kThreads * 8 * 4;
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

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// v rounded to T and back: one operation's result in T
template <typename T>
__device__ __forceinline__ typename Acc<T>::type in_t(
    typename Acc<T>::type v) {
  T t;
  down(v, t);
  return up(t);
}

// values of T in 16 bytes
template <typename T> constexpr int kVec = 16 / (int)sizeof(T);

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// dx = ((dy * p) + (x * q)) + r, each operation rounded to T
template <typename T>
__device__ __forceinline__ T combine3(T dy, T x, typename Acc<T>::type p,
                                     typename Acc<T>::type q,
                                     typename Acc<T>::type r) {
  using A = typename Acc<T>::type;
  const A t1 = in_t<T>(mul_rn(up(dy), p));
  const A t2 = in_t<T>(mul_rn(up(x), q));
  const A t3 = in_t<T>(add_rn(t1, t2));
  T out;
  down(add_rn(t3, r), out);
  return out;
}

// V values of T, loaded and stored as one access
template <typename T, int V> struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// a block's threads as `rows` voxels by `ct` channel vectors of V values
struct Tile {
  int cv, ct, rows, r, j;
  __device__ Tile(int C, int V) {
    cv = C / V;
    ct = cv < kThreads ? cv : kThreads;
    rows = kThreads / ct;
    r = threadIdx.x / ct;
    j = threadIdx.x % ct;
  }
  // this thread's channel vector in the pass starting at vector p0
  __device__ bool on(int p0) const { return r < rows && p0 + j < cv; }
};

// one vector of u (and v) into the V sums of u and of u * v
template <typename T, int V, bool kSquare>
__device__ __forceinline__ void add_sums(typename Acc<T>::type* a1,
                                         typename Acc<T>::type* a2,
                                         const Vec<T, V>& pu,
                                         const Vec<T, V>& pv) {
  using A = typename Acc<T>::type;
#pragma unroll
  for (int q = 0; q < V; ++q) {
    const A x = up(pu.v[q]);
    a1[q] += x;
    a2[q] += x * (kSquare ? x : up(pv.v[q]));
  }
}

// loads a thread of K3 keeps in flight
constexpr int kBatch = 4;

// K3 stage 1: block (k, n) writes part[n * C + c, k] = (sum u, sum u*v)
// over channel c of voxels [k * vchunk, (k + 1) * vchunk) of sample n
template <typename T, int V, bool kSquare>
__global__ void __launch_bounds__(kThreads)
    sums_kernel(const T* __restrict__ u, const T* __restrict__ v,
                typename Acc<T>::type* __restrict__ part, int64_t S, int C,
                int64_t vchunk) {
  using A = typename Acc<T>::type;
  __shared__ A red[2 * V][kThreads];
  const Tile t(C, V);
  const int64_t n = blockIdx.y;
  const int chunks = gridDim.x;
  const int64_t s0 = (int64_t)blockIdx.x * vchunk;
  const int64_t s1 = s0 + vchunk < S ? s0 + vchunk : S;
  const T* us = u + n * S * C;
  const T* vs = kSquare ? us : v + n * S * C;
  for (int p0 = 0; p0 < t.cv; p0 += t.ct) {
    A a1[V], a2[V];
#pragma unroll
    for (int q = 0; q < V; ++q) a1[q] = a2[q] = 0;
    if (t.on(p0)) {
      const Vec<T, V>* uv = reinterpret_cast<const Vec<T, V>*>(
          us + (int64_t)(p0 + t.j) * V);
      const Vec<T, V>* vv = reinterpret_cast<const Vec<T, V>*>(
          vs + (int64_t)(p0 + t.j) * V);
      const int64_t step = C / V;   // vectors a voxel
      int64_t s = s0 + t.r;
      for (; s + (kBatch - 1) * t.rows < s1; s += kBatch * t.rows) {
        Vec<T, V> pu[kBatch], pv[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          pu[b] = uv[(s + b * t.rows) * step];
          if (!kSquare) pv[b] = vv[(s + b * t.rows) * step];
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
          add_sums<T, V, kSquare>(a1, a2, pu[b], kSquare ? pu[b] : pv[b]);
      }
      for (; s < s1; s += t.rows) {
        const Vec<T, V> pu = uv[s * step];
        add_sums<T, V, kSquare>(a1, a2, pu, kSquare ? pu : vv[s * step]);
      }
    }
#pragma unroll
    for (int q = 0; q < V; ++q) {
      red[q][threadIdx.x] = a1[q];
      red[V + q][threadIdx.x] = a2[q];
    }
    __syncthreads();
    // value (q, jj) of the pass summed over the tile's rows, in order
    for (int i = threadIdx.x; i < 2 * V * t.ct; i += kThreads) {
      const int q = i / t.ct, jj = i % t.ct;
      if (p0 + jj < t.cv) {
        A acc = 0;
        for (int rr = 0; rr < t.rows; ++rr) acc += red[q][rr * t.ct + jj];
        const int64_t c = (int64_t)(p0 + jj) * V + q % V;
        part[((n * C + c) * chunks + blockIdx.x) * 2 + q / V] = acc;
      }
    }
    __syncthreads();
  }
}

// K3 stage 2: out[0, n * C + c] = sum_k part[n * C + c, k, 0], out[1,
// ...] likewise; a block is 32 channels by kLanes lanes, lane l adding
// chunks l, l + kLanes, ... in order, then the lanes in order
constexpr int kLanes = 32;
constexpr int kFinishThreads = 32 * kLanes;

template <typename A>
__global__ void __launch_bounds__(kFinishThreads)
    sums_finish(const A* __restrict__ part, A* __restrict__ out,
                int64_t rows, int C, int chunks) {
  __shared__ A red[2][kLanes][32];
  const int cx = threadIdx.x & 31, lane = threadIdx.x >> 5;
  const int64_t c = (int64_t)blockIdx.x * 32 + cx;
  const int64_t row = (int64_t)blockIdx.y * C + c;
  A s1 = 0, s2 = 0;
  if (c < C)
    for (int k = lane; k < chunks; k += kLanes) {
      s1 += part[(row * chunks + k) * 2];
      s2 += part[(row * chunks + k) * 2 + 1];
    }
  red[0][lane][cx] = s1;
  red[1][lane][cx] = s2;
  __syncthreads();
  if (lane == 0 && c < C) {
    A t1 = 0, t2 = 0;
    for (int l = 0; l < kLanes; ++l) {
      t1 += red[0][l][cx];
      t2 += red[1][l][cx];
    }
    out[row] = t1;
    out[rows + row] = t2;
  }
}

// K4: y = x * a[n, c] + b[n, c] in A, stored in T, over voxels
// [k * vchunk, (k + 1) * vchunk) of sample n for block (k, n)
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    affine_kernel(const T* __restrict__ x,
                  const typename Acc<T>::type* __restrict__ a,
                  const typename Acc<T>::type* __restrict__ b,
                  T* __restrict__ y, int64_t S, int C, int64_t vchunk) {
  using A = typename Acc<T>::type;
  const Tile t(C, V);
  const int64_t n = blockIdx.y;
  const int64_t s0 = (int64_t)blockIdx.x * vchunk;
  const int64_t s1 = s0 + vchunk < S ? s0 + vchunk : S;
  const T* xs = x + n * S * C;
  T* ys = y + n * S * C;
  for (int p0 = 0; p0 < t.cv; p0 += t.ct) {
    if (!t.on(p0)) continue;
    const int64_t c0 = (int64_t)(p0 + t.j) * V;
    A ca[V], cb[V];
#pragma unroll
    for (int q = 0; q < V; ++q) {
      ca[q] = a[n * C + c0 + q];
      cb[q] = b[n * C + c0 + q];
    }
#pragma unroll 4
    for (int64_t s = s0 + t.r; s < s1; s += t.rows) {
      const Vec<T, V> px = *reinterpret_cast<const Vec<T, V>*>(
          xs + s * C + c0);
      Vec<T, V> py;
#pragma unroll
      for (int q = 0; q < V; ++q)
        down(add_rn(mul_rn(up(px.v[q]), ca[q]), cb[q]), py.v[q]);
      *reinterpret_cast<Vec<T, V>*>(ys + s * C + c0) = py;
    }
  }
}

// K5: dx = ((dy * P[n, c]) + (x * Q[n, c])) + R[n, c], each operation
// rounded to T
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    affine3_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                   const T* __restrict__ P, const T* __restrict__ Q,
                   const T* __restrict__ R, T* __restrict__ dx, int64_t S,
                   int C, int64_t vchunk) {
  using A = typename Acc<T>::type;
  const Tile t(C, V);
  const int64_t n = blockIdx.y;
  const int64_t s0 = (int64_t)blockIdx.x * vchunk;
  const int64_t s1 = s0 + vchunk < S ? s0 + vchunk : S;
  const T* gs = dy + n * S * C;
  const T* xs = x + n * S * C;
  T* ds = dx + n * S * C;
  for (int p0 = 0; p0 < t.cv; p0 += t.ct) {
    if (!t.on(p0)) continue;
    const int64_t c0 = (int64_t)(p0 + t.j) * V;
    A p[V], q3[V], r[V];
#pragma unroll
    for (int q = 0; q < V; ++q) {
      p[q] = up(P[n * C + c0 + q]);
      q3[q] = up(Q[n * C + c0 + q]);
      r[q] = up(R[n * C + c0 + q]);
    }
#pragma unroll 4
    for (int64_t s = s0 + t.r; s < s1; s += t.rows) {
      const Vec<T, V> pg = *reinterpret_cast<const Vec<T, V>*>(
          gs + s * C + c0);
      const Vec<T, V> px = *reinterpret_cast<const Vec<T, V>*>(
          xs + s * C + c0);
      Vec<T, V> pd;
#pragma unroll
      for (int q = 0; q < V; ++q)
        pd.v[q] = combine3(pg.v[q], px.v[q], p[q], q3[q], r[q]);
      *reinterpret_cast<Vec<T, V>*>(ds + s * C + c0) = pd;
    }
  }
}

// voxels a block of K4 / K5 covers: a multiple of the tile's rows, at
// least 4 steps and about kAffineChunk elements
int64_t vchunk_of(int C, int V) {
  const int cv = C / V;
  const int64_t rows = kThreads / (cv < kThreads ? cv : kThreads);
  int64_t steps = (kAffineChunk + rows * C - 1) / (rows * C);
  if (steps < 4) steps = 4;
  return rows * steps;
}

template <typename T>
int launch_sums(const void* u, const void* v, void* part, void* out,
                int64_t N, int64_t S, int C, int64_t vchunk, int chunks,
                cudaStream_t s) {
  using A = typename Acc<T>::type;
  constexpr int V = kVec<T>;
  const T* ut = (const T*)u;
  const T* vt = v == nullptr ? ut : (const T*)v;
  A* pt = (A*)part;
  const dim3 grid((unsigned)chunks, (unsigned)N);
  const bool vec = C % V == 0 && aligned16(u) && (v == nullptr ||
                                                   aligned16(v));
  if (vec && v == nullptr)
    sums_kernel<T, V, true><<<grid, kThreads, 0, s>>>(ut, vt, pt, S, C,
                                                      vchunk);
  else if (vec)
    sums_kernel<T, V, false><<<grid, kThreads, 0, s>>>(ut, vt, pt, S, C,
                                                       vchunk);
  else if (v == nullptr)
    sums_kernel<T, 1, true><<<grid, kThreads, 0, s>>>(ut, vt, pt, S, C,
                                                      vchunk);
  else
    sums_kernel<T, 1, false><<<grid, kThreads, 0, s>>>(ut, vt, pt, S, C,
                                                       vchunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 fgrid((unsigned)((C + 31) / 32), (unsigned)N);
  sums_finish<A><<<fgrid, kFinishThreads, 0, s>>>(pt, (A*)out, N * C, C,
                                                   chunks);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_affine(const void* x, const void* a, const void* b, void* y,
                  int64_t N, int64_t S, int C, cudaStream_t s) {
  using A = typename Acc<T>::type;
  constexpr int V = kVec<T>;
  const bool vec = C % V == 0 && aligned16(x) && aligned16(y);
  const int64_t vchunk = vchunk_of(C, vec ? V : 1);
  const dim3 grid((unsigned)((S + vchunk - 1) / vchunk), (unsigned)N);
  if (vec)
    affine_kernel<T, V><<<grid, kThreads, 0, s>>>(
        (const T*)x, (const A*)a, (const A*)b, (T*)y, S, C, vchunk);
  else
    affine_kernel<T, 1><<<grid, kThreads, 0, s>>>(
        (const T*)x, (const A*)a, (const A*)b, (T*)y, S, C, vchunk);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_affine3(const void* dy, const void* x, const void* P,
                   const void* Q, const void* R, void* dx, int64_t N,
                   int64_t S, int C, cudaStream_t s) {
  constexpr int V = kVec<T>;
  const bool vec = C % V == 0 && aligned16(dy) && aligned16(x) &&
                   aligned16(dx);
  const int64_t vchunk = vchunk_of(C, vec ? V : 1);
  const dim3 grid((unsigned)((S + vchunk - 1) / vchunk), (unsigned)N);
  if (vec)
    affine3_kernel<T, V><<<grid, kThreads, 0, s>>>(
        (const T*)dy, (const T*)x, (const T*)P, (const T*)Q, (const T*)R,
        (T*)dx, S, C, vchunk);
  else
    affine3_kernel<T, 1><<<grid, kThreads, 0, s>>>(
        (const T*)dy, (const T*)x, (const T*)P, (const T*)Q, (const T*)R,
        (T*)dx, S, C, vchunk);
  return (int)cudaGetLastError();
}

// the grid: N samples on y, blocks on x
bool grid_ok(long long N, int C, long long S, long long xblocks) {
  return N > 0 && N <= kMaxGridY && C > 0 && S >= 0 && xblocks > 0 &&
         xblocks <= 0x7fffffffLL;
}

}  // namespace

// K3: out (2, N, C) = per (sample, channel) (sum u, sum u * v) over the
// S voxels of (N, S, C) operands; v == NULL means v = u. part is scratch
// of N * C * chunks * 2 statistics-type values; each block covers `chunk`
// voxels of a sample (chunks * chunk >= S).
extern "C" int chan_sums(const void* u, const void* v, void* part, void* out,
                         int dtype, long long N, long long S, int C,
                         long long chunk, int chunks, void* stream) {
  if (N == 0 || C == 0) return (int)cudaGetLastError();
  if (!grid_ok(N, C, S, chunks) || chunk <= 0 || chunk * chunks < S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kBF16:
      return launch_sums<__nv_bfloat16>(u, v, part, out, N, S, C, chunk,
                                        chunks, s);
    case kF32:
      return launch_sums<float>(u, v, part, out, N, S, C, chunk, chunks, s);
    case kF64:
      return launch_sums<double>(u, v, part, out, N, S, C, chunk, chunks, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K4: y = x * a + b per (sample, channel) of (N, S, C) x and y (a, b of
// N * C statistics-type values)
extern "C" int chan_affine(const void* x, const void* a, const void* b,
                           void* y, int dtype, long long N, long long S,
                           int C, void* stream) {
  if (N == 0 || C == 0 || S == 0) return (int)cudaGetLastError();
  if (!grid_ok(N, C, S, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kBF16: return launch_affine<__nv_bfloat16>(x, a, b, y, N, S, C, s);
    case kF32: return launch_affine<float>(x, a, b, y, N, S, C, s);
    case kF64: return launch_affine<double>(x, a, b, y, N, S, C, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K5: dx = dy * P + x * Q + R per (sample, channel) of (N, S, C) dy, x and
// dx (P, Q, R of N * C values of x's type)
extern "C" int chan_affine3(const void* dy, const void* x, const void* P,
                            const void* Q, const void* R, void* dx, int dtype,
                            long long N, long long S, int C, void* stream) {
  if (N == 0 || C == 0 || S == 0) return (int)cudaGetLastError();
  if (!grid_ok(N, C, S, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kBF16:
      return launch_affine3<__nv_bfloat16>(dy, x, P, Q, R, dx, N, S, C, s);
    case kF32: return launch_affine3<float>(dy, x, P, Q, R, dx, N, S, C, s);
    case kF64: return launch_affine3<double>(dy, x, P, Q, R, dx, N, S, C, s);
  }
  return (int)cudaErrorInvalidValue;
}
