// K2: small-table lookup out[i, :] = table[idx[i], :], written for Hopper
// (sm_90a).
//
// Replaces brainfm_tpu/ops/pallas_lut.py::lut_apply (_lut_pallas, the
// pl.pallas_call at :53). The TPU kernel evaluates the lookup as a
// compare-accumulate over the whole table because its gather is
// serialized; Hopper gathers directly, from a copy of the table in shared
// memory.
//
// Semantics are exactly brainfm_tpu_torch/ops/lut.py::lut_apply_plain:
// a (K, C) table, integer indices of any count; an index < 0 or >= K gives
// 0. The kernels copy 32-bit words and do no arithmetic on them, so an
// int32 table never passes through fp32 and an fp32 one keeps its bits; the
// two entry points differ in name only, so that launches count per type.
//
// Bound on the H100: bytes. The least traffic is the indices read once and
// the output written once (the table is a few KB): for the GMM lookup,
// 192^3 int32 in and 192^3 x 8 fp32 out, about 0.25 GB, 0.08 ms at
// 3.35 TB/s.
//
// Design. A persistent grid, sized by the occupancy API to the blocks that
// fit on the SMs at once, so each resident block stages the table once;
// tables up to 48 KB sit in shared memory as they are, up to the opt-in
// limit (227 KB on the H100) after cudaFuncSetAttribute, and larger ones are
// read through __ldg. The launcher picks a path from C and the pointers'
// alignment only:
//  - row path (C % 4 == 0, table and output 16-B aligned): a thread handles
//    one 16-B chunk of one row (block (Q, kThreads / Q), Q = C/4): one
//    shared-memory float4 read and one float4 store, consecutive lanes on
//    consecutive 16 B; the Q lanes of an index read it as one broadcast.
//  - word path (C == 1, indices and output 16-B aligned): a thread handles 4
//    consecutive indices, one int4 load and one int4 store; the n % 4 tail
//    is read one index at a time.
//  - scalar path (any other C, or a misaligned pointer): one index per
//    thread, C words each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;   // threads per block
constexpr size_t kSmemDefault = 48 * 1024;
constexpr int kMaxQuads = 32;  // row path up to C = 128

enum Staging { kShared, kGlobal };

// table words into shared memory, 16 B at a time where the source allows
__device__ __forceinline__ void stage(const uint32_t* __restrict__ table,
                                      uint32_t* tbl, int words) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  int head = 0;
  if (((uintptr_t)table & 15) == 0) {
    head = words & ~3;
    const uint4* t4 = reinterpret_cast<const uint4*>(table);
    uint4* s4 = reinterpret_cast<uint4*>(tbl);
    for (int t = tid; t < head / 4; t += nt) s4[t] = t4[t];
  }
  for (int t = head + tid; t < words; t += nt) tbl[t] = table[t];
  __syncthreads();
}

template <Staging S>
__device__ __forceinline__ uint32_t word(const uint32_t* __restrict__ table,
                                         const uint32_t* tbl, int k, int K) {
  if ((unsigned)k >= (unsigned)K) return 0u;
  return S == kShared ? tbl[k] : __ldg(table + k);
}

template <Staging S>
__global__ void __launch_bounds__(kThreads)
    lut_row_kernel(const uint4* __restrict__ table,
                   const int32_t* __restrict__ idx, uint4* __restrict__ out,
                   int K, int64_t n) {
  extern __shared__ uint4 tbl4[];
  const int Q = blockDim.x, q = threadIdx.x;
  if (S == kShared)
    stage(reinterpret_cast<const uint32_t*>(table),
          reinterpret_cast<uint32_t*>(tbl4), K * Q * 4);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.y + threadIdx.y; i < n;
       i += (int64_t)gridDim.x * blockDim.y) {
    const int k = idx[i];
    uint4 r = make_uint4(0u, 0u, 0u, 0u);
    if ((unsigned)k < (unsigned)K)
      r = S == kShared ? tbl4[k * Q + q] : __ldg(table + (int64_t)k * Q + q);
    out[i * Q + q] = r;
  }
}

template <Staging S>
__global__ void __launch_bounds__(kThreads)
    lut_word_kernel(const uint32_t* __restrict__ table,
                    const int32_t* __restrict__ idx,
                    uint32_t* __restrict__ out, int K, int64_t n) {
  extern __shared__ uint32_t tbl[];
  if (S == kShared) stage(table, tbl, K);
  const int64_t n4 = n / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t t = i; t < n4; t += stride) {
    const int4 k = reinterpret_cast<const int4*>(idx)[t];
    uint4 r;
    r.x = word<S>(table, tbl, k.x, K);
    r.y = word<S>(table, tbl, k.y, K);
    r.z = word<S>(table, tbl, k.z, K);
    r.w = word<S>(table, tbl, k.w, K);
    reinterpret_cast<uint4*>(out)[t] = r;
  }
  for (int64_t t = 4 * n4 + i; t < n; t += stride)
    out[t] = word<S>(table, tbl, idx[t], K);
}

template <Staging S>
__global__ void __launch_bounds__(kThreads)
    lut_scalar_kernel(const uint32_t* __restrict__ table,
                      const int32_t* __restrict__ idx,
                      uint32_t* __restrict__ out, int K, int C, int64_t n) {
  extern __shared__ uint32_t tbl[];
  if (S == kShared) stage(table, tbl, K * C);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int k = idx[i];
    uint32_t* o = out + i * C;
    if ((unsigned)k >= (unsigned)K) {
      for (int c = 0; c < C; ++c) o[c] = 0u;
    } else {
      const int64_t r = (int64_t)k * C;
      for (int c = 0; c < C; ++c)
        o[c] = S == kShared ? tbl[r + c] : __ldg(table + r + c);
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Launch `kernel` on a persistent grid: the blocks resident on the `sms`
// SMs at once, or fewer where `units` (one per thread) need fewer.
template <typename Kernel, typename... Args>
int launch_persistent(Kernel kernel, dim3 block, size_t smem, int sms,
                      int64_t units, cudaStream_t s, Args... args) {
  int per_sm = 0;
  cudaError_t e = cudaSuccess;
  if (smem > kSmemDefault)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  const int threads = block.x * block.y;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      smem);
  if (e != cudaSuccess) return (int)e;
  int64_t want = (units + threads - 1) / threads;
  int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  unsigned blocks = (unsigned)(want < resident ? want : resident);
  kernel<<<blocks, block, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

int lut_gather(const void* table, const void* idx, void* out, int K, int C,
               long long n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  int dev = 0, sms = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return (int)e;
  const size_t bytes = (size_t)K * C * 4;
  const bool shared = bytes <= (size_t)optin;
  const size_t smem = shared ? bytes : 0;
  const int32_t* ix = (const int32_t*)idx;
  const int Q = C / 4;
  if (C % 4 == 0 && Q <= kMaxQuads && aligned16(table) && aligned16(out)) {
    dim3 block(Q, kThreads / Q);
    auto* t = (const uint4*)table;
    auto* o = (uint4*)out;
    return shared ? launch_persistent(lut_row_kernel<kShared>, block, smem,
                                      sms, n * Q, s, t, ix, o, K, (int64_t)n)
                  : launch_persistent(lut_row_kernel<kGlobal>, block, smem,
                                      sms, n * Q, s, t, ix, o, K, (int64_t)n);
  }
  auto* t = (const uint32_t*)table;
  auto* o = (uint32_t*)out;
  if (C == 1 && aligned16(idx) && aligned16(out)) {
    return shared ? launch_persistent(lut_word_kernel<kShared>, dim3(kThreads),
                                      smem, sms, (n + 3) / 4, s, t, ix, o, K,
                                      (int64_t)n)
                  : launch_persistent(lut_word_kernel<kGlobal>, dim3(kThreads),
                                      smem, sms, (n + 3) / 4, s, t, ix, o, K,
                                      (int64_t)n);
  }
  return shared ? launch_persistent(lut_scalar_kernel<kShared>, dim3(kThreads),
                                    smem, sms, n, s, t, ix, o, K, C, (int64_t)n)
                : launch_persistent(lut_scalar_kernel<kGlobal>, dim3(kThreads),
                                    smem, sms, n, s, t, ix, o, K, C, (int64_t)n);
}

}  // namespace

extern "C" int lut_gather_f32(const void* table, const void* idx, void* out,
                              int K, int C, long long n, void* stream) {
  return lut_gather(table, idx, out, K, C, n, stream);
}

extern "C" int lut_gather_i32(const void* table, const void* idx, void* out,
                              int K, int C, long long n, void* stream) {
  return lut_gather(table, idx, out, K, C, n, stream);
}
