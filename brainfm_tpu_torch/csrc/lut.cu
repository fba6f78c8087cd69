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
// 0. The int32 and fp32 tables take separate instantiations, so an integer
// table never passes through fp32.
//
// Design: each block stages the table in shared memory when K*C*4 bytes
// fit in 48 KB (both tables of the generator path do: 40 KB and 8 KB),
// else reads it through __ldg; then a grid-stride loop gives each thread
// one index at a time and it writes the C values of that row.
//
// Bound on the H100: bytes. The least traffic is the indices read once and
// the output written once (the table is a few KB): for the GMM lookup,
// 192^3 int32 in and 192^3 x 8 fp32 out, about 0.27 GB, 0.08 ms at
// 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBytes = 48 * 1024;
constexpr int kMaxBlocks = 132 * 8;  // grid-stride: a few resident blocks per SM

template <typename T>
__global__ void lut_gather_smem(const T* __restrict__ table,
                                const int32_t* __restrict__ idx,
                                T* __restrict__ out, int K, int C, int64_t n) {
  extern __shared__ unsigned char smem_raw[];
  T* tbl = reinterpret_cast<T*>(smem_raw);
  for (int t = threadIdx.x; t < K * C; t += blockDim.x) tbl[t] = table[t];
  __syncthreads();
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    int k = idx[i];
    T* o = out + i * C;
    if (k < 0 || k >= K) {
      for (int c = 0; c < C; ++c) o[c] = T(0);
    } else {
      const T* r = tbl + (int64_t)k * C;
      for (int c = 0; c < C; ++c) o[c] = r[c];
    }
  }
}

template <typename T>
__global__ void lut_gather_ldg(const T* __restrict__ table,
                               const int32_t* __restrict__ idx,
                               T* __restrict__ out, int K, int C, int64_t n) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    int k = idx[i];
    T* o = out + i * C;
    if (k < 0 || k >= K) {
      for (int c = 0; c < C; ++c) o[c] = T(0);
    } else {
      const T* r = table + (int64_t)k * C;
      for (int c = 0; c < C; ++c) o[c] = __ldg(r + c);
    }
  }
}

template <typename T>
int lut_gather(const void* table, const void* idx, void* out, int K, int C,
               long long n, void* stream) {
  if (n > 0) {
    int64_t want = (n + kThreads - 1) / kThreads;
    unsigned int blocks = (unsigned int)(want < kMaxBlocks ? want : kMaxBlocks);
    size_t bytes = (size_t)K * C * sizeof(T);
    cudaStream_t s = (cudaStream_t)stream;
    if (bytes <= (size_t)kSmemBytes) {
      lut_gather_smem<T><<<blocks, kThreads, bytes, s>>>(
          (const T*)table, (const int32_t*)idx, (T*)out, K, C, n);
    } else {
      lut_gather_ldg<T><<<blocks, kThreads, 0, s>>>(
          (const T*)table, (const int32_t*)idx, (T*)out, K, C, n);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lut_gather_f32(const void* table, const void* idx, void* out,
                              int K, int C, long long n, void* stream) {
  return lut_gather<float>(table, idx, out, K, C, n, stream);
}

extern "C" int lut_gather_i32(const void* table, const void* idx, void* out,
                              int K, int C, long long n, void* stream) {
  return lut_gather<int32_t>(table, idx, out, K, C, n, stream);
}
