// Candidate scoring for the sampled head:
//   out[t, j] = w[ids[t, j]] . h[t] + b[ids[t, j]]   (float32 result)
//
// Replaces src/repro/kernels/gather_scores.py:gather_scores (Pallas, TPU).
// The work is a gather of T*n rows of K values with two operations per value
// read, so device memory bytes bound it. Design: one warp per (t, j) pair
// reads its row once with 16-byte loads, multiplies it with h[t] held in
// shared memory as float32, and reduces with warp shuffles; the block of 8
// warps shares one token t, so h[t] is read once per 8 rows. Tables are
// float32 or bfloat16 (upcast with the intrinsics), ids are torch's int64,
// and every edge (any T, any n, any K) is masked here. An id outside [0, C)
// is never read: its score is written as NaN.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kWarp = 32;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Dot product of one 16-byte chunk of a row with the matching floats of h.
__device__ __forceinline__ float dot_chunk(const float* row, const float* h) {
  const float4 r = *reinterpret_cast<const float4*>(row);
  const float4 x = *reinterpret_cast<const float4*>(h);
  return r.x * x.x + r.y * x.y + r.z * x.z + r.w * x.w;
}

__device__ __forceinline__ float dot_chunk(const __nv_bfloat16* row,
                                           const float* h) {
  const uint4 raw = *reinterpret_cast<const uint4*>(row);
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float4 x0 = *reinterpret_cast<const float4*>(h);
  const float4 x1 = *reinterpret_cast<const float4*>(h + 4);
  const float2 r0 = __bfloat1622float2(pairs[0]);
  const float2 r1 = __bfloat1622float2(pairs[1]);
  const float2 r2 = __bfloat1622float2(pairs[2]);
  const float2 r3 = __bfloat1622float2(pairs[3]);
  return r0.x * x0.x + r0.y * x0.y + r1.x * x0.z + r1.y * x0.w +
         r2.x * x1.x + r2.y * x1.y + r3.x * x1.z + r3.y * x1.w;
}

// grid = (T, ceil(n / kWarpsPerBlock)); shared memory = K floats.
// vec != 0 promises 16-byte aligned rows (w aligned, K*sizeof(Scalar) % 16 == 0).
template <typename Scalar>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
gather_scores_kernel(const Scalar* __restrict__ w, const Scalar* __restrict__ b,
                     const float* __restrict__ h,
                     const int64_t* __restrict__ ids, float* __restrict__ out,
                     int64_t n, int64_t K, int64_t C, int vec) {
  extern __shared__ __align__(16) float h_s[];
  const int64_t t = blockIdx.x;
  const float* h_t = h + t * K;
  for (int64_t k = threadIdx.x; k < K; k += blockDim.x) h_s[k] = h_t[k];
  __syncthreads();

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t j = (int64_t)blockIdx.y * kWarpsPerBlock + warp;
  if (j >= n) return;
  const int64_t slot = t * n + j;
  const int64_t id = ids[slot];
  if (id < 0 || id >= C) {  // warp-uniform: the whole warp leaves together
    if (lane == 0) out[slot] = __int_as_float(0x7fc00000);
    return;
  }
  const Scalar* row = w + id * K;
  constexpr int kVec = 16 / sizeof(Scalar);  // elements in one 16-byte load
  float acc = 0.f;
  int64_t tail = 0;
  if (vec) {
    for (int64_t k = (int64_t)lane * kVec; k < K; k += kWarp * kVec)
      acc += dot_chunk(row + k, h_s + k);
    tail = K;
  }
  for (int64_t k = tail + lane; k < K; k += kWarp)
    acc += to_float(row[k]) * h_s[k];
#pragma unroll
  for (int offset = kWarp / 2; offset > 0; offset >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, offset);
  if (lane == 0) out[slot] = acc + to_float(b[id]);
}

template <typename Scalar>
int launch(const void* w, const void* b, const void* h, const void* ids,
           void* out, int64_t T, int64_t n, int64_t K, int64_t C, int vec,
           void* stream) {
  if (T == 0 || n == 0) return 0;
  const dim3 grid((unsigned)T,
                  (unsigned)((n + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const size_t smem = (size_t)K * sizeof(float);
  gather_scores_kernel<Scalar><<<grid, kWarpsPerBlock * kWarp, smem,
                                 (cudaStream_t)stream>>>(
      (const Scalar*)w, (const Scalar*)b, (const float*)h,
      (const int64_t*)ids, (float*)out, n, K, C, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns cudaGetLastError()
// after the launch (0 when it was accepted).
extern "C" int gather_scores_f32(const void* w, const void* b, const void* h,
                                 const void* ids, void* out, int64_t T,
                                 int64_t n, int64_t K, int64_t C, int vec,
                                 void* stream) {
  return launch<float>(w, b, h, ids, out, T, n, K, C, vec, stream);
}

extern "C" int gather_scores_bf16(const void* w, const void* b, const void* h,
                                  const void* ids, void* out, int64_t T,
                                  int64_t n, int64_t K, int64_t C, int vec,
                                  void* stream) {
  return launch<__nv_bfloat16>(w, b, h, ids, out, T, n, K, C, vec, stream);
}

extern "C" const char* gather_scores_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
