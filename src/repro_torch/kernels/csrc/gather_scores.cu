// Candidate scoring for the sampled head:
//   out[t, j] = w[ids[t, j]] . h[t] + b[ids[t, j]]   (float32 result)
//
// Replaces src/repro/kernels/gather_scores.py:gather_scores (Pallas, TPU).
// The work is a gather of T*n rows of K values with two operations per value
// read, so device memory bytes bound it. At the LM-serving beam call (4
// tokens, 64 candidates, K = 3,840) those bytes are 3.9 MB, about a
// microsecond of bandwidth: what a row waits for there is the latency of
// dependent reads and how many of them the card has in flight.
//
// Design: two dependent round trips to device memory for every row. Lanes
// form groups of `lanes` threads (8 to 256, a power of two); a group scores
// `rows` slots of one token (1, 2 or 4). In round trip 1 a lane reads its
// part of h[t], which does not depend on the ids, and the ids of its
// group's slots; in round trip 2 it issues every 16-byte chunk
// of every row it owns (16 values of a row, all in registers: 4 chunks of
// float32 or 2 of bfloat16) and b[id], and only then runs an FMA. Nothing
// waits on a barrier before the ids are read, and h is never staged in
// shared memory, so K has no cap. A row longer than 16 * lanes values takes
// more rounds of the same kind.
//
// Two variants, one source (kernels/gather_scores.py:launch_plan picks one
// from the shape alone; the C entry checks the plan again):
// - rows (lanes <= 32): a row lies within one warp; a warp scores several
//   rows, reusing its h in registers, and sums with shuffles only. Many-row
//   calls (B = 256 queries, K = 512) take it.
// - split (lanes >= 64): a row is spread over the warps of a block, summed
//   in shared memory. Few-row calls take it, so that the grid has blocks on
//   every SM (the LM-serving beam call: a block a row).
// The plan aims the grid at one wave, kBlocksPerSm blocks an SM (what 256
// threads at up to 128 registers let reside; exported so the plan can check
// it): every load of a block is issued at once, so a second wave would wait
// a whole round trip behind the first. Every sum runs in a fixed order
// (lane chunks, shuffle tree, warps) and no atomics are used: two calls
// give the same bits. Tables are float32 or bfloat16 (upcast with the
// intrinsics), h is float32, ids are torch's int64; any T, n and K is
// masked here. Rows that are not 16-byte aligned (vec == 0) are read element
// by element by the same lanes. An id outside [0, C) is never read: its
// score is written as NaN.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 2;   // the occupancy launch_plan's wave assumes
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr int kLaneValues = 16;  // values of each row a lane holds in a round
constexpr int kMaxRows = 4;      // slots a group scores together
constexpr int kMinLanes = 8;
constexpr unsigned kFull = 0xffffffffu;
enum Variant : int { kRows = 0, kSplit = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// h for one 16-byte chunk of the table: 4 floats (float32 rows) or 8
// (bfloat16 rows), zero where the chunk is masked.
template <int kElts>
__device__ __forceinline__ void load_h(float (&x)[kElts], const float* h, bool live) {
#pragma unroll
  for (int i = 0; i < kElts; i += 4) {
    const float4 v = live ? __ldg(reinterpret_cast<const float4*>(h + i))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    x[i] = v.x; x[i + 1] = v.y; x[i + 2] = v.z; x[i + 3] = v.w;
  }
}

// acc + (one chunk of a row) . (its h), in element order.
__device__ __forceinline__ float dot_chunk(float, const uint4& r, const float (&x)[4],
                                           float acc) {
  acc = fmaf(__uint_as_float(r.x), x[0], acc);
  acc = fmaf(__uint_as_float(r.y), x[1], acc);
  acc = fmaf(__uint_as_float(r.z), x[2], acc);
  return fmaf(__uint_as_float(r.w), x[3], acc);
}
__device__ __forceinline__ float dot_chunk(__nv_bfloat16, const uint4& r, const float (&x)[8],
                                           float acc) {
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    acc = fmaf(f.x, x[2 * i], acc);
    acc = fmaf(f.y, x[2 * i + 1], acc);
  }
  return acc;
}

// grid = ceil(groups / (kThreads / lanes)) blocks of kThreads; a group is
// `rows` consecutive slots of one token. vec != 0 promises 16-byte aligned
// rows of w and h (K * sizeof(Scalar) % 16 == 0).
template <typename Scalar, bool kSplitRows>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
gather_scores_kernel(const Scalar* __restrict__ w, const Scalar* __restrict__ b,
                     const float* __restrict__ h, const int64_t* __restrict__ ids,
                     float* __restrict__ out, int64_t T, int64_t n, int64_t K, int64_t C,
                     int vec, int lanes, int rows) {
  constexpr int kElts = 16 / (int)sizeof(Scalar);   // elements in a chunk
  constexpr int kVec = kLaneValues / kElts;          // chunks of a row a lane holds
  const int tid = threadIdx.x;
  const int lane = tid & (lanes - 1);
  const int group_in_block = tid / lanes;
  const int64_t group = (int64_t)blockIdx.x * (kThreads / lanes) + group_in_block;
  const int64_t per_token = (n + rows - 1) / rows;
  const bool live = group < T * per_token;
  const int64_t t = live ? group / per_token : 0;
  const int64_t j0 = live ? (group - t * per_token) * rows : 0;

  const int64_t chunks = (K + kElts - 1) / kElts;   // of a row
  const int64_t stride = (int64_t)kVec * lanes;
  const float* h_t = h + t * K;

  // Round trip 1: h for the first round, then the ids; neither waits on the other.
  float hv[kVec][kElts];
  if (vec) {
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const int64_t c = lane + (int64_t)v * lanes;
      load_h(hv[v], h_t + c * kElts, c < chunks);
    }
  }
  int64_t id[kMaxRows];
  bool exists[kMaxRows], ok[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    exists[r] = live && r < rows && j0 + r < n;
    id[r] = exists[r] ? (int64_t)__ldg(reinterpret_cast<const long long*>(ids) + t * n + j0 + r)
                      : 0;
    ok[r] = exists[r] && id[r] >= 0 && id[r] < C;
  }

  // Round trip 2: b[id] for the lane that writes, and every chunk of the
  // group's rows in this round, issued before any is used.
  const bool writer = lane == 0;
  float bias[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) bias[r] = (writer && ok[r]) ? to_float(b[id[r]]) : 0.f;
  float acc[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.f;
  if (vec) {
    for (int64_t c0 = 0; c0 < chunks; c0 += stride) {
      if (c0 != 0) {
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          const int64_t c = c0 + lane + (int64_t)v * lanes;
          load_h(hv[v], h_t + c * kElts, c < chunks);
        }
      }
      uint4 wv[kMaxRows][kVec];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        const Scalar* row = w + id[r] * K;
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          const int64_t c = c0 + lane + (int64_t)v * lanes;
          wv[r][v] = (ok[r] && c < chunks)
                         ? __ldg(reinterpret_cast<const uint4*>(row + c * kElts))
                         : make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r)
#pragma unroll
        for (int v = 0; v < kVec; ++v) acc[r] = dot_chunk(Scalar(), wv[r][v], hv[v], acc[r]);
    }
  } else {
    for (int64_t k = lane; k < K; k += lanes) {
      const float x = __ldg(h_t + k);
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r)
        if (ok[r]) acc[r] = fmaf(to_float(w[id[r] * K + k]), x, acc[r]);
    }
  }

  // The sums, in a fixed order.
  float* dst = out + t * n + j0;
  if constexpr (!kSplitRows) {
    for (int o = lanes / 2; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) acc[r] += __shfl_xor_sync(kFull, acc[r], o);
  } else {
    __shared__ float warp_s[kWarps][kMaxRows];
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) acc[r] += __shfl_xor_sync(kFull, acc[r], o);
    if ((tid & (kWarp - 1)) == 0)
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) warp_s[tid / kWarp][r] = acc[r];
    __syncthreads();
    const int warps = lanes / kWarp;   // warps of a group
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        acc[r] = 0.f;
        for (int i = 0; i < warps; ++i) acc[r] += warp_s[group_in_block * warps + i][r];
      }
    }
  }
  if (writer)
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r)
      if (exists[r]) dst[r] = ok[r] ? acc[r] + bias[r] : __int_as_float(0x7fc00000);
}

template <typename Scalar>
int launch(const void* w, const void* b, const void* h, const void* ids, void* out,
           int64_t T, int64_t n, int64_t K, int64_t C, int vec, int variant, int lanes,
           int rows, void* stream) {
  const bool pow2 = lanes >= kMinLanes && lanes <= kThreads && (lanes & (lanes - 1)) == 0;
  const bool plan_ok = pow2 && (rows == 1 || rows == 2 || rows == 4) &&
                       ((variant == kRows && lanes <= kWarp) ||
                        (variant == kSplit && lanes > kWarp));
  if (T < 0 || n < 0 || K < 0 || !plan_ok) return (int)cudaErrorInvalidValue;
  if (T == 0 || n == 0) return 0;
  const int64_t groups = T * ((n + rows - 1) / rows);
  const int64_t per_block = kThreads / lanes;
  const int64_t blocks = (groups + per_block - 1) / per_block;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;

  const Scalar* w_ = static_cast<const Scalar*>(w);
  const Scalar* b_ = static_cast<const Scalar*>(b);
  const float* h_ = static_cast<const float*>(h);
  const int64_t* ids_ = static_cast<const int64_t*>(ids);
  float* out_ = static_cast<float*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == kRows)
    gather_scores_kernel<Scalar, false><<<(unsigned)blocks, kThreads, 0, s>>>(
        w_, b_, h_, ids_, out_, T, n, K, C, vec, lanes, rows);
  else
    gather_scores_kernel<Scalar, true><<<(unsigned)blocks, kThreads, 0, s>>>(
        w_, b_, h_, ids_, out_, T, n, K, C, vec, lanes, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes. (variant, lanes, rows) is
// kernels/gather_scores.py:launch_plan's; a plan this file cannot run
// returns cudaErrorInvalidValue. Otherwise each returns cudaGetLastError()
// after the launch (0 when it was accepted).
extern "C" int gather_scores_f32(const void* w, const void* b, const void* h, const void* ids,
                                 void* out, int64_t T, int64_t n, int64_t K, int64_t C,
                                 int vec, int variant, int lanes, int rows, void* stream) {
  return launch<float>(w, b, h, ids, out, T, n, K, C, vec, variant, lanes, rows, stream);
}

extern "C" int gather_scores_bf16(const void* w, const void* b, const void* h, const void* ids,
                                  void* out, int64_t T, int64_t n, int64_t K, int64_t C,
                                  int vec, int variant, int lanes, int rows, void* stream) {
  return launch<__nv_bfloat16>(w, b, h, ids, out, T, n, K, C, vec, variant, lanes, rows,
                               stream);
}

// The blocks an SM the kernel's launch bounds promise, which launch_plan's
// wave assumes (kernels/gather_scores.py checks the two agree).
extern "C" int gather_scores_blocks_per_sm() { return kBlocksPerSm; }

extern "C" const char* gather_scores_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
