// Segment sums of per-point statistics, the reduction of the level-parallel
// generator fit:
//   out[s, :] = sum of vals[i, :] over the rows i with seg[i] == s   (float32)
// Rows whose id lies outside [0, S), negatives included, are dropped.
//
// Replaces src/repro/kernels/segment_scores.py:segment_stats (Pallas, TPU),
// a one-hot matmul into an (S, D) accumulator that stays in VMEM and is
// therefore capped at 8 MB. Here nothing is capped: the fit asks for up to
// S = 131,072 nodes x D = 289 Hessian entries (151 MB) and for N = 524,288
// rows x 289 (606 MB) into S = 1. Each value is read once and used once, so
// device memory bytes bound the work.
//
// The fit promises bit-exact replay, so the sums must not depend on timing:
// no float atomics. The wrapper stable-sorts the row ids (torch.sort), which
// keeps the rows of a segment in their original order. Then:
//   1. offsets_kernel: off[s] = first sorted position with id >= s
//      (a binary search per segment; off[S] counts the kept rows);
//   2. chunk_sums_kernel: a segment's rows are cut into chunks of kChunk
//      rows, counted from the segment's own first row; one warp sums each
//      chunk row by row in order. A warp owns a window of kChunk sorted
//      positions and sums every chunk that starts inside it. Rows are staged
//      through shared memory by flat cooperative loads, so every lane loads
//      whatever D is (one column or 289). A segment of one chunk is written
//      to out directly; a longer segment's chunk partials go to two slots of
//      the window: `tail` for the segment's first chunk, `head` for a later
//      one (a window holds at most one of each). A warp loads the ids and
//      bounds of 32 positions at once, and issues all its loads of up to 32
//      staged values before it stores any, so each lane keeps up to 32 loads
//      in flight;
//   3. segments_kernel: one warp per segment writes zeros for an empty
//      one; a segment of Q > 1 chunks adds its partials in 8 fixed parts,
//      part p taking partials p, p + 8, p + 16, ... in order, and then the 8
//      part sums in part order. A segment of more than kLongChunks chunks
//      (a skewed one) is listed instead (an integer atomic counter), and
//   4. long_segments_kernel gives each listed segment a block, whose 8 warps
//      take its 8 parts for 32 columns. The arithmetic is the same either
//      way, and partials appended at the end only add to the parts they
//      join.
// A segment's sum so depends only on its own rows in their order: appended
// zero-weight rows, other segments, N and S do not change it. A segment that
// holds every row (S = 1) or a quarter of them (a zipf head label) is spread
// over N / kChunk warps, not serialised on one.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kChunk = 256;   // rows of one chunk, and of one window
constexpr int kSumWarps = 4;      // warps of a chunk_sums block
constexpr int kStage = 1024;      // floats a warp stages at a time
constexpr int kPerLane = kStage / kWarp;   // staged values a lane loads
constexpr int kParts = 8;         // fixed split of a segment's partials
constexpr int64_t kLongChunks = 32;   // more chunks: a block per segment

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename Id>
__global__ void keys_kernel(const Id* __restrict__ seg,
                            int32_t* __restrict__ keys, int64_t N, int64_t S) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int64_t s = (int64_t)seg[i];
  keys[i] = (s >= 0 && s < S) ? (int32_t)s : (int32_t)S;
}

// off[s] for s in [0, S]: the first sorted position whose id is >= s.
__global__ void offsets_kernel(const int32_t* __restrict__ keys,
                               int64_t* __restrict__ off, int64_t N,
                               int64_t S) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s > S) return;
  int64_t lo = 0, hi = N;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if ((int64_t)keys[mid] < s) lo = mid + 1; else hi = mid;
  }
  off[s] = lo;
}

// grid = (ceil(n_win / kSumWarps), column tiles of kWarp * NC columns).
// A lane owns columns lane, lane + 32, ... of the tile. The warp of window w
// walks the sorted positions from the first chunk start at or after w's
// start to the first chunk start at or after its end, 32 positions (a batch)
// at a time: lane l loads position l's id, row and segment bounds at once,
// so a run of small segments costs three dependent loads per batch, not per
// chunk. Then the batch's rows are staged and added, row by row in order,
// into the open chunk, which is written out when the next chunk starts.
template <typename T, int NC>
__global__ void __launch_bounds__(kSumWarps * kWarp)
chunk_sums_kernel(const T* __restrict__ vals, const int32_t* __restrict__ keys,
                  const int64_t* __restrict__ perm,
                  const int64_t* __restrict__ off, float* __restrict__ out,
                  float* __restrict__ head, float* __restrict__ tail,
                  int64_t D, int64_t S, int64_t n_win) {
  constexpr int kCols = kWarp * NC;
  constexpr int kRows = kStage / kCols;             // rows staged at a time
  constexpr int kBatch = (kWarp / kRows) * kRows;   // positions loaded at once
  __shared__ float stage[kSumWarps][kStage];
  __shared__ int64_t row_at[kSumWarps][kWarp];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t w = (int64_t)blockIdx.x * kSumWarps + warp;
  if (w >= n_win) return;
  const int64_t nv = off[S];              // kept rows, all sorted first
  const int64_t wbeg = w * kChunk;
  if (wbeg >= nv) return;
  const int64_t wend = min(wbeg + kChunk, nv);
  const int64_t col0 = (int64_t)blockIdx.y * kCols;
  const unsigned tw = (unsigned)min((int64_t)kCols, D - col0);
  float* st = stage[warp];
  int64_t* rows_at = row_at[warp];

  // The first chunk start at or after wbeg: inside the segment of wbeg, or
  // the start of the next segment.
  int64_t b;
  {
    const int32_t s = keys[wbeg];
    const int64_t sb = off[s], se = off[s + 1];
    b = sb + (wbeg - sb + kChunk - 1) / kChunk * kChunk;
    if (b > se) b = se;
  }
  float acc[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[j] = 0.f;
  int64_t c_start = -1, c_sb = 0, c_se = 0;   // the open chunk
  int32_t c_s = 0;
  auto flush = [&]() {
    float* dst = (c_se - c_sb <= kChunk) ? out + (int64_t)c_s * D
                                         : (c_start == c_sb ? tail : head) + w * D;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const unsigned col = lane + kWarp * j;
      if (col < tw) dst[col0 + col] = acc[j];
      acc[j] = 0.f;
    }
  };
  while (b < nv) {
    const int brows = (int)min((int64_t)kBatch, nv - b);
    const int64_t p = b + lane;
    const bool in = lane < brows;
    const int32_t k = in ? keys[p] : 0;
    const int64_t row = in ? perm[p] : 0;
    const int64_t sb = in ? off[k] : 0;
    const int64_t se = in ? off[k + 1] : 0;
    const bool starts = in && (p - sb) % kChunk == 0;
    // A chunk start at or after wend belongs to the next window.
    const unsigned stop = __ballot_sync(kFull, starts && p >= wend);
    const int rows_here = stop ? __ffs(stop) - 1 : brows;
    rows_at[lane] = row * D + col0;
    __syncwarp();
    for (int g = 0; g < rows_here; g += kRows) {
      const int rows = min(kRows, rows_here - g);
      const unsigned total = (unsigned)rows * tw;
      const int64_t* at = rows_at + g;
      float v[kPerLane];
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) {
        const unsigned e = lane + kWarp * u;
        if (e < total) {
          const unsigned r = e / tw;
          v[u] = to_float(vals[at[r] + (e - r * tw)]);
        }
      }
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) {
        const unsigned e = lane + kWarp * u;
        if (e < total) {
          const unsigned r = e / tw;
          st[r * kCols + (e - r * tw)] = v[u];
        }
      }
      __syncwarp();
      for (int r = 0; r < rows; ++r) {
        if (__shfl_sync(kFull, (int)starts, g + r)) {
          if (c_start >= 0) flush();
          c_start = b + g + r;
          c_s = __shfl_sync(kFull, k, g + r);
          c_sb = __shfl_sync(kFull, sb, g + r);
          c_se = __shfl_sync(kFull, se, g + r);
        }
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const unsigned col = lane + kWarp * j;
          if (col < tw) acc[j] += st[r * kCols + col];
        }
      }
      __syncwarp();
    }
    if (stop || brows < kBatch) break;
    b += kBatch;
  }
  if (c_start >= 0) flush();
}

// Part p of the Q partials of a segment whose first chunk lies in window w0:
// partials p, p + kParts, ... in order, where partial 0 is tail[w0] and
// partial q > 0 is head[w0 + q].
__device__ __forceinline__ float part_sum(const float* __restrict__ head,
                                          const float* __restrict__ tail,
                                          int64_t w0, int p, int64_t Q,
                                          int64_t D, int64_t col) {
  float a = 0.f;
#pragma unroll 4
  for (int64_t q = p; q < Q; q += kParts)
    a += q == 0 ? tail[w0 * D + col] : head[(w0 + q) * D + col];
  return a;
}

// grid = ceil(S / 8): warp w takes segment 8 * blockIdx.x + w. longs[0]
// counts the listed long segments, longs[1 + j] holds them.
__global__ void __launch_bounds__(kParts * kWarp)
segments_kernel(const int64_t* __restrict__ off,
                const float* __restrict__ head, const float* __restrict__ tail,
                float* __restrict__ out, int64_t* __restrict__ longs,
                int64_t D, int64_t S) {
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t s = (int64_t)blockIdx.x * kParts + warp;
  if (s >= S) return;
  const int64_t sb = off[s], cnt = off[s + 1] - sb;
  if (cnt == 0) {
    for (int64_t col = lane; col < D; col += kWarp) out[s * D + col] = 0.f;
    return;
  }
  if (cnt <= kChunk) return;              // written by chunk_sums_kernel
  const int64_t q = (cnt + kChunk - 1) / kChunk, w0 = sb / kChunk;
  if (q > kLongChunks) {
    if (lane == 0)
      longs[1 + atomicAdd(reinterpret_cast<unsigned long long*>(longs), 1ull)] = s;
    return;
  }
  for (int64_t col = lane; col < D; col += kWarp) {
    float t = part_sum(head, tail, w0, 0, q, D, col);
    for (int p = 1; p < kParts; ++p) t += part_sum(head, tail, w0, p, q, D, col);
    out[s * D + col] = t;
  }
}

// grid = (listed segments at most, ceil(D / 32)): block j sums listed
// segment j for 32 columns, its 8 warps taking the 8 parts.
__global__ void __launch_bounds__(kParts * kWarp)
long_segments_kernel(const int64_t* __restrict__ off,
                     const float* __restrict__ head,
                     const float* __restrict__ tail, float* __restrict__ out,
                     const int64_t* __restrict__ longs, int64_t D) {
  __shared__ float part[kParts][kWarp];
  if ((int64_t)blockIdx.x >= longs[0]) return;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t s = longs[1 + blockIdx.x];
  const int64_t sb = off[s], cnt = off[s + 1] - sb;
  const int64_t q = (cnt + kChunk - 1) / kChunk, w0 = sb / kChunk;
  const int64_t col = (int64_t)blockIdx.y * kWarp + lane;
  part[warp][lane] = col < D ? part_sum(head, tail, w0, warp, q, D, col) : 0.f;
  __syncthreads();
  if (warp == 0 && col < D) {
    float t = part[0][lane];
#pragma unroll
    for (int p = 1; p < kParts; ++p) t += part[p][lane];
    out[s * D + col] = t;
  }
}

template <typename T, int NC>
cudaError_t launch_sums(const T* vals, const int32_t* keys,
                        const int64_t* perm, const int64_t* off, float* out,
                        float* head, float* tail, int64_t D, int64_t S,
                        int64_t n_win, cudaStream_t stream) {
  const dim3 grid((unsigned)((n_win + kSumWarps - 1) / kSumWarps),
                  (unsigned)((D + kWarp * NC - 1) / (kWarp * NC)));
  chunk_sums_kernel<T, NC><<<grid, kSumWarps * kWarp, 0, stream>>>(
      vals, keys, perm, off, out, head, tail, D, S, n_win);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* vals, const void* keys, const void* perm, void* off,
           void* out, void* head, void* tail, void* longs, int64_t N,
           int64_t D, int64_t S, void* stream_ptr) {
  if (N == 0 || D == 0 || S == 0) return 0;
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int32_t* k = (const int32_t*)keys;
  const int64_t* p = (const int64_t*)perm;
  int64_t* o = (int64_t*)off;
  offsets_kernel<<<(unsigned)((S + 1 + 255) / 256), 256, 0, stream>>>(k, o, N,
                                                                      S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n_win = (N + kChunk - 1) / kChunk;
  const int64_t cols = (D + kWarp - 1) / kWarp;
  const T* v = (const T*)vals;
  float *ou = (float*)out, *hd = (float*)head, *tl = (float*)tail;
  if (cols <= 1)
    err = launch_sums<T, 1>(v, k, p, o, ou, hd, tl, D, S, n_win, stream);
  else if (cols <= 2)
    err = launch_sums<T, 2>(v, k, p, o, ou, hd, tl, D, S, n_win, stream);
  else if (cols <= 4)
    err = launch_sums<T, 4>(v, k, p, o, ou, hd, tl, D, S, n_win, stream);
  else
    err = launch_sums<T, 10>(v, k, p, o, ou, hd, tl, D, S, n_win, stream);
  if (err != cudaSuccess) return (int)err;
  int64_t* lg = (int64_t*)longs;
  err = cudaMemsetAsync(lg, 0, sizeof(int64_t), stream);
  if (err != cudaSuccess) return (int)err;
  segments_kernel<<<(unsigned)((S + kParts - 1) / kParts), kParts * kWarp, 0,
                    stream>>>(o, hd, tl, ou, lg, D, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(n_win / kLongChunks + 1), (unsigned)cols);
  long_segments_kernel<<<grid, kParts * kWarp, 0, stream>>>(o, hd, tl, ou, lg,
                                                            D);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns cudaGetLastError()
// after its launches (0 when they were accepted).

// keys[i] = seg[i] where 0 <= seg[i] < S, else S (the dropped rows sort last).
extern "C" int segment_keys(const void* seg, int seg_is_int64, void* keys,
                            int64_t N, int64_t S, void* stream) {
  if (N == 0) return 0;
  const unsigned blocks = (unsigned)((N + 255) / 256);
  if (seg_is_int64)
    keys_kernel<int64_t><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const int64_t*)seg, (int32_t*)keys, N, S);
  else
    keys_kernel<int32_t><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const int32_t*)seg, (int32_t*)keys, N, S);
  return (int)cudaGetLastError();
}

// keys: the stably sorted keys (N,); perm: their original row indices;
// off: (S + 1,) int64 scratch; head, tail: (n_win, D) float32 scratch with
// n_win = ceil(N / chunk_rows); longs: (n_win / long_chunks + 2,) int64
// scratch; out: (S, D) float32.
extern "C" int segment_stats_f32(const void* vals, const void* keys,
                                 const void* perm, void* off, void* out,
                                 void* head, void* tail, void* longs,
                                 int64_t N, int64_t D, int64_t S,
                                 void* stream) {
  return launch<float>(vals, keys, perm, off, out, head, tail, longs, N, D, S,
                       stream);
}

extern "C" int segment_stats_bf16(const void* vals, const void* keys,
                                  const void* perm, void* off, void* out,
                                  void* head, void* tail, void* longs,
                                  int64_t N, int64_t D, int64_t S,
                                  void* stream) {
  return launch<__nv_bfloat16>(vals, keys, perm, off, out, head, tail, longs,
                               N, D, S, stream);
}

extern "C" int64_t segment_stats_chunk_rows() { return kChunk; }

extern "C" int64_t segment_stats_long_chunks() { return kLongChunks; }

extern "C" const char* segment_stats_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
