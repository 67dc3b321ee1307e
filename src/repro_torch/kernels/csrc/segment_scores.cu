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
// no float atomics. The work is split in two.
//
// A plan, built once per set of ids (segment_keys, then torch.sort in the
// wrapper, then segment_offsets, then a few torch ops for the long
// segments' chunk table): the kept rows' original indices in stably sorted
// order (perm), the first sorted position of each segment (off), and the
// chunks of kChunk rows of every segment longer than kChunk, counted from
// the segment's own first row. The fit's ids stay fixed through a Newton
// solve (and its labels through a whole fit), so one plan serves every
// call of the solve.
//
// A call with a plan (segment_stats_f32 / _bf16) launches:
//   1. segments_kernel: every segment of at most kChunk rows, empty ones
//      included, is summed straight into out; a segment's rows are added
//      one by one in their original order at each column;
//   2. only when the plan has long segments: chunks_kernel sums each chunk
//      the same way into a partial, and
//   3. long_kernel adds a long segment's partials: lane l of a warp takes
//      partials l, l + 32, ... in order, then a fixed shuffle tree adds the
//      32 lane sums.
// How threads map to the work keeps every lane busy at the fit's widths
// (D = 1, 10, 16, 17 and 289): at D <= 32 a thread owns one (segment,
// column) and consecutive threads own consecutive output values, so one
// warp spans several segments; at larger D a warp owns a segment and a lane
// up to NC columns lane, lane + 32, ..., so each row read is 128 bytes a
// warp. A thread loads U rows (U * NC values) before it adds any, through
// the plan's perm, so several loads are in flight a lane.
//
// A segment's sum so depends only on its own rows and their order: other
// segments, N and S do not change it, and zero rows appended after its last
// row only add zeros (a short segment that grows long sums the same rows in
// the same order into its first chunk, and the other partials and lanes of
// the tree are zeros). A segment that holds every row (S = 1, level 0) or a
// quarter of them (a zipf head label) is spread over N / kChunk chunks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 256;      // rows of a chunk; a longer segment is long
constexpr int kThreads = 256;    // threads of a summing block
constexpr int kFlatMaxD = 32;    // up to this D a thread owns one (segment, column)

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
                               int32_t* __restrict__ off, int64_t N,
                               int64_t S) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s > S) return;
  int64_t lo = 0, hi = N;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if ((int64_t)keys[mid] < s) lo = mid + 1; else hi = mid;
  }
  off[s] = (int32_t)lo;
}

// The thread's unit of work: item (a segment or a chunk) and its first
// column. NC == 0: a thread per (item, column), consecutive threads on
// consecutive output values. NC > 0: a warp per (item, tile of 32 * NC
// columns), lane l owning columns l, l + 32, ... of the tile.
template <int NC>
__device__ __forceinline__ bool unit_of(int64_t n_items, int64_t D,
                                        int64_t& item, int64_t& col) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (NC == 0) {
    item = t / D;
    col = t - item * D;
  } else {
    const int64_t w = t / kWarp, tiles = (D + kWarp * NC - 1) / (kWarp * NC);
    item = w / tiles;
    col = (w - item * tiles) * kWarp * NC + (t % kWarp);
  }
  return item < n_items;
}

// acc[j] = sum over sorted positions p in [beg, end), in order, of
// vals[perm[p], col + 32 j]: ((0 + v_beg) + v_beg+1) + ... . U rows are
// loaded before any is added.
template <typename T, int NC, int U>
__device__ __forceinline__ void sum_rows(const T* __restrict__ vals,
                                         const int32_t* __restrict__ perm,
                                         int64_t D, int beg, int end,
                                         int64_t col, float (&acc)[NC > 0 ? NC : 1]) {
  constexpr int W = NC > 0 ? NC : 1;
#pragma unroll
  for (int j = 0; j < W; ++j) acc[j] = 0.f;
  for (int p = beg; p < end; p += U) {
    int64_t at[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      at[u] = p + u < end ? (int64_t)__ldg(perm + p + u) * D : -1;
    float v[U][W];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const int64_t c = col + kWarp * j;
        v[u][j] = (at[u] >= 0 && c < D) ? to_float(__ldg(vals + at[u] + c)) : 0.f;
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (p + u < end)
#pragma unroll
        for (int j = 0; j < W; ++j) acc[j] += v[u][j];
  }
}

// Every segment of at most kChunk rows, straight into out (zeros for an
// empty one); a longer segment is left to long_kernel.
template <typename T, int NC, int U>
__global__ void __launch_bounds__(kThreads)
segments_kernel(const T* __restrict__ vals, const int32_t* __restrict__ perm,
                const int32_t* __restrict__ off, float* __restrict__ out,
                int64_t D, int64_t S) {
  int64_t s, col;
  if (!unit_of<NC>(S, D, s, col)) return;
  const int beg = __ldg(off + s), end = __ldg(off + s + 1);
  if (end - beg > kChunk) return;
  float acc[NC > 0 ? NC : 1];
  sum_rows<T, NC, U>(vals, perm, D, beg, end, col, acc);
#pragma unroll
  for (int j = 0; j < (NC > 0 ? NC : 1); ++j)
    if (col + kWarp * j < D) out[s * D + col + kWarp * j] = acc[j];
}

// Chunk c = sorted positions [chunks[2c], chunks[2c + 1]) into part[c].
template <typename T, int NC, int U>
__global__ void __launch_bounds__(kThreads)
chunks_kernel(const T* __restrict__ vals, const int32_t* __restrict__ perm,
              const int32_t* __restrict__ chunks, float* __restrict__ part,
              int64_t D, int64_t n_chunks) {
  int64_t c, col;
  if (!unit_of<NC>(n_chunks, D, c, col)) return;
  float acc[NC > 0 ? NC : 1];
  sum_rows<T, NC, U>(vals, perm, D, __ldg(chunks + 2 * c), __ldg(chunks + 2 * c + 1),
                     col, acc);
#pragma unroll
  for (int j = 0; j < (NC > 0 ? NC : 1); ++j)
    if (col + kWarp * j < D) part[c * D + col + kWarp * j] = acc[j];
}

// A warp per (long segment i, column): lane l adds the segment's partials
// l, l + 32, ... in order, then a fixed tree adds the 32 lane sums.
__global__ void __launch_bounds__(kThreads)
long_kernel(const float* __restrict__ part, const int32_t* __restrict__ long_seg,
            const int32_t* __restrict__ long_first, float* __restrict__ out,
            int64_t D, int64_t n_long) {
  const int64_t w = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t i = w / D, col = w - (w / D) * D;
  if (i >= n_long) return;   // a whole warp: w is the same on every lane
  const int first = __ldg(long_first + i), last = __ldg(long_first + i + 1);
  float a = 0.f;
  for (int q = first + lane; q < last; q += kWarp) a += part[(int64_t)q * D + col];
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) a += __shfl_down_sync(kFull, a, off);
  if (lane == 0) out[(int64_t)__ldg(long_seg + i) * D + col] = a;
}

// Blocks of kThreads over n_units units of `per` threads each; false if
// the grid would be too large.
bool grid_for(int64_t n_units, int64_t per, unsigned& blocks) {
  const int64_t b = (n_units * per + kThreads - 1) / kThreads;
  if (b >= (int64_t)1 << 31) return false;
  blocks = (unsigned)b;
  return true;
}

template <typename T, int NC, int U>
int launch_sums(const T* vals, const int32_t* perm, const int32_t* off,
                const int32_t* chunks, const int32_t* long_seg,
                const int32_t* long_first, float* part, float* out, int64_t D,
                int64_t S, int64_t n_chunks, int64_t n_long,
                cudaStream_t stream) {
  // Threads a unit takes: one (NC == 0: a unit is one column) or a warp
  // per tile of 32 * NC columns.
  constexpr int kCols = kWarp * (NC > 0 ? NC : 1);
  const int64_t per = NC == 0 ? D : kWarp * ((D + kCols - 1) / kCols);
  unsigned blocks;
  if (!grid_for(S, per, blocks)) return (int)cudaErrorInvalidConfiguration;
  segments_kernel<T, NC, U><<<blocks, kThreads, 0, stream>>>(vals, perm, off, out, D, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_long == 0) return (int)err;
  if (!grid_for(n_chunks, per, blocks)) return (int)cudaErrorInvalidConfiguration;
  chunks_kernel<T, NC, U><<<blocks, kThreads, 0, stream>>>(vals, perm, chunks, part, D,
                                                           n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (!grid_for(n_long * D, kWarp, blocks)) return (int)cudaErrorInvalidConfiguration;
  long_kernel<<<blocks, kThreads, 0, stream>>>(part, long_seg, long_first, out, D, n_long);
  return (int)cudaGetLastError();
}

// D <= 32: a thread per output value, 8 rows in flight; wider: a warp per
// segment and up to 32 * NC columns, NC * U values in flight a lane.
template <typename T>
int launch(const void* vals, const void* perm, const void* off, const void* chunks,
           const void* long_seg, const void* long_first, void* part, void* out,
           int64_t D, int64_t S, int64_t n_chunks, int64_t n_long, void* stream_ptr) {
  if (D == 0 || S == 0) return 0;
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  const T* v = (const T*)vals;
  const int32_t *pm = (const int32_t*)perm, *of = (const int32_t*)off,
                *ch = (const int32_t*)chunks, *ls = (const int32_t*)long_seg,
                *lf = (const int32_t*)long_first;
  float *pt = (float*)part, *ou = (float*)out;
  if (D <= kFlatMaxD)
    return launch_sums<T, 0, 8>(v, pm, of, ch, ls, lf, pt, ou, D, S, n_chunks, n_long, stream);
  if (D <= 2 * kWarp)
    return launch_sums<T, 2, 8>(v, pm, of, ch, ls, lf, pt, ou, D, S, n_chunks, n_long, stream);
  if (D <= 4 * kWarp)
    return launch_sums<T, 4, 4>(v, pm, of, ch, ls, lf, pt, ou, D, S, n_chunks, n_long, stream);
  return launch_sums<T, 10, 2>(v, pm, of, ch, ls, lf, pt, ou, D, S, n_chunks, n_long, stream);
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns cudaGetLastError()
// after its launches (0 when they were accepted).

// The plan's first step: keys[i] = seg[i] where 0 <= seg[i] < S, else S
// (the dropped rows sort last).
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

// The plan's third step, after the stable sort: off (S + 1,) int32 from the
// sorted keys (N,); off[S] counts the kept rows.
extern "C" int segment_offsets(const void* keys, void* off, int64_t N,
                               int64_t S, void* stream) {
  offsets_kernel<<<(unsigned)((S + 1 + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)keys, (int32_t*)off, N, S);
  return (int)cudaGetLastError();
}

// A call with a plan. perm: (kept rows,) int32 original row indices in
// sorted order; off: (S + 1,) int32; chunks: (n_chunks, 2) int32 sorted
// [begin, end) of the long segments' chunks, in segment order; long_seg:
// (n_long,) int32 the long segments; long_first: (n_long + 1,) int32 each
// long segment's first chunk; part: (n_chunks, D) float32 scratch; out:
// (S, D) float32, every value written.
extern "C" int segment_stats_f32(const void* vals, const void* perm, const void* off,
                                 const void* chunks, const void* long_seg,
                                 const void* long_first, void* part, void* out,
                                 int64_t D, int64_t S, int64_t n_chunks,
                                 int64_t n_long, void* stream) {
  return launch<float>(vals, perm, off, chunks, long_seg, long_first, part, out, D, S,
                       n_chunks, n_long, stream);
}

extern "C" int segment_stats_bf16(const void* vals, const void* perm, const void* off,
                                  const void* chunks, const void* long_seg,
                                  const void* long_first, void* part, void* out,
                                  int64_t D, int64_t S, int64_t n_chunks,
                                  int64_t n_long, void* stream) {
  return launch<__nv_bfloat16>(vals, perm, off, chunks, long_seg, long_first, part, out,
                               D, S, n_chunks, n_long, stream);
}

extern "C" int64_t segment_stats_chunk_rows() { return kChunk; }

extern "C" const char* segment_stats_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
