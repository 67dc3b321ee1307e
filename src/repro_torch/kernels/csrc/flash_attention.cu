// Forward attention with an online softmax (flash attention):
//   out[b, h, i] = sum_k softmax_k(s[i, k]) v[b, h / G, k],
//   s[i, k] = softcap(scale * q[b, h, i] . k[b, h / G, k]), masked to the
//   causal / sliding-window band, query row i at absolute position
//   Skv - Sq + i (end-aligned: prefill has Sq == Skv, decode Sq == 1).
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention (Pallas,
// TPU), whose grid walks the KV blocks of one (b*h, q block) in order and
// keeps the running max, sum and accumulator in VMEM scratch. Here one block
// owns a tile of query rows and loops over the KV tiles itself; the running
// state stays in registers. What bounds it on the H100: prefill at
// h2o-danube-3-4b's shapes (Sq = Skv = 4,608, hd = 120, window 4,096) does
// ~4*hd operations per (query, key) pair in the band and is bound by
// arithmetic (989 TFLOP/s bf16 tensor-core peak; this kernel uses float32
// FMAs, so its own ceiling is the 67 TFLOP/s of float32); decode (Sq = 1)
// reads the whole K/V cache once per step and is bound by its bytes.
//
// Design (right and simple first; tensor cores, TMA and warp specialisation
// are later work):
// - GQA without expanding K/V: a block serves one (b, kv head) and packs the
//   G = H / KV query heads of that group as rows, row r = i * G + g, so each
//   K/V tile staged in shared memory serves all G heads, and decode (Sq = 1)
//   still fills G rows of a tile.
// - A tile is 16 * RQ packed rows by 64 keys; 256 threads as 16 x 16, each
//   thread owns RQ rows x 4 keys of the logits (keys strided by 16, so the
//   K reads are free of bank conflicts) and RQ rows x HDP / 16 columns of
//   the output accumulator. Q, K, V and P are staged as float32; every
//   product and sum is float32.
// - Only the KV tiles that meet the tile's causal / window band are visited
//   (a tile spans 16 * RQ / G query positions); ragged edges are masked per
//   element. In-band but masked logits are -1e30 as in the Pallas kernel, so
//   a row whose keys are all masked (causal with Sq > Skv) averages V over
//   all keys like the plain version; for such tiles every KV tile is
//   visited. Keys at or beyond Skv do not exist and weigh exactly 0.
// - Finalised as acc / max(l, 1e-30) and rounded once to q's dtype.
// - Split-KV where the (tile, b, kv head) blocks are too few to fill the
//   card (decode: B * KV blocks): the wrapper gives each tile n_split
//   blocks, each walks a run of whole KV tiles and leaves its running
//   (max, sum, accumulator) in float32 scratch, and combine_kernel merges
//   the runs in a fixed order. No atomics: two calls give the same bits.
// - Staged loads are issued in chunks before their shared-memory stores,
//   so a thread keeps up to 16 device loads in flight.
// - Any Sq, Skv >= 1 and hd <= 256 (padded to HDP in {64, 128, 256}); any
//   strides over (b, h, s) with hd contiguous, so the port passes
//   (B, S, KV, hd) cache slices and (B, S, H, hd) projections as permuted
//   views without a copy. q and out share a dtype (float32 or bfloat16);
//   k and v share one (float32 or bfloat16).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kTx = 16;        // threads along the keys / output columns
constexpr int kBK = 64;        // keys per KV tile
constexpr int kKeysPerThread = kBK / kTx;
constexpr int kChunk = 8;      // staged loads a thread keeps in flight
constexpr float kMasked = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int B, H, KV, Sq, Skv, hd;
  float scale;
  int causal;
  int64_t window;
  float softcap;
  int n_split;       // blocks that share one tile's KV range (split-KV)
  float* part_ml;    // n_split > 1: each split's running max and sum per row
  float* part_acc;   // and its unnormalised accumulator (rows x hd)
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float component(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Max and sum over the 16 threads that share a row (one half of a warp).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = kTx / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = kTx / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int HDP, int RQ>
struct Layout {
  static constexpr int BQ = kTx * RQ;    // packed rows in a tile
  static constexpr int QLD = HDP + 4;    // row stride of Q and K (floats)
  static constexpr int VLD = HDP;        // row stride of V
  static constexpr int PLD = kBK + 4;    // row stride of P (aliases K)
  static constexpr int DCOLS = HDP / kTx;
  static constexpr int Q_ITERS = BQ * HDP / kThreads;   // staged values a thread loads
  static constexpr int KV_ITERS = kBK * HDP / kThreads;
  static constexpr int Q_CHUNK = Q_ITERS < kChunk ? Q_ITERS : kChunk;
  static_assert(Q_ITERS % Q_CHUNK == 0 && KV_ITERS % kChunk == 0, "chunks");
  static constexpr size_t smem_floats =
      (size_t)BQ * QLD + (size_t)kBK * QLD + (size_t)kBK * VLD;
  static_assert(BQ * PLD <= kBK * QLD, "P must fit in K's shared memory");
};

// grid = (ceil(Sq * G / BQ), B * KV, n_split); block = 256 threads; dynamic
// shared memory = Layout::smem_floats floats. With n_split > 1 the tile's KV
// range is cut into n_split runs of whole KV tiles, one per block along z,
// and each block leaves its (max, sum, accumulator) in part_ml / part_acc
// for combine_kernel (decode: B * KV blocks alone cannot fill the card).
template <typename TQ, typename TKV, int HDP, int RQ>
__global__ void __launch_bounds__(kThreads, HDP <= 128 ? 2 : 1)
flash_attention_kernel(const Params p) {
  using L = Layout<HDP, RQ>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                     // BQ x QLD, pre-scaled
  float* Ks = Qs + L::BQ * L::QLD;      // kBK x QLD; P (BQ x PLD) after S
  float* Vs = Ks + kBK * L::QLD;        // kBK x VLD
  float* Ps = Ks;

  const int tid = threadIdx.x;
  const int tx = tid % kTx, ty = tid / kTx;
  const int G = p.H / p.KV;
  const int64_t R = (int64_t)p.Sq * G;
  const int64_t r0 = (int64_t)blockIdx.x * L::BQ;
  const int b = blockIdx.y / p.KV;
  const int kvh = blockIdx.y % p.KV;
  const int64_t off = (int64_t)p.Skv - p.Sq;  // row i sits at off + i

  const TQ* __restrict__ qb = (const TQ*)p.q + b * p.q_sb;
  const TKV* __restrict__ kb = (const TKV*)p.k + b * p.k_sb + kvh * p.k_sh;
  const TKV* __restrict__ vb = (const TKV*)p.v + b * p.v_sb + kvh * p.v_sh;

  // Stage the tile's query rows, scaled, zero past hd and past R. Every
  // load of a chunk is issued before its stores, so they are in flight
  // together (a store to shared memory between two loads would make each
  // load wait for the previous one).
#pragma unroll
  for (int c0 = 0; c0 < L::Q_ITERS; c0 += L::Q_CHUNK) {
    float val[L::Q_CHUNK];
#pragma unroll
    for (int u = 0; u < L::Q_CHUNK; ++u) {
      const int idx = tid + (c0 + u) * kThreads;
      const int row = idx / HDP, d = idx % HDP;
      const int64_t r = r0 + row;
      val[u] = 0.f;
      if (r < R && d < p.hd) {
        const int64_t i = r / G;
        const int g = (int)(r % G);
        val[u] = to_float(qb[(int64_t)(kvh * G + g) * p.q_sh + i * p.q_ss + d]);
      }
    }
#pragma unroll
    for (int u = 0; u < L::Q_CHUNK; ++u) {
      const int idx = tid + (c0 + u) * kThreads;
      Qs[(idx / HDP) * L::QLD + idx % HDP] = val[u] * p.scale;
    }
  }

  // The keys the tile's rows can see.
  const int64_t r_last = min(r0 + L::BQ, R) - 1;
  const int64_t qa_lo = r0 / G + off, qa_hi = r_last / G + off;
  int64_t k_begin = 0, k_end = p.Skv;
  if (!(p.causal && qa_lo < 0)) {  // else some row sees no key: visit all
    if (p.causal) k_end = min((int64_t)p.Skv, qa_hi + 1);
    if (p.window > 0) k_begin = max((int64_t)0, qa_lo - p.window + 1);
  }
  if (p.n_split > 1) {
    const int64_t n_tiles = (k_end - k_begin + kBK - 1) / kBK;
    const int64_t per = (n_tiles + p.n_split - 1) / p.n_split;
    const int64_t first = (int64_t)blockIdx.z * per;
    k_end = min(k_end, k_begin + (first + per) * kBK);
    k_begin += first * kBK;  // at or past k_end: an empty run
  }

  float m[RQ], l[RQ], acc[RQ][L::DCOLS];
  int64_t qa[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
    qa[i] = (r0 + ty * RQ + i) / G + off;
#pragma unroll
    for (int j = 0; j < L::DCOLS; ++j) acc[i][j] = 0.f;
  }
  const int hd4 = (p.hd + 3) & ~3;

  for (int64_t k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's P and V reads are done
#pragma unroll 1
    for (int c0 = 0; c0 < L::KV_ITERS; c0 += kChunk) {
      float kval[kChunk], vval[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int idx = tid + (c0 + u) * kThreads;
        const int row = idx / HDP, d = idx % HDP;
        const int64_t key = k0 + row;
        const bool ok = key < p.Skv && d < p.hd;
        kval[u] = ok ? to_float(kb[key * p.k_ss + d]) : 0.f;
        vval[u] = ok ? to_float(vb[key * p.v_ss + d]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int idx = tid + (c0 + u) * kThreads;
        const int row = idx / HDP, d = idx % HDP;
        Ks[row * L::QLD + d] = kval[u];
        Vs[row * L::VLD + d] = vval[u];
      }
    }
    __syncthreads();

    // Logits: rows ty * RQ + i, keys tx + 16 * j.
    float s[RQ][kKeysPerThread];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < hd4; d += 4) {
      float4 qv[RQ], kv[kKeysPerThread];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            &Qs[(ty * RQ + i) * L::QLD + d]);
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            &Ks[(tx + kTx * j) * L::QLD + d]);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < kKeysPerThread; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // Softcap, mask, online softmax update.
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const int64_t key = k0 + tx + kTx * j;
        float x = s[i][j];
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        const int64_t delta = qa[i] - key;
        const bool valid = (!p.causal || delta >= 0) &&
                           (p.window <= 0 || delta < p.window);
        x = key < p.Skv ? (valid ? x : kMasked) : -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));  // >= -1e30: finite
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        s[i][j] = expf(s[i][j] - m_new);  // a key past Skv gives exactly 0
        sum += s[i][j];
      }
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < L::DCOLS; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // every thread is done reading K: P takes its place
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j)
        Ps[(ty * RQ + i) * L::PLD + tx + kTx * j] = s[i][j];
    __syncthreads();

    // acc += P V: rows ty * RQ + i, columns tx + 16 * j.
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            &Ps[(ty * RQ + i) * L::PLD + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = Vs + (c + cc) * L::VLD + tx;
#pragma unroll
        for (int j = 0; j < L::DCOLS; ++j) {
          const float vv = vrow[kTx * j];
#pragma unroll
          for (int i = 0; i < RQ; ++i)
            acc[i][j] = fmaf(component(pv[i], cc), vv, acc[i][j]);
        }
      }
    }
  }

  if (p.n_split > 1) {  // leave this run's state for combine_kernel
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int64_t r = r0 + ty * RQ + i;
      if (r >= R) continue;
      const int64_t slot = ((int64_t)blockIdx.y * p.n_split + blockIdx.z) * R + r;
      if (tx == 0) {
        p.part_ml[2 * slot] = m[i];
        p.part_ml[2 * slot + 1] = l[i];
      }
#pragma unroll
      for (int j = 0; j < L::DCOLS; ++j) {
        const int d = tx + kTx * j;
        if (d < p.hd) p.part_acc[slot * p.hd + d] = acc[i][j];
      }
    }
    return;
  }

  // Finalise and write the rows this thread owns.
  TQ* ob = (TQ*)p.out + b * p.o_sb;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int64_t r = r0 + ty * RQ + i;
    if (r >= R) continue;
    const int64_t qi = r / G;
    const int g = (int)(r % G);
    TQ* orow = ob + (int64_t)(kvh * G + g) * p.o_sh + qi * p.o_ss;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < L::DCOLS; ++j) {
      const int d = tx + kTx * j;
      if (d < p.hd) orow[d] = from_float<TQ>(acc[i][j] / denom);
    }
  }
}

// Merges the n_split runs of each (b, kv head, packed row, column) in a
// fixed order: out = sum_z acc_z e^(m_z - M) / max(sum_z l_z e^(m_z - M),
// 1e-30) with M = max_z m_z; one thread per output value.
template <typename TQ>
__global__ void __launch_bounds__(kThreads) combine_kernel(const Params p) {
  const int G = p.H / p.KV;
  const int64_t R = (int64_t)p.Sq * G;
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (int64_t)p.B * p.KV * R * p.hd) return;
  const int d = (int)(idx % p.hd);
  const int64_t r = (idx / p.hd) % R;
  const int64_t y = idx / (p.hd * R);
  const int64_t slot0 = y * p.n_split * R + r;
  float M = kMasked;
  for (int z = 0; z < p.n_split; ++z) M = fmaxf(M, p.part_ml[2 * (slot0 + z * R)]);
  float denom = 0.f, num = 0.f;
  for (int z = 0; z < p.n_split; ++z) {
    const int64_t slot = slot0 + z * R;
    const float w = expf(p.part_ml[2 * slot] - M);
    denom += w * p.part_ml[2 * slot + 1];
    num += w * p.part_acc[slot * p.hd + d];
  }
  const int b = (int)(y / p.KV), kvh = (int)(y % p.KV);
  const int64_t qi = r / G;
  const int g = (int)(r % G);
  TQ* o = (TQ*)p.out + b * p.o_sb + (int64_t)(kvh * G + g) * p.o_sh + qi * p.o_ss;
  o[d] = from_float<TQ>(num / fmaxf(denom, 1e-30f));
}

template <typename TQ, typename TKV, int HDP, int RQ>
int launch(const Params& p, cudaStream_t stream) {
  using L = Layout<HDP, RQ>;
  const size_t smem = L::smem_floats * sizeof(float);
  auto kernel = flash_attention_kernel<TQ, TKV, HDP, RQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t rows = (int64_t)p.Sq * (p.H / p.KV);
  const dim3 grid((unsigned)((rows + L::BQ - 1) / L::BQ),
                  (unsigned)(p.B * p.KV), (unsigned)p.n_split);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  if (p.n_split > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int64_t total = (int64_t)p.B * p.KV * rows * p.hd;
    combine_kernel<TQ><<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0,
                         stream>>>(p);
  }
  return (int)cudaGetLastError();
}

// Tiles of 16 packed rows when a (b, kv head) has at most 16 (decode), else
// 64; hd padded to the next of 64, 128, 256. The wrapper chooses n_split
// with the same tile sizes.
template <typename TQ, typename TKV>
int dispatch(const Params& p, cudaStream_t stream) {
  const bool few_rows = (int64_t)p.Sq * (p.H / p.KV) <= kTx;
  if (p.hd <= 64)
    return few_rows ? launch<TQ, TKV, 64, 1>(p, stream)
                    : launch<TQ, TKV, 64, 4>(p, stream);
  if (p.hd <= 128)
    return few_rows ? launch<TQ, TKV, 128, 1>(p, stream)
                    : launch<TQ, TKV, 128, 4>(p, stream);
  return few_rows ? launch<TQ, TKV, 256, 1>(p, stream)
                  : launch<TQ, TKV, 256, 4>(p, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Strides are in elements; dtype
// codes: 0 = float32, 1 = bfloat16. n_split > 1 needs part_ml (B * KV *
// n_split * Sq * G * 2 floats) and part_acc (the same rows x hd floats).
// Returns cudaGetLastError() after the launches (0 when accepted).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, int64_t q_sb,
    int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh,
    int64_t o_ss, int64_t B, int64_t H, int64_t KV, int64_t Sq, int64_t Skv,
    int64_t hd, float scale, int causal, int64_t window, float softcap,
    int q_dtype, int kv_dtype, int n_split, void* part_ml, void* part_acc,
    void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (H <= 0 || KV <= 0 || H % KV != 0 || Skv <= 0 || hd <= 0 || hd > 256 ||
      n_split < 1 || n_split > 65535 ||
      (n_split > 1 && (part_ml == nullptr || part_acc == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Params p{q,    k,    v,    out,  q_sb,          q_sh,     q_ss,
                 k_sb, k_sh, k_ss, v_sb, v_sh,          v_ss,     o_sb,
                 o_sh, o_ss, (int)B, (int)H, (int)KV,   (int)Sq,  (int)Skv,
                 (int)hd, scale, causal, window, softcap, n_split,
                 (float*)part_ml, (float*)part_acc};
  cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == 0 && kv_dtype == 0) return dispatch<float, float>(p, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(p, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return dispatch<float, __nv_bfloat16>(p, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return dispatch<__nv_bfloat16, float>(p, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
