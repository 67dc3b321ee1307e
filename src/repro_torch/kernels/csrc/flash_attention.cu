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
// arithmetic (989 TFLOP/s bf16 tensor-core peak); decode (Sq = 1) reads the
// whole K/V cache once per step and is bound by its bytes.
//
// Three kernels; the wrapper (flash_attention.py: decode_path,
// tensor_core_path) picks one from the operands alone and passes its
// choice, which the entry point checks:
// - flash_attention_decode_kernel (namespace dec, below) when q, k and v
//   are all bf16, a (b, kv head) has at most 16 packed rows (Sq * G <= 16:
//   decode), hd % 8 == 0 and every base pointer and (b, h, s) stride is
//   16-byte aligned: each lane streams 16-byte slices of the K and V rows
//   into registers, split-KV over enough blocks to fill the card; its
//   ceiling is the cache's bytes.
// - flash_attention_tc_kernel (namespace tc, below) when q, k and v are all
//   bf16, a (b, kv head) has more than 16 packed rows (Sq * G > 16), hd <=
//   128 with hd % 8 == 0, every base pointer and (b, h, s) stride is 16-byte
//   aligned, and the KV range is not split: bf16 prefill, on tensor cores
//   (mma.sync m16n8k16 fed by cp.async; P as bf16 hi + lo). Its own ceiling
//   is the tensor cores' rate; the hi + lo split and hd's padding to a
//   multiple of 16 make its MMA work ~1.6x the 4*hd operations per pair that
//   the bound counts.
// - flash_attention_kernel for every other call (float32, hd > 128 in
//   prefill, a bf16 call the other two refuse, split-KV prefill): float32
//   FMAs over tiles staged in shared memory, so its own ceiling is the 67
//   TFLOP/s of float32; decode in it is bound by its bytes.
//
// Design of the FMA kernel (right and simple first):
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
#include <string.h>

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

// combine_kernel over every output value, after a split kernel's launch.
template <typename TQ>
int launch_combine(const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)p.B * p.H * p.Sq * p.hd;
  combine_kernel<TQ><<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0,
                       stream>>>(p);
  return (int)cudaGetLastError();
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
  if (p.n_split > 1) return launch_combine<TQ>(p, stream);
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


// ---------------------------------------------------------------------------
// The tensor-core path: bf16 q, k, v with more than 16 packed rows (prefill).
//
// A block takes BQ = 128 packed rows of one (b, kv head), 16 rows per warp
// (8 warps), and walks the KV tiles of its band, 64 keys each. Per tile:
//   S = Q K^T   mma.sync m16n8k16 (bf16 in, float32 accumulate): each product
//               of two bf16 values is exact in float32, so S differs from the
//               plain version only in summation order;
//   softmax     scale, softcap, the causal / window masks and the online
//               update on the accumulator fragments, each a separate pass
//               (softcap only if asked, masks only on the band's edge
//               tiles); a row's max and sum go across the 4 threads of a
//               quad; exponentials by ex2.approx;
//   O += P V    P stays in registers (two adjacent m16n8 accumulator tiles
//               are one m16n8k16 A fragment), split as P = P_hi + P_lo, both
//               bf16, two MMAs into one float32 accumulator: the residual is
//               ~2^-17 of P where P rounded to bf16 once (2^-9) fails the
//               2^-11 relative-RMS check; V's B fragments by ldmatrix.trans.
// Q is staged once with cp.async and kept in registers as A fragments. K and
// V tiles go through a 2-stage ring of 16-byte cp.async.cg copies; the
// src-size operand zero-fills hd up to HDP (a multiple of 16) and every key
// at or past Skv. Shared rows are padded by 16 bytes, so the 8 rows an
// ldmatrix reads fall in 8 distinct bank groups. The last row tiles, which
// see the most keys under a causal mask, are scheduled first. At hd 128 a
// thread holds 64 (O) + 32 (S) + 32 (Q) accumulator and fragment registers;
// ptxas gives it 255 with no spills, so one 8-warp block fits an SM.
// (Tried at h2o-danube's prefill and no faster: 4 warps of 16 rows, 4 warps
// of 32 rows over 32-key tiles, Q read from shared memory every tile.) No
// atomics: two calls give the same bits.
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int BQ = 128;      // packed rows a block, 16 a warp
constexpr int BK = 64;       // keys a KV tile
constexpr int kThreads = BQ / 16 * 32;
constexpr int kJ = BK / 8;   // 8-key tiles of S
constexpr int kPad = 8;      // bf16 of padding at the end of a shared row
constexpr int kStages = 2;   // K/V tiles in flight
constexpr float kLog2e = 1.4426950408889634f;

// HDP: hd padded to a multiple of 16.
template <int HDP>
struct Tile {
  static constexpr int LD = HDP + kPad;          // shared row stride (bf16)
  static constexpr int kChunks = HDP / 8;        // 16-byte copies per row
  static constexpr int kKT = HDP / 16;           // k-steps of Q K^T
  static constexpr int kNT = HDP / 8;            // 8-column tiles of O
  static constexpr int kQCopies = BQ * kChunks / kThreads;
  static constexpr int kKVCopies = (BK * kChunks + kThreads - 1) / kThreads;
  static constexpr int kStage = 2 * BK * LD;     // a K tile and a V tile
  static constexpr size_t smem_bytes =
      ((size_t)BQ * LD + (size_t)kStages * kStage) * sizeof(bf16);
  static_assert(HDP % 16 == 0 && BQ * kChunks % kThreads == 0, "tile shape");
};

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes from src, or 16 zero bytes where !ok (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 float32.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// (x, y) = hi + lo: hi rounded to bf16, lo the residual rounded to bf16.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 residual = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = as_u32(h);
  lo = as_u32(residual);
}

// 2^x to a few float32 ulps, results below 2^-126 flushed to 0: only P's
// weights that are below 2^-126 in the plain version too vanish.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// grid = (ceil(Sq * G / BQ), B * KV), the last row tile first (it has the
// most keys); block = kThreads; dynamic shared memory = Tile::smem_bytes:
// Q, then the K/V ring. Warp w owns rows 16 w .. 16 w + 15 of the tile.
// Lane l holds, of each 16 x 8 fragment, rows l / 4 and l / 4 + 8 and
// columns 2 (l % 4) and 2 (l % 4) + 1.
template <int HDP>
__global__ void __launch_bounds__(kThreads) flash_attention_tc_kernel(const Params p) {
  using T = Tile<HDP>;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* const qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* const ring = qs + BQ * T::LD;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = p.H / p.KV;
  const int64_t R = (int64_t)p.Sq * G;
  const int64_t r0 = (int64_t)(gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = blockIdx.y / p.KV;
  const int kvh = blockIdx.y % p.KV;
  const int64_t off = (int64_t)p.Skv - p.Sq;  // row i sits at off + i

  const bf16* __restrict__ qb = (const bf16*)p.q + b * p.q_sb;
  const bf16* __restrict__ kb = (const bf16*)p.k + b * p.k_sb + kvh * p.k_sh;
  const bf16* __restrict__ vb = (const bf16*)p.v + b * p.v_sb + kvh * p.v_sh;

  // The keys the block's rows can see, in whole tiles from kv_lo.
  const int64_t first_q = r0 / G + off;
  const int64_t last_q = (min(r0 + BQ, R) - 1) / G + off;
  int64_t kv_lo = 0, kv_hi = p.Skv;
  if (!(p.causal && first_q < 0)) {  // else some row sees no key: visit all
    if (p.causal) kv_hi = min((int64_t)p.Skv, last_q + 1);
    if (p.window > 0) kv_lo = max((int64_t)0, first_q - p.window + 1);
  }
  const int n_tiles = (int)((kv_hi - kv_lo + BK - 1) / BK);

  auto load_kv = [&](int64_t k0, int stage) {
    bf16* ks = ring + stage * T::kStage;
    bf16* vs = ks + BK * T::LD;
#pragma unroll
    for (int u = 0; u < T::kKVCopies; ++u) {
      const int c = tid + u * kThreads;
      if (c >= BK * T::kChunks) break;
      const int row = c / T::kChunks, col = c % T::kChunks * 8;
      const int64_t key = k0 + row;
      const bool ok = key < p.Skv && col < p.hd;
      cp_async16(smem_addr(ks + row * T::LD + col), ok ? kb + key * p.k_ss + col : kb, ok);
      cp_async16(smem_addr(vs + row * T::LD + col), ok ? vb + key * p.v_ss + col : vb, ok);
    }
  };

  // Q and the first K/V tile.
#pragma unroll
  for (int u = 0; u < T::kQCopies; ++u) {
    const int c = tid + u * kThreads;
    const int row = c / T::kChunks, col = c % T::kChunks * 8;
    const int64_t r = r0 + row;
    const bool ok = r < R && col < p.hd;
    const bf16* src =
        ok ? qb + (int64_t)(kvh * G + (int)(r % G)) * p.q_sh + (r / G) * p.q_ss + col : qb;
    cp_async16(smem_addr(qs + row * T::LD + col), src, ok);
  }
  if (n_tiles > 0) load_kv(kv_lo, 0);
  cp_async_commit();

  // Q's A fragments, one per k-step, kept in registers.
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[T::kKT][4];
  {
    const bf16* qrow = qs + (warp * 16 + (lane & 15)) * T::LD + (lane >> 4) * 8;
#pragma unroll
    for (int kt = 0; kt < T::kKT; ++kt) ldmatrix_x4(qf[kt], smem_addr(qrow + kt * 16));
  }

  const int quad_row = lane >> 2, quad_col = 2 * (lane & 3);
  const int64_t row0 = r0 + warp * 16 + quad_row;  // this thread's rows: row0, row0 + 8
  const int64_t qpos[2] = {row0 / G + off, (row0 + 8) / G + off};
  float o[T::kNT][4];
#pragma unroll
  for (int j = 0; j < T::kNT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};  // l: this thread's part

  for (int it = 0; it < n_tiles; ++it) {
    const int64_t k0 = kv_lo + (int64_t)it * BK;
    __syncthreads();  // every warp is done with the stage about to refill
    if (it + 1 < n_tiles) load_kv(k0 + BK, (it + 1) % kStages);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies are done
    __syncthreads();     // ... for every thread
    const bf16* ks = ring + (it % kStages) * T::kStage;
    const bf16* vs = ks + BK * T::LD;

    // S = Q K^T; K's B fragments by ldmatrix, two 8-key tiles at a time.
    float s[kJ][4];
#pragma unroll
    for (int j = 0; j < kJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const bf16* krow =
        ks + ((lane & 7) + ((lane >> 4) << 3)) * T::LD + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kt = 0; kt < T::kKT; ++kt)
#pragma unroll
      for (int jp = 0; jp < kJ / 2; ++jp) {
        uint32_t kf[4];
        ldmatrix_x4(kf, smem_addr(krow + jp * 16 * T::LD + kt * 16));
        mma(s[2 * jp], qf[kt], kf[0], kf[1]);
        mma(s[2 * jp + 1], qf[kt], kf[2], kf[3]);
      }

    // Scale, softcap, mask (tiles on the band's edge only), online softmax;
    // each a separate pass, so a call without softcap or mask skips it.
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= p.scale;
    if (p.softcap > 0.f) {
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = p.softcap * tanhf(s[j][e] / p.softcap);
    }
    const bool inside = k0 + BK <= p.Skv && (!p.causal || k0 + BK - 1 <= first_q) &&
                        (p.window <= 0 || last_q - k0 < p.window);
    if (!inside) {
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int64_t key = k0 + 8 * j + quad_col + (e & 1);
          const int64_t dq = qpos[e >> 1] - key;
          const bool seen = (!p.causal || dq >= 0) && (p.window <= 0 || dq < p.window);
          s[j][e] = key < p.Skv ? (seen ? s[j][e] : kMasked) : -INFINITY;
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kJ; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      const float m_new = fmaxf(m[h], quad_max(mx));  // >= -1e30: finite
      const float alpha = exp2_approx((m[h] - m_new) * kLog2e);
      m[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[j][e] = exp2_approx((s[j][e] - m_new) * kLog2e);  // a key past Skv: 0
          sum += s[j][e];
        }
      l[h] = alpha * l[h] + sum;
#pragma unroll
      for (int j = 0; j < T::kNT; ++j) {
        o[j][2 * h] *= alpha;
        o[j][2 * h + 1] *= alpha;
      }
    }

    // O += (P_hi + P_lo) V, 16 keys a step; V's B fragments by
    // ldmatrix.trans, two 8-column tiles at a time.
    const bf16* vrow = vs + (lane & 15) * T::LD + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int jp = 0; jp < T::kNT / 2; ++jp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, smem_addr(vrow + kk * 16 * T::LD + jp * 16));
        mma(o[2 * jp], ph, vf[0], vf[1]);
        mma(o[2 * jp + 1], ph, vf[2], vf[3]);
        mma(o[2 * jp], pl, vf[0], vf[1]);
        mma(o[2 * jp + 1], pl, vf[2], vf[3]);
      }
    }
  }

  // Finalise as acc / max(l, 1e-30), rounded once to bf16, through out's
  // strides (q's).
  bf16* ob = (bf16*)p.out + b * p.o_sb;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = row0 + 8 * h;
    const float denom = fmaxf(quad_sum(l[h]), 1e-30f);
    if (r >= R) continue;
    bf16* orow = ob + (int64_t)(kvh * G + (int)(r % G)) * p.o_sh + (r / G) * p.o_ss;
#pragma unroll
    for (int j = 0; j < T::kNT; ++j) {
      const int d = 8 * j + quad_col;
      if (d < p.hd)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) =
            __floats2bfloat162_rn(o[j][2 * h] / denom, o[j][2 * h + 1] / denom);
    }
  }
}

template <int HDP>
int launch(const Params& p, cudaStream_t stream) {
  using T = Tile<HDP>;
  auto kernel = flash_attention_tc_kernel<HDP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t rows = (int64_t)p.Sq * (p.H / p.KV);
  const dim3 grid((unsigned)((rows + BQ - 1) / BQ), (unsigned)(p.B * p.KV));
  kernel<<<grid, kThreads, T::smem_bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// hd padded to the next of 32, 64, 80, 96, 128.
int dispatch(const Params& p, cudaStream_t stream) {
  if (p.hd <= 32) return launch<32>(p, stream);
  if (p.hd <= 64) return launch<64>(p, stream);
  if (p.hd <= 80) return launch<80>(p, stream);
  if (p.hd <= 96) return launch<96>(p, stream);
  return launch<128>(p, stream);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// The decode path: bf16 q, k and v with at most 16 packed rows (Sq * G <=
// 16), hd % 8 == 0 (hd <= 256), 16-byte aligned pointers and (b, h, s)
// strides. Decode reads each K/V byte once and does ~4 * hd operations per
// (query, key) pair on at most 16 rows, so the cache's bytes bound it.
//
// A block takes up to RB packed rows of one (b, kv head) and one split of
// their band (n_split blocks share a band; combine_kernel merges their
// states in a fixed order). Its 4 warps are cut into lane groups of LPK
// lanes, LPK the power of two at or above hd / 8: lane v of a group owns
// the 8 values [8v, 8v + 8) of hd, and a group takes U keys a step. A lane
// loads its 16 bytes of each of its keys' K and V rows straight into
// registers (__ldg of a uint4: a row of hd 120 is 15 such loads, one a
// lane), all 2U loads before any is used. The group's q rows, scaled, sit
// in registers as float32. A logit is the group's 8-value dot products
// added by an xor-shuffle tree (every lane of the group gets the same
// bits); softcap, the online softmax (in log2 units, by exp2) and P V are
// float32 (P is not rounded), each lane keeping RB x 8 accumulators. Keys
// are visited only inside the band of the block's rows; a key outside a
// row's own band is masked to -1e30 as in the other kernels, and a step
// whose keys every row sees skips the mask. At the end the groups' states
// are merged through shared memory in group order. No atomics: two calls
// give the same bits.
//
// At h2o-danube decode the kernel is bound by its instructions more than by
// the cache's bytes: with its loads removed it takes most of its time
// (PERF.md, PR 17). Staging K and V through a cp.async ring, finishing each
// logit on one lane (a reduce-scatter), and one row a thread with K and V
// read from shared memory were each no faster there.
// ---------------------------------------------------------------------------
namespace dec {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <int LPK, int RB>
struct Cfg {
  static constexpr int kGroups = kWarps * (32 / LPK);   // lane groups a block
  static constexpr int U = RB <= 2 ? 8 : RB == 4 ? 4 : 2;   // keys a group loads at once
};

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A query at absolute position qa sees keys [band_begin, band_end).
__device__ __forceinline__ int64_t band_begin(int64_t qa, const Params& p) {
  return p.window > 0 ? qa - p.window + 1 : 0;
}
__device__ __forceinline__ int64_t band_end(int64_t qa, const Params& p) {
  return p.causal ? qa + 1 : p.Skv;
}

__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// grid = (ceil(Sq * G / RB), B * KV, n_split); block = 128 threads; dynamic
// shared memory = kGroups * RB * (hd + 2) + 2 * RB floats (the merge).
template <int LPK, int RB>
__global__ void __launch_bounds__(kThreads)
flash_attention_decode_kernel(const Params p) {
  using C = Cfg<LPK, RB>;
  constexpr int U = C::U;
  constexpr int kGroupsPerWarp = 32 / LPK;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int grp = warp * kGroupsPerWarp + lane / LPK;
  const int vec = lane % LPK;
  const bool has_vec = vec < p.hd / 8;
  const int G = p.H / p.KV;
  const int64_t R = (int64_t)p.Sq * G;
  const int64_t r0 = (int64_t)blockIdx.x * RB;
  const int b = blockIdx.y / p.KV;
  const int kvh = blockIdx.y % p.KV;
  const int64_t off = (int64_t)p.Skv - p.Sq;   // row i sits at off + i

  // The rows' q slices, scaled, and each row's own band.
  float q[RB][8];
  int lo[RB], hi[RB];   // within [0, Skv]
  const bf16* qb = (const bf16*)p.q + b * p.q_sb;
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int64_t row = min(r0 + r, R - 1);
    const int64_t qa = row / G + off;
    lo[r] = (int)max((int64_t)0, band_begin(qa, p));
    hi[r] = (int)min((int64_t)p.Skv, max((int64_t)0, band_end(qa, p)));
#pragma unroll
    for (int e = 0; e < 8; ++e) q[r][e] = 0.f;
    if (r0 + r < R && has_vec) {
      const int g = (int)(row % G);
      float f[8];
      unpack8(__ldg(reinterpret_cast<const uint4*>(
                  qb + (int64_t)(kvh * G + g) * p.q_sh + (row / G) * p.q_ss + 8 * vec)),
              f);
#pragma unroll
      for (int e = 0; e < 8; ++e) q[r][e] = f[e] * p.scale;
    }
  }

  // The keys the block's rows see (all of them if some row sees none),
  // then this block's split of them.
  const int64_t r_last = min(r0 + RB, R) - 1;
  const int64_t qa_lo = r0 / G + off, qa_hi = r_last / G + off;
  int64_t k_begin = 0, k_end = p.Skv;
  if (!(p.causal && qa_lo < 0)) {
    k_begin = max((int64_t)0, band_begin(qa_lo, p));
    k_end = min((int64_t)p.Skv, band_end(qa_hi, p));
  }
  const int64_t per = (k_end - k_begin + p.n_split - 1) / p.n_split;
  const int64_t kz_begin = k_begin + (int64_t)blockIdx.z * per;
  const int64_t kz_end = min(k_end, kz_begin + per);
  // Keys every row sees: a step inside them needs no mask.
  int all_lo = 0, all_hi = (int)kz_end;
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    all_lo = max(all_lo, lo[r]);
    all_hi = min(all_hi, hi[r]);
  }

  float m[RB], l[RB], acc[RB][8];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  }
  const bf16* kb = (const bf16*)p.k + b * p.k_sb + kvh * p.k_sh + 8 * vec;
  const bf16* vb = (const bf16*)p.v + b * p.v_sb + kvh * p.v_sh + 8 * vec;

  // The warp steps together (its shuffles need every lane); group g of the
  // warp takes keys k0 .. k0 + U - 1 of each step.
  for (int64_t w0 = kz_begin + (int64_t)warp * kGroupsPerWarp * U; w0 < kz_end;
       w0 += (int64_t)C::kGroups * U) {
    const int k0 = (int)w0 + (lane / LPK) * U;
    uint4 kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = k0 + u;
      if (key < kz_end && has_vec) {
        kr[u] = __ldg(reinterpret_cast<const uint4*>(kb + (int64_t)key * p.k_ss));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(vb + (int64_t)key * p.v_ss));
      } else {
        kr[u] = make_uint4(0u, 0u, 0u, 0u);
        vr[u] = kr[u];
      }
    }
    float s[U][RB];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[8];
      unpack8(kr[u], kf);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(q[r][e], kf[e], d);
        s[u][r] = d;
      }
    }
#pragma unroll
    for (int o = LPK / 2; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < RB; ++r) s[u][r] += __shfl_xor_sync(0xffffffffu, s[u][r], o);

    // Softcap, then the logits in log2 units (m, the running max, too);
    // the mask only where a key of the step lies outside some row's band
    // or past the split.
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        float x = s[u][r];
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        s[u][r] = x * kLog2e;
      }
    if (!(k0 >= all_lo && k0 + U <= all_hi)) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const int key = k0 + u;
          const bool seen = key >= lo[r] && key < hi[r];
          s[u][r] = key < kz_end ? (seen ? s[u][r] : kMasked) : -INFINITY;
        }
    }
    // Online softmax update, P V.
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][r]);
      const float m_new = fmaxf(m[r], mx);   // >= -1e30: finite
      const float alpha = exp2f(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u][r] = exp2f(s[u][r] - m_new);    // a key past the split gives 0
        sum += s[u][r];
      }
      l[r] = alpha * l[r] + sum;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[8];
      unpack8(vr[u], vf);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float pw = s[u][r];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(pw, vf[e], acc[r][e]);
      }
    }
  }

  // Merge the groups' states in group order: M = max m_g, weights
  // 2^(m_g - M) (m in log2 units), L = sum w_g l_g, A = sum w_g acc_g.
  float* s_acc = smem;                                 // kGroups x RB x hd
  float* s_w = s_acc + (int64_t)C::kGroups * RB * p.hd;  // kGroups x RB: m, then weight
  float* s_l = s_w + C::kGroups * RB;                  // kGroups x RB
  float* s_ml = s_l + C::kGroups * RB;                 // RB x (M, L)
  if (has_vec)
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int e = 0; e < 8; ++e) s_acc[(grp * RB + r) * p.hd + 8 * vec + e] = acc[r][e];
  if (vec == 0)
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      s_w[grp * RB + r] = m[r];
      s_l[grp * RB + r] = l[r];
    }
  __syncthreads();
  if (threadIdx.x < RB) {
    const int r = threadIdx.x;
    float M = kMasked, L = 0.f;
    for (int g = 0; g < C::kGroups; ++g) M = fmaxf(M, s_w[g * RB + r]);
    for (int g = 0; g < C::kGroups; ++g) {
      const float w = exp2f(s_w[g * RB + r] - M);
      s_w[g * RB + r] = w;
      L += w * s_l[g * RB + r];
    }
    s_ml[2 * r] = M;
    s_ml[2 * r + 1] = L;
  }
  __syncthreads();
  bf16* ob = (bf16*)p.out + b * p.o_sb;
  for (int idx = threadIdx.x; idx < RB * p.hd; idx += kThreads) {
    const int r = idx / p.hd, d = idx % p.hd;
    const int64_t row = r0 + r;
    if (row >= R) continue;
    float a = 0.f;
    for (int g = 0; g < C::kGroups; ++g)
      a = fmaf(s_w[g * RB + r], s_acc[(g * RB + r) * p.hd + d], a);
    if (p.n_split > 1) {   // this split's state, for combine_kernel
      const int64_t slot = ((int64_t)blockIdx.y * p.n_split + blockIdx.z) * R + row;
      if (d == 0) {   // combine_kernel takes the max in natural units
        p.part_ml[2 * slot] = s_ml[2 * r] * kLn2;
        p.part_ml[2 * slot + 1] = s_ml[2 * r + 1];
      }
      p.part_acc[slot * p.hd + d] = a;
    } else {
      bf16* orow = ob + (int64_t)(kvh * G + (int)(row % G)) * p.o_sh + (row / G) * p.o_ss;
      orow[d] = __float2bfloat16(a / fmaxf(s_ml[2 * r + 1], 1e-30f));
    }
  }
}

template <int LPK, int RB>
int launch(const Params& p, cudaStream_t stream) {
  using C = Cfg<LPK, RB>;
  const size_t smem = ((size_t)C::kGroups * RB * (p.hd + 2) + 2 * RB) * sizeof(float);
  auto kernel = flash_attention_decode_kernel<LPK, RB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t rows = (int64_t)p.Sq * (p.H / p.KV);
  const dim3 grid((unsigned)((rows + RB - 1) / RB), (unsigned)(p.B * p.KV),
                  (unsigned)p.n_split);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  if (p.n_split > 1) return launch_combine<bf16>(p, stream);
  return (int)cudaGetLastError();
}

// RB: the packed rows (at most 16) rounded up to 1, 2, 4 or 8 (16 rows take
// two blocks); LPK: hd / 8 rounded up to 4, 8, 16 or 32.
template <int RB>
int dispatch_lanes(const Params& p, cudaStream_t stream) {
  const int vecs = p.hd / 8;
  if (vecs <= 4) return launch<4, RB>(p, stream);
  if (vecs <= 8) return launch<8, RB>(p, stream);
  if (vecs <= 16) return launch<16, RB>(p, stream);
  return launch<32, RB>(p, stream);
}

int dispatch(const Params& p, cudaStream_t stream) {
  const int64_t rows = (int64_t)p.Sq * (p.H / p.KV);
  if (rows <= 1) return dispatch_lanes<1>(p, stream);
  if (rows <= 2) return dispatch_lanes<2>(p, stream);
  if (rows <= 4) return dispatch_lanes<4>(p, stream);
  return dispatch_lanes<8>(p, stream);
}

}  // namespace dec

}  // namespace

// Plain C entry point, loaded with ctypes. Strides are in elements; dtype
// codes: 0 = float32, 1 = bfloat16. n_split > 1 needs part_ml (B * KV *
// n_split * Sq * G * 2 floats) and part_acc (the same rows x hd floats).
// kernel: 0 = the FMA kernel, 1 = the tensor-core kernel, 2 = the decode
// kernel; 1 and 2 are refused unless the operands meet their rule (see the
// top of this file). Returns cudaGetLastError() after the launches (0 when
// accepted).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, int64_t q_sb,
    int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh,
    int64_t o_ss, int64_t B, int64_t H, int64_t KV, int64_t Sq, int64_t Skv,
    int64_t hd, float scale, int causal, int64_t window, float softcap,
    int q_dtype, int kv_dtype, int n_split, int kernel, void* part_ml,
    void* part_acc, void* stream) {
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
  const bool bf16_aligned =
      q_dtype == 1 && kv_dtype == 1 && hd % 8 == 0 &&
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 == 0 &&
      (q_sb | q_sh | q_ss | k_sb | k_sh | k_ss | v_sb | v_sh | v_ss | o_sb | o_sh | o_ss) %
              8 == 0;
  const int64_t rows = Sq * (H / KV);
  if (kernel == 1) {
    if (!bf16_aligned || rows <= kTx || hd > 128 || n_split != 1)
      return (int)cudaErrorInvalidValue;
    return tc::dispatch(p, s);
  }
  if (kernel == 2) {
    if (!bf16_aligned || rows > kTx) return (int)cudaErrorInvalidValue;
    return dec::dispatch(p, s);
  }
  if (kernel != 0) return (int)cudaErrorInvalidValue;
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
