// Fused sampled-head loss, forward and backward in one pass. For each token
// t with slot 0 the positive and slots 1..m-1 the negatives:
//   xi[t, j]    = softcap(w[ids[t, j]] . h[t] + b[ids[t, j]])
//   loss[t]     = the per-kind loss (logistic NS family + Eq. 6 regularizer,
//                 NCE, logQ sampled softmax, OVE, augment-and-reduce)
//   coeff[t, j] = d loss[t] / d score[t, j], accidental hits masked
//   dh[t, :]    = sum_j coeff[t, j] * w[ids[t, j], :]
//
// Replaces src/repro/kernels/sampled_loss.py:sampled_head_loss (Pallas, TPU).
// The work is a gather of T*m rows of K values with four operations per value
// read (the score dot and the dh sum), so device memory bytes bound it. Design:
// one warp per token. h[t] is staged in shared memory; each of the m rows is
// read once with 16-byte loads and reduced with warp shuffles, and is kept in
// shared memory as float32 where the warp's m*K rows fit in its share of 48 KB
// (at K = 512 up to m = 10); otherwise the dh pass reads the rows again, which
// then come from L2. The loss and coefficient math runs one lane per slot
// (lane j, j + 32, ...) with shuffle reductions for the negatives' sums, the
// maximum and the softmax normaliser, in accurate expf/log1pf/logf/tanhf: these
// are training gradients. Tables are float32 or bfloat16 (upcast with the
// intrinsics); ids are torch's int64; T, m and K are ragged and masked here,
// with no padding of the inputs. A token with an id outside [0, C) gets NaN in
// all its outputs and no row of it is read.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 2;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmemBytes = 48 * 1024;

// Kind codes: the index of the kind in SAMPLED_KINDS (kernels/sampled_loss.py).
enum Kind : int {
  kUniformNs = 0,
  kFreqNs = 1,
  kAdversarialNs = 2,
  kNce = 3,
  kSampledSoftmax = 4,
  kOve = 5,
  kAugmentReduce = 6,
};

struct LossArgs {
  int kind;
  int mask_accidental;
  float reg;
  float softcap;
  float scl;      // (C - 1) / n, the OVE scale
  float scl_n;    // scl / n
  float log_scl;  // log((C - 1) / n), the augment-reduce rest mass
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16 bytes of a row as floats: 4 float32 or 8 bfloat16 values.
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// 4 consecutive values as a float4 (8-byte aligned for bfloat16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(pairs[0]);
  const float2 b = __bfloat1622float2(pairs[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Accurate, overflow-free forms of the JAX package's jax.nn functions.
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}
__device__ __forceinline__ float sigmoid(float x) {
  if (x >= 0.f) return 1.f / (1.f + expf(-x));
  const float e = expf(x);
  return e / (1.f + e);
}
__device__ __forceinline__ float logaddexp(float a, float b) {
  return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
}

// The per-token loss; leaves the raw coefficients of slots 1..m-1 in g_s and
// returns slot 0's in *g0. xi_s holds the softcapped scores of all m slots.
__device__ float token_loss(const LossArgs& a, const float* xi_s, float* g_s,
                            const float* lp, const int64_t* ids, int m,
                            int lane, float* g0) {
  const int n = m - 1;
  const float pos = xi_s[0];
  const float lp0 = lp[0];
  const int64_t id0 = ids[0];
  float loss;
  switch (a.kind) {
    case kUniformNs:
    case kFreqNs:
    case kAdversarialNs: {
      float ls = 0.f, sq = 0.f;
      for (int j = 1 + lane; j < m; j += kWarp) {
        const float x = xi_s[j];
        ls += log_sigmoid(-x);
        float g = sigmoid(x) / n;
        if (a.reg != 0.f) {
          const float unb = x + lp[j];
          sq += unb * unb;
          g += (2.f * a.reg / n) * unb;
        }
        g_s[j] = g;
      }
      ls = warp_sum(ls);
      sq = warp_sum(sq);
      loss = -log_sigmoid(pos) - ls / n;
      *g0 = -sigmoid(-pos);
      if (a.reg != 0.f) {
        const float unb0 = pos + lp0;
        loss += a.reg * (unb0 * unb0 + sq / n);
        *g0 += 2.f * a.reg * unb0;
      }
      return loss;
    }
    case kNce: {
      const float ln_nu = logf((float)n);
      float ls = 0.f;
      for (int j = 1 + lane; j < m; j += kWarp) {
        const float u = xi_s[j] - lp[j] - ln_nu;
        ls += log_sigmoid(-u);
        g_s[j] = sigmoid(u);
      }
      ls = warp_sum(ls);
      const float u0 = pos - lp0 - ln_nu;
      *g0 = -sigmoid(-u0);
      return -log_sigmoid(u0) - ls;
    }
    case kSampledSoftmax: {
      // Slot 0 is never masked, so the normaliser stays finite.
      const float c0 = pos - lp0;
      float mx = c0;
      for (int j = 1 + lane; j < m; j += kWarp) {
        const bool hit = a.mask_accidental && ids[j] == id0;
        if (!hit) mx = fmaxf(mx, xi_s[j] - lp[j]);
      }
      mx = warp_max(mx);
      float se = 0.f;
      for (int j = 1 + lane; j < m; j += kWarp) {
        const bool hit = a.mask_accidental && ids[j] == id0;
        const float e = hit ? 0.f : expf(xi_s[j] - lp[j] - mx);
        g_s[j] = e;
        se += e;
      }
      se = warp_sum(se) + expf(c0 - mx);
      for (int j = 1 + lane; j < m; j += kWarp) g_s[j] /= se;
      *g0 = expf(c0 - mx) / se - 1.f;
      return mx + logf(se) - c0;
    }
    case kOve: {
      float sp = 0.f, gs = 0.f;
      for (int j = 1 + lane; j < m; j += kWarp) {
        float g = 0.f;
        if (ids[j] != id0) {
          const float diff = xi_s[j] - pos;
          sp += softplus(diff);
          g = a.scl_n * sigmoid(diff);
        }
        g_s[j] = g;
        gs += g;
      }
      sp = warp_sum(sp);
      *g0 = -warp_sum(gs);
      return a.scl * (sp / n);
    }
    case kAugmentReduce: {
      float mx = -INFINITY;
      for (int j = 1 + lane; j < m; j += kWarp) mx = fmaxf(mx, xi_s[j]);
      mx = warp_max(mx);
      float se = 0.f;
      for (int j = 1 + lane; j < m; j += kWarp) {
        const float e = expf(xi_s[j] - mx);
        g_s[j] = e;
        se += e;
      }
      se = warp_sum(se);
      const float ln_rest = mx + logf(se) + a.log_scl;
      const float w_rest = sigmoid(ln_rest - pos);   // rest-mass weight
      for (int j = 1 + lane; j < m; j += kWarp) g_s[j] = w_rest * (g_s[j] / se);
      *g0 = -w_rest;
      return logaddexp(pos, ln_rest) - pos;
    }
    default:
      *g0 = __int_as_float(0x7fc00000);
      return __int_as_float(0x7fc00000);
  }
}

// grid = ceil(T / kWarpsPerBlock) blocks of kWarpsPerBlock warps, one token a
// warp. Shared memory: a region of `region` floats per warp, laid out as
// [rows (m*K, if stage) | h (K) | xi (m) | g (m)]. vec != 0 promises 16-byte
// aligned rows (w aligned, K*sizeof(Scalar) % 16 == 0), hence K % 4 == 0.
template <typename Scalar>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
sampled_loss_kernel(const Scalar* __restrict__ w, const Scalar* __restrict__ b,
                    const float* __restrict__ h,
                    const int64_t* __restrict__ ids,
                    const float* __restrict__ slot_logp,
                    float* __restrict__ loss, float* __restrict__ coeff,
                    float* __restrict__ xi_out, float* __restrict__ dh,
                    int64_t T, int m, int64_t K, int64_t C, LossArgs args,
                    int vec, int stage, int64_t region) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t t = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (t >= T) return;  // warp-uniform; the kernel has no block barrier
  float* rows_s = smem + warp * region;
  float* h_s = rows_s + (stage ? (int64_t)m * K : 0);
  float* xi_s = h_s + K;
  float* g_s = xi_s + m;
  const int64_t* ids_t = ids + t * m;
  const float* lp_t = slot_logp + t * m;

  bool bad = false;
  for (int j = lane; j < m; j += kWarp) {
    const int64_t id = ids_t[j];
    bad |= id < 0 || id >= C;
  }
  if (__any_sync(kFull, bad)) {
    const float nan = __int_as_float(0x7fc00000);
    if (lane == 0) loss[t] = nan;
    for (int j = lane; j < m; j += kWarp) coeff[t * m + j] = xi_out[t * m + j] = nan;
    for (int64_t k = lane; k < K; k += kWarp) dh[t * K + k] = nan;
    return;
  }

  for (int64_t k = lane; k < K; k += kWarp) h_s[k] = h[t * K + k];
  __syncwarp();

  // Scores: each row read once, staged as float32 where it fits.
  constexpr int kVec = 16 / sizeof(Scalar);
  for (int j = 0; j < m; ++j) {
    const int64_t id = ids_t[j];
    const Scalar* row = w + id * K;
    float* stage_j = stage ? rows_s + (int64_t)j * K : nullptr;
    float acc = 0.f;
    if (vec) {
#pragma unroll 4
      for (int64_t k = (int64_t)lane * kVec; k < K; k += kWarp * kVec) {
        float v[kVec];
        load16(row + k, v);
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc += v[i] * h_s[k + i];
        if (stage_j) {
#pragma unroll
          for (int i = 0; i < kVec; i += 4)
            *reinterpret_cast<float4*>(stage_j + k + i) =
                make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
        }
      }
    } else {
      for (int64_t k = lane; k < K; k += kWarp) {
        const float v = to_float(row[k]);
        acc += v * h_s[k];
        if (stage_j) stage_j[k] = v;
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) xi_s[j] = acc + to_float(b[id]);
  }
  __syncwarp();

  for (int j = lane; j < m; j += kWarp) {
    const float s = xi_s[j];
    const float x = args.softcap != 0.f ? args.softcap * tanhf(s / args.softcap) : s;
    xi_s[j] = x;
    xi_out[t * m + j] = x;
  }
  __syncwarp();

  float g0;
  const float token = token_loss(args, xi_s, g_s, lp_t, ids_t, m, lane, &g0);
  // The softcap chain factor d xi / d score multiplies every coefficient.
  for (int j = lane; j < m; j += kWarp) {
    float g = j == 0 ? g0 : g_s[j];
    if (args.softcap != 0.f) {
      const float r = xi_s[j] / args.softcap;
      g *= 1.f - r * r;
    }
    g_s[j] = g;
    coeff[t * m + j] = g;
  }
  if (lane == 0) loss[t] = token;
  __syncwarp();

  // dh = coeff @ rows, from the staged rows or read again (from L2).
  float* dh_t = dh + t * K;
  if (vec) {
    for (int64_t k = (int64_t)lane * 4; k < K; k += kWarp * 4) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = 0; j < m; ++j) {
        const float g = g_s[j];
        const float4 r = stage ? *reinterpret_cast<const float4*>(rows_s + (int64_t)j * K + k)
                               : load4(w + ids_t[j] * K + k);
        acc.x += g * r.x;
        acc.y += g * r.y;
        acc.z += g * r.z;
        acc.w += g * r.w;
      }
      *reinterpret_cast<float4*>(dh_t + k) = acc;
    }
  } else {
    for (int64_t k = lane; k < K; k += kWarp) {
      float acc = 0.f;
      for (int j = 0; j < m; ++j) {
        const float r = stage ? rows_s[(int64_t)j * K + k] : to_float(w[ids_t[j] * K + k]);
        acc += g_s[j] * r;
      }
      dh_t[k] = acc;
    }
  }
}

template <typename Scalar>
int launch(const void* w, const void* b, const void* h, const void* ids,
           const void* slot_logp, void* loss, void* coeff, void* xi, void* dh,
           int64_t T, int64_t m, int64_t K, int64_t C, int kind, float reg,
           float softcap, float scl, float scl_n, float log_scl,
           int mask_accidental, int vec, void* stream) {
  if (T == 0) return 0;
  const LossArgs args{kind, mask_accidental, reg, softcap, scl, scl_n, log_scl};
  auto region_of = [&](bool stage) {
    const int64_t floats = (stage ? m * K : 0) + K + 2 * m;
    return (floats + 3) / 4 * 4;  // keeps every warp's region 16-byte aligned
  };
  const int stage =
      (size_t)(kWarpsPerBlock * region_of(true)) * sizeof(float) <= kSmemBytes;
  const int64_t region = region_of(stage);
  const size_t smem = (size_t)(kWarpsPerBlock * region) * sizeof(float);
  const unsigned grid = (unsigned)((T + kWarpsPerBlock - 1) / kWarpsPerBlock);
  sampled_loss_kernel<Scalar><<<grid, kWarpsPerBlock * kWarp, smem,
                                (cudaStream_t)stream>>>(
      (const Scalar*)w, (const Scalar*)b, (const float*)h, (const int64_t*)ids,
      (const float*)slot_logp, (float*)loss, (float*)coeff, (float*)xi,
      (float*)dh, T, (int)m, K, C, args, vec, stage, region);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns cudaGetLastError()
// after the launch (0 when it was accepted).
extern "C" int sampled_head_loss_f32(
    const void* w, const void* b, const void* h, const void* ids,
    const void* slot_logp, void* loss, void* coeff, void* xi, void* dh,
    int64_t T, int64_t m, int64_t K, int64_t C, int kind, float reg,
    float softcap, float scl, float scl_n, float log_scl, int mask_accidental,
    int vec, void* stream) {
  return launch<float>(w, b, h, ids, slot_logp, loss, coeff, xi, dh, T, m, K,
                       C, kind, reg, softcap, scl, scl_n, log_scl,
                       mask_accidental, vec, stream);
}

extern "C" int sampled_head_loss_bf16(
    const void* w, const void* b, const void* h, const void* ids,
    const void* slot_logp, void* loss, void* coeff, void* xi, void* dh,
    int64_t T, int64_t m, int64_t K, int64_t C, int kind, float reg,
    float softcap, float scl, float scl_n, float log_scl, int mask_accidental,
    int vec, void* stream) {
  return launch<__nv_bfloat16>(w, b, h, ids, slot_logp, loss, coeff, xi, dh, T,
                               m, K, C, kind, reg, softcap, scl, scl_n,
                               log_scl, mask_accidental, vec, stream);
}

extern "C" const char* sampled_head_loss_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
