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
// read (the score dot and the dh sum), so device memory bytes bound it; at
// the training shape (T = 256, m = 2) they are under a microsecond of
// bandwidth, so what a token waits for is the latency of dependent reads.
//
// Design: one block of 4 warps per token, and two dependent round trips to
// device memory. The first reads the token's ids and, in the same trip, its
// slot_logp and h[t] (cp.async into shared memory). The second issues,
// all at once, every row of the token (cp.async, 16 bytes a lane, a warp a
// row) and b[ids], whatever m is. Rows are staged in shared memory in their
// own dtype, up to the 227 KB a block can have (the launch's `chunk` slots
// at a time: all m of them unless m * K does not fit, when the rows are
// staged a chunk at a time and read again for dh). Warps then take a slot
// each for the score dot (warp shuffles); one warp runs the loss and
// coefficient math, one lane per slot (lane j, j + 32, ...) with shuffle
// reductions for the negatives' sums, the maximum and the softmax
// normaliser, in accurate expf/log1pf/logf/tanhf: these are training
// gradients. dh is summed from the staged rows in slot order, a column per
// thread, so two calls give the same bits. Tables are float32 or bfloat16
// (upcast with the intrinsics); ids are torch's int64; T, m and K are ragged
// and masked here, with no padding of the inputs. A token with an id outside
// [0, C) gets NaN in all its outputs and no row of it is read.
// K is bounded only by shared memory: h, the per-slot arrays and one row
// must fit a block (the wrapper's max_k, about 29k for float32 tables and
// 38k for bf16); past the rows that fit at once the chunked path takes over.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kWarp = 32;
constexpr int kThreads = kWarps * kWarp;
constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kMaxSmemBytes = 232448;   // the most a block can have (227 KB)

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

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__host__ __device__ constexpr int64_t round16(int64_t bytes) { return (bytes + 15) / 16 * 16; }

// Shared memory: [rows (chunk*K Scalar) | h (K floats) | ids (m int64) |
// b, slot_logp, xi, g (m floats each)], each part 16-byte aligned.
__host__ __device__ constexpr int64_t fixed_bytes(int64_t m, int64_t K) {
  return round16(4 * K) + round16(8 * m) + 4 * round16(4 * m);
}
__host__ __device__ constexpr int64_t smem_bytes(int64_t chunk, int64_t m, int64_t K,
                                                 int64_t elt) {
  return round16(chunk * K * elt) + fixed_bytes(m, K);
}

// Copies the rows of slots j0 .. j0 + ns - 1 into rows_s, a warp a row:
// 16-byte cp.async where vec, else element by element.
template <typename Scalar>
__device__ __forceinline__ void stage_rows(Scalar* rows_s, const Scalar* __restrict__ w,
                                           const int64_t* id_s, int j0, int ns, int64_t K,
                                           int vec, int warp, int lane) {
  constexpr int kVec = 16 / sizeof(Scalar);
  for (int j = warp; j < ns; j += kWarps) {
    const Scalar* row = w + id_s[j0 + j] * K;
    Scalar* dst = rows_s + (int64_t)j * K;
    if (vec) {
      for (int64_t k = (int64_t)lane * kVec; k < K; k += kWarp * kVec) cp_async16(dst + k, row + k);
    } else {
      for (int64_t k = lane; k < K; k += kWarp) dst[k] = row[k];
    }
  }
  cp_async_commit();
}

// grid = T blocks of kThreads (registers for 6 resident an SM with float32
// rows, whose shared memory takes that many at m = 17, K = 512; 8 with
// bfloat16), one token a block. vec != 0 promises 16-byte
// aligned rows of w and h (K * sizeof(Scalar) % 16 == 0), hence K % 4 == 0.
template <typename Scalar>
__global__ void __launch_bounds__(kThreads, sizeof(Scalar) == 4 ? 6 : 8)
sampled_loss_kernel(const Scalar* __restrict__ w, const Scalar* __restrict__ b,
                    const float* __restrict__ h,
                    const int64_t* __restrict__ ids,
                    const float* __restrict__ slot_logp,
                    float* __restrict__ loss, float* __restrict__ coeff,
                    float* __restrict__ xi_out, float* __restrict__ dh,
                    int64_t T, int m, int64_t K, int64_t C, LossArgs args,
                    int vec, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int64_t t = blockIdx.x;
  Scalar* rows_s = reinterpret_cast<Scalar*>(smem);
  float* h_s = reinterpret_cast<float*>(smem + round16((int64_t)chunk * K * sizeof(Scalar)));
  int64_t* id_s = reinterpret_cast<int64_t*>(reinterpret_cast<unsigned char*>(h_s) + round16(4 * K));
  float* b_s = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(id_s) + round16(8 * m));
  const int64_t mf = round16(4 * m) / 4;
  float* lp_s = b_s + mf;
  float* xi_s = lp_s + mf;
  float* g_s = xi_s + mf;
  const float* h_t = h + t * K;

  // Round trip 1: the ids, and h and slot_logp, which do not depend on them.
  if (vec) {
    for (int64_t k = (int64_t)tid * 4; k < K; k += kThreads * 4) cp_async16(h_s + k, h_t + k);
    cp_async_commit();
  }
  bool bad = false;
  for (int j = tid; j < m; j += kThreads) {
    const int64_t id = ids[t * m + j];
    id_s[j] = id;
    lp_s[j] = slot_logp[t * m + j];
    bad |= id < 0 || id >= C;
  }
  if (!vec)
    for (int64_t k = tid; k < K; k += kThreads) h_s[k] = h_t[k];
  if (__syncthreads_or(bad)) {
    cp_async_wait_all();
    const float nan = __int_as_float(0x7fc00000);
    if (tid == 0) loss[t] = nan;
    for (int j = tid; j < m; j += kThreads) coeff[t * m + j] = xi_out[t * m + j] = nan;
    for (int64_t k = tid; k < K; k += kThreads) dh[t * K + k] = nan;
    return;
  }

  // Round trip 2: every row of the first chunk (all m where they fit) and
  // b[ids], issued together. Then the score dots, a warp a slot.
  constexpr int kVec = 16 / sizeof(Scalar);
  for (int j0 = 0; j0 < m; j0 += chunk) {
    const int ns = min(chunk, m - j0);
    if (j0 > 0) __syncthreads();          // the previous chunk's dots are done
    stage_rows(rows_s, w, id_s, j0, ns, K, vec, warp, lane);
    if (j0 == 0)
      for (int j = tid; j < m; j += kThreads) b_s[j] = to_float(b[id_s[j]]);
    cp_async_wait_all();
    __syncthreads();
    for (int j = warp; j < ns; j += kWarps) {
      const Scalar* row = rows_s + (int64_t)j * K;
      float acc = 0.f;
      if (vec) {
        for (int64_t k = (int64_t)lane * kVec; k < K; k += kWarp * kVec) {
          float v[kVec];
          load16(row + k, v);
#pragma unroll
          for (int i = 0; i < kVec; i += 4) {
            const float4 hv = *reinterpret_cast<const float4*>(h_s + k + i);
            acc += v[i] * hv.x + v[i + 1] * hv.y + v[i + 2] * hv.z + v[i + 3] * hv.w;
          }
        }
      } else {
        for (int64_t k = lane; k < K; k += kWarp) acc += to_float(row[k]) * h_s[k];
      }
      acc = warp_sum(acc);
      if (lane == 0) xi_s[j0 + j] = acc + b_s[j0 + j];
    }
  }
  __syncthreads();

  // The softcap, the loss and the coefficients: warp 0, a lane a slot.
  if (warp == 0) {
    for (int j = lane; j < m; j += kWarp) {
      const float s = xi_s[j];
      const float x = args.softcap != 0.f ? args.softcap * tanhf(s / args.softcap) : s;
      xi_s[j] = x;
      xi_out[t * m + j] = x;
    }
    __syncwarp();
    float g0;
    const float token = token_loss(args, xi_s, g_s, lp_s, id_s, m, lane, &g0);
    __syncwarp();
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
  }
  __syncthreads();

  // dh = coeff @ rows in slot order, a column (or 4) per thread; with more
  // than one chunk, the partial sums wait in h_s (h is no longer needed)
  // while each chunk is staged again.
  float* dh_t = dh + t * K;
  const int n_chunks = (m + chunk - 1) / chunk;
  for (int j0 = 0; j0 < m; j0 += chunk) {
    const int ns = min(chunk, m - j0);
    const bool first = j0 == 0, last = j0 + ns == m;
    if (n_chunks > 1) {
      __syncthreads();                    // the previous chunk's reads are done
      stage_rows(rows_s, w, id_s, j0, ns, K, vec, warp, lane);
      cp_async_wait_all();
      __syncthreads();
    }
    const int j_end = ns;
    if (vec) {
      for (int64_t k = (int64_t)tid * 4; k < K; k += kThreads * 4) {
        float4 acc = first ? make_float4(0.f, 0.f, 0.f, 0.f)
                           : *reinterpret_cast<const float4*>(h_s + k);
        for (int j = 0; j < j_end; ++j) {
          const float g = g_s[j0 + j];
          const float4 r = load4(rows_s + (int64_t)j * K + k);
          acc.x += g * r.x;
          acc.y += g * r.y;
          acc.z += g * r.z;
          acc.w += g * r.w;
        }
        if (last)
          *reinterpret_cast<float4*>(dh_t + k) = acc;
        else
          *reinterpret_cast<float4*>(h_s + k) = acc;
      }
    } else {
      for (int64_t k = tid; k < K; k += kThreads) {
        float acc = first ? 0.f : h_s[k];
        for (int j = 0; j < j_end; ++j) acc += g_s[j0 + j] * to_float(rows_s[(int64_t)j * K + k]);
        if (last)
          dh_t[k] = acc;
        else
          h_s[k] = acc;
      }
    }
  }
}

template <typename Scalar>
int launch(const void* w, const void* b, const void* h, const void* ids,
           const void* slot_logp, void* loss, void* coeff, void* xi, void* dh,
           int64_t T, int64_t m, int64_t K, int64_t C, int kind, float reg,
           float softcap, float scl, float scl_n, float log_scl,
           int mask_accidental, int vec, int64_t chunk, void* stream) {
  if (T == 0) return 0;
  const int64_t smem = smem_bytes(chunk, m, K, sizeof(Scalar));
  if (chunk < 1 || chunk > m || smem > kMaxSmemBytes || T > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sampled_loss_kernel<Scalar>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const LossArgs args{kind, mask_accidental, reg, softcap, scl, scl_n, log_scl};
  sampled_loss_kernel<Scalar><<<(unsigned)T, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      (const Scalar*)w, (const Scalar*)b, (const float*)h, (const int64_t*)ids,
      (const float*)slot_logp, (float*)loss, (float*)coeff, (float*)xi,
      (float*)dh, T, (int)m, K, C, args, vec, (int)chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes. `chunk` is the wrapper's
// staged_slots(m, K, itemsize): the slots staged at once, checked here to
// fit. Each returns cudaGetLastError() after the launch (0 when it was
// accepted).
extern "C" int sampled_head_loss_f32(
    const void* w, const void* b, const void* h, const void* ids,
    const void* slot_logp, void* loss, void* coeff, void* xi, void* dh,
    int64_t T, int64_t m, int64_t K, int64_t C, int kind, float reg,
    float softcap, float scl, float scl_n, float log_scl, int mask_accidental,
    int vec, int64_t chunk, void* stream) {
  return launch<float>(w, b, h, ids, slot_logp, loss, coeff, xi, dh, T, m, K,
                       C, kind, reg, softcap, scl, scl_n, log_scl,
                       mask_accidental, vec, chunk, stream);
}

extern "C" int sampled_head_loss_bf16(
    const void* w, const void* b, const void* h, const void* ids,
    const void* slot_logp, void* loss, void* coeff, void* xi, void* dh,
    int64_t T, int64_t m, int64_t K, int64_t C, int kind, float reg,
    float softcap, float scl, float scl_n, float log_scl, int mask_accidental,
    int vec, int64_t chunk, void* stream) {
  return launch<__nv_bfloat16>(w, b, h, ids, slot_logp, loss, coeff, xi, dh, T,
                               m, K, C, kind, reg, softcap, scl, scl_n,
                               log_scl, mask_accidental, vec, chunk, stream);
}

extern "C" const char* sampled_head_loss_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
