// Dense Eq. 5 bias-removal term: log p_n(leaf | x[r]) for every leaf of the
// level-order probabilistic tree (root 0, children of i at 2i+1 and 2i+2):
//   out[r, leaf] = sum over the depth ancestors a of leaf of
//                  log_sigmoid(+z_a) if the path turns right at a, else
//                  log_sigmoid(-z_a),  with z_a = w[a] . x[r] + b[a].
//
// Replaces src/repro/kernels/tree_logprob.py:tree_logprob_all (Pallas, TPU).
// The output, B * C_pad floats, is 16 times the bytes of everything read at
// k = 16, so the output write bounds it; the node logits (2k operations per
// node and row) and two transcendentals per node must stay under that.
//
// Design. A block owns one aligned leaf block of up to 256 leaves and up to
// 256 query rows. It stages the weights of the block's subtree nodes and of
// its ancestors above (the prefix) in shared memory once, then never
// synchronises again. Each warp takes 4 rows at a time, and each lane owns
// 8 neighbouring leaves:
//   - the 3 lowest levels of the leaf block (7 nodes) are the lane's own, and
//     its 8 leaf values grow from the lane's path sum in registers;
//   - the 5 levels above (31 nodes) are one node per lane; each lane adds the
//     terms on its path from the owning lanes with warp shuffles;
//   - the prefix ancestors are one per lane, summed with a warp reduction.
// Each node's weights are read from shared memory once for 4 rows (nodes are
// placed so that a warp's 32 reads hit distinct banks). A row's 1 KB of
// output is written by one warp with 16-byte stores. log_sigmoid(z) is
// min(z, 0) - log(1 + exp(-|z|)) with the fast intrinsics (absolute error
// about 1e-7 per term); padding nodes carry b = -PAD_LOGIT = -30, and padding
// leaves come out finite. Trees of fewer than 256 leaves use fewer lanes and
// levels; k is padded with zeros to a multiple of 4, up to 32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;
constexpr int kUpperMax = 5;        // levels with one node per lane
constexpr int kBottomMax = 3;       // levels inside a lane: 8 leaves
constexpr int kSubMax = kUpperMax + kBottomMax;   // leaf block of 256
constexpr int kRowsPerBlock = 256;
constexpr int kRowsAtOnce = 4;      // rows sharing one read of a node's weights
constexpr int kSlots = 2 + (1 << kBottomMax) - 1;  // prefix, upper, 7 bottom
constexpr int kMaxK = 32;

// Floats between two staged nodes: a multiple of 4 with an odd number of
// 16-byte chunks, so 8 lanes reading 8 consecutive nodes hit distinct banks.
__host__ __device__ constexpr int node_stride(int kp) {
  return (kp / 4) % 2 ? kp : kp + 4;
}

__device__ __forceinline__ float softplus_neg_abs(float z) {
  return __logf(1.f + __expf(-fabsf(z)));
}

struct Shape {
  int depth, sub, up, lb, groups, pre, n_slots;
};

__host__ __device__ inline Shape make_shape(int depth) {
  Shape s;
  s.depth = depth;
  s.sub = depth < kSubMax ? depth : kSubMax;
  s.up = s.sub < kUpperMax ? s.sub : kUpperMax;
  s.lb = s.sub - s.up;
  s.groups = 1 << s.up;
  s.pre = depth - s.sub;
  s.n_slots = s.pre + (1 << s.sub) - 1;
  return s;
}

// Staged node e of leaf block ic: e < pre is the prefix ancestor at level e;
// else block-local node j = e - pre in level order. Returns its index in the
// tree and sets its shared-memory slot: prefix and upper nodes keep their
// order, bottom level m puts the q-th node of lane g at q * groups + g.
__device__ __forceinline__ int64_t staged_node(int e, int64_t ic,
                                               const Shape& s, int* slot) {
  const int64_t leaf0 = ic << s.sub;
  if (e < s.pre) {
    *slot = e;
    return ((int64_t)1 << e) - 1 + (leaf0 >> (s.depth - e));
  }
  const int j = e - s.pre;
  const int level = 31 - __clz(j + 1);
  const int p = j - ((1 << level) - 1);
  if (level < s.up) {
    *slot = e;
  } else {
    const int m = level - s.up;
    const int g = p >> m, q = p & ((1 << m) - 1);
    *slot = s.pre + s.groups - 1 + ((1 << m) - 1) * s.groups + q * s.groups + g;
  }
  return ((int64_t)1 << (s.pre + level)) - 1 + (ic << level) + p;
}

// grid = (C_pad >> sub, ceil(B / kRowsPerBlock)), block = kThreads.
template <int KP>
__global__ void __launch_bounds__(kThreads, 2)
tree_logprob_kernel(const float* __restrict__ w, const float* __restrict__ b,
                    const float* __restrict__ x, float* __restrict__ out,
                    int64_t B, int depth, int k) {
  constexpr int kStride = node_stride(KP);
  constexpr int kChunks = KP / 4;
  const Shape s = make_shape(depth);
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                                  // [n_slots][kStride]
  float* bs = ws + s.n_slots * kStride;              // [n_slots]
  float* xs = bs + ((s.n_slots + 3) & ~3);           // [kRowsPerBlock][KP]

  const int tid = threadIdx.x;
  const int64_t ic = blockIdx.x;
  const int64_t leaf0 = ic << s.sub;
  const int64_t row0 = (int64_t)blockIdx.y * kRowsPerBlock;
  const int rows = B - row0 < kRowsPerBlock ? (int)(B - row0) : kRowsPerBlock;
  const int64_t c_pad = (int64_t)1 << depth;

  for (int i = tid; i < s.n_slots * KP; i += kThreads) {
    const int e = i / KP, kk = i % KP;
    int slot;
    const int64_t node = staged_node(e, ic, s, &slot);
    ws[slot * kStride + kk] = kk < k ? w[node * k + kk] : 0.f;
  }
  for (int e = tid; e < s.n_slots; e += kThreads) {
    int slot;
    const int64_t node = staged_node(e, ic, s, &slot);
    bs[slot] = b[node];
  }
  for (int i = tid; i < kRowsPerBlock * KP; i += kThreads) {
    const int r = i / KP, kk = i % KP;
    xs[i] = (r < rows && kk < k) ? x[(row0 + r) * k + kk] : 0.f;
  }
  __syncthreads();

  const int warp = tid / kWarp, lane = tid % kWarp;
  const bool leaf_lane = lane < s.groups;
  // This lane's node slots: prefix level `lane`, upper node `lane`, and the
  // 2^m nodes of each bottom level m. Unused slots point at slot 0.
  int slot[kSlots];
  slot[0] = lane < s.pre ? lane : 0;
  slot[1] = lane < s.groups - 1 ? s.pre + lane : 0;
#pragma unroll
  for (int m = 0; m < kBottomMax; ++m)
#pragma unroll
    for (int q = 0; q < (1 << m); ++q)
      slot[1 + (1 << m) + q] =
          (m < s.lb && leaf_lane)
              ? s.pre + s.groups - 1 + ((1 << m) - 1) * s.groups + q * s.groups + lane
              : 0;
  const bool prefix_right =
      lane < s.pre && ((leaf0 >> (depth - 1 - lane)) & 1);
  int src[kUpperMax];
  bool up_right[kUpperMax];
#pragma unroll
  for (int l = 0; l < kUpperMax; ++l) {
    const int g = leaf_lane ? lane : 0;
    src[l] = l < s.up ? (1 << l) - 1 + (g >> (s.up - l)) : 0;
    up_right[l] = l < s.up && ((g >> (s.up - 1 - l)) & 1);
  }
  const int n_bottom = (1 << s.lb) - 1;

  for (int r0 = warp * kRowsAtOnce; r0 < rows; r0 += kWarps * kRowsAtOnce) {
    float z[kSlots][kRowsAtOnce];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const float bias = bs[slot[i]];
#pragma unroll
      for (int r = 0; r < kRowsAtOnce; ++r) z[i][r] = bias;
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      float4 xc[kRowsAtOnce];
#pragma unroll
      for (int r = 0; r < kRowsAtOnce; ++r)
        xc[r] = *reinterpret_cast<const float4*>(xs + (r0 + r) * KP + 4 * c);
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        if (i >= 2 && i - 2 >= n_bottom) continue;
        const float4 wc =
            *reinterpret_cast<const float4*>(ws + slot[i] * kStride + 4 * c);
#pragma unroll
        for (int r = 0; r < kRowsAtOnce; ++r)
          z[i][r] += wc.x * xc[r].x + wc.y * xc[r].y + wc.z * xc[r].z +
                     wc.w * xc[r].w;
      }
    }

#pragma unroll
    for (int r = 0; r < kRowsAtOnce; ++r) {
      // Prefix: one ancestor per lane, summed over the warp.
      float t = 0.f;
      if (lane < s.pre) {
        const float zp = z[0][r];
        t = fminf(prefix_right ? zp : -zp, 0.f) - softplus_neg_abs(zp);
      }
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1)
        t += __shfl_xor_sync(0xffffffffu, t, off);
      // Upper levels: one node per lane, path terms gathered by shuffles.
      const float zu = z[1][r];
      const float spu = softplus_neg_abs(zu);
      const float left = fminf(-zu, 0.f) - spu, right = fminf(zu, 0.f) - spu;
      float v[1 << kBottomMax];
      v[0] = t;
#pragma unroll
      for (int l = 0; l < kUpperMax; ++l) {
        if (l < s.up) {
          const float lt = __shfl_sync(0xffffffffu, left, src[l]);
          const float rt = __shfl_sync(0xffffffffu, right, src[l]);
          v[0] += up_right[l] ? rt : lt;
        }
      }
      // Bottom levels: the lane's own nodes, leaf values in registers.
#pragma unroll
      for (int m = 0; m < kBottomMax; ++m) {
        if (m < s.lb) {
#pragma unroll
          for (int q = (1 << m) - 1; q >= 0; --q) {
            const int i = 1 + (1 << m) + q;
            const float zb = z[i][r];
            const float sp = softplus_neg_abs(zb);
            v[2 * q + 1] = v[q] + (fminf(zb, 0.f) - sp);
            v[2 * q] = v[q] + (fminf(-zb, 0.f) - sp);
          }
        }
      }
      const int64_t row = row0 + r0 + r;
      if (r0 + r < rows && leaf_lane) {
        float* dst = out + row * c_pad + leaf0 + ((int64_t)lane << s.lb);
        if (s.lb == kBottomMax) {
          reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
          reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
        } else {
#pragma unroll
          for (int q = 0; q < (1 << kBottomMax); ++q)
            if (q < (1 << s.lb)) dst[q] = v[q];
        }
      }
    }
  }
}

template <int KP>
int launch(const void* w, const void* b, const void* x, void* out, int64_t B,
           int depth, int k, void* stream) {
  const Shape s = make_shape(depth);
  const size_t smem =
      sizeof(float) * ((size_t)s.n_slots * node_stride(KP) +
                       ((s.n_slots + 3) & ~3) + (size_t)kRowsPerBlock * KP);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tree_logprob_kernel<KP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)(((int64_t)1 << depth) >> s.sub),
                  (unsigned)((B + kRowsPerBlock - 1) / kRowsPerBlock));
  tree_logprob_kernel<KP><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)b, (const float*)x, (float*)out, B, depth,
      k);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Takes 1 <= depth <= 30 and
// 1 <= k <= 32. Returns cudaGetLastError() after the launch (0 when it was
// accepted).
extern "C" int tree_logprob_all_f32(const void* w, const void* b,
                                    const void* x, void* out, int64_t B,
                                    int depth, int k, void* stream) {
  if (B == 0) return 0;
  if (depth < 1 || depth > 30 || k < 1 || k > kMaxK)
    return (int)cudaErrorInvalidValue;
  switch ((k + 3) / 4) {
    case 1: return launch<4>(w, b, x, out, B, depth, k, stream);
    case 2: return launch<8>(w, b, x, out, B, depth, k, stream);
    case 3: return launch<12>(w, b, x, out, B, depth, k, stream);
    case 4: return launch<16>(w, b, x, out, B, depth, k, stream);
    case 5: return launch<20>(w, b, x, out, B, depth, k, stream);
    case 6: return launch<24>(w, b, x, out, B, depth, k, stream);
    case 7: return launch<28>(w, b, x, out, B, depth, k, stream);
    default: return launch<32>(w, b, x, out, B, depth, k, stream);
  }
}

extern "C" const char* tree_logprob_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
