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
// Two kernels; the wrapper's launch_plan picks one and this entry checks it.
//
// Tensor-core kernel (depth >= 8). A block owns a range of 16-leaf
// sub-blocks of one 256-leaf block and up to 16 groups of 16 query rows; it
// stages the weights of their nodes and of the ancestors above them in
// shared memory once (cp.async, all copies in flight), split into TF32 hi +
// lo parts once for all its rows. A warp takes (row group, sub-block) pairs.
// The node logits of 16 rows and 8 nodes are one m16n8k8 tile on mma.sync
// with three products (hi.hi + hi.lo + lo.hi), which keeps float32 accuracy
// (a plain TF32 product would not keep the tolerance over 18 levels); the k
// index is permuted so that a lane's share of a node row and of an x row is
// contiguous. The nodes go into tiles so
// that the accumulator layout lands every term where it is used:
//   - a sub-block's tile A holds its 8 lowest nodes and tile B its 4 nodes
//     above them (columns 0, 2, 4, 6) and, twice each, the 2 above those
//     (columns 1, 3 and 5, 7): lane t of a quad then holds every node on the
//     paths of leaves 4t..4t+3 for two rows and writes them as one 16-byte
//     streaming store a row, with no shuffle;
//   - the 31 nodes of the block's top 5 levels and the ancestors above the
//     block (the prefix) are 4 + ceil(prefix / 8) tiles, computed once a row
//     group; their terms go through a small table in shared memory into a
//     per-(row, 8-leaf unit) base value.
// One log_sigmoid a node and row: log_sigmoid(-z) = min(-z, 0) -
// log(1 + exp(-|z|)) with the fast intrinsics (about 1e-7 absolute a term),
// and log_sigmoid(z) = log_sigmoid(-z) + z. Stores stream out (st.global.cs)
// while the next pairs compute; two blocks an SM overlap one's staging with
// the other's math. At B = 256 its instructions, more than the output's
// bytes, bound it (PERF.md, scripts/kernel_variants.py). Padding nodes carry b = -PAD_LOGIT = -30, and
// padding leaves come out finite. k is padded with zeros to a multiple of 8.
//
// FMA kernel (depth < 8, or when asked for): a block owns one aligned leaf
// block of up to 256 leaves and up to 256 query rows. It stages the weights
// of the block's subtree nodes and of its ancestors above (the prefix) in
// shared memory once, then never synchronises again. Each warp takes 4 rows
// at a time, and each lane owns 8 neighbouring leaves:
//   - the 3 lowest levels of the leaf block (7 nodes) are the lane's own, and
//     its 8 leaf values grow from the lane's path sum in registers;
//   - the 5 levels above (31 nodes) are one node per lane; each lane adds the
//     terms on its path from the owning lanes with warp shuffles;
//   - the prefix ancestors are one per lane, summed with a warp reduction.
// Each node's weights are read from shared memory once for 4 rows (nodes are
// placed so that a warp's 32 reads hit distinct banks). A row's 1 KB of
// output is written by one warp with 16-byte stores. Trees of fewer than
// 256 leaves use fewer lanes and levels; k is padded with zeros to a
// multiple of 4, up to 32.
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
int launch_fma(const void* w, const void* b, const void* x, void* out, int64_t B,
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

// ---------------------------------------------------------------------------
// Tensor-core kernel.
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kLeafBits = 8;        // a leaf block: 256 leaves, local levels 0..7
constexpr int kSubBlocks = 16;      // 16-leaf sub-blocks of a leaf block
constexpr int kUnits = 32;          // 8-leaf units: their paths end at local level 4
constexpr int kUpperTiles = 4;      // local levels 0..4: 31 nodes and a pad column
constexpr int kRows = 16;           // rows of an m16n8k8 tile: one row group
constexpr int kMaxRowGroups = 16;
constexpr int kTermLd = 20;         // row stride of a warp's term table (no bank conflicts)
// A warp's scratch: the upper tiles' left terms and logits ([node][row],
// 32 nodes), the prefix sums of its 16 rows, and the base table ([unit][row]).
constexpr int kScratch = 2 * 32 * kTermLd + kRows + kUnits * kRows;

// Floats between two staged nodes: a lane reads 2*KS floats at t * 2*KS of
// node g, so 8 (or, for 8-byte reads, 16) lanes cover distinct banks.
__host__ __device__ constexpr int node_ld(int ks) { return ks == 4 ? 36 : 8 * ks; }

// Staged weights as TF32 hi and lo parts, [tile][8][node_ld] each, then the
// biases [tile][8], then each warp's scratch.
__host__ __device__ constexpr size_t smem_floats(int ks, int n_tiles) {
  return (size_t)n_tiles * 8 * (2 * node_ld(ks) + 1) + (size_t)kWarps * kScratch;
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// d += a b: a 16x8 tf32 (row), b 8x8 tf32 (col), d 16x8 float32.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// log_sigmoid(-z); log_sigmoid(z) is this plus z.
__device__ __forceinline__ float left_term(float z) {
  return fminf(-z, 0.f) - softplus_neg_abs(z);
}

struct Task {
  int depth, pre, n_prefix_tiles;
  int64_t ic, leaf0;  // leaf block, its first leaf
  int sb0;            // the block's first sub-block
};

// The tree node in column c of staged tile T (-1: a pad column). Tiles:
// prefix tiles (ancestors above the leaf block, by level), 4 upper tiles
// (local nodes 0..30 in level order), then tiles A and B of each sub-block.
__device__ __forceinline__ int64_t tile_node(int T, int c, const Task& s) {
  int level, q;                     // local level and position in it
  if (T < s.n_prefix_tiles) {
    const int p = T * 8 + c;
    if (p >= s.pre) return -1;
    return ((int64_t)1 << p) - 1 + (s.leaf0 >> (s.depth - p));
  }
  T -= s.n_prefix_tiles;
  if (T < kUpperTiles) {
    const int j = T * 8 + c;
    if (j >= 31) return -1;
    level = 31 - __clz(j + 1);
    q = j - ((1 << level) - 1);
  } else {
    T -= kUpperTiles;
    const int sb = s.sb0 + (T >> 1);
    if ((T & 1) == 0) {             // tile A: the sub-block's 8 nodes at level 7
      level = 7, q = 8 * sb + c;
    } else if ((c & 1) == 0) {      // tile B, even columns: its 4 nodes at level 6
      level = 6, q = 4 * sb + c / 2;
    } else {                        // tile B, odd columns: its 2 nodes at level 5
      level = 5, q = 2 * sb + (c >> 2);
    }
  }
  return ((int64_t)1 << (s.pre + level)) - 1 + (s.ic << level) + q;
}

// One tile's logits: c = bias + x (16 rows) . w (8 nodes), 3xTF32: the
// hi.hi products and the two cross products in separate chains.
template <int KS>
__device__ __forceinline__ void tile_logits(float (&c)[4], const float* wh_s, const float* wl_s,
                                            const float* bs, int T, const uint32_t (&xh)[KS][4],
                                            const uint32_t (&xl)[KS][4], int g, int t) {
  constexpr int LD = node_ld(KS);
  const int off = (T * 8 + g) * LD + t * 2 * KS;
  uint32_t wh[2 * KS], wl[2 * KS];
  if constexpr (KS % 2 == 0) {
#pragma unroll
    for (int i = 0; i < KS / 2; ++i) {
      const uint4 h = reinterpret_cast<const uint4*>(wh_s + off)[i];
      const uint4 l = reinterpret_cast<const uint4*>(wl_s + off)[i];
      wh[4 * i] = h.x; wh[4 * i + 1] = h.y; wh[4 * i + 2] = h.z; wh[4 * i + 3] = h.w;
      wl[4 * i] = l.x; wl[4 * i + 1] = l.y; wl[4 * i + 2] = l.z; wl[4 * i + 3] = l.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const uint2 h = reinterpret_cast<const uint2*>(wh_s + off)[i];
      const uint2 l = reinterpret_cast<const uint2*>(wl_s + off)[i];
      wh[2 * i] = h.x; wh[2 * i + 1] = h.y;
      wl[2 * i] = l.x; wl[2 * i + 1] = l.y;
    }
  }
  const float2 bias = *reinterpret_cast<const float2*>(bs + T * 8 + 2 * t);
  float cross[4] = {0.f, 0.f, 0.f, 0.f};
  c[0] = bias.x; c[1] = bias.y; c[2] = bias.x; c[3] = bias.y;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    mma(cross, xl[s], wh[2 * s], wh[2 * s + 1]);
    mma(cross, xh[s], wl[2 * s], wl[2 * s + 1]);
    mma(c, xh[s], wh[2 * s], wh[2 * s + 1]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += cross[i];
}

// grid = (leaf blocks * 16 / sub_blocks, ceil(B / (16 * row_groups))),
// block = kThreads. Shared memory: the staged tiles' weights
// [tile][8][node_ld], their biases [tile][8], each warp's scratch.
template <int KS>
__global__ void __launch_bounds__(kThreads, 2)
tree_logprob_tc_kernel(const float* __restrict__ w, const float* __restrict__ b,
                       const float* __restrict__ x, float* __restrict__ out,
                       int64_t B, int depth, int k, int row_groups, int sub_log2,
                       int vec) {
  constexpr int LD = node_ld(KS);
  const int sub_blocks = 1 << sub_log2;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int per_block = kSubBlocks / sub_blocks;
  Task s;
  s.depth = depth;
  s.pre = depth - kLeafBits;
  s.n_prefix_tiles = (s.pre + 7) / 8;
  s.ic = blockIdx.x / per_block;
  s.leaf0 = s.ic << kLeafBits;
  s.sb0 = (int)(blockIdx.x % per_block) * sub_blocks;
  const int n_tiles = s.n_prefix_tiles + kUpperTiles + 2 * sub_blocks;
  float* ws = smem;                         // the hi parts (staged as float32 first)
  float* wl_s = ws + (size_t)n_tiles * 8 * LD;
  float* bs = wl_s + (size_t)n_tiles * 8 * LD;
  float* scratch = bs + n_tiles * 8 + warp * kScratch;
  float* left_s = scratch;                  // [node][kTermLd]
  float* z_s = scratch + 32 * kTermLd;      // [node][kTermLd]
  float* pre_s = scratch + 2 * 32 * kTermLd;
  float* base_s = pre_s + kRows;            // [unit][row]
  const int64_t c_pad = (int64_t)1 << depth;

  // Stage the tiles with cp.async, every copy in flight at once (16 bytes
  // where w's rows are 16-byte aligned); pads are zeros.
  if (vec) {
    for (int i = tid; i < n_tiles * 8 * 2 * KS; i += kThreads) {
      const int slot = i / (2 * KS), kk = 4 * (i % (2 * KS));
      const int64_t node = tile_node(slot >> 3, slot & 7, s);
      float* dst = ws + slot * LD + kk;
      if (node >= 0 && kk < k)
        cp_async16(dst, w + node * k + kk);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = tid; i < n_tiles * 8 * 8 * KS; i += kThreads) {
      const int slot = i / (8 * KS), kk = i % (8 * KS);
      const int64_t node = tile_node(slot >> 3, slot & 7, s);
      float* dst = ws + slot * LD + kk;
      if (node >= 0 && kk < k)
        cp_async4(dst, w + node * k + kk);
      else
        *dst = 0.f;
    }
  }
  for (int slot = tid; slot < n_tiles * 8; slot += kThreads) {
    const int64_t node = tile_node(slot >> 3, slot & 7, s);
    if (node >= 0)
      cp_async4(bs + slot, b + node);
    else
      bs[slot] = 0.f;
  }

  const int64_t rg0 = (int64_t)blockIdx.y * row_groups;
  const int64_t groups = (B + kRows - 1) / kRows;
  const int n_groups = (int)min((int64_t)row_groups, groups - rg0);
  const int pairs = n_groups * sub_blocks;
  const int p_begin = warp * pairs / kWarps, p_end = (warp + 1) * pairs / kWarps;
  // A row group's x, split into TF32 hi + lo: kstep s, slots t and t + 4
  // hold k = 2*KS*t + 2s and 2*KS*t + 2s + 1.
  uint32_t xh[KS][4], xl[KS][4];
  int x_rg = -1;
  auto load_x = [&](int rg) {
    x_rg = rg;
    const int64_t row_g = (rg0 + rg) * kRows + g, row_g8 = row_g + 8;
#pragma unroll
    for (int j = 0; j < 2 * KS; ++j) {
      const int kk = 2 * KS * t + j;
      const float a = (row_g < B && kk < k) ? x[row_g * k + kk] : 0.f;
      const float a8 = (row_g8 < B && kk < k) ? x[row_g8 * k + kk] : 0.f;
      const uint32_t ah = to_tf32(a), a8h = to_tf32(a8);
      const int r = (j & 1) * 2;            // a0/a1 for slot t, a2/a3 for slot t + 4
      xh[j >> 1][r] = ah;
      xh[j >> 1][r + 1] = a8h;
      xl[j >> 1][r] = to_tf32(a - __uint_as_float(ah));
      xl[j >> 1][r + 1] = to_tf32(a8 - __uint_as_float(a8h));
    }
  };
  if (p_begin < p_end) load_x(p_begin >> sub_log2);   // in flight with the tiles
  cp_async_wait_all();
  __syncthreads();
  // Split every staged weight into TF32 hi + lo once, for all row groups.
  for (int i = tid; i < n_tiles * 8 * LD; i += kThreads) {
    const float v = ws[i];
    const uint32_t h = to_tf32(v);
    ws[i] = __uint_as_float(h);
    wl_s[i] = __uint_as_float(to_tf32(v - __uint_as_float(h)));
  }
  __syncthreads();

  int cur = -1;
  for (int p = p_begin; p < p_end; ++p) {
    const int rg = p >> sub_log2, sbl = p & (sub_blocks - 1);
    const int64_t row_g = (rg0 + rg) * kRows + g, row_g8 = row_g + 8;
    if (rg != cur) {
      cur = rg;
      if (rg != x_rg) load_x(rg);
      // Prefix: each term with its known turn, summed over the quad.
      float pre_g = 0.f, pre_g8 = 0.f;
      for (int T = 0; T < s.n_prefix_tiles; ++T) {
        float c[4];
        tile_logits<KS>(c, ws, wl_s, bs, T, xh, xl, g, t);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int lvl = T * 8 + 2 * t + h;
          if (lvl < s.pre) {
            const bool right = (s.leaf0 >> (depth - 1 - lvl)) & 1;
            pre_g += left_term(c[h]) + (right ? c[h] : 0.f);
            pre_g8 += left_term(c[2 + h]) + (right ? c[2 + h] : 0.f);
          }
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        pre_g += __shfl_xor_sync(0xffffffffu, pre_g, o);
        pre_g8 += __shfl_xor_sync(0xffffffffu, pre_g8, o);
      }
      // Upper 5 levels: left terms and logits into the warp's table.
      __syncwarp();                 // the previous group's base reads are done
#pragma unroll
      for (int T = 0; T < kUpperTiles; ++T) {
        float c[4];
        tile_logits<KS>(c, ws, wl_s, bs, s.n_prefix_tiles + T, xh, xl, g, t);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = T * 8 + 2 * t + h;
          left_s[j * kTermLd + g] = left_term(c[h]);
          left_s[j * kTermLd + g + 8] = left_term(c[2 + h]);
          z_s[j * kTermLd + g] = c[h];
          z_s[j * kTermLd + g + 8] = c[2 + h];
        }
      }
      if (t == 0) {
        pre_s[g] = pre_g;
        pre_s[g + 8] = pre_g8;
      }
      __syncwarp();
      // Base of (unit u, row r): the prefix sum plus the 5 upper terms on
      // the unit's path; entry e = u * 16 + r.
#pragma unroll 4
      for (int e = lane; e < kUnits * kRows; e += kWarp) {
        const int u = e >> 4, r = e & 15;
        float v = pre_s[r];
#pragma unroll
        for (int l = 0; l < 5; ++l) {
          const int j = (1 << l) - 1 + (u >> (5 - l));
          v += left_s[j * kTermLd + r] + (((u >> (4 - l)) & 1) ? z_s[j * kTermLd + r] : 0.f);
        }
        base_s[e] = v;
      }
      __syncwarp();
    }
    // Sub-block sb: lane t's leaves 4t..4t+3 for rows g and g + 8.
    const int sb = s.sb0 + sbl;
    float ca[4], cb[4];
    tile_logits<KS>(ca, ws, wl_s, bs, s.n_prefix_tiles + kUpperTiles + 2 * sbl, xh, xl, g, t);
    tile_logits<KS>(cb, ws, wl_s, bs, s.n_prefix_tiles + kUpperTiles + 2 * sbl + 1, xh, xl, g, t);
    const int u = 2 * sb + (t >> 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = h ? row_g8 : row_g;
      const float z5 = cb[2 * h + 1], z6 = cb[2 * h], za = ca[2 * h], zb = ca[2 * h + 1];
      const float v5 = base_s[u * kRows + g + 8 * h] + left_term(z5) + ((t & 1) ? z5 : 0.f);
      const float v6l = v5 + left_term(z6), v6r = v6l + z6;
      const float la = v6l + left_term(za), lb = v6r + left_term(zb);
      if (row < B)
        __stcs(reinterpret_cast<float4*>(out + row * c_pad + s.leaf0 + 16 * sb + 4 * t),
               make_float4(la, la + za, lb, lb + zb));
    }
  }
}

template <int KS>
int launch(const void* w, const void* b, const void* x, void* out, int64_t B, int depth,
           int k, int row_groups, int sub_blocks, void* stream) {
  const int n_tiles = ((depth - kLeafBits) + 7) / 8 + kUpperTiles + 2 * sub_blocks;
  const size_t smem = sizeof(float) * smem_floats(KS, n_tiles);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tree_logprob_tc_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t chunks = (B + kRows * row_groups - 1) / (kRows * row_groups);
  const dim3 grid((unsigned)((((int64_t)1 << depth) >> kLeafBits) * (kSubBlocks / sub_blocks)),
                  (unsigned)chunks);
  const int vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  tree_logprob_tc_kernel<KS><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)b, (const float*)x, (float*)out, B, depth, k,
      row_groups, 31 - __builtin_clz(sub_blocks), vec);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// Plain C entry point, loaded with ctypes. Takes 1 <= depth <= 30 and
// 1 <= k <= 32. kernel 1 is the tensor-core kernel (depth >= 8, 1 <=
// row_groups <= 16, sub_blocks a power of two up to 16, at most 65,535 row
// chunks), kernel 0 the FMA kernel (row_groups and sub_blocks unused).
// Returns cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int tree_logprob_all_f32(const void* w, const void* b, const void* x, void* out,
                                    int64_t B, int depth, int k, int kernel,
                                    int row_groups, int sub_blocks, void* stream) {
  if (B == 0) return 0;
  if (depth < 1 || depth > 30 || k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  if (kernel == 1) {
    const bool pow2 = sub_blocks >= 1 && sub_blocks <= tc::kSubBlocks &&
                      (sub_blocks & (sub_blocks - 1)) == 0;
    if (depth < tc::kLeafBits || row_groups < 1 || row_groups > tc::kMaxRowGroups || !pow2 ||
        (B + 16 * row_groups - 1) / (16 * row_groups) > 65535)
      return (int)cudaErrorInvalidValue;
    switch ((k + 7) / 8) {
      case 1: return tc::launch<1>(w, b, x, out, B, depth, k, row_groups, sub_blocks, stream);
      case 2: return tc::launch<2>(w, b, x, out, B, depth, k, row_groups, sub_blocks, stream);
      case 3: return tc::launch<3>(w, b, x, out, B, depth, k, row_groups, sub_blocks, stream);
      default: return tc::launch<4>(w, b, x, out, B, depth, k, row_groups, sub_blocks, stream);
    }
  }
  if (kernel != 0 || (B + kRowsPerBlock - 1) / kRowsPerBlock > 65535)
    return (int)cudaErrorInvalidValue;
  switch ((k + 3) / 4) {
    case 1: return launch_fma<4>(w, b, x, out, B, depth, k, stream);
    case 2: return launch_fma<8>(w, b, x, out, B, depth, k, stream);
    case 3: return launch_fma<12>(w, b, x, out, B, depth, k, stream);
    case 4: return launch_fma<16>(w, b, x, out, B, depth, k, stream);
    case 5: return launch_fma<20>(w, b, x, out, B, depth, k, stream);
    case 6: return launch_fma<24>(w, b, x, out, B, depth, k, stream);
    case 7: return launch_fma<28>(w, b, x, out, B, depth, k, stream);
    default: return launch_fma<32>(w, b, x, out, B, depth, k, stream);
  }
}

extern "C" const char* tree_logprob_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
