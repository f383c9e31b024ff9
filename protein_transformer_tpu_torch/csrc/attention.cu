// Flash self-attention over a key-padding mask: the forward (K3a) and the
// backward (dQ, dK and dV in one launch).
//
// Replaces the TPU flash kernels that
// protein_transformer_tpu/ops/attention.py::flash_self_attention reaches in
// jax/experimental/pallas/ops/tpu/flash_attention.py
// (_flash_attention_kernel; _flash_attention_dkv_kernel and
// _flash_attention_dq_kernel together). What it computes, per batch row b
// and head h, with s_ij = scale * q_i . k_j:
//
//     key j valid:   score s_ij
//     key j masked:  score -FLT_MAX (the largest negative fp32 value, finite)
//     P = softmax over all L keys,   O = P V.
//
// That is the materialised masked softmax of models/transformer.py on every
// row: a masked key weighs exp(-FLT_MAX - max) = 0 wherever the row has a
// valid key; pad query rows attend to the valid keys like any other row; and
// a batch row with no valid key at all gets uniform weights 1/L, finite
// outputs and finite gradients. Nothing of the TPU kernel's blocking is
// kept: no padding of L to 128, no segment ids, no block-size table. The
// kernel takes L as it is and the (B, L) mask directly; a key beyond L scores
// -inf and weighs exactly 0 (the running maximum is finite from the first
// tile on, since every tile holds at least one key inside L).
//
// The probabilities never reach device memory. The forward keeps a running
// maximum m and a running sum l per query row and can write both, (B, H, L)
// each; the backward recomputes P = exp(s - m) / l tile by tile. m and l are
// kept apart, not folded into one logsumexp: for a row with no valid key
// m = -FLT_MAX swallows log(l), and exp(s - lse) would be 1, not 1/L. The
// gradient is that of the masked softmax: dS = P o (dP - delta) on valid
// keys and 0 on masked ones (a constant score passes no gradient), dP = dO
// V^T, delta_i = sum_d dO[i][d] O[i][d], dV = P^T dO, dK = scale * dS^T Q,
// dQ = scale * dS K.
//
// The forward (K3a): fp32 FMAs on the CUDA cores, 4 L^2 D operations a (b, h)
// (1.07 GFLOP at B=8, H=8, L=256, D=64: 16 us at 67 TFLOP/s, 5 us by bytes).
// exp is expf (never __expf: ~2 ulp more error on every probability, over
// six layers).
//   * one block of 256 threads (16 x 16) owns 64 query rows of one (b, h)
//     and loops over 64-row key tiles, where the TPU grid ran sequentially
//     over key blocks; no atomics, the same bits on every call.
//   * tiles sit row-major in shared memory with a row stride of D + 4
//     floats. For C[r][c] = A[r] . B[c] thread (ty, tx) holds rows 4 ty ..
//     4 ty + 3 and the strided columns tx, tx + 16, tx + 32, tx + 48: the A
//     rows are broadcasts within a half-warp, the B rows of neighbouring
//     threads D + 4 floats apart, so their 16-byte loads fall in distinct
//     banks: 8 vector loads for 64 FMAs.
//   * the 64 x 64 tile of P goes through shared memory once (stride 68) for
//     O += P V; row maxima and sums are reduced over the 16 threads of a row
//     group by shuffles, in a fixed tree.
//
// The backward: one launch, two roles, products on the tensor cores.
//   * grid (kv_blocks + q_blocks, B * H) of 128-thread blocks (four warps, a
//     warp owning 16 rows of 64). A dK/dV block owns 64 key rows, loops over
//     every query tile and keeps dK and dV in registers; a dQ block owns 64
//     query rows, loops over the key tiles and keeps dQ. A role that is not
//     wanted has no blocks. Each role recomputes S and dP (2 x 2D operations
//     a pair each): 14 D a pair in all, against 10 D for one pass that would
//     need dQ partials summed by a second pass. Every output element is
//     written by one block, its sums taken in a fixed order: no atomics, the
//     same bits on every call. delta is taken inside, from O and dO as a tile
//     is staged, by the same code in both roles: no pre-pass, no (B, H, L)
//     buffer.
//   * the five products (S = Q K^T, dP = dO V^T, dV = P^T dO, dK = dS^T Q,
//     dQ = dS K) are mma.sync m16n8k8 in TF32 with every operand split into a
//     TF32 head and remainder, three products a tile (mma_tf32.cuh): the
//     sums keep ~21 bits, fp32-grade (64-deep scores within ~2e-7 of the
//     largest from float64, where one TF32 product misses by ~3e-4), which
//     holds the gradients' 1e-4 gate. That is 3 x 2 operations a
//     multiply-add on the tensor cores where an FMA was 2 on the CUDA cores
//     (67 TFLOP/s). K3a keeps its FMAs: it is 4 D a pair, already ahead of
//     the library's forward, and its 2e-5 gate is the model's.
//   * what bounds it: bytes, by the count (q, k, v, dO, O read once, dQ, dK,
//     dV written once, m, l and the mask: 20 us at (16, 8, 256, 64)); what
//     holds it back is the 14 D a pair times three mma.sync, fed by 32-bit
//     shared-memory loads of the right operands, at two blocks (eight warps)
//     an SM (PERF.md, section 6).
//   * a staged tile of the looped axis is split once as it lands and stored
//     as head and rest (the right operands, read by all four warps); the
//     block's own two tiles stay fp32 and are split as a warp loads its left
//     operand, once a k-step for 8 products. S and dP leave the accumulators
//     straight into the next product: their 8 columns are the contraction,
//     so column 2t is taken as k = t and 2t + 1 as k = t + 4, which is the
//     register mma.sync reads, and the right operand's rows follow that order
//     (no shared-memory round trip for P or dS). Row stride D + 4 = 4 mod 32
//     words: every fragment load of a warp hits 32 banks.
//   * key tiles without a valid key are skipped. A dQ block skips them in
//     every batch row (dS is zero on masked keys). A dK/dV block whose tile
//     has none, in a row that has a valid key, writes zeros to its rows (the
//     outputs are torch.empty) and returns; in a row with no valid key every
//     key weighs 1/L, so the block walks every query tile and dV is the mean
//     of dO. Query tiles are never skipped: a pad query row attends like any
//     other.
//   * shared memory: 6 tiles [64][D + 4] of 4-byte words and 64 rows of
//     statistics: 31, 55, 103 and 199 KB at D = 16, 32, 64 and 128 (two
//     blocks an SM at D = 64). At D = 128 a pass covers 32 rows of the
//     staged tile, so that the dK/dV role's accumulators stay in registers.
//
// q, k, v, o and the gradients are addressed by strides (batch, head, row;
// elements of a row adjacent), so the (B, L, H, D) memory of the model's
// head split is read and written in place. D is one of 16, 32, 64, 128; the
// forward's shared memory is 70 KB at D=64 and 119 KB at D=128.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cfloat>
#include <cstdint>

#include "mma_tf32.cuh"

using namespace tf32;

namespace {

constexpr int kTile = 64;             // query rows and key rows per tile
constexpr int kGroup = 16;            // threads per row group
constexpr int kThreads = kGroup * kGroup;
constexpr int kRows = kTile / kGroup;  // rows (and strided columns) a thread
constexpr int kPStride = kTile + 4;   // row stride of the forward's P tile

constexpr unsigned char kKeyMasked = 0;
constexpr unsigned char kKeyValid = 1;
constexpr unsigned char kKeyOutside = 2;  // beyond L: weighs exactly 0

// Strides of a (B, H, L, D) tensor in elements; the D elements are adjacent.
struct Strides {
  long long b, h, l;
};

// The score of key flag f from the raw dot product.
__device__ inline float masked_score(float dot, float scale, unsigned char f) {
  if (f == kKeyValid) return dot * scale;
  return f == kKeyMasked ? -FLT_MAX : -CUDART_INF_F;
}

__device__ inline float group_max(float v) {
#pragma unroll
  for (int o = kGroup / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ inline float group_sum(float v) {
#pragma unroll
  for (int o = kGroup / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows row0 .. row0 + 63 of a (L, D) matrix with row stride `stride` into a
// shared tile [64][D + 4]; rows beyond n_rows become zeros.
template <int D>
__device__ inline void load_tile(float* dst, const float* src,
                                 long long stride, int row0, int n_rows,
                                 int tid) {
  constexpr int kVecs = D / 4;
  for (int idx = tid; idx < kTile * kVecs; idx += kThreads) {
    const int r = idx / kVecs, c = (idx % kVecs) * 4;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const float4*>(src + (row0 + r) * stride + c);
    *reinterpret_cast<float4*>(dst + r * (D + 4) + c) = val;
  }
}

// acc[i][j] = A[4 ty + i] . B[tx + 16 j] over the D columns of two shared
// tiles [64][D + 4].
template <int D>
__device__ inline void tile_dot(const float* a_tile, const float* b_tile,
                                int ty, int tx, float (&acc)[kRows][kRows]) {
  constexpr int DP = D + 4;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kRows; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[kRows], b[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      a[i] = *reinterpret_cast<const float4*>(a_tile + (ty * kRows + i) * DP
                                              + d);
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      b[j] = *reinterpret_cast<const float4*>(b_tile + (tx + kGroup * j) * DP
                                              + d);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
  }
}

// The columns of a D-wide row that thread tx holds: D / 16 of them, in
// chunks of kVec = min(D / 16, 4) adjacent ones; chunk m starts at
// m * 16 * kVec + tx * kVec.
template <int D>
struct Cols {
  static constexpr int kCount = D / kGroup;
  static constexpr int kVec = kCount < 4 ? kCount : 4;
  static constexpr int kChunks = kCount / kVec;
  __device__ static inline int start(int chunk, int tx) {
    return chunk * kGroup * kVec + tx * kVec;
  }
};

template <int V>
__device__ inline void load_vec(const float* p, float* out) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x, out[1] = t.y, out[2] = t.z, out[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x, out[1] = t.y;
  } else {
    out[0] = p[0];
  }
}

template <int V>
__device__ inline void store_vec(float* p, const float* in) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
  } else {
    p[0] = in[0];
  }
}

// out[i][c] += sum_j P[4 ty + i][j] * V[j][col c of thread tx], over the 64
// rows j of the shared tiles P [64][68] and V [64][D + 4].
template <int D>
__device__ inline void tile_accum(const float* p_tile, const float* v_tile,
                                  int ty, int tx,
                                  float (&out)[kRows][D / kGroup]) {
  using C = Cols<D>;
  constexpr int DP = D + 4;
  for (int j = 0; j < kTile; j += 4) {
    float p[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      load_vec<4>(p_tile + (ty * kRows + i) * kPStride + j, p[i]);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float v[C::kCount];
#pragma unroll
      for (int m = 0; m < C::kChunks; ++m)
        load_vec<C::kVec>(v_tile + (j + jj) * DP + C::start(m, tx),
                          v + m * C::kVec);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < C::kCount; ++c)
          out[i][c] = fmaf(p[i][jj], v[c], out[i][c]);
    }
  }
}

// Rows 4 ty + i of a thread's register tile, times `factor`, to the rows
// row0 + 4 ty + i < n_rows of a strided (L, D) matrix.
template <int D>
__device__ inline void store_rows(float* dst, long long stride, int row0,
                                  int n_rows, int ty, int tx,
                                  const float (&acc)[kRows][D / kGroup],
                                  const float (&factor)[kRows]) {
  using C = Cols<D>;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = row0 + ty * kRows + i;
    if (row >= n_rows) continue;
    float scaled[C::kCount];
#pragma unroll
    for (int c = 0; c < C::kCount; ++c) scaled[c] = acc[i][c] * factor[i];
#pragma unroll
    for (int m = 0; m < C::kChunks; ++m)
      store_vec<C::kVec>(dst + row * stride + C::start(m, tx),
                         scaled + m * C::kVec);
  }
}

// Flags of the keys k0 .. k0 + 63 of batch row b.
__device__ inline unsigned char key_flag(const unsigned char* valid, int b,
                                         int length, int key) {
  if (key >= length) return kKeyOutside;
  return valid[static_cast<long long>(b) * length + key] ? kKeyValid
                                                         : kKeyMasked;
}

template <int D>
constexpr int fwd_smem_bytes() {
  return (3 * kTile * (D + 4) + kTile * kPStride) * 4 + kTile;
}
// K3a. Grid (ceil(L / 64), B * H). m_out and l_out may be null.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const unsigned char* __restrict__ valid,
                      float* __restrict__ o, float* __restrict__ m_out,
                      float* __restrict__ l_out, int n_heads, int length,
                      float scale, Strides sq, Strides sk, Strides sv,
                      Strides so) {
  extern __shared__ __align__(16) float smem[];
  constexpr int DP = D + 4;
  constexpr int DC = D / kGroup;
  float* q_s = smem;
  float* k_s = q_s + kTile * DP;
  float* v_s = k_s + kTile * DP;
  float* p_s = v_s + kTile * DP;
  unsigned char* flag_s = reinterpret_cast<unsigned char*>(p_s
                                                           + kTile * kPStride);
  const int tid = threadIdx.x, ty = tid / kGroup, tx = tid % kGroup;
  const int b = blockIdx.y / n_heads, h = blockIdx.y % n_heads;
  const int q0 = blockIdx.x * kTile;
  const float* q_bh = q + b * sq.b + h * sq.h;
  const float* k_bh = k + b * sk.b + h * sk.h;
  const float* v_bh = v + b * sv.b + h * sv.h;

  load_tile<D>(q_s, q_bh, sq.l, q0, length, tid);
  float acc[kRows][DC];
  float m_run[kRows], l_run[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_run[i] = -FLT_MAX;
    l_run[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = 0; k0 < length; k0 += kTile) {
    load_tile<D>(k_s, k_bh, sk.l, k0, length, tid);
    load_tile<D>(v_s, v_bh, sv.l, k0, length, tid);
    if (tid < kTile) flag_s[tid] = key_flag(valid, b, length, k0 + tid);
    __syncthreads();

    float s[kRows][kRows];
    tile_dot<D>(q_s, k_s, ty, tx, s);
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const unsigned char f = flag_s[tx + kGroup * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i) s[i][j] = masked_score(s[i][j], scale, f);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float top = s[i][0];
#pragma unroll
      for (int j = 1; j < kRows; ++j) top = fmaxf(top, s[i][j]);
      const float m_new = fmaxf(m_run[i], group_max(top));
      const float alpha = expf(m_run[i] - m_new);
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float p = expf(s[i][j] - m_new);
        row_sum += p;
        p_s[(ty * kRows + i) * kPStride + tx + kGroup * j] = p;
      }
      l_run[i] = l_run[i] * alpha + group_sum(row_sum);
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    tile_accum<D>(p_s, v_s, ty, tx, acc);
    __syncthreads();
  }

  float inv_l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) inv_l[i] = 1.0f / l_run[i];
  store_rows<D>(o + b * so.b + h * so.h, so.l, q0, length, ty, tx, acc, inv_l);
  if (m_out != nullptr && tx == 0) {
    const long long row0 = static_cast<long long>(blockIdx.y) * length;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty * kRows + i;
      if (row < length) {
        m_out[row0 + row] = m_run[i];
        l_out[row0 + row] = l_run[i];
      }
    }
  }
}

// ---------------------------------------------------------- the backward

// Four warps a block; a warp owns 16 rows of the block's 64.
constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = 32 * kBwdWarps;

// Rows of the staged tile that one pass covers: all 64 up to D = 64, 32 at
// D = 128, so that the dK/dV role's four accumulators stay in registers.
template <int D>
constexpr int kBwdChunk = D <= 64 ? kTile : kTile / 2;

// Two fp32 tiles [64][D + 4] (the block's own rows), the TF32 head and rest
// of two staged tiles [64][D + 4], m, 1 / l and delta of 64 query rows, and
// 64 key flags.
template <int D>
constexpr int bwd_smem_bytes() {
  return (6 * kTile * (D + 4) + 3 * kTile) * 4 + kTile;
}

struct BwdArgs {
  const float* q;
  const float* k;
  const float* v;
  const unsigned char* valid;
  const float* d_o;
  const float* o;
  const float* m;
  const float* l;
  float* d_q;
  float* d_k;
  float* d_v;
  Strides sq, sk, sv, sdo, so, sdq, sdk, sdv;
  int n_heads, length;
  int kv_blocks;  // blocks 0 .. kv_blocks - 1 take the dK/dV role
  float scale;
};

// Rows row0 .. row0 + 63 of a strided (L, D) matrix into a tile [64][D + 4],
// rows beyond n_rows as zeros: fp32 into `dst`, or split into `head` and
// `rest` (kSplit). With `o`, also delta[r] = sum_d src[r][d] o[r][d]: the
// D / 4 threads of a row are adjacent lanes and add their partials in a
// fixed shuffle tree, so both roles get delta with the same bits.
template <int D, bool kSplit>
__device__ __forceinline__ void stage_bwd_tile(
    float* dst, uint32_t* head, uint32_t* rest, const float* src,
    long long stride, int row0, int n_rows, const float* o = nullptr,
    long long o_stride = 0, float* delta = nullptr) {
  constexpr int kVecs = D / 4;
  constexpr int S = D + 4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int idx = threadIdx.x; idx < kTile * kVecs; idx += kBwdThreads) {
    const int r = idx / kVecs, c = (idx % kVecs) * 4;
    const bool inside = row0 + r < n_rows;
    const float4 x = inside ? *reinterpret_cast<const float4*>(
                                  src + (row0 + r) * stride + c)
                            : zero;
    if constexpr (kSplit) {
      uint4 hd, rs;
      split_tf32(x.x, &hd.x, &rs.x);
      split_tf32(x.y, &hd.y, &rs.y);
      split_tf32(x.z, &hd.z, &rs.z);
      split_tf32(x.w, &hd.w, &rs.w);
      *reinterpret_cast<uint4*>(head + r * S + c) = hd;
      *reinterpret_cast<uint4*>(rest + r * S + c) = rs;
    } else {
      *reinterpret_cast<float4*>(dst + r * S + c) = x;
    }
    if (o != nullptr) {
      const float4 y = inside ? *reinterpret_cast<const float4*>(
                                    o + (row0 + r) * o_stride + c)
                              : zero;
      float part = __fmul_rn(x.x, y.x);
      part = __fmaf_rn(x.y, y.y, part);
      part = __fmaf_rn(x.z, y.z, part);
      part = __fmaf_rn(x.w, y.w, part);
#pragma unroll
      for (int off = kVecs / 2; off > 0; off >>= 1)
        part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
      if (c == 0) delta[r] = part;
    }
  }
}

// The left operand (16 x 8 at row0, col0) of an fp32 tile [64][S], split.
template <int S>
__device__ __forceinline__ SplitFrag<4> left_split(const float* tile,
                                                   int row0, int col0, int g,
                                                   int t) {
  const float* p = tile + (row0 + g) * S + col0 + t;
  SplitFrag<4> a;
  split_tf32(p[0], &a.head[0], &a.rest[0]);
  split_tf32(p[8 * S], &a.head[1], &a.rest[1]);
  split_tf32(p[4], &a.head[2], &a.rest[2]);
  split_tf32(p[8 * S + 4], &a.head[3], &a.rest[3]);
  return a;
}

// The right operand of A B^T from a staged tile [64][S] that holds B's
// columns as rows: (k, n) = (t, g) and (t + 4, g) at tile row n0 + g, column
// k0 + t. With S = D + 4 = 4 mod 32, a warp's 32 loads hit 32 banks.
template <int S>
__device__ __forceinline__ SplitFrag<2> right_t(const uint32_t* head,
                                                const uint32_t* rest, int n0,
                                                int k0, int g, int t) {
  const int i = (n0 + g) * S + k0 + t;
  return {{head[i], head[i + 4]}, {rest[i], rest[i + 4]}};
}

// The right operand of A B from a staged tile [64][S] that holds B's rows,
// in the column order of acc_as_left: k = t is tile row k0 + 2t, k = t + 4
// is row k0 + 2t + 1 (banks 8t + g: again all 32).
template <int S>
__device__ __forceinline__ SplitFrag<2> right_perm(const uint32_t* head,
                                                   const uint32_t* rest,
                                                   int k0, int n0, int g,
                                                   int t) {
  const int i = (k0 + 2 * t) * S + n0 + g;
  return {{head[i], head[i + S]}, {rest[i], rest[i + S]}};
}

// An accumulator tile (16 x 8; a thread holds (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1)) as the left operand of the next product,
// split. The contraction runs over its 8 columns, so their order is free:
// column 2t becomes k = t and column 2t + 1 becomes k = t + 4, which puts
// every value in the register of its own thread that mma.sync reads.
__device__ __forceinline__ SplitFrag<4> acc_as_left(const float (&c)[4]) {
  SplitFrag<4> a;
  split_tf32(c[0], &a.head[0], &a.rest[0]);
  split_tf32(c[2], &a.head[1], &a.rest[1]);
  split_tf32(c[1], &a.head[2], &a.rest[2]);
  split_tf32(c[3], &a.head[3], &a.rest[3]);
  return a;
}

// The dQ role: 64 query rows of one (b, h); loops over the key tiles that
// hold a valid key (a tile without one adds nothing: dS is zero on masked
// keys, in every batch row).
template <int D>
__device__ __forceinline__ void bwd_dq_role(const BwdArgs& a, float* smem,
                                            int tile) {
  constexpr int S = D + 4, NT = kBwdChunk<D> / 8, DT = D / 8;
  float* q_s = smem;
  float* do_s = q_s + kTile * S;
  uint32_t* k_head = reinterpret_cast<uint32_t*>(do_s + kTile * S);
  uint32_t* k_rest = k_head + kTile * S;
  uint32_t* v_head = k_rest + kTile * S;
  uint32_t* v_rest = v_head + kTile * S;
  float* m_s = reinterpret_cast<float*>(v_rest + kTile * S);
  float* inv_l_s = m_s + kTile;
  float* delta_s = inv_l_s + kTile;
  unsigned char* flag_s = reinterpret_cast<unsigned char*>(delta_s + kTile);
  const int tid = threadIdx.x, g = tid % 32 / 4, t = tid % 4;
  const int wrow = tid / 32 * 16;  // the warp's first row in the tile
  const int bh = blockIdx.y, b = bh / a.n_heads, h = bh % a.n_heads;
  const int length = a.length, q0 = tile * kTile;
  const float* k_bh = a.k + b * a.sk.b + h * a.sk.h;
  const float* v_bh = a.v + b * a.sv.b + h * a.sv.h;

  stage_bwd_tile<D, false>(q_s, nullptr, nullptr,
                           a.q + b * a.sq.b + h * a.sq.h, a.sq.l, q0, length);
  stage_bwd_tile<D, false>(do_s, nullptr, nullptr,
                           a.d_o + b * a.sdo.b + h * a.sdo.h, a.sdo.l, q0,
                           length, a.o + b * a.so.b + h * a.so.h, a.so.l,
                           delta_s);
  if (tid < kTile) {
    // rows beyond L: m = 0 and 1 / l = 0 make every probability 0
    const bool inside = q0 + tid < length;
    const long long i = static_cast<long long>(bh) * length + q0 + tid;
    m_s[tid] = inside ? a.m[i] : 0.f;
    inv_l_s[tid] = inside ? 1.f / a.l[i] : 0.f;
  }
  __syncthreads();
  float m_row[2], inv_l[2], delta_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wrow + g + 8 * i;
    m_row[i] = m_s[r];
    inv_l[i] = inv_l_s[r];
    delta_row[i] = delta_s[r];
  }
  float acc[DT][4] = {};

  for (int k0 = 0; k0 < length; k0 += kTile) {
    unsigned char flag = kKeyOutside;
    if (tid < kTile) {
      flag = key_flag(a.valid, b, length, k0 + tid);
      flag_s[tid] = flag;
    }
    if (!__syncthreads_or(flag == kKeyValid)) continue;
    stage_bwd_tile<D, true>(nullptr, k_head, k_rest, k_bh, a.sk.l, k0,
                            length);
    stage_bwd_tile<D, true>(nullptr, v_head, v_rest, v_bh, a.sv.l, k0,
                            length);
    __syncthreads();
#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += 8 * NT) {
      float s[NT][4] = {}, dp[NT][4] = {};
#pragma unroll 2
      for (int kk = 0; kk < D; kk += 8) {
        const SplitFrag<4> aq = left_split<S>(q_s, wrow, kk, g, t);
        const SplitFrag<4> ado = left_split<S>(do_s, wrow, kk, g, t);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mma_split(s[j], aq,
                    right_t<S>(k_head, k_rest, c0 + 8 * j, kk, g, t));
          mma_split(dp[j], ado,
                    right_t<S>(v_head, v_rest, c0 + 8 * j, kk, g, t));
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const unsigned char f = flag_s[c0 + 8 * j + 2 * t + (e & 1)];
          const float p = expf(masked_score(s[j][e], a.scale, f) - m_row[i])
                          * inv_l[i];
          ds[e] = f == kKeyValid ? p * (dp[j][e] - delta_row[i]) : 0.0f;
        }
        const SplitFrag<4> a_ds = acc_as_left(ds);
#pragma unroll
        for (int n = 0; n < DT; ++n)
          mma_split(acc[n], a_ds,
                    right_perm<S>(k_head, k_rest, c0 + 8 * j, 8 * n, g, t));
      }
    }
    __syncthreads();
  }

  float* dq_bh = a.d_q + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wrow + g + 8 * i;
    if (row >= length) continue;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      *reinterpret_cast<float2*>(dq_bh + row * a.sdq.l + 8 * n + 2 * t) =
          make_float2(acc[n][2 * i] * a.scale, acc[n][2 * i + 1] * a.scale);
  }
}

// The dK/dV role: 64 key rows of one (b, h), the score tile held
// transposed (rows are keys, columns queries); loops over every query tile.
template <int D>
__device__ __forceinline__ void bwd_dkv_role(const BwdArgs& a, float* smem,
                                             int tile) {
  constexpr int S = D + 4, NT = kBwdChunk<D> / 8, DT = D / 8;
  float* k_s = smem;
  float* v_s = k_s + kTile * S;
  uint32_t* q_head = reinterpret_cast<uint32_t*>(v_s + kTile * S);
  uint32_t* q_rest = q_head + kTile * S;
  uint32_t* do_head = q_rest + kTile * S;
  uint32_t* do_rest = do_head + kTile * S;
  float* m_s = reinterpret_cast<float*>(do_rest + kTile * S);
  float* inv_l_s = m_s + kTile;
  float* delta_s = inv_l_s + kTile;
  unsigned char* flag_s = reinterpret_cast<unsigned char*>(delta_s + kTile);
  const int tid = threadIdx.x, g = tid % 32 / 4, t = tid % 4;
  const int wrow = tid / 32 * 16;
  const int bh = blockIdx.y, b = bh / a.n_heads, h = bh % a.n_heads;
  const int length = a.length, k0 = tile * kTile;
  const float* q_bh = a.q + b * a.sq.b + h * a.sq.h;
  const float* do_bh = a.d_o + b * a.sdo.b + h * a.sdo.h;
  const float* o_bh = a.o + b * a.so.b + h * a.so.h;
  float* dk_bh = a.d_k + b * a.sdk.b + h * a.sdk.h;
  float* dv_bh = a.d_v + b * a.sdv.b + h * a.sdv.h;

  // Where the batch row has a valid key and this tile none, no key of the
  // tile weighs anything: its dK and dV rows are zero. A row with no valid
  // key at all weighs every key 1/L and walks on.
  bool row_valid = false;
  for (int j = tid; j < length; j += kBwdThreads)
    row_valid |= a.valid[static_cast<long long>(b) * length + j] != 0;
  unsigned char flag = kKeyOutside;
  if (tid < kTile) {
    flag = key_flag(a.valid, b, length, k0 + tid);
    flag_s[tid] = flag;
  }
  const bool tile_valid = __syncthreads_or(flag == kKeyValid);
  if (__syncthreads_or(row_valid) && !tile_valid) {
    constexpr int kVecs = D / 4;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int idx = tid; idx < kTile * kVecs; idx += kBwdThreads) {
      const int row = k0 + idx / kVecs, c = (idx % kVecs) * 4;
      if (row >= length) continue;
      *reinterpret_cast<float4*>(dk_bh + row * a.sdk.l + c) = zero;
      *reinterpret_cast<float4*>(dv_bh + row * a.sdv.l + c) = zero;
    }
    return;
  }
  stage_bwd_tile<D, false>(k_s, nullptr, nullptr,
                           a.k + b * a.sk.b + h * a.sk.h, a.sk.l, k0, length);
  stage_bwd_tile<D, false>(v_s, nullptr, nullptr,
                           a.v + b * a.sv.b + h * a.sv.h, a.sv.l, k0, length);
  unsigned char key_f[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) key_f[i] = flag_s[wrow + g + 8 * i];
  float acc_k[DT][4] = {}, acc_v[DT][4] = {};

  for (int q0 = 0; q0 < length; q0 += kTile) {
    stage_bwd_tile<D, true>(nullptr, q_head, q_rest, q_bh, a.sq.l, q0,
                            length);
    stage_bwd_tile<D, true>(nullptr, do_head, do_rest, do_bh, a.sdo.l, q0,
                            length, o_bh, a.so.l, delta_s);
    if (tid < kTile) {
      // queries beyond L: m = 0 and 1 / l = 0 make every probability 0
      const bool inside = q0 + tid < length;
      const long long i = static_cast<long long>(bh) * length + q0 + tid;
      m_s[tid] = inside ? a.m[i] : 0.f;
      inv_l_s[tid] = inside ? 1.f / a.l[i] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += 8 * NT) {
      float s[NT][4] = {}, dp[NT][4] = {};
#pragma unroll 2
      for (int kk = 0; kk < D; kk += 8) {
        const SplitFrag<4> ak = left_split<S>(k_s, wrow, kk, g, t);
        const SplitFrag<4> av = left_split<S>(v_s, wrow, kk, g, t);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mma_split(s[j], ak,
                    right_t<S>(q_head, q_rest, c0 + 8 * j, kk, g, t));
          mma_split(dp[j], av,
                    right_t<S>(do_head, do_rest, c0 + 8 * j, kk, g, t));
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + 8 * j + 2 * t + (e & 1);
          const unsigned char f = key_f[e >> 1];
          p[e] = expf(masked_score(s[j][e], a.scale, f) - m_s[col])
                 * inv_l_s[col];
          ds[e] = f == kKeyValid ? p[e] * (dp[j][e] - delta_s[col]) : 0.0f;
        }
        const SplitFrag<4> a_p = acc_as_left(p);
        const SplitFrag<4> a_ds = acc_as_left(ds);
#pragma unroll
        for (int n = 0; n < DT; ++n) {
          mma_split(acc_v[n], a_p,
                    right_perm<S>(do_head, do_rest, c0 + 8 * j, 8 * n, g, t));
          mma_split(acc_k[n], a_ds,
                    right_perm<S>(q_head, q_rest, c0 + 8 * j, 8 * n, g, t));
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + wrow + g + 8 * i;
    if (row >= length) continue;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      *reinterpret_cast<float2*>(dv_bh + row * a.sdv.l + 8 * n + 2 * t) =
          make_float2(acc_v[n][2 * i], acc_v[n][2 * i + 1]);
      *reinterpret_cast<float2*>(dk_bh + row * a.sdk.l + 8 * n + 2 * t) =
          make_float2(acc_k[n][2 * i] * a.scale,
                      acc_k[n][2 * i + 1] * a.scale);
    }
  }
}

// The backward. Grid (kv_blocks + q_blocks, B * H): blocks below kv_blocks
// take the dK/dV role of key tile blockIdx.x, the others the dQ role of query
// tile blockIdx.x - kv_blocks. A role that is not wanted has no blocks.
template <int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_attn_bwd_kernel(const BwdArgs args) {
  extern __shared__ __align__(16) float smem[];
  const int x = static_cast<int>(blockIdx.x);
  if (x < args.kv_blocks)
    bwd_dkv_role<D>(args, smem, x);
  else
    bwd_dq_role<D>(args, smem, x - args.kv_blocks);
}

inline Strides strides_at(const long long* st, int tensor) {
  return Strides{st[3 * tensor], st[3 * tensor + 1], st[3 * tensor + 2]};
}

inline bool bad_shape(int batch, int n_heads, int length, int head_dim) {
  return batch <= 0 || n_heads <= 0 || length <= 0
         || static_cast<long long>(batch) * n_heads > 65535
         || (head_dim != 16 && head_dim != 32 && head_dim != 64
             && head_dim != 128);
}

template <int D>
int launch_fwd(const float* q, const float* k, const float* v,
               const unsigned char* valid, float* o, float* m_out,
               float* l_out, int batch, int n_heads, int length, float scale,
               const long long* st, cudaStream_t stream) {
  auto kernel = flash_attn_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, fwd_smem_bytes<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((length + kTile - 1) / kTile, batch * n_heads);
  kernel<<<grid, kThreads, fwd_smem_bytes<D>(), stream>>>(
      q, k, v, valid, o, m_out, l_out, n_heads, length, scale,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd(const BwdArgs& args, int batch, int q_blocks,
               cudaStream_t stream) {
  auto kernel = flash_attn_bwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bwd_smem_bytes<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(args.kv_blocks + q_blocks, batch * args.n_heads);
  kernel<<<grid, kBwdThreads, bwd_smem_bytes<D>(), stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Calls `launch<D>(args...)` for the head dimension given at run time.
#define ATTENTION_DISPATCH(head_dim, launch, ...)   \
  switch (head_dim) {                               \
    case 16: return launch<16>(__VA_ARGS__);        \
    case 32: return launch<32>(__VA_ARGS__);        \
    case 64: return launch<64>(__VA_ARGS__);        \
    default: return launch<128>(__VA_ARGS__);       \
  }

extern "C" {

const char* attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Every tensor is float32 of shape (B, H, L, D) with adjacent elements along
// D, 16-byte aligned rows, and strides in elements for batch, head and row:
// `strides` is a host array of three per tensor, in the order given at each
// function. valid is (B, L), one byte per key (0 masked, else valid),
// contiguous; m, l and delta are (B, H, L), contiguous. D is 16, 32, 64 or
// 128 and B * H at most 65535, else cudaErrorInvalidValue. Each function
// launches on `stream` and returns the CUDA error code (0 on success).

// K3a. strides: q, k, v, o. m_out and l_out (running maximum and sum of
// every query row) are written when both are non-null.
int flash_attn_fwd(const float* q, const float* k, const float* v,
                   const unsigned char* valid, float* o, float* m_out,
                   float* l_out, int batch, int n_heads, int length,
                   int head_dim, float scale, const long long* strides,
                   void* stream) {
  if (bad_shape(batch, n_heads, length, head_dim)
      || (m_out == nullptr) != (l_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  ATTENTION_DISPATCH(head_dim, launch_fwd, q, k, v, valid, o, m_out, l_out,
                     batch, n_heads, length, scale, strides,
                     static_cast<cudaStream_t>(stream))
}

// The backward, one launch: dQ when d_q is non-null, dK and dV when both are
// non-null (one of the two alone, or no output at all, is refused), from the
// forward's O and row statistics m and l. strides: q, k, v, dO, O, dQ, dK,
// dV (any values for an output not asked for).
int flash_attn_bwd(const float* q, const float* k, const float* v,
                   const unsigned char* valid, const float* d_o,
                   const float* o, const float* m, const float* l,
                   float* d_q, float* d_k, float* d_v, int batch, int n_heads,
                   int length, int head_dim, float scale,
                   const long long* strides, void* stream) {
  if (bad_shape(batch, n_heads, length, head_dim)
      || (d_k == nullptr) != (d_v == nullptr)
      || (d_q == nullptr && d_k == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (length + kTile - 1) / kTile;
  const BwdArgs args{q, k, v, valid, d_o, o, m, l, d_q, d_k, d_v,
                     strides_at(strides, 0), strides_at(strides, 1),
                     strides_at(strides, 2), strides_at(strides, 3),
                     strides_at(strides, 4), strides_at(strides, 5),
                     strides_at(strides, 6), strides_at(strides, 7),
                     n_heads, length, d_k != nullptr ? n_tiles : 0, scale};
  ATTENTION_DISPATCH(head_dim, launch_bwd, args, batch,
                     d_q != nullptr ? n_tiles : 0,
                     static_cast<cudaStream_t>(stream))
}

}  // extern "C"
