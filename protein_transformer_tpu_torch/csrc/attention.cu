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
// Both kernels take their products on the tensor cores: mma.sync m16n8k8 in
// TF32 with every operand split into a TF32 head and remainder, three
// products a tile (mma_tf32.cuh). The sums keep ~21 bits, fp32-grade (64-deep
// scores within ~2e-7 of the largest from float64, where one TF32 product
// misses by ~3e-4), which holds the forward's 2e-5 gate and the gradients'
// 1e-4. exp is expf (never __expf: ~2 ulp more error on every probability,
// over six layers). No atomics: the same bits on every call.
//
// The forward (K3a): 4 D operations a weighted (query, key) pair on the
// tensor cores (0.78 GFLOP at B=8, H=8, L=256, D=64 on ragged rows: 1.6 us
// at 495 TFLOP/s); what bounds it is bytes (q, k, v and O once, m and l when
// written, the mask: 16.8 MB, 5.0 us at 3.35 TB/s). The design:
//   * grid (ceil(L / 64), B * H) of 128-thread blocks, four warps; a warp
//     owns 16 of the block's 64 query rows and walks the key tiles, where
//     the TPU grid ran sequentially over key blocks.
//   * Q in registers: a warp splits its rows once into TF32 head and rest
//     fragments (left operands of S = Q K^T) and keeps them for the whole
//     key loop (D <= 64; at D = 128 Q stays in shared memory as fp32 and is
//     split as it is read, so that the accumulators fit).
//   * K and V pipelined: the next tile's raw rows are in flight (cp.async,
//     16 bytes, .cg; rows beyond L filled with zeros) while the warps take
//     this tile's products. A tile is split once as it lands, by a loop
//     unrolled so that a thread's reads are in flight together, into one
//     16-byte word per (row, k-step, lane) that holds a lane's two TF32
//     heads and two rests of a right operand: one conflict-free 128-bit
//     shared load feeds three mma.sync.
//   * P in registers: S leaves its accumulators straight into O += P V as
//     the left operand, column 2t as k = t and 2t + 1 as k = t + 4
//     (acc_as_left), and V's split follows that row order: no shared-memory
//     round trip for P, two barriers a key tile.
//   * online softmax by quad shuffles: each row's maximum is reduced over
//     its four lanes (xor 1, then 2) every tile; each lane keeps its share
//     of the row sum, rescaled by the same factor, and the four shares are
//     added in that fixed order once, at the end.
//   * key tiles without a valid key are skipped in every batch row that has
//     one (they weigh exactly 0 there, before or after the first valid
//     tile); a row with no valid key walks every tile at 1/L. The block
//     reads its batch row's mask once, into bits in shared memory (a ballot
//     a warp per 32 keys, while Q is in flight): no tile waits on the mask.
//   * shared memory: the raw K and V tiles [keys][D + 4], their split (4
//     keys D words) and L / 8 bytes of mask bits: 26, 51 and 100 KB at
//     D = 16, 32 and 64 (64 keys a tile, two blocks an SM at D = 64); 133 KB
//     at D = 128 (32 keys a tile, Q kept in shared memory).
//   * what holds it back (PERF.md, section 6): 2 x 3 mma.sync a 16 x 8
//     block of pairs, 384 a warp and key tile, which at the rate the card
//     gives mma.sync (tools/bench_mma.py) take about a third of its time at
//     (16, 8, 256, 64); at two blocks an SM (eight warps, 230 registers)
//     each warp runs a tile's split, products and softmax in series. The
//     next form takes the products as wgmma, with a warp group that loads
//     and splits beside the ones that multiply.

// The backward: one launch, two roles.
//   * grid (kv_blocks + q_blocks, B * H) of 128-thread blocks (four warps, a
//     warp owning 16 rows of 64). A dK/dV block owns 64 key rows, loops over
//     every query tile and keeps dK and dV in registers; a dQ block owns 64
//     query rows, loops over the key tiles and keeps dQ. A role that is not
//     wanted has no blocks. Each role recomputes S and dP (2 x 2D operations
//     a pair each): 14 D a pair in all, against 10 D for one pass that would
//     need dQ partials summed by a second pass. Every output element is
//     written by one block, its sums taken in a fixed order. delta is taken
//     inside, from O and dO as a tile is staged, by the same code in both
//     roles: no pre-pass, no (B, H, L) buffer.
//   * the five products (S = Q K^T, dP = dO V^T, dV = P^T dO, dK = dS^T Q,
//     dQ = dS K) are split-TF32 mma.sync, 3 x 2 operations a multiply-add on
//     the tensor cores.
//   * what bounds it: bytes, by the count (q, k, v, dO, O read once, dQ, dK,
//     dV written once, m, l and the mask: 20 us at (16, 8, 256, 64)); what
//     holds it back is the 14 D a pair times three mma.sync, fed by 32-bit
//     shared-memory loads of the right operands, at two blocks (eight warps)
//     an SM (PERF.md, section 6).
//   * a staged tile of the looped axis is split once as it lands and stored
//     as head and rest (the right operands, read by all four warps); the
//     block's own two tiles stay fp32 and are split as a warp loads its left
//     operand, once a k-step for 8 products. S and dP leave the accumulators
//     straight into the next product (acc_as_left and right_perm). Row
//     stride D + 4 = 4 mod 32 words: every fragment load of a warp hits 32
//     banks.
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
// head split is read and written in place. D is one of 16, 32, 64, 128.
//
// Each kernel has a float32 instance (above) and a bf16 instance (the
// section "the bf16 instances" below), one C entry point each.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cfloat>
#include <cstdint>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

using namespace tf32;

namespace {

constexpr int kTile = 64;  // query rows of a block; key rows of a tile

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

// Flags of the keys k0 .. k0 + 63 of batch row b.
__device__ inline unsigned char key_flag(const unsigned char* valid, int b,
                                         int length, int key) {
  if (key >= length) return kKeyOutside;
  return valid[static_cast<long long>(b) * length + key] ? kKeyValid
                                                         : kKeyMasked;
}

// ------------------------------------------------- split-TF32 operands

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

// ----------------------------------------------------------- the forward

constexpr int kFwdWarps = 4;
constexpr int kFwdThreads = 32 * kFwdWarps;

// Key rows of a staged tile, and whether a warp keeps its Q fragments in
// registers: at D = 128 they would take 128 registers beside 64 of O, so Q
// stays in shared memory and the tile is halved to fit it.
template <int D>
constexpr int kFwdKeys = D <= 64 ? kTile : kTile / 2;
template <int D>
constexpr bool kQInRegisters = D <= 64;

// In 4-byte words: the raw K and V tiles [keys][D + 4], their split (2 keys
// D words each), Q [64][D + 4] where it stays in shared memory (else staged
// once in the split space, before the first tile is split), and the batch
// row's valid-key bits, ceil(L / 32) words.
template <int D>
int fwd_smem_bytes(int length) {
  constexpr int keys = kFwdKeys<D>;
  constexpr int q_words = kQInRegisters<D> ? 0 : kTile * (D + 4);
  return (2 * keys * (D + 4) + 4 * keys * D + q_words + (length + 31) / 32)
         * 4;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool inside) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // a source size of 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(inside ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows row0 .. row0 + kRows - 1 of a strided (L, D) matrix into a tile
// [kRows][D + 4] by cp.async; rows beyond n_rows become zeros.
template <int D, int kRows>
__device__ __forceinline__ void stage_async(float* dst, const float* src,
                                            long long stride, int row0,
                                            int n_rows) {
  constexpr int kVecs = D / 4;
  for (int idx = threadIdx.x; idx < kRows * kVecs; idx += kFwdThreads) {
    const int r = idx / kVecs, c = (idx % kVecs) * 4;
    const bool inside = row0 + r < n_rows;
    cp_async16(dst + r * (D + 4) + c,
               inside ? src + (row0 + r) * stride + c : src, inside);
  }
}

// x0 and x1 split: {head x0, head x1, rest x0, rest x1}, the two registers
// of a right operand, head and rest, in one 16-byte word.
__device__ __forceinline__ uint4 split_pair(float x0, float x1) {
  uint4 w;
  split_tf32(x0, &w.x, &w.z);
  split_tf32(x1, &w.y, &w.w);
  return w;
}

// A landed tile, split. K as the right operand of S = Q K^T:
// ks[(kk keys + key) 4 + t] holds K[key][8 kk + t] and K[key][8 kk + t + 4].
// V as the right operand of O += P V, rows in acc_as_left's order:
// vs[(j D + d) 4 + t] holds V[8 j + 2 t][d] and V[8 j + 2 t + 1][d]. Row
// stride D + 4 = 4 (20 at D = 16) mod 32 words: a warp's 32 reads of either
// hit 32 banks, and its 16-byte writes are adjacent. Unrolled by four, so
// that a thread has eight reads in flight (every warp waits on the split of
// a landed tile before its products) without spilling Q's registers.
template <int D>
__device__ __forceinline__ void split_kv(uint4* ks, uint4* vs,
                                         const float* k_raw,
                                         const float* v_raw) {
  constexpr int keys = kFwdKeys<D>, S = D + 4;
  constexpr int kPerThread = keys * D / 2 / kFwdThreads;
  static_assert(keys * D / 2 % kFwdThreads == 0, "whole rounds");
#pragma unroll 4
  for (int i = 0; i < kPerThread; ++i) {
    const int idx = threadIdx.x + i * kFwdThreads;
    const int t = idx % 4;
    const int key = idx / 4 % keys, kk = idx / (4 * keys);
    const float* pk = k_raw + key * S + 8 * kk + t;
    ks[idx] = split_pair(pk[0], pk[4]);
    const int d = idx / 4 % D, j = idx / (4 * D);
    const float* pv = v_raw + (8 * j + 2 * t) * S + d;
    vs[idx] = split_pair(pv[0], pv[S]);
  }
}

// The valid-key bits of key tile `tile` from the batch row's words (bit j:
// key tile * keys + j).
template <int D>
__device__ __forceinline__ unsigned long long tile_bits(const unsigned* bits,
                                                        int tile,
                                                        int n_words) {
  constexpr int words = kFwdKeys<D> / 32;
  const int w0 = tile * words;
  unsigned long long out = bits[w0];
  if (words > 1 && w0 + 1 < n_words)
    out |= static_cast<unsigned long long>(bits[w0 + 1]) << 32;
  return out;
}

// The first key tile at or after `from` that holds a valid key of the batch
// row, or n_tiles; every tile from `from` on where the row has none. Read
// from shared memory, the same for every thread.
template <int D>
__device__ __forceinline__ int next_live_tile(int from, int n_tiles,
                                              bool row_valid,
                                              const unsigned* bits,
                                              int n_words) {
  if (!row_valid) return from;
  for (int tile = from; tile < n_tiles; ++tile)
    if (tile_bits<D>(bits, tile, n_words) != 0) return tile;
  return n_tiles;
}

// K3a. Grid (ceil(L / 64), B * H). m_out and l_out may be null.
template <int D>
__global__ void __launch_bounds__(kFwdThreads)
flash_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const unsigned char* __restrict__ valid,
                      float* __restrict__ o, float* __restrict__ m_out,
                      float* __restrict__ l_out, int n_heads, int length,
                      float scale, Strides sq, Strides sk, Strides sv,
                      Strides so) {
  constexpr int keys = kFwdKeys<D>, S = D + 4;
  constexpr int NT = keys / 8, DT = D / 8;
  constexpr bool kQRegs = kQInRegisters<D>;
  extern __shared__ __align__(16) float smem[];
  float* k_raw = smem;
  float* v_raw = k_raw + keys * S;
  uint4* ks = reinterpret_cast<uint4*>(v_raw + keys * S);
  uint4* vs = ks + keys * D / 2;
  float* q_s = kQRegs ? reinterpret_cast<float*>(ks)
                      : reinterpret_cast<float*>(vs + keys * D / 2);
  unsigned* row_bits = kQRegs
      ? reinterpret_cast<unsigned*>(vs + keys * D / 2)
      : reinterpret_cast<unsigned*>(q_s + kTile * S);

  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wrow = tid / 32 * 16;  // the warp's first row in the tile
  const int b = blockIdx.y / n_heads, h = blockIdx.y % n_heads;
  const int q0 = blockIdx.x * kTile;
  const bool rows_inside = q0 + wrow < length;
  const float* k_bh = k + b * sk.b + h * sk.h;
  const float* v_bh = v + b * sv.b + h * sv.h;
  const unsigned char* valid_b = valid + static_cast<long long>(b) * length;
  const int n_tiles = (length + keys - 1) / keys;
  const int n_words = (length + 31) / 32;

  // Q in flight while the batch row's mask becomes bits in shared memory,
  // one ballot a warp per 32 keys: no tile waits on the mask again
  stage_async<D, kTile>(q_s, q + b * sq.b + h * sq.h, sq.l, q0, length);
  bool any = false;
  for (int c = tid / 32; c < n_words; c += kFwdWarps) {
    const int key = 32 * c + lane;
    const unsigned bits =
        __ballot_sync(0xffffffffu, key < length && valid_b[key] != 0);
    if (lane == 0) row_bits[c] = bits;
    any |= bits != 0;
  }
  const bool row_valid = __syncthreads_or(any);
  int tile = next_live_tile<D>(0, n_tiles, row_valid, row_bits, n_words);
  if (tile < n_tiles) {
    stage_async<D, keys>(k_raw, k_bh, sk.l, tile * keys, length);
    stage_async<D, keys>(v_raw, v_bh, sv.l, tile * keys, length);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  SplitFrag<4> qf[kQRegs ? DT : 1];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < DT; ++kk)
      qf[kk] = left_split<S>(q_s, wrow, 8 * kk, g, t);
    __syncthreads();  // Q's space is the split tiles'
  }

  float acc[DT][4] = {};
  float m_run[2] = {-FLT_MAX, -FLT_MAX};
  float l_part[2] = {0.f, 0.f};  // this lane's share of each row's sum
  while (tile < n_tiles) {
    const int k0 = tile * keys;
    split_kv<D>(ks, vs, k_raw, v_raw);
    __syncthreads();
    const int next = next_live_tile<D>(tile + 1, n_tiles, row_valid, row_bits,
                                       n_words);
    if (next < n_tiles) {
      stage_async<D, keys>(k_raw, k_bh, sk.l, next * keys, length);
      stage_async<D, keys>(v_raw, v_bh, sv.l, next * keys, length);
    }
    cp_async_commit();

    if (rows_inside) {
      float s[NT][4] = {};
#pragma unroll
      for (int kk = 0; kk < DT; ++kk) {
        SplitFrag<4> a;
        if constexpr (kQRegs)
          a = qf[kk];
        else
          a = left_split<S>(q_s, wrow, 8 * kk, g, t);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint4 w = ks[(kk * keys + 8 * j + g) * 4 + t];
          mma_split(s[j], a, SplitFrag<2>{{w.x, w.y}, {w.z, w.w}});
        }
      }
      const unsigned long long bits = tile_bits<D>(row_bits, tile, n_words);
      const int n_inside = length - k0;  // keys of the tile inside L
      float top[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          const float x = (bits >> col) & 1ull ? s[j][e] * scale
                          : col < n_inside    ? -FLT_MAX
                                              : -CUDART_INF_F;
          s[j][e] = x;
          top[e >> 1] = fmaxf(top[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        top[i] = fmaxf(top[i], __shfl_xor_sync(0xffffffffu, top[i], 1));
        top[i] = fmaxf(top[i], __shfl_xor_sync(0xffffffffu, top[i], 2));
        const float m_new = fmaxf(m_run[i], top[i]);
        alpha[i] = expf(m_run[i] - m_new);
        m_run[i] = m_new;
        l_part[i] *= alpha[i];
      }
#pragma unroll
      for (int n = 0; n < DT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = expf(s[j][e] - m_run[e >> 1]);
          l_part[e >> 1] += p[e];
        }
        const SplitFrag<4> ap = acc_as_left(p);
#pragma unroll
        for (int n = 0; n < DT; ++n) {
          const uint4 w = vs[(j * D + 8 * n + g) * 4 + t];
          mma_split(acc[n], ap, SplitFrag<2>{{w.x, w.y}, {w.z, w.w}});
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
    tile = next;
  }

  if (!rows_inside) return;
  float l_row[2], inv_l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_part[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_row[i] = l;
    inv_l[i] = 1.0f / l;
  }
  float* o_bh = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wrow + g + 8 * i;
    if (row >= length) continue;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      *reinterpret_cast<float2*>(o_bh + row * so.l + 8 * n + 2 * t) =
          make_float2(acc[n][2 * i] * inv_l[i],
                      acc[n][2 * i + 1] * inv_l[i]);
    if (m_out != nullptr && t == 0) {
      const long long at = static_cast<long long>(blockIdx.y) * length + row;
      m_out[at] = m_run[i];
      l_out[at] = l_row[i];
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

// ------------------------------------------------------- the bf16 instances
//
// K3a and the backward on bf16 q, k, v, computing what the TPU flash kernel
// computes on bf16 inputs (jax/experimental/pallas/ops/tpu/flash_attention.py:
// S = Q K^T with fp32 accumulation :396, the scale and the online softmax in
// fp32, P = exp(s - m) cast to bf16 before P V :471, O accumulated in fp32
// and written in bf16 :477; in the backward dV = P^T dO :900, dP = dO V^T
// :909, dS = scale * P o (dP - delta) in fp32 and cast to bf16 for dK = dS^T
// Q :918 and dQ = dS K :1258, delta = sum_d dO o O in fp32 :274). m and l
// stay fp32. Every product is one mma.sync m16n8k16 with bf16 operands and
// fp32 accumulators (mma_bf16.cuh): one product where the fp32 instances
// take three split-TF32 ones, and half the bytes of shared memory and of
// the registers that hold an operand.
//
// The frame is the fp32 instances': 128-thread blocks, 16 query (or key)
// rows a warp, the masking contract and the key-tile skip, strided
// head-split views, no atomics. What differs:
//   * tiles stay bf16 in shared memory, rows of D + 8 elements (a row
//     stride of 4 mod 32 words: every 32-bit fragment load of a warp and
//     every ldmatrix phase hits 32 banks), and they are the operands as
//     they land: no split.
//   * K3a keys its tiles by 64 at every D, with two buffers: the next live
//     tile is in flight by cp.async while the warps multiply this one. Q's
//     fragments stay in registers (D / 4 of them).
//   * P (and in the backward P and dS) leave the accumulators as the left
//     operand of the next product without a permutation: two neighbouring
//     n8 tiles of S, packed to bf16 pairs, are the m16n8k16 left operand
//     over those 16 keys (bf16::acc_as_left). V (dO, Q, K as right operands
//     of P V, P^T dO, dS^T Q, dS K) is read by ldmatrix's transposing load.
//   * what bounds them: bytes, as for the fp32 instances, at half the bytes
//     of q, k, v, O and the gradients (chip_smoke.py::attention_bound).

constexpr int kBfKeys = 64;  // keys of a K3a-bf16 tile

using bf16_t = __nv_bfloat16;

// The valid-key bits of 64-key tile `tile` (bit j: key 64 tile + j).
__device__ __forceinline__ unsigned long long tile_bits64(
    const unsigned* bits, int tile, int n_words) {
  const int w0 = 2 * tile;
  unsigned long long out = bits[w0];
  if (w0 + 1 < n_words)
    out |= static_cast<unsigned long long>(bits[w0 + 1]) << 32;
  return out;
}

// next_live_tile for 64-key tiles.
__device__ __forceinline__ int next_live_tile64(int from, int n_tiles,
                                                bool row_valid,
                                                const unsigned* bits,
                                                int n_words) {
  if (!row_valid) return from;
  for (int tile = from; tile < n_tiles; ++tile)
    if (tile_bits64(bits, tile, n_words) != 0) return tile;
  return n_tiles;
}

// Rows row0 .. row0 + 63 of a strided bf16 (L, D) matrix into a tile
// [64][D + 8] by cp.async, 8 elements a copy; rows beyond n_rows become
// zeros.
template <int D>
__device__ __forceinline__ void stage_async_bf16(bf16_t* dst,
                                                 const bf16_t* src,
                                                 long long stride, int row0,
                                                 int n_rows) {
  constexpr int kVecs = D / 8;
  for (int idx = threadIdx.x; idx < kTile * kVecs; idx += kFwdThreads) {
    const int r = idx / kVecs, c = (idx % kVecs) * 8;
    const bool inside = row0 + r < n_rows;
    cp_async16(dst + r * (D + 8) + c,
               inside ? src + (row0 + r) * stride + c : src, inside);
  }
}

// In bytes: Q [64][D + 8], two buffers of K and V [64][D + 8], and the
// batch row's valid-key bits, ceil(L / 32) words.
template <int D>
int fwd_bf16_smem_bytes(int length) {
  return 5 * kTile * (D + 8) * 2 + (length + 31) / 32 * 4;
}

// K3a-bf16. Grid (ceil(L / 64), B * H). m_out and l_out may be null.
template <int D>
__global__ void __launch_bounds__(kFwdThreads)
flash_attn_fwd_bf16_kernel(const bf16_t* __restrict__ q,
                           const bf16_t* __restrict__ k,
                           const bf16_t* __restrict__ v,
                           const unsigned char* __restrict__ valid,
                           bf16_t* __restrict__ o, float* __restrict__ m_out,
                           float* __restrict__ l_out, int n_heads, int length,
                           float scale, Strides sq, Strides sk, Strides sv,
                           Strides so) {
  constexpr int S = D + 8, NT = kBfKeys / 8, KT = D / 16, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_t* q_s = reinterpret_cast<bf16_t*>(smem_raw);
  bf16_t* kv_s = q_s + kTile * S;  // [buffer][K, V][64][S]
  unsigned* row_bits = reinterpret_cast<unsigned*>(kv_s + 4 * kTile * S);

  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wrow = tid / 32 * 16;
  const int b = blockIdx.y / n_heads, h = blockIdx.y % n_heads;
  const int q0 = blockIdx.x * kTile;
  const bool rows_inside = q0 + wrow < length;
  const bf16_t* k_bh = k + b * sk.b + h * sk.h;
  const bf16_t* v_bh = v + b * sv.b + h * sv.h;
  const unsigned char* valid_b = valid + static_cast<long long>(b) * length;
  const int n_tiles = (length + kBfKeys - 1) / kBfKeys;
  const int n_words = (length + 31) / 32;

  stage_async_bf16<D>(q_s, q + b * sq.b + h * sq.h, sq.l, q0, length);
  bool any = false;
  for (int c = tid / 32; c < n_words; c += kFwdWarps) {
    const int key = 32 * c + lane;
    const unsigned bits =
        __ballot_sync(0xffffffffu, key < length && valid_b[key] != 0);
    if (lane == 0) row_bits[c] = bits;
    any |= bits != 0;
  }
  const bool row_valid = __syncthreads_or(any);
  int tile = next_live_tile64(0, n_tiles, row_valid, row_bits, n_words);
  int buf = 0;
  if (tile < n_tiles) {
    stage_async_bf16<D>(kv_s, k_bh, sk.l, tile * kBfKeys, length);
    stage_async_bf16<D>(kv_s + kTile * S, v_bh, sv.l, tile * kBfKeys,
                        length);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t qa[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) bf16::left<S>(q_s, wrow, 16 * kk, g, t,
                                                qa[kk]);

  float acc[DT][4] = {};
  float m_run[2] = {-FLT_MAX, -FLT_MAX};
  float l_part[2] = {0.f, 0.f};  // this lane's share of each row's sum
  while (tile < n_tiles) {
    const int k0 = tile * kBfKeys;
    const bf16_t* k_s = kv_s + buf * 2 * kTile * S;
    const bf16_t* v_s = k_s + kTile * S;
    const int next = next_live_tile64(tile + 1, n_tiles, row_valid, row_bits,
                                      n_words);
    if (next < n_tiles) {  // the other buffer: read by no warp since the
                           // barrier that ended the last tile
      bf16_t* nk = kv_s + (buf ^ 1) * 2 * kTile * S;
      stage_async_bf16<D>(nk, k_bh, sk.l, next * kBfKeys, length);
      stage_async_bf16<D>(nk + kTile * S, v_bh, sv.l, next * kBfKeys,
                          length);
    }
    cp_async_commit();

    if (rows_inside) {
      float s[NT][4] = {};
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t b0, b1;
          bf16::right_t<S>(k_s, 8 * j, 16 * kk, g, t, &b0, &b1);
          bf16::mma(s[j], qa[kk], b0, b1);
        }
      const unsigned long long bits = tile_bits64(row_bits, tile, n_words);
      const int n_inside = length - k0;
      float top[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          const float x = (bits >> col) & 1ull ? s[j][e] * scale
                          : col < n_inside    ? -FLT_MAX
                                              : -CUDART_INF_F;
          s[j][e] = x;
          top[e >> 1] = fmaxf(top[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        top[i] = fmaxf(top[i], __shfl_xor_sync(0xffffffffu, top[i], 1));
        top[i] = fmaxf(top[i], __shfl_xor_sync(0xffffffffu, top[i], 2));
        const float m_new = fmaxf(m_run[i], top[i]);
        alpha[i] = expf(m_run[i] - m_new);
        m_run[i] = m_new;
        l_part[i] *= alpha[i];
      }
#pragma unroll
      for (int n = 0; n < DT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        // l sums the fp32 probabilities; P V takes them rounded to bf16
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& x = s[2 * jj + half][e];
            x = expf(x - m_run[e >> 1]);
            l_part[e >> 1] += x;
          }
        uint32_t pa[4];
        bf16::acc_as_left(s[2 * jj], s[2 * jj + 1], pa);
#pragma unroll
        for (int n = 0; n < KT; ++n) {
          uint32_t vb[4];
          bf16::right_rows<S>(v_s, 16 * jj, 16 * n, lane, vb);
          bf16::mma(acc[2 * n], pa, vb[0], vb[1]);
          bf16::mma(acc[2 * n + 1], pa, vb[2], vb[3]);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
    buf ^= 1;
    tile = next;
  }

  if (!rows_inside) return;
  float l_row[2], inv_l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_part[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_row[i] = l;
    inv_l[i] = 1.0f / l;
  }
  bf16_t* o_bh = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wrow + g + 8 * i;
    if (row >= length) continue;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      *reinterpret_cast<uint32_t*>(o_bh + row * so.l + 8 * n + 2 * t) =
          bf16::pack(acc[n][2 * i] * inv_l[i], acc[n][2 * i + 1] * inv_l[i]);
    if (m_out != nullptr && t == 0) {
      const long long at = static_cast<long long>(blockIdx.y) * length + row;
      m_out[at] = m_run[i];
      l_out[at] = l_row[i];
    }
  }
}

// The backward's bf16 instance: the fp32 instance's two roles and grid.
// Shared memory: the block's own two tiles and the two staged tiles of the
// looped axis, bf16 [64][D + 8] each, m, 1 / l and delta of 64 query rows,
// and 64 key flags.
template <int D>
constexpr int bwd_bf16_smem_bytes() {
  return 4 * kTile * (D + 8) * 2 + 3 * kTile * 4 + kTile;
}

struct BwdBf16Args {
  const bf16_t* q;
  const bf16_t* k;
  const bf16_t* v;
  const unsigned char* valid;
  const bf16_t* d_o;
  const bf16_t* o;
  const float* m;
  const float* l;
  bf16_t* d_q;
  bf16_t* d_k;
  bf16_t* d_v;
  Strides sq, sk, sv, sdo, so, sdq, sdk, sdv;
  int n_heads, length;
  int kv_blocks;  // blocks 0 .. kv_blocks - 1 take the dK/dV role
  float scale;
};

// Rows row0 .. row0 + 63 of a strided bf16 (L, D) matrix into a tile
// [64][D + 8], rows beyond n_rows as zeros. With `o`, also delta[r] =
// sum_d src[r][d] o[r][d] in fp32: the D / 8 threads of a row are adjacent
// lanes and add their partials in a fixed shuffle tree, so both roles get
// delta with the same bits.
template <int D>
__device__ __forceinline__ void stage_bwd_bf16(
    bf16_t* dst, const bf16_t* src, long long stride, int row0, int n_rows,
    const bf16_t* o = nullptr, long long o_stride = 0,
    float* delta = nullptr) {
  constexpr int kVecs = D / 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int idx = threadIdx.x; idx < kTile * kVecs; idx += kBwdThreads) {
    const int r = idx / kVecs, c = (idx % kVecs) * 8;
    const bool inside = row0 + r < n_rows;
    const uint4 x = inside ? *reinterpret_cast<const uint4*>(
                                 src + (row0 + r) * stride + c)
                           : zero;
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = x;
    if (o != nullptr) {
      const uint4 y = inside ? *reinterpret_cast<const uint4*>(
                                   o + (row0 + r) * o_stride + c)
                             : zero;
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
      const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
      float part = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float2 a = bf16::unpack(xs[w]), bb = bf16::unpack(ys[w]);
        part = __fmaf_rn(a.x, bb.x, part);
        part = __fmaf_rn(a.y, bb.y, part);
      }
#pragma unroll
      for (int off = kVecs / 2; off > 0; off >>= 1)
        part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
      if (c == 0) delta[r] = part;
    }
  }
}

// m and 1 / l of query rows q0 .. q0 + 63 into shared memory; rows beyond L
// get m = 0 and 1 / l = 0, which make every probability 0.
__device__ __forceinline__ void stage_stats(const float* m, const float* l,
                                            long long bh, int length, int q0,
                                            float* m_s, float* inv_l_s) {
  const int tid = threadIdx.x;
  if (tid < kTile) {
    const bool inside = q0 + tid < length;
    const long long i = bh * length + q0 + tid;
    m_s[tid] = inside ? m[i] : 0.f;
    inv_l_s[tid] = inside ? 1.f / l[i] : 0.f;
  }
}

// The dQ role, bf16: 64 query rows of one (b, h); loops over the key tiles
// that hold a valid key.
template <int D>
__device__ __forceinline__ void bwd_bf16_dq_role(const BwdBf16Args& a,
                                                 unsigned char* smem,
                                                 int tile) {
  constexpr int S = D + 8, NT = kBwdChunk<D> / 8, KT = D / 16, DT = D / 8;
  bf16_t* q_s = reinterpret_cast<bf16_t*>(smem);
  bf16_t* do_s = q_s + kTile * S;
  bf16_t* k_s = do_s + kTile * S;
  bf16_t* v_s = k_s + kTile * S;
  float* m_s = reinterpret_cast<float*>(v_s + kTile * S);
  float* inv_l_s = m_s + kTile;
  float* delta_s = inv_l_s + kTile;
  unsigned char* flag_s = reinterpret_cast<unsigned char*>(delta_s + kTile);
  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wrow = tid / 32 * 16;
  const int bh = blockIdx.y, b = bh / a.n_heads, h = bh % a.n_heads;
  const int length = a.length, q0 = tile * kTile;
  const bf16_t* k_bh = a.k + b * a.sk.b + h * a.sk.h;
  const bf16_t* v_bh = a.v + b * a.sv.b + h * a.sv.h;

  stage_bwd_bf16<D>(q_s, a.q + b * a.sq.b + h * a.sq.h, a.sq.l, q0, length);
  stage_bwd_bf16<D>(do_s, a.d_o + b * a.sdo.b + h * a.sdo.h, a.sdo.l, q0,
                    length, a.o + b * a.so.b + h * a.so.h, a.so.l, delta_s);
  stage_stats(a.m, a.l, bh, length, q0, m_s, inv_l_s);
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
    stage_bwd_bf16<D>(k_s, k_bh, a.sk.l, k0, length);
    stage_bwd_bf16<D>(v_s, v_bh, a.sv.l, k0, length);
    __syncthreads();
#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += 8 * NT) {
      float s[NT][4] = {}, dp[NT][4] = {};
#pragma unroll 2
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t aq[4], ado[4];
        bf16::left<S>(q_s, wrow, 16 * kk, g, t, aq);
        bf16::left<S>(do_s, wrow, 16 * kk, g, t, ado);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t b0, b1;
          bf16::right_t<S>(k_s, c0 + 8 * j, 16 * kk, g, t, &b0, &b1);
          bf16::mma(s[j], aq, b0, b1);
          bf16::right_t<S>(v_s, c0 + 8 * j, 16 * kk, g, t, &b0, &b1);
          bf16::mma(dp[j], ado, b0, b1);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const unsigned char f = flag_s[c0 + 8 * j + 2 * t + (e & 1)];
          const float p = expf(masked_score(s[j][e], a.scale, f) - m_row[i])
                          * inv_l[i];
          // dS scaled before it is rounded to bf16, as the TPU kernel does
          s[j][e] = f == kKeyValid
                        ? p * (dp[j][e] - delta_row[i]) * a.scale : 0.0f;
        }
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        uint32_t a_ds[4];
        bf16::acc_as_left(s[2 * jj], s[2 * jj + 1], a_ds);
#pragma unroll
        for (int n = 0; n < KT; ++n) {
          uint32_t kb[4];
          bf16::right_rows<S>(k_s, c0 + 16 * jj, 16 * n, lane, kb);
          bf16::mma(acc[2 * n], a_ds, kb[0], kb[1]);
          bf16::mma(acc[2 * n + 1], a_ds, kb[2], kb[3]);
        }
      }
    }
    __syncthreads();
  }

  bf16_t* dq_bh = a.d_q + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wrow + g + 8 * i;
    if (row >= length) continue;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      *reinterpret_cast<uint32_t*>(dq_bh + row * a.sdq.l + 8 * n + 2 * t) =
          bf16::pack(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// The dK/dV role, bf16: 64 key rows of one (b, h), the score tile held
// transposed (rows are keys, columns queries); loops over every query tile.
template <int D>
__device__ __forceinline__ void bwd_bf16_dkv_role(const BwdBf16Args& a,
                                                  unsigned char* smem,
                                                  int tile) {
  constexpr int S = D + 8, NT = kBwdChunk<D> / 8, KT = D / 16, DT = D / 8;
  bf16_t* k_s = reinterpret_cast<bf16_t*>(smem);
  bf16_t* v_s = k_s + kTile * S;
  bf16_t* q_s = v_s + kTile * S;
  bf16_t* do_s = q_s + kTile * S;
  float* m_s = reinterpret_cast<float*>(do_s + kTile * S);
  float* inv_l_s = m_s + kTile;
  float* delta_s = inv_l_s + kTile;
  unsigned char* flag_s = reinterpret_cast<unsigned char*>(delta_s + kTile);
  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wrow = tid / 32 * 16;
  const int bh = blockIdx.y, b = bh / a.n_heads, h = bh % a.n_heads;
  const int length = a.length, k0 = tile * kTile;
  const bf16_t* q_bh = a.q + b * a.sq.b + h * a.sq.h;
  const bf16_t* do_bh = a.d_o + b * a.sdo.b + h * a.sdo.h;
  const bf16_t* o_bh = a.o + b * a.so.b + h * a.so.h;
  bf16_t* dk_bh = a.d_k + b * a.sdk.b + h * a.sdk.h;
  bf16_t* dv_bh = a.d_v + b * a.sdv.b + h * a.sdv.h;

  // as the fp32 role: a tile without a valid key, in a batch row that has
  // one, weighs nothing and its rows are zero
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
    constexpr int kVecs = D / 8;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int idx = tid; idx < kTile * kVecs; idx += kBwdThreads) {
      const int row = k0 + idx / kVecs, c = (idx % kVecs) * 8;
      if (row >= length) continue;
      *reinterpret_cast<uint4*>(dk_bh + row * a.sdk.l + c) = zero;
      *reinterpret_cast<uint4*>(dv_bh + row * a.sdv.l + c) = zero;
    }
    return;
  }
  stage_bwd_bf16<D>(k_s, a.k + b * a.sk.b + h * a.sk.h, a.sk.l, k0, length);
  stage_bwd_bf16<D>(v_s, a.v + b * a.sv.b + h * a.sv.h, a.sv.l, k0, length);
  unsigned char key_f[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) key_f[i] = flag_s[wrow + g + 8 * i];
  float acc_k[DT][4] = {}, acc_v[DT][4] = {};

  for (int q0 = 0; q0 < length; q0 += kTile) {
    stage_bwd_bf16<D>(q_s, q_bh, a.sq.l, q0, length);
    stage_bwd_bf16<D>(do_s, do_bh, a.sdo.l, q0, length, o_bh, a.so.l,
                      delta_s);
    stage_stats(a.m, a.l, bh, length, q0, m_s, inv_l_s);
    __syncthreads();
#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += 8 * NT) {
      float s[NT][4] = {}, dp[NT][4] = {};
#pragma unroll 2
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t ak[4], av[4];
        bf16::left<S>(k_s, wrow, 16 * kk, g, t, ak);
        bf16::left<S>(v_s, wrow, 16 * kk, g, t, av);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t b0, b1;
          bf16::right_t<S>(q_s, c0 + 8 * j, 16 * kk, g, t, &b0, &b1);
          bf16::mma(s[j], ak, b0, b1);
          bf16::right_t<S>(do_s, c0 + 8 * j, 16 * kk, g, t, &b0, &b1);
          bf16::mma(dp[j], av, b0, b1);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + 8 * j + 2 * t + (e & 1);
          const unsigned char f = key_f[e >> 1];
          const float p = expf(masked_score(s[j][e], a.scale, f) - m_s[col])
                          * inv_l_s[col];
          dp[j][e] = f == kKeyValid
                         ? p * (dp[j][e] - delta_s[col]) * a.scale : 0.0f;
          s[j][e] = p;
        }
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        uint32_t a_p[4], a_ds[4];
        bf16::acc_as_left(s[2 * jj], s[2 * jj + 1], a_p);
        bf16::acc_as_left(dp[2 * jj], dp[2 * jj + 1], a_ds);
#pragma unroll
        for (int n = 0; n < KT; ++n) {
          uint32_t rb[4];
          bf16::right_rows<S>(do_s, c0 + 16 * jj, 16 * n, lane, rb);
          bf16::mma(acc_v[2 * n], a_p, rb[0], rb[1]);
          bf16::mma(acc_v[2 * n + 1], a_p, rb[2], rb[3]);
          bf16::right_rows<S>(q_s, c0 + 16 * jj, 16 * n, lane, rb);
          bf16::mma(acc_k[2 * n], a_ds, rb[0], rb[1]);
          bf16::mma(acc_k[2 * n + 1], a_ds, rb[2], rb[3]);
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
      *reinterpret_cast<uint32_t*>(dv_bh + row * a.sdv.l + 8 * n + 2 * t) =
          bf16::pack(acc_v[n][2 * i], acc_v[n][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dk_bh + row * a.sdk.l + 8 * n + 2 * t) =
          bf16::pack(acc_k[n][2 * i], acc_k[n][2 * i + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_attn_bwd_bf16_kernel(const BwdBf16Args args) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  const int x = static_cast<int>(blockIdx.x);
  if (x < args.kv_blocks)
    bwd_bf16_dkv_role<D>(args, smem_bytes, x);
  else
    bwd_bf16_dq_role<D>(args, smem_bytes, x - args.kv_blocks);
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
  const int smem = fwd_smem_bytes<D>(length);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((length + kTile - 1) / kTile, batch * n_heads);
  kernel<<<grid, kFwdThreads, smem, stream>>>(
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

template <int D>
int launch_fwd_bf16(const bf16_t* q, const bf16_t* k, const bf16_t* v,
                    const unsigned char* valid, bf16_t* o, float* m_out,
                    float* l_out, int batch, int n_heads, int length,
                    float scale, const long long* st, cudaStream_t stream) {
  auto kernel = flash_attn_fwd_bf16_kernel<D>;
  const int smem = fwd_bf16_smem_bytes<D>(length);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((length + kTile - 1) / kTile, batch * n_heads);
  kernel<<<grid, kFwdThreads, smem, stream>>>(
      q, k, v, valid, o, m_out, l_out, n_heads, length, scale,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd_bf16(const BwdBf16Args& args, int batch, int q_blocks,
                    cudaStream_t stream) {
  auto kernel = flash_attn_bwd_bf16_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bwd_bf16_smem_bytes<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(args.kv_blocks + q_blocks, batch * args.n_heads);
  kernel<<<grid, kBwdThreads, bwd_bf16_smem_bytes<D>(), stream>>>(args);
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

// Every tensor is float32 (bf16 for the _bf16 functions; m, l stay float32)
// of shape (B, H, L, D) with adjacent elements along D, 16-byte aligned
// rows, and strides in elements for batch, head and row:
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

// The bf16 instances: arguments as flash_attn_fwd and flash_attn_bwd, with
// q, k, v, dO, O and the outputs bf16 (m and l float32).
int flash_attn_fwd_bf16(const void* q, const void* k, const void* v,
                        const unsigned char* valid, void* o, float* m_out,
                        float* l_out, int batch, int n_heads, int length,
                        int head_dim, float scale, const long long* strides,
                        void* stream) {
  if (bad_shape(batch, n_heads, length, head_dim)
      || (m_out == nullptr) != (l_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  ATTENTION_DISPATCH(head_dim, launch_fwd_bf16,
                     static_cast<const bf16_t*>(q),
                     static_cast<const bf16_t*>(k),
                     static_cast<const bf16_t*>(v), valid,
                     static_cast<bf16_t*>(o), m_out, l_out, batch, n_heads,
                     length, scale, strides,
                     static_cast<cudaStream_t>(stream))
}

int flash_attn_bwd_bf16(const void* q, const void* k, const void* v,
                        const unsigned char* valid, const void* d_o,
                        const void* o, const float* m, const float* l,
                        void* d_q, void* d_k, void* d_v, int batch,
                        int n_heads, int length, int head_dim, float scale,
                        const long long* strides, void* stream) {
  if (bad_shape(batch, n_heads, length, head_dim)
      || (d_k == nullptr) != (d_v == nullptr)
      || (d_q == nullptr && d_k == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (length + kTile - 1) / kTile;
  const BwdBf16Args args{
      static_cast<const bf16_t*>(q), static_cast<const bf16_t*>(k),
      static_cast<const bf16_t*>(v), valid,
      static_cast<const bf16_t*>(d_o), static_cast<const bf16_t*>(o), m, l,
      static_cast<bf16_t*>(d_q), static_cast<bf16_t*>(d_k),
      static_cast<bf16_t*>(d_v), strides_at(strides, 0),
      strides_at(strides, 1), strides_at(strides, 2), strides_at(strides, 3),
      strides_at(strides, 4), strides_at(strides, 5), strides_at(strides, 6),
      strides_at(strides, 7), n_heads, length,
      d_k != nullptr ? n_tiles : 0, scale};
  ATTENTION_DISPATCH(head_dim, launch_bwd_bf16, args, batch,
                     d_q != nullptr ? n_tiles : 0,
                     static_cast<cudaStream_t>(stream))
}

}  // extern "C"
