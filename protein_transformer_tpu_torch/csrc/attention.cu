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

#include "mma_tf32.cuh"
#include "wgmma_bf16.cuh"

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
// K3a and the backward on bf16 q, k, v: the TPU flash kernels of
// jax/experimental/pallas/ops/tpu/flash_attention.py (:331 the forward;
// :796 dK, dV and :1146 dQ, the backward), which
// protein_transformer_tpu/ops/attention.py:63 reaches with bf16 inputs.
// They compute what those compute: S = Q K^T with fp32 accumulation :396,
// the scale and the online softmax in fp32, P = exp(s - m) cast to bf16
// before P V :471, O accumulated in fp32 and written in bf16 :477; in the
// backward dV = P^T dO :900, dP = dO V^T :909, dS = scale * P o (dP -
// delta) in fp32, cast to bf16 for dK = dS^T Q :918 and dQ = dS K :1258,
// delta = sum_d dO o O in fp32 :274. m and l stay fp32. The masking
// contract, the key-tile skip, the strided head-split views and the fixed
// summation order (no atomics, the same bits on every call) are the fp32
// instances'.
//
// What bounds them: bytes (chip_smoke.py::attention_bound, two bytes an
// element, products at 989 TFLOP/s). K3a-bf16 at (8, 8, 256, 64) moves
// 8.39 MB, 2.50 us at 3.35 TB/s (products 1.09 us); the backward at
// (16, 8, 256, 64) 33.8 MB, 10.1 us.
//
// The design (wgmma_bf16.cuh): one warpgroup a block, 64 rows, every
// product one chain of wgmma.mma_async m64nNk16 issued by the four warps
// together, fp32 accumulators in registers.
//   * Tiles in shared memory are what the descriptors name: swizzled bf16
//     rows, 128-byte swizzle at D = 64 and at D = 128 (two column halves),
//     64-byte at D = 32, 32-byte at D = 16. Every D the wrapper takes goes
//     through this one body. A staged tile serves both ways: K-major as an
//     operand of S = Q K^T (or S^T = K Q^T, dP, dP^T), MN-major, through
//     the descriptor, as the B of O += P V, dV += P^T dO, dK += dS^T Q and
//     dQ += dS K.
//   * A of the score products comes from shared memory; P and dS leave the
//     S and dP accumulators rounded to bf16 in place as the A fragments of
//     the next product (two neighbouring n8 blocks are one k16 step), no
//     shared-memory round trip.
//   * tiles land by TMA: one thread asks for each box of a tensor map (made
//     on the host at each launch, one per strided head-split view, with the
//     tile's swizzle; cuTensorMapEncodeTiled is found through the runtime,
//     no driver library is linked), and the copies complete on an mbarrier
//     of their ring stage. The looped axis is double-buffered: the next key
//     tile (K3a, the dQ role) or query tile (the dK/dV role) is in flight
//     while this one's products run. Rows beyond L land as zeros. m and l
//     come by cp.async, 4 bytes a row (a row of L floats need not be 16-byte
//     aligned). Staging the tiles by cp.async instead, 16 bytes a thread,
//     spent the threads' issue slots and registers on addresses, and was
//     the slower form of this kernel.
//   * the batch row's mask is read once, as ballot bits, by every block.
//   * the backward's two roles and grid are the fp32 instance's. A dK/dV
//     block owns 64 keys, lands K and V once and walks every query tile
//     (64 queries, 32 at D = 128) with its dO, O, m and l; of each tile it
//     takes 1 / l and delta = sum_d dO o O once (two threads a row, a fixed
//     order: both roles get the same bits), while the previous tile's dK
//     chain runs, and dS while the dV chain runs: one barrier a tile.
//     delta is recomputed by every dK/dV block of a (b, h): O read
//     kv_blocks times, 4 x 4.19 MB of (mostly L2) reads at (16, 8, 256, 64)
//     beside the bound's 33.8 MB; a pre-pass launch would cost a
//     host-bound step more than that. A dQ block lands Q, dO and O once and
//     walks the key tiles that hold a valid key.
//   * shared memory, the backward: 69 KB at D = 64 (three blocks an SM),
//     86 KB at D = 128 (two); K3a: 42 KB at D = 64, 83 KB at D = 128.
//   * registers (ptxas, chip_smoke.py phase 2): the backward 168 at D = 64,
//     held to three blocks an SM without a spill, 205 at D = 128 (two
//     blocks); the dK/dV role's dK and dV (D floats a thread) beside S^T
//     and dP^T (64 floats; 32 at D = 128) set the count. K3a-bf16 107 at
//     D = 64.
//   * what holds them back (PERF.md, section 6): a block runs its tiles in
//     series, products, then the softmax's exp and the masking on the CUDA
//     cores, then the next products, with 12 warps an SM to cover the
//     waits; the backward's roles recompute S and dP (14 D operations a
//     pair against 10), and every dK/dV block reads Q, dO and O again.

using bf16_t = __nv_bfloat16;

constexpr int kBfKeys = 64;  // keys of a K3a-bf16 tile

// Rows of a looped tile of the backward: 64, 32 at D = 128 (two D-wide
// accumulators and two score tiles a thread then fit 255 registers).
template <int D>
constexpr int kBwdLoop = D <= 64 ? 64 : 32;

// Blocks an SM the backward is built for: three at D <= 64 (<= 168
// registers a thread), two at D = 128.
template <int D>
constexpr int kBwdBf16Blocks = D <= 64 ? 3 : 2;

// The first 1024-byte boundary at or after p: the swizzle atoms' phase.
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  return p + ((1024 - (a & 1023)) & 1023);
}

// The valid-key bits of key tile `tile` of kt keys (64 or 32; bit j: key
// kt tile + j).
template <int kt>
__device__ __forceinline__ unsigned long long tile_bits_of(
    const unsigned* bits, int tile, int n_words) {
  if (kt == 32) return bits[tile];
  const int w0 = 2 * tile;
  unsigned long long out = bits[w0];
  if (w0 + 1 < n_words)
    out |= static_cast<unsigned long long>(bits[w0 + 1]) << 32;
  return out;
}

// The first tile of kt keys at or after `from` that holds a valid key, or
// n_tiles; `from` itself when the row has no valid key (every tile counts).
template <int kt>
__device__ __forceinline__ int next_live_tile_of(int from, int n_tiles,
                                                 bool row_valid,
                                                 const unsigned* bits,
                                                 int n_words) {
  if (!row_valid) return from;
  for (int tile = from; tile < n_tiles; ++tile)
    if (tile_bits_of<kt>(bits, tile, n_words) != 0) return tile;
  return n_tiles;
}

// The batch row's valid-key bits into shared memory (bit j of word c: key
// 32 c + j), one ballot a warp per 32 keys. Returns, to every thread,
// whether the row has a valid key; ends with a barrier.
__device__ __forceinline__ bool load_row_bits(const unsigned char* valid_b,
                                              int length, unsigned* bits) {
  const int lane = threadIdx.x % 32;
  bool any = false;
  for (int c = threadIdx.x / 32; c < (length + 31) / 32; c += kFwdWarps) {
    const int key = 32 * c + lane;
    const unsigned w =
        __ballot_sync(0xffffffffu, key < length && valid_b[key] != 0);
    if (lane == 0) bits[c] = w;
    any |= w != 0;
  }
  return __syncthreads_or(any);
}

// Rows row0 .. row0 + rows - 1 of the (b, h) slice of a tensor map's (B,
// H, L, D) view into a tile (wgmma_bf16.cuh's layout) by TMA, boxes of
// `box` rows and min(D, 64) values, completing on bar; rows beyond L land as
// zeros. One thread; `bar` expects rows D 2 bytes for it.
template <int D>
__device__ __forceinline__ void tma_tile(bf16_t* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row0, int rows,
                                         int box, int h, int b) {
  constexpr int RB = wg::kRowBytes<D>, halves = D > 64 ? D / 64 : 1;
  unsigned char* base = reinterpret_cast<unsigned char*>(dst);
  for (int half = 0; half < halves; ++half)
    for (int r = 0; r < rows; r += box)
      wg::tma_load(base + (half * rows + r) * RB, map, bar, 64 * half,
                   row0 + r, h, b);
}

// m and l of rows row0 .. row0 + rows - 1 of one (b, h) into raw[0][r]
// and raw[1][r] (rows of 64) by cp.async, 4 bytes a copy, rows beyond n_rows
// as zeros: thread 2 r copies m, thread 2 r + 1 copies l, the two threads
// that take the row in prep_rows, so that each reads only its own copy.
__device__ __forceinline__ void stage_stats(float* raw, const float* m,
                                            const float* l, int row0,
                                            int rows, int n_rows) {
  const int r = threadIdx.x / 2, which = threadIdx.x % 2;
  if (r >= rows) return;
  const bool inside = row0 + r < n_rows;
  const float* src = (which ? l : m) + (inside ? row0 + r : 0);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(wg::smem_u32(raw + which * kTile + r)), "l"(src),
                  "r"(inside ? 4 : 0));
}

// In bytes: the alignment slack, Q [64][D], two buffers of K and V
// [64][D], three mbarriers (Q, buffer 0, buffer 1) and the batch row's
// valid-key bits, ceil(L / 32) words.
template <int D>
int fwd_bf16_smem_bytes(int length) {
  return 1024 + 5 * kTile * D * 2 + 3 * 8 + (length + 31) / 32 * 4;
}

// K3a-bf16. Grid (ceil(L / 64), B * H). q, k and v come by their tensor
// maps (boxes of 64 rows); m_out and l_out may be null.
template <int D>
__global__ void __launch_bounds__(kFwdThreads)
flash_attn_fwd_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const unsigned char* __restrict__ valid,
                           bf16_t* __restrict__ o, float* __restrict__ m_out,
                           float* __restrict__ l_out, int n_heads, int length,
                           float scale, Strides so) {
  constexpr int T = kTile * D, NS = kBfKeys / 2, ND = D / 2;
  constexpr uint32_t kTileBytes = T * 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_t* q_s = reinterpret_cast<bf16_t*>(align1024(smem_raw));
  bf16_t* kv_s = q_s + T;  // [buffer][K, V][64][D]
  uint64_t* bars = reinterpret_cast<uint64_t*>(kv_s + 4 * T);
  unsigned* row_bits = reinterpret_cast<unsigned*>(bars + 3);

  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wrow = tid / 32 * 16;
  const int b = blockIdx.y / n_heads, h = blockIdx.y % n_heads;
  const int q0 = blockIdx.x * kTile;
  const int n_tiles = (length + kBfKeys - 1) / kBfKeys;
  const int n_words = (length + 31) / 32;

  // the next live tile's K and V into buffer `buf`: one thread
  auto load_kv = [&](int buf, int tile) {
    uint64_t* bar = bars + 1 + buf;
    bf16_t* dst = kv_s + buf * 2 * T;
    wg::fence_shared();
    wg::bar_expect(bar, 2 * kTileBytes);
    tma_tile<D>(dst, &map_k, bar, tile * kBfKeys, kBfKeys, kBfKeys, h, b);
    tma_tile<D>(dst + T, &map_v, bar, tile * kBfKeys, kBfKeys, kBfKeys, h,
                b);
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) wg::bar_init(bars + i);
    wg::fence_init();
    wg::bar_expect(bars, kTileBytes);
    tma_tile<D>(q_s, &map_q, bars, q0, kTile, kTile, h, b);
  }
  const bool row_valid = load_row_bits(
      valid + static_cast<long long>(b) * length, length, row_bits);
  int tile = next_live_tile_of<kBfKeys>(0, n_tiles, row_valid, row_bits,
                                        n_words);
  if (tid == 0 && tile < n_tiles) load_kv(0, tile);
  wg::bar_wait(bars, 0);

  float acc[ND] = {};
  float m_run[2] = {-FLT_MAX, -FLT_MAX};
  float l_part[2] = {0.f, 0.f};  // this lane's share of each row's sum
  for (int used = 0; tile < n_tiles; ++used) {
    const int k0 = tile * kBfKeys, buf = used & 1;
    const bf16_t* k_s = kv_s + buf * 2 * T;
    const bf16_t* v_s = k_s + T;
    wg::bar_wait(bars + 1 + buf, (used >> 1) & 1);
    const int next = next_live_tile_of<kBfKeys>(tile + 1, n_tiles, row_valid,
                                                row_bits, n_words);
    // the other buffer: read by no warp since the barrier that ended the
    // last tile
    if (tid == 0 && next < n_tiles) load_kv(buf ^ 1, next);

    float s[NS] = {};
    wg::hold(s);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::Mma<kBfKeys>::ss<0>(s, wg::desc_k<D>(q_s, kTile, 0, kk),
                              wg::desc_k<D>(k_s, kBfKeys, 0, kk), kk > 0);
    wg::commit();
    wg::wait_all();
    wg::hold(s);

    const unsigned long long bits =
        tile_bits_of<kBfKeys>(row_bits, tile, n_words);
    const int n_inside = length - k0;
    float top[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int col = 8 * (i / 4) + 2 * t + (i & 1);
      const float x = (bits >> col) & 1ull ? s[i] * scale
                      : col < n_inside    ? -FLT_MAX
                                          : -CUDART_INF_F;
      s[i] = x;
      top[(i >> 1) & 1] = fmaxf(top[(i >> 1) & 1], x);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      top[r] = fmaxf(top[r], __shfl_xor_sync(0xffffffffu, top[r], 1));
      top[r] = fmaxf(top[r], __shfl_xor_sync(0xffffffffu, top[r], 2));
      const float m_new = fmaxf(m_run[r], top[r]);
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
      l_part[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] *= alpha[(i >> 1) & 1];
    // l sums the fp32 probabilities; P V takes them rounded to bf16
    uint32_t pa[kBfKeys / 16][4];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      s[i] = expf(s[i] - m_run[(i >> 1) & 1]);
      l_part[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int kk = 0; kk < kBfKeys / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = wg::pack(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

    wg::hold(acc);
    wg::hold(pa);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kBfKeys / 16; ++kk)
      wg::Mma<D>::template rs<1>(acc, pa[kk],
                                 wg::desc_mn<D>(v_s, kBfKeys, kk), 1);
    wg::commit();
    wg::wait_all();
    wg::hold(acc);

    __syncthreads();  // every warp is done with this buffer
    tile = next;
  }

  float l_row[2], inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_part[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_row[r] = l;
    inv_l[r] = 1.0f / l;
  }
  bf16_t* o_bh = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wrow + g + 8 * r;
    if (row >= length) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(o_bh + row * so.l + 8 * n + 2 * t) =
          wg::pack(acc[4 * n + 2 * r] * inv_l[r],
                     acc[4 * n + 2 * r + 1] * inv_l[r]);
    if (m_out != nullptr && t == 0) {
      const long long at = static_cast<long long>(blockIdx.y) * length + row;
      m_out[at] = m_run[r];
      l_out[at] = l_row[r];
    }
  }
}

// The backward's bf16 instance: the fp32 instance's two roles and grid.
// Shared memory, in bytes: the alignment slack; the tiles of the larger
// role (dK/dV: K and V [64][D] and two stages of Q, dO and O [LT][D]; dQ:
// Q, dO and O [64][D] and two stages of K and V [LT][D]); the staged m and
// l (two stages of two rows of LT, or one of 64); m, 1 / l and delta of 64
// rows; the batch row's valid-key bits.
template <int D>
__host__ __device__ constexpr int bwd_bf16_tile_bytes() {
  constexpr int LT = kBwdLoop<D>;
  constexpr int dkv = (2 * kTile + 6 * LT) * D * 2;
  constexpr int dq = (3 * kTile + 4 * LT) * D * 2;
  return dkv > dq ? dkv : dq;
}

template <int D>
int bwd_bf16_smem_bytes(int length) {
  return 1024 + bwd_bf16_tile_bytes<D>() + 4 * kTile * 4 + 6 * kTile * 4
         + 3 * 8 + (length + 31) / 32 * 4;
}

// q, k, v, dO and O come by their tensor maps (boxes of kBwdLoop<D> rows);
// the struct is a __grid_constant__ parameter, so the maps stay in the
// parameter space where TMA reads them.
struct BwdBf16Args {
  CUtensorMap map_q, map_k, map_v, map_do, map_o;
  const unsigned char* valid;
  const float* m;
  const float* l;
  bf16_t* d_q;
  bf16_t* d_k;
  bf16_t* d_v;
  Strides sdq, sdk, sdv;
  int n_heads, length;
  int kv_blocks;  // blocks 0 .. kv_blocks - 1 take the dK/dV role
  float scale;
};

// The shared memory past the tiles: staged m and l ([stage][m, l][64]), two
// slots of m, 1 / l and delta of up to 64 rows ([slot][64] each), three
// mbarriers (the block's own tiles, ring stages 0 and 1), then the row's
// valid-key bits.
struct BwdStats {
  float* raw;
  float* m;
  float* inv_l;
  float* delta;
  uint64_t* bars;
  unsigned* bits;
};

template <int D>
__device__ __forceinline__ BwdStats bwd_stats(unsigned char* tiles) {
  float* raw = reinterpret_cast<float*>(tiles + bwd_bf16_tile_bytes<D>());
  float* m = raw + 4 * kTile;
  uint64_t* bars = reinterpret_cast<uint64_t*>(m + 6 * kTile);
  return {raw, m, m + 2 * kTile, m + 4 * kTile, bars,
          reinterpret_cast<unsigned*>(bars + 3)};
}

// The three mbarriers, by thread 0, before the barrier in load_row_bits.
__device__ __forceinline__ void init_bars(uint64_t* bars) {
  if (threadIdx.x != 0) return;
  for (int i = 0; i < 3; ++i) wg::bar_init(bars + i);
  wg::fence_init();
}

// For the `rows` rows of staged dO and O tiles, into slot `slot`: delta =
// sum_d dO o O in fp32, two adjacent threads a row, each D / 2 values in
// order, then their sum; m and 1 / l from the m and l that the same two
// threads staged (stage_stats, `raw`: each reads its own copy, so no
// barrier is needed once its cp.async and the tile's mbarrier are done);
// rows at or beyond n_inside m = 0 and 1 / l = 0 (every probability 0).
template <int D>
__device__ __forceinline__ void prep_rows(const bf16_t* do_s,
                                          const bf16_t* o_s, int rows,
                                          const float* raw, int n_inside,
                                          const BwdStats& st, int slot) {
  const int r = threadIdx.x / 2, half = threadIdx.x % 2;
  const unsigned char* dob = reinterpret_cast<const unsigned char*>(do_s);
  const unsigned char* ob = reinterpret_cast<const unsigned char*>(o_s);
  float part = 0.f;
  if (r < rows) {
#pragma unroll
    for (int c = half * D / 16; c < (half + 1) * D / 16; ++c) {
      const int off = wg::chunk_offset<D>(r, c, rows);
      const uint4 x = *reinterpret_cast<const uint4*>(dob + off);
      const uint4 y = *reinterpret_cast<const uint4*>(ob + off);
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
      const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float2 a = wg::unpack(xs[w]), bb = wg::unpack(ys[w]);
        part = __fmaf_rn(a.x, bb.x, part);
        part = __fmaf_rn(a.y, bb.y, part);
      }
    }
  }
  part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, 1));
  const float own = r < rows ? raw[half * kTile + r] : 0.f;  // m, or l
  const float l = __shfl_xor_sync(0xffffffffu, own, 1);
  if (r < rows && half == 0) {
    const bool inside = r < n_inside;
    const int at = slot * kTile + r;
    st.delta[at] = part;
    st.m[at] = inside ? own : 0.f;
    st.inv_l[at] = inside ? 1.f / l : 0.f;
  }
}

// The flag of `key` from the row's bits.
__device__ __forceinline__ unsigned char bit_flag(const unsigned* bits,
                                                  int key, int length) {
  if (key >= length) return kKeyOutside;
  return (bits[key / 32] >> (key % 32)) & 1u ? kKeyValid : kKeyMasked;
}

// The dQ role, bf16: 64 query rows of one (b, h), staged once with their
// dO, O, m and l; loops over the key tiles (LT keys) that hold a valid key,
// the next one in flight.
template <int D>
__device__ __forceinline__ void bwd_bf16_dq_role(const BwdBf16Args& a,
                                                 unsigned char* smem,
                                                 int tile) {
  constexpr int LT = kBwdLoop<D>, T = kTile * D, TL = LT * D;
  constexpr int NS = LT / 2, ND = D / 2;
  bf16_t* q_s = reinterpret_cast<bf16_t*>(smem);
  bf16_t* do_s = q_s + T;
  bf16_t* o_s = do_s + T;
  bf16_t* ring = o_s + T;  // [stage][K, V][LT][D]
  const BwdStats st = bwd_stats<D>(smem);
  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wrow = tid / 32 * 16;
  const int bh = blockIdx.y, b = bh / a.n_heads, h = bh % a.n_heads;
  const int length = a.length, q0 = tile * kTile;
  const int n_tiles = (length + LT - 1) / LT;
  const int n_words = (length + 31) / 32;

  // the K and V tiles of key tile `kt` into ring stage `buf`: one thread
  auto load_kv = [&](int buf, int kt) {
    uint64_t* bar = st.bars + 1 + buf;
    bf16_t* dst = ring + buf * 2 * TL;
    wg::fence_shared();
    wg::bar_expect(bar, 2 * TL * 2);
    tma_tile<D>(dst, &a.map_k, bar, kt * LT, LT, LT, h, b);
    tma_tile<D>(dst + TL, &a.map_v, bar, kt * LT, LT, LT, h, b);
  };
  init_bars(st.bars);
  if (tid == 0) {
    wg::bar_expect(st.bars, 3 * T * 2);
    tma_tile<D>(q_s, &a.map_q, st.bars, q0, kTile, LT, h, b);
    tma_tile<D>(do_s, &a.map_do, st.bars, q0, kTile, LT, h, b);
    tma_tile<D>(o_s, &a.map_o, st.bars, q0, kTile, LT, h, b);
  }
  const long long bh_rows = static_cast<long long>(bh) * length;
  stage_stats(st.raw, a.m + bh_rows, a.l + bh_rows, q0, kTile, length);
  cp_async_commit();
  load_row_bits(a.valid + static_cast<long long>(b) * length, length,
                st.bits);
  // dS is zero on masked keys: tiles without a valid key are skipped in
  // every batch row, and a row without any gets dQ = 0
  int kt = next_live_tile_of<LT>(0, n_tiles, true, st.bits, n_words);
  if (tid == 0 && kt < n_tiles) load_kv(0, kt);
  wg::bar_wait(st.bars, 0);
  cp_async_wait_all();
  prep_rows<D>(do_s, o_s, kTile, st.raw, length - q0, st, 0);
  __syncthreads();
  float m_row[2], inv_l[2], delta_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + g + 8 * r;
    m_row[r] = st.m[row];
    inv_l[r] = st.inv_l[row];
    delta_row[r] = st.delta[row];
  }

  float acc[ND] = {};
  for (int used = 0; kt < n_tiles; ++used) {
    const int buf = used & 1;
    const bf16_t* k_s = ring + buf * 2 * TL;
    const bf16_t* v_s = k_s + TL;
    wg::bar_wait(st.bars + 1 + buf, (used >> 1) & 1);
    const int next =
        next_live_tile_of<LT>(kt + 1, n_tiles, true, st.bits, n_words);
    // the other stage: read by no warp since the barrier that ended the
    // last tile
    if (tid == 0 && next < n_tiles) load_kv(buf ^ 1, next);

    float s[NS] = {}, dp[NS] = {};
    wg::hold(s);
    wg::hold(dp);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::Mma<LT>::template ss<0>(s, wg::desc_k<D>(q_s, kTile, 0, kk),
                                  wg::desc_k<D>(k_s, LT, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::Mma<LT>::template ss<0>(dp, wg::desc_k<D>(do_s, kTile, 0, kk),
                                  wg::desc_k<D>(v_s, LT, 0, kk), kk > 0);
    wg::commit();
    wg::wait_all();
    wg::hold(s);
    wg::hold(dp);

    const unsigned long long bits = tile_bits_of<LT>(st.bits, kt, n_words);
    const int n_inside = length - kt * LT;
    uint32_t da[LT / 16][4];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i >> 1) & 1, col = 8 * (i / 4) + 2 * t + (i & 1);
      const unsigned char f = (bits >> col) & 1ull ? kKeyValid
                              : col < n_inside      ? kKeyMasked
                                                    : kKeyOutside;
      const float p =
          expf(masked_score(s[i], a.scale, f) - m_row[r]) * inv_l[r];
      // dS scaled before it is rounded to bf16, as the TPU kernel does
      s[i] = f == kKeyValid ? p * (dp[i] - delta_row[r]) * a.scale : 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < LT / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        da[kk][r] = wg::pack(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

    wg::hold(acc);
    wg::hold(da);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < LT / 16; ++kk)
      wg::Mma<D>::template rs<1>(acc, da[kk], wg::desc_mn<D>(k_s, LT, kk),
                                 1);
    wg::commit();
    wg::wait_all();
    wg::hold(acc);

    __syncthreads();  // every warp is done with this stage
    kt = next;
  }

  bf16_t* dq_bh = a.d_q + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wrow + g + 8 * r;
    if (row >= length) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dq_bh + row * a.sdq.l + 8 * n + 2 * t) =
          wg::pack(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
  }
}

// The dK/dV role, bf16: 64 key rows of one (b, h), K and V staged once, the
// score tile held transposed (rows keys, columns queries); walks every
// query tile (LT queries), the next one in flight with its dO, O, m and l.
template <int D>
__device__ __forceinline__ void bwd_bf16_dkv_role(const BwdBf16Args& a,
                                                  unsigned char* smem,
                                                  int tile) {
  constexpr int LT = kBwdLoop<D>, T = kTile * D, TL = LT * D;
  constexpr int NS = LT / 2, ND = D / 2;
  bf16_t* k_s = reinterpret_cast<bf16_t*>(smem);
  bf16_t* v_s = k_s + T;
  bf16_t* ring = v_s + T;  // [stage][Q, dO, O][LT][D]
  const BwdStats st = bwd_stats<D>(smem);
  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wrow = tid / 32 * 16;
  const int bh = blockIdx.y, b = bh / a.n_heads, h = bh % a.n_heads;
  const int length = a.length, k0 = tile * kTile;
  const float* m_bh = a.m + static_cast<long long>(bh) * length;
  const float* l_bh = a.l + static_cast<long long>(bh) * length;
  bf16_t* dk_bh = a.d_k + b * a.sdk.b + h * a.sdk.h;
  bf16_t* dv_bh = a.d_v + b * a.sdv.b + h * a.sdv.h;
  const int n_words = (length + 31) / 32;

  init_bars(st.bars);
  // as the fp32 role: a tile without a valid key, in a batch row that has
  // one, weighs nothing and its rows are zero
  const bool row_valid = load_row_bits(
      a.valid + static_cast<long long>(b) * length, length, st.bits);
  if (row_valid && tile_bits_of<kTile>(st.bits, tile, n_words) == 0) {
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
  // the Q, dO and O tiles of query rows q0 .. q0 + LT - 1 (by TMA, one
  // thread) and their m and l (cp.async) into ring stage `stage`
  auto stage_queries = [&](int stage, int q0) {
    if (tid == 0) {
      uint64_t* bar = st.bars + 1 + stage;
      bf16_t* dst = ring + stage * 3 * TL;
      wg::fence_shared();
      wg::bar_expect(bar, 3 * TL * 2);
      tma_tile<D>(dst, &a.map_q, bar, q0, LT, LT, h, b);
      tma_tile<D>(dst + TL, &a.map_do, bar, q0, LT, LT, h, b);
      tma_tile<D>(dst + 2 * TL, &a.map_o, bar, q0, LT, LT, h, b);
    }
    stage_stats(st.raw + stage * 2 * kTile, m_bh, l_bh, q0, LT, length);
    cp_async_commit();
  };
  // tile i's statistics into slot i & 1, once its stage has landed
  auto prep = [&](int i) {
    const int stage = i & 1;
    const bf16_t* do_t = ring + stage * 3 * TL + TL;
    wg::bar_wait(st.bars + 1 + stage, (i >> 1) & 1);
    cp_async_wait_all();
    prep_rows<D>(do_t, do_t + TL, LT, st.raw + stage * 2 * kTile,
                 length - i * LT, st, stage);
  };
  if (tid == 0) {
    wg::bar_expect(st.bars, 2 * T * 2);
    tma_tile<D>(k_s, &a.map_k, st.bars, k0, kTile, LT, h, b);
    tma_tile<D>(v_s, &a.map_v, st.bars, k0, kTile, LT, h, b);
  }
  stage_queries(0, 0);
  unsigned char key_f[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    key_f[r] = bit_flag(st.bits, k0 + wrow + g + 8 * r, length);

  float acc_k[ND] = {}, acc_v[ND] = {};
  const int n_tiles = (length + LT - 1) / LT;
  prep(0);
  wg::bar_wait(st.bars, 0);
  __syncthreads();
  // One barrier a tile: it publishes the next tile's statistics and frees
  // this tile's stage. The next tile is in flight from the top of the loop;
  // dS is taken while the dV chain runs, and the next tile's statistics
  // while the dK chain runs.
  for (int i = 0; i < n_tiles; ++i) {
    const int cur = i & 1;
    if (i + 1 < n_tiles) stage_queries(cur ^ 1, (i + 1) * LT);
    const bf16_t* q_t = ring + cur * 3 * TL;
    const bf16_t* do_t = q_t + TL;
    const float* m_t = st.m + cur * kTile;
    const float* inv_l_t = st.inv_l + cur * kTile;
    const float* delta_t = st.delta + cur * kTile;

    float s[NS] = {}, dp[NS] = {};
    wg::hold(s);
    wg::hold(dp);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::Mma<LT>::template ss<0>(s, wg::desc_k<D>(k_s, kTile, 0, kk),
                                  wg::desc_k<D>(q_t, LT, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::Mma<LT>::template ss<0>(dp, wg::desc_k<D>(v_s, kTile, 0, kk),
                                  wg::desc_k<D>(do_t, LT, 0, kk), kk > 0);
    wg::commit();
    wg::wait_all();
    wg::hold(s);
    wg::hold(dp);

    uint32_t pa[LT / 16][4], da[LT / 16][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int col = 8 * (j / 4) + 2 * t + (j & 1);
      s[j] = expf(masked_score(s[j], a.scale, key_f[(j >> 1) & 1])
                  - m_t[col]) * inv_l_t[col];
    }
#pragma unroll
    for (int kk = 0; kk < LT / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = wg::pack(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    wg::hold(acc_v);
    wg::hold(pa);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < LT / 16; ++kk)
      wg::Mma<D>::template rs<1>(acc_v, pa[kk], wg::desc_mn<D>(do_t, LT, kk),
                                 1);
    wg::commit();

#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int col = 8 * (j / 4) + 2 * t + (j & 1);
      // dS scaled before it is rounded to bf16, as the TPU kernel does
      dp[j] = key_f[(j >> 1) & 1] == kKeyValid
                  ? s[j] * (dp[j] - delta_t[col]) * a.scale : 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < LT / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        da[kk][r] = wg::pack(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
    wg::hold(acc_k);
    wg::hold(da);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < LT / 16; ++kk)
      wg::Mma<D>::template rs<1>(acc_k, da[kk], wg::desc_mn<D>(q_t, LT, kk),
                                 1);
    wg::commit();

    if (i + 1 < n_tiles) prep(i + 1);
    wg::wait_all();
    wg::hold(acc_v);
    wg::hold(acc_k);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + wrow + g + 8 * r;
    if (row >= length) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dv_bh + row * a.sdv.l + 8 * n + 2 * t) =
          wg::pack(acc_v[4 * n + 2 * r], acc_v[4 * n + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dk_bh + row * a.sdk.l + 8 * n + 2 * t) =
          wg::pack(acc_k[4 * n + 2 * r], acc_k[4 * n + 2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, kBwdBf16Blocks<D>)
flash_attn_bwd_bf16_kernel(const __grid_constant__ BwdBf16Args args) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  unsigned char* smem = align1024(smem_bytes);
  const int x = static_cast<int>(blockIdx.x);
  if (x < args.kv_blocks)
    bwd_bf16_dkv_role<D>(args, smem, x);
  else
    bwd_bf16_dq_role<D>(args, smem, x - args.kv_blocks);
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

// What a bf16 launcher returns when the driver refuses a view's tensor map
// (no CUDA error code says that).
constexpr int kTensorMapRefused = -1;

// The driver's cuTensorMapEncodeTiled, found through the runtime once (no
// link to the driver library).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess
        || found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tensor map of a strided bf16 (B, H, L, D) view at `base` (element
// strides s, D adjacent) for tma_tile: boxes of min(D, 64) values by `rows`
// rows, swizzled as wgmma_bf16.cuh's tiles (128, 64 or 32 bytes), rows
// beyond L read as zeros. False where the driver refuses the view.
template <int D>
bool tile_map(CUtensorMap* map, const void* base, int batch, int n_heads,
              int length, Strides s, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  auto bytes = [](long long stride) {  // a dimension of one may have 0
    return static_cast<cuuint64_t>(stride > 0 ? 2 * stride : 16);
  };
  const cuuint64_t dims[4] = {D, static_cast<cuuint64_t>(length),
                              static_cast<cuuint64_t>(n_heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {bytes(s.l), bytes(s.h), bytes(s.b)};
  const cuuint32_t box[4] = {D < 64 ? D : 64, static_cast<cuuint32_t>(rows),
                             1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      D >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B
      : D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_fwd_bf16(const bf16_t* q, const bf16_t* k, const bf16_t* v,
                    const unsigned char* valid, bf16_t* o, float* m_out,
                    float* l_out, int batch, int n_heads, int length,
                    float scale, const long long* st, cudaStream_t stream) {
  // a runtime call before the maps: it makes the device's context current
  // on this thread (the autograd engine's may have none yet), which the
  // driver's encoder needs
  auto kernel = flash_attn_fwd_bf16_kernel<D>;
  const int smem = fwd_bf16_smem_bytes<D>(length);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap maps[3];
  const bf16_t* views[3] = {q, k, v};
  for (int i = 0; i < 3; ++i)
    if (!tile_map<D>(&maps[i], views[i], batch, n_heads, length,
                     strides_at(st, i), kTile))
      return kTensorMapRefused;
  const dim3 grid((length + kTile - 1) / kTile, batch * n_heads);
  kernel<<<grid, kFwdThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], valid, o, m_out, l_out, n_heads, length,
      scale, strides_at(st, 3));
  return static_cast<int>(cudaGetLastError());
}

// views: q, k, v, dO, O, with their strides first in st. The maps are
// made in a local array, where the 64-byte alignment that the driver
// requires holds, and copied into the caller's args.
template <int D>
int launch_bwd_bf16(BwdBf16Args& args, const void* const* views,
                    const long long* st, int batch, int q_blocks,
                    cudaStream_t stream) {
  auto kernel = flash_attn_bwd_bf16_kernel<D>;  // first: as launch_fwd_bf16
  const int smem = bwd_bf16_smem_bytes<D>(args.length);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap maps[5];
  for (int i = 0; i < 5; ++i)
    if (!tile_map<D>(&maps[i], views[i], batch, args.n_heads, args.length,
                     strides_at(st, i), kBwdLoop<D>))
      return kTensorMapRefused;
  args.map_q = maps[0];
  args.map_k = maps[1];
  args.map_v = maps[2];
  args.map_do = maps[3];
  args.map_o = maps[4];
  const dim3 grid(args.kv_blocks + q_blocks, batch * args.n_heads);
  kernel<<<grid, kBwdThreads, smem, stream>>>(args);
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
  if (err == kTensorMapRefused)
    return "the driver refused a tensor map (cuTensorMapEncodeTiled) of a "
           "bf16 view";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Every tensor is float32 (bf16 for the _bf16 functions; m, l stay float32)
// of shape (B, H, L, D) with adjacent elements along D, 16-byte aligned
// rows, and strides in elements for batch, head and row:
// `strides` is a host array of three per tensor, in the order given at each
// function. valid is (B, L), one byte per key (0 masked, else valid),
// contiguous; m, l and delta are (B, H, L), contiguous. D is 16, 32, 64 or
// 128 and B * H at most 65535, else cudaErrorInvalidValue. Each function
// launches on `stream` and returns the CUDA error code (0 on success), or
// -1 where the driver refuses a bf16 view's tensor map;
// attention_error_string names either.

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
  BwdBf16Args args{};
  args.valid = valid;
  args.m = m;
  args.l = l;
  args.d_q = static_cast<bf16_t*>(d_q);
  args.d_k = static_cast<bf16_t*>(d_k);
  args.d_v = static_cast<bf16_t*>(d_v);
  args.sdq = strides_at(strides, 5);
  args.sdk = strides_at(strides, 6);
  args.sdv = strides_at(strides, 7);
  args.n_heads = n_heads;
  args.length = length;
  args.kv_blocks = d_k != nullptr ? n_tiles : 0;
  args.scale = scale;
  const void* const views[5] = {q, k, v, d_o, o};
  ATTENTION_DISPATCH(head_dim, launch_bwd_bf16, args, views, strides, batch,
                     d_q != nullptr ? n_tiles : 0,
                     static_cast<cudaStream_t>(stream))
}

}  // extern "C"
