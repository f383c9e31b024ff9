// Flash self-attention over a key-padding mask: forward (K3a) and the two
// backward passes (K3b: dK and dV, K3c: dQ), with a row pre-pass for
// delta_i = sum_d dO[i][d] O[i][d].
//
// Replaces the TPU flash kernels that
// protein_transformer_tpu/ops/attention.py::flash_self_attention reaches in
// jax/experimental/pallas/ops/tpu/flash_attention.py
// (_flash_attention_kernel, _flash_attention_dkv_kernel,
// _flash_attention_dq_kernel). What it computes, per batch row b and head h,
// with s_ij = scale * q_i . k_j:
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
// each; the backward passes recompute P = exp(s - m) / l tile by tile. m and
// l are kept apart, not folded into one logsumexp: for a row with no valid
// key m = -FLT_MAX swallows log(l), and exp(s - lse) would be 1, not 1/L.
// The gradient is that of the masked softmax: dS = P o (dP - delta) on valid
// keys and 0 on masked ones (a constant score passes no gradient), dP = dO
// V^T, dV = P^T dO, dK = scale * dS^T Q, dQ = scale * dS K.
//
// What bounds it on Hopper: fp32 operations. At B=8, H=8, L=256, D=64 the
// forward is 4 B H L^2 D = 1.07 GFLOP against 17 MB moved: 16 us at the
// card's 67 TFLOP/s outside the tensor cores, 5 us by bytes. The products
// are fp32 FMAs, not tensor-core operations, to hold the model's 2e-5
// forward gate; exp is expf (never __expf: ~2 ulp more error on every
// probability, over six layers).
//
// Design:
//   * one block of 256 threads (16 x 16) owns 64 query rows (forward, dQ) or
//     64 key rows (dK/dV) of one (b, h) and loops over 64-row tiles of the
//     other axis, where the TPU grid ran sequentially over key blocks.
//     Every output element is written by exactly one block, its sum taken in
//     a fixed order: no atomics, the same bits on every call.
//   * tiles sit row-major in shared memory with a row stride of D + 4
//     floats. For a product over the head dimension, C[r][c] = A[r] . B[c],
//     thread (ty, tx) holds rows 4 ty .. 4 ty + 3 and the strided columns
//     tx, tx + 16, tx + 32, tx + 48: the A rows are broadcasts within a
//     half-warp, and the B rows of neighbouring threads are D + 4 floats
//     apart, so their 16-byte loads fall in distinct banks. Each thread does
//     a 4 x 4 register tile: 8 vector loads for 64 FMAs.
//   * the 64 x 64 tile of P (or dS) goes through shared memory once (stride
//     68), and the second product, out[r][:] += sum_j P[r][j] V[j][:], reads
//     P as broadcasts and V's row j as neighbouring vectors: each thread
//     holds 4 rows x D/16 columns of the output in registers.
//   * row maxima and sums are reduced over the 16 threads of a row group by
//     shuffles, in a fixed tree.
//   * q, k, v, o and the gradients are addressed by strides (batch, head,
//     row; elements of a row adjacent), so the (B, L, H, D) memory of the
//     model's head split is read and written in place, without a copy.
//   * shared memory is dynamic: 70 KB (forward), 87 KB (dQ), 104 KB (dK/dV)
//     at D=64; 119, 152 and 170 KB at D=128. D is one of 16, 32, 64, 128.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cfloat>

namespace {

constexpr int kTile = 64;             // query rows and key rows per tile
constexpr int kGroup = 16;            // threads per row group
constexpr int kThreads = kGroup * kGroup;
constexpr int kRows = kTile / kGroup;  // rows (and strided columns) a thread
constexpr int kPStride = kTile + 4;   // row stride of the P / dS tile

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
template <int D>
constexpr int dq_smem_bytes() {
  return (4 * kTile * (D + 4) + kTile * kPStride) * 4 + kTile;
}
template <int D>
constexpr int dkv_smem_bytes() {
  return (4 * kTile * (D + 4) + 2 * kTile * kPStride + 3 * kTile) * 4;
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

// delta[b, h, i] = sum_d dO[i][d] * O[i][d]: one thread per row.
__global__ void attn_delta_kernel(const float* __restrict__ o,
                                  const float* __restrict__ d_o,
                                  float* __restrict__ delta, int n_heads,
                                  int length, int head_dim, long long n_rows,
                                  Strides so, Strides sdo) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (r >= n_rows) return;
  const int i = static_cast<int>(r % length);
  const long long bh = r / length;
  const int h = static_cast<int>(bh % n_heads);
  const long long b = bh / n_heads;
  const float* o_row = o + b * so.b + h * so.h + i * so.l;
  const float* do_row = d_o + b * sdo.b + h * sdo.h + i * sdo.l;
  float sum = 0.0f;
  for (int d = 0; d < head_dim; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(o_row + d);
    const float4 y = *reinterpret_cast<const float4*>(do_row + d);
    sum = fmaf(x.x, y.x, sum);
    sum = fmaf(x.y, y.y, sum);
    sum = fmaf(x.z, y.z, sum);
    sum = fmaf(x.w, y.w, sum);
  }
  delta[r] = sum;
}

// K3c. dQ of 64 query rows; grid (ceil(L / 64), B * H).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dq_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const unsigned char* __restrict__ valid,
                         const float* __restrict__ d_o,
                         const float* __restrict__ m_in,
                         const float* __restrict__ l_in,
                         const float* __restrict__ delta,
                         float* __restrict__ d_q, int n_heads, int length,
                         float scale, Strides sq, Strides sk, Strides sv,
                         Strides sdo, Strides sdq) {
  extern __shared__ __align__(16) float smem[];
  constexpr int DP = D + 4;
  constexpr int DC = D / kGroup;
  float* q_s = smem;
  float* do_s = q_s + kTile * DP;
  float* k_s = do_s + kTile * DP;
  float* v_s = k_s + kTile * DP;
  float* ds_s = v_s + kTile * DP;
  unsigned char* flag_s = reinterpret_cast<unsigned char*>(ds_s
                                                           + kTile * kPStride);
  const int tid = threadIdx.x, ty = tid / kGroup, tx = tid % kGroup;
  const int b = blockIdx.y / n_heads, h = blockIdx.y % n_heads;
  const int q0 = blockIdx.x * kTile;
  const float* k_bh = k + b * sk.b + h * sk.h;
  const float* v_bh = v + b * sv.b + h * sv.h;

  load_tile<D>(q_s, q + b * sq.b + h * sq.h, sq.l, q0, length, tid);
  load_tile<D>(do_s, d_o + b * sdo.b + h * sdo.h, sdo.l, q0, length, tid);
  // rows beyond L: m = 0 and 1 / l = 0 make every probability 0
  float m_row[kRows], inv_l[kRows], delta_row[kRows];
  const long long row0 = static_cast<long long>(blockIdx.y) * length;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    const bool inside = row < length;
    m_row[i] = inside ? m_in[row0 + row] : 0.0f;
    inv_l[i] = inside ? 1.0f / l_in[row0 + row] : 0.0f;
    delta_row[i] = inside ? delta[row0 + row] : 0.0f;
  }
  float acc[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;

  for (int k0 = 0; k0 < length; k0 += kTile) {
    load_tile<D>(k_s, k_bh, sk.l, k0, length, tid);
    load_tile<D>(v_s, v_bh, sv.l, k0, length, tid);
    if (tid < kTile) flag_s[tid] = key_flag(valid, b, length, k0 + tid);
    __syncthreads();

    float s[kRows][kRows], dp[kRows][kRows];
    tile_dot<D>(q_s, k_s, ty, tx, s);
    tile_dot<D>(do_s, v_s, ty, tx, dp);
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const unsigned char f = flag_s[tx + kGroup * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = expf(masked_score(s[i][j], scale, f) - m_row[i])
                        * inv_l[i];
        ds_s[(ty * kRows + i) * kPStride + tx + kGroup * j] =
            f == kKeyValid ? p * (dp[i][j] - delta_row[i]) : 0.0f;
      }
    }
    __syncthreads();
    tile_accum<D>(ds_s, k_s, ty, tx, acc);
    __syncthreads();
  }

  float factor[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) factor[i] = scale;
  store_rows<D>(d_q + b * sdq.b + h * sdq.h, sdq.l, q0, length, ty, tx, acc,
                factor);
}

// K3b. dK and dV of 64 key rows; grid (ceil(L / 64), B * H). The score tile
// is held transposed: rows are keys, strided columns are queries.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dkv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const unsigned char* __restrict__ valid,
                          const float* __restrict__ d_o,
                          const float* __restrict__ m_in,
                          const float* __restrict__ l_in,
                          const float* __restrict__ delta,
                          float* __restrict__ d_k, float* __restrict__ d_v,
                          int n_heads, int length, float scale, Strides sq,
                          Strides sk, Strides sv, Strides sdo, Strides sdk,
                          Strides sdv) {
  extern __shared__ __align__(16) float smem[];
  constexpr int DP = D + 4;
  constexpr int DC = D / kGroup;
  float* k_s = smem;
  float* v_s = k_s + kTile * DP;
  float* q_s = v_s + kTile * DP;
  float* do_s = q_s + kTile * DP;
  float* p_s = do_s + kTile * DP;
  float* ds_s = p_s + kTile * kPStride;
  float* m_s = ds_s + kTile * kPStride;
  float* inv_l_s = m_s + kTile;
  float* delta_s = inv_l_s + kTile;
  const int tid = threadIdx.x, ty = tid / kGroup, tx = tid % kGroup;
  const int b = blockIdx.y / n_heads, h = blockIdx.y % n_heads;
  const int k0 = blockIdx.x * kTile;
  const float* q_bh = q + b * sq.b + h * sq.h;
  const float* do_bh = d_o + b * sdo.b + h * sdo.h;
  const long long row0 = static_cast<long long>(blockIdx.y) * length;

  load_tile<D>(k_s, k + b * sk.b + h * sk.h, sk.l, k0, length, tid);
  load_tile<D>(v_s, v + b * sv.b + h * sv.h, sv.l, k0, length, tid);
  unsigned char flag[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j)
    flag[j] = key_flag(valid, b, length, k0 + ty * kRows + j);
  float acc_k[kRows][DC], acc_v[kRows][DC];
#pragma unroll
  for (int j = 0; j < kRows; ++j)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_k[j][c] = acc_v[j][c] = 0.0f;

  for (int q0 = 0; q0 < length; q0 += kTile) {
    load_tile<D>(q_s, q_bh, sq.l, q0, length, tid);
    load_tile<D>(do_s, do_bh, sdo.l, q0, length, tid);
    if (tid < kTile) {
      // queries beyond L: m = 0 and 1 / l = 0 make every probability 0
      const bool inside = q0 + tid < length;
      m_s[tid] = inside ? m_in[row0 + q0 + tid] : 0.0f;
      inv_l_s[tid] = inside ? 1.0f / l_in[row0 + q0 + tid] : 0.0f;
      delta_s[tid] = inside ? delta[row0 + q0 + tid] : 0.0f;
    }
    __syncthreads();

    float s[kRows][kRows], dp[kRows][kRows];
    tile_dot<D>(k_s, q_s, ty, tx, s);    // s[j][i] = k_j . q_i
    tile_dot<D>(v_s, do_s, ty, tx, dp);  // dp[j][i] = v_j . dO_i
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int col = tx + kGroup * i;
      const float m_i = m_s[col], inv_l_i = inv_l_s[col], delta_i = delta_s[col];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float p = expf(masked_score(s[j][i], scale, flag[j]) - m_i)
                        * inv_l_i;
        p_s[(ty * kRows + j) * kPStride + col] = p;
        ds_s[(ty * kRows + j) * kPStride + col] =
            flag[j] == kKeyValid ? p * (dp[j][i] - delta_i) : 0.0f;
      }
    }
    __syncthreads();
    tile_accum<D>(p_s, do_s, ty, tx, acc_v);
    tile_accum<D>(ds_s, q_s, ty, tx, acc_k);
    __syncthreads();
  }

  float one[kRows], factor[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) one[j] = 1.0f, factor[j] = scale;
  store_rows<D>(d_v + b * sdv.b + h * sdv.h, sdv.l, k0, length, ty, tx, acc_v,
                one);
  store_rows<D>(d_k + b * sdk.b + h * sdk.h, sdk.l, k0, length, ty, tx, acc_k,
                factor);
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
int launch_dq(const float* q, const float* k, const float* v,
              const unsigned char* valid, const float* d_o, const float* m_in,
              const float* l_in, const float* delta, float* d_q, int batch,
              int n_heads, int length, float scale, const long long* st,
              cudaStream_t stream) {
  auto kernel = flash_attn_bwd_dq_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem_bytes<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((length + kTile - 1) / kTile, batch * n_heads);
  kernel<<<grid, kThreads, dq_smem_bytes<D>(), stream>>>(
      q, k, v, valid, d_o, m_in, l_in, delta, d_q, n_heads, length, scale,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), strides_at(st, 4));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v,
               const unsigned char* valid, const float* d_o, const float* m_in,
               const float* l_in, const float* delta, float* d_k, float* d_v,
               int batch, int n_heads, int length, float scale,
               const long long* st, cudaStream_t stream) {
  auto kernel = flash_attn_bwd_dkv_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dkv_smem_bytes<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((length + kTile - 1) / kTile, batch * n_heads);
  kernel<<<grid, kThreads, dkv_smem_bytes<D>(), stream>>>(
      q, k, v, valid, d_o, m_in, l_in, delta, d_k, d_v, n_heads, length, scale,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), strides_at(st, 4), strides_at(st, 5));
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

// delta = sum over D of dO o O. strides: o, dO.
int attention_delta(const float* o, const float* d_o, float* delta, int batch,
                    int n_heads, int length, int head_dim,
                    const long long* strides, void* stream) {
  if (bad_shape(batch, n_heads, length, head_dim))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_rows = static_cast<long long>(batch) * n_heads * length;
  const int threads = 128;
  const unsigned blocks = static_cast<unsigned>((n_rows + threads - 1)
                                                / threads);
  attn_delta_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d_o, delta, n_heads, length, head_dim, n_rows, strides_at(strides, 0),
      strides_at(strides, 1));
  return static_cast<int>(cudaGetLastError());
}

// K3b. strides: q, k, v, dO, dK, dV.
int flash_attn_bwd_dkv(const float* q, const float* k, const float* v,
                       const unsigned char* valid, const float* d_o,
                       const float* m_in, const float* l_in,
                       const float* delta, float* d_k, float* d_v, int batch,
                       int n_heads, int length, int head_dim, float scale,
                       const long long* strides, void* stream) {
  if (bad_shape(batch, n_heads, length, head_dim))
    return static_cast<int>(cudaErrorInvalidValue);
  ATTENTION_DISPATCH(head_dim, launch_dkv, q, k, v, valid, d_o, m_in, l_in,
                     delta, d_k, d_v, batch, n_heads, length, scale, strides,
                     static_cast<cudaStream_t>(stream))
}

// K3c. strides: q, k, v, dO, dQ.
int flash_attn_bwd_dq(const float* q, const float* k, const float* v,
                      const unsigned char* valid, const float* d_o,
                      const float* m_in, const float* l_in,
                      const float* delta, float* d_q, int batch, int n_heads,
                      int length, int head_dim, float scale,
                      const long long* strides, void* stream) {
  if (bad_shape(batch, n_heads, length, head_dim))
    return static_cast<int>(cudaErrorInvalidValue);
  ATTENTION_DISPATCH(head_dim, launch_dq, q, k, v, valid, d_o, m_in, l_in,
                     delta, d_q, batch, n_heads, length, scale, strides,
                     static_cast<cudaStream_t>(stream))
}

}  // extern "C"
