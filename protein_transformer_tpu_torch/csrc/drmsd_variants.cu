// Candidate rewrites of the dRMSD kernels, run by the kernel-variant bench
// (protein_transformer_tpu_torch/tools/bench_drmsd_kernel.py) beside the
// production kernels of drmsd_fwd.cu and drmsd_train.cu.
//
// Replaces the three TPU kernel bodies of tools/bench_drmsd_kernel.py:
//   * drmsd_fwd_sqrt1 (K4a) replaces _fwd_kernel_sqrt1: (S, C) with each
//     pair's term taken as d2a + d2b - 2 sqrt(d2a d2b), the squared
//     distances in difference form: one square root a pair where the
//     production kernel takes two rsqrt;
//   * drmsd_fwd_mxu (K4b) replaces _fwd_kernel_mxu: the same term with
//     d2 = |x_i|^2 + |x_j|^2 - 2 x_i . x_j, the 3-deep cross term as a
//     matrix product;
//   * drmsd_grad_a_mxu (K4c) replaces _bwd_kernel_mxu: dS/da with
//     coef = 2 w (1 - sqrt(d2b) rsqrt(d2a)) in the norm + cross form,
//     ga_i = a_i rowsum(coef) - coef a_j and ga_j = a_j colsum(coef) -
//     coef^T a_i as matrix products.
// Every squared distance is clamped at 1e-30, as in the production kernels.
//
// What bounds them on Hopper: arithmetic on the CUDA cores. The matrix
// products are 3 deep (K4b, and the cross terms of K4c) or 3 wide (K4c's
// coef . x), so the tensor cores run at 3/8 of a tile at best, and what is
// left per pair on the CUDA cores (the norms' sum, the clamp, the square
// root, the mask, and for the split two conversions an operand) is of the
// order of the production kernel's work. Device time on an NVIDIA H100 80GB
// HBM3 at 700 W, B=8 x 3584 atoms (chip_smoke.py): K4a 0.085 ms beside
// K1a's 0.081, K4b 0.114, K4c 0.261 beside K1b's 0.188 (which also gives S
// and C): one root ties two rsqrt, and the tensor-core form loses.
//
// Design:
//   * the grid, the partial sums and the final sums are the production
//     kernels': grid = (upper-triangular tile pairs, proteins), an integer
//     pair count, per-block (S, C) partials summed per protein in a fixed
//     order (drmsd_common.cuh), and for K4c per-tile-pair row and column
//     partials gathered in a fixed order. No float atomics: the same bits on
//     every call.
//   * the matrix products run on the tensor cores with
//     mma.sync.aligned.m16n8k8 in TF32, the contraction padded from 3 to 8
//     with zeros. Plain TF32 keeps ~3 digits, and with coordinates of tens
//     of A the cross term is ~10^3 A^2 while a pair's term is ~1 A^2. So
//     every operand is split into a TF32 head and a TF32 remainder, and a
//     product is three TF32 products, remainder x head, head x remainder and
//     head x head, summed in fp32 in that order: what Precision.HIGHEST does
//     on the TPU with bf16 passes.
//   * a warp owns 16 rows of the 128 x 128 tile pair and walks its 16
//     column groups of 8. Its cross-term accumulators hold (row g, g + 8;
//     columns 2t, 2t + 1) per thread (g = lane / 4, t = lane % 4). K4c
//     feeds coef from those registers straight back as the left operand of
//     coef . x: the contraction runs over the columns, so the column order
//     inside a group of 8 is free as long as the right operand's rows follow
//     it (k = t is column 2t, k = t + 4 is column 2t + 1).
//   * K4c sweeps a tile pair twice, as drmsd_train.cu does: once with the
//     row tile's atoms as the rows of coef (the row partial) and once with
//     the column tile's (the column partial, coef^T), so that no transpose
//     across threads is needed. The row sums of coef are fp32 sums on the
//     CUDA cores, reduced over the four threads of a row by shuffles.

#include "drmsd_common.cuh"
#include "mma_tf32.cuh"

using namespace drmsd;
using namespace tf32;

namespace {

__device__ __forceinline__ float clamped_d2(float dx, float dy, float dz) {
  return fmaxf(fmaf(dz, dz, fmaf(dy, dy, dx * dx)), kDistClamp);
}

// (Da - Db)^2 of one pair from its squared distances: one square root.
__device__ __forceinline__ float pair_term(float d2a, float d2b) {
  return (d2a + d2b) - 2.f * sqrtf(d2a * d2b);
}

// ---------------------------------------------------------------- K4a

__global__ void __launch_bounds__(kThreads)
sqrt1_tile_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const uint8_t* __restrict__ mask, int n, int n_tiles,
                  int n_pairs, float* __restrict__ part_s,
                  int* __restrict__ part_c) {
  const int pair = blockIdx.x;
  const int prot = blockIdx.y;
  int ti, tj;
  unrank_pair(pair, n_tiles, &ti, &tj);

  __shared__ float sa[3][kTile];
  __shared__ float sb[3][kTile];
  __shared__ uint8_t sm[kTile];
  __shared__ float red_s[kWarps];
  __shared__ int red_c[kWarps];

  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(prot) * n;
  if (tid < kTile) {
    const int j = tj * kTile + tid;
    const bool ok = j < n;
    const size_t o = (base + (ok ? j : 0)) * 3;
    for (int c = 0; c < 3; ++c) {
      sa[c][tid] = ok ? a[o + c] : 0.f;
      sb[c][tid] = ok ? b[o + c] : 0.f;
    }
    sm[tid] = ok ? mask[base + j] : 0;
  }

  const int i = ti * kTile + tid % kTile;
  const bool row_ok = i < n && mask[base + i] != 0;
  float ax = 0.f, ay = 0.f, az = 0.f, bx = 0.f, by = 0.f, bz = 0.f;
  if (row_ok) {
    const size_t o = (base + i) * 3;
    ax = a[o];
    ay = a[o + 1];
    az = a[o + 2];
    bx = b[o];
    by = b[o + 1];
    bz = b[o + 2];
  }
  __syncthreads();

  float s = 0.f;
  int cnt = 0;
  if (row_ok) {
    for (int col = tid / kTile; col < kTile; col += kColGroups) {
      if (sm[col] && i < tj * kTile + col) {
        const float d2a =
            clamped_d2(ax - sa[0][col], ay - sa[1][col], az - sa[2][col]);
        const float d2b =
            clamped_d2(bx - sb[0][col], by - sb[1][col], bz - sb[2][col]);
        s += pair_term(d2a, d2b);
        cnt += 1;
      }
    }
  }
  block_stat_partial(s, cnt, red_s, red_c, part_s, part_c,
                     static_cast<size_t>(prot) * n_pairs + pair);
}

// ------------------------------------------------- the matrix-unit form

// to_tf32, mma_tf32, SplitFrag, split_tf32 and mma_split: mma_tf32.cuh.

// One staged tile of kTile atoms: fp32 coordinates of a, their split, the
// split of b's, the squared norms and the mask. Atoms beyond n are zeros
// with the mask off.
struct Tile {
  float xa[3][kTile];
  uint32_t a_head[3][kTile];
  uint32_t a_rest[3][kTile];
  uint32_t b_head[3][kTile];
  uint32_t b_rest[3][kTile];
  float na[kTile];
  float nb[kTile];
  uint8_t m[kTile];
};

// Thread k of a group of kTile threads stages atom k of tile t.
__device__ __forceinline__ void stage_atom(Tile& tile, int k, int t,
                                           const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           const uint8_t* __restrict__ mask,
                                           size_t base, int n) {
  const int atom = t * kTile + k;
  const bool ok = atom < n;
  const size_t o = (base + (ok ? atom : 0)) * 3;
  float xa[3], xb[3];
  for (int c = 0; c < 3; ++c) {
    xa[c] = ok ? a[o + c] : 0.f;
    xb[c] = ok ? b[o + c] : 0.f;
    tile.xa[c][k] = xa[c];
    split_tf32(xa[c], &tile.a_head[c][k], &tile.a_rest[c][k]);
    split_tf32(xb[c], &tile.b_head[c][k], &tile.b_rest[c][k]);
  }
  tile.na[k] = fmaf(xa[2], xa[2], fmaf(xa[1], xa[1], xa[0] * xa[0]));
  tile.nb[k] = fmaf(xb[2], xb[2], fmaf(xb[1], xb[1], xb[0] * xb[0]));
  tile.m[k] = ok ? mask[base + atom] : 0;
}

// The left operand of the cross term: rows r0 + g and r0 + g + 8 of a tile's
// coordinates, component t along the contraction (zero for t = 3 and for
// the padding k = 4 .. 7).
__device__ __forceinline__ SplitFrag<4> row_operand(
    const uint32_t (&head)[3][kTile], const uint32_t (&rest)[3][kTile],
    int r0, int g, int t) {
  SplitFrag<4> f;
  const bool live = t < 3;
  const int c = live ? t : 0;
  f.head[0] = live ? head[c][r0 + g] : 0u;
  f.head[1] = live ? head[c][r0 + g + 8] : 0u;
  f.rest[0] = live ? rest[c][r0 + g] : 0u;
  f.rest[1] = live ? rest[c][r0 + g + 8] : 0u;
  f.head[2] = f.head[3] = f.rest[2] = f.rest[3] = 0u;
  return f;
}

// The right operand of the cross term: column c0 + g of a tile's
// coordinates, component t along the contraction.
__device__ __forceinline__ SplitFrag<2> col_operand(
    const uint32_t (&head)[3][kTile], const uint32_t (&rest)[3][kTile],
    int c0, int g, int t) {
  SplitFrag<2> f;
  const bool live = t < 3;
  const int c = live ? t : 0;
  f.head[0] = live ? head[c][c0 + g] : 0u;
  f.rest[0] = live ? rest[c][c0 + g] : 0u;
  f.head[1] = f.rest[1] = 0u;
  return f;
}

// What a warp keeps of its 16 rows while it walks the columns.
struct WarpRows {
  SplitFrag<4> a;
  SplitFrag<4> b;
  int r0;
};

__device__ __forceinline__ WarpRows warp_rows(const Tile& rows, int r0, int g,
                                              int t) {
  return {row_operand(rows.a_head, rows.a_rest, r0, g, t),
          row_operand(rows.b_head, rows.b_rest, r0, g, t), r0};
}

// Clamped squared distances of a and b for the thread's four entries
// e = 0 .. 3 of the 16 x 8 block at rows w.r0 .., columns c0 ..: entry e is
// (row w.r0 + g + 8 (e / 2), column c0 + 2 t + e % 2).
__device__ __forceinline__ void d2_block(const Tile& rows, const Tile& cols,
                                         const WarpRows& w, int c0, int g,
                                         int t, float (&d2a)[4],
                                         float (&d2b)[4]) {
  float cross_a[4] = {0.f, 0.f, 0.f, 0.f};
  float cross_b[4] = {0.f, 0.f, 0.f, 0.f};
  mma_split(cross_a, w.a, col_operand(cols.a_head, cols.a_rest, c0, g, t));
  mma_split(cross_b, w.b, col_operand(cols.b_head, cols.b_rest, c0, g, t));
  for (int e = 0; e < 4; ++e) {
    const int row = w.r0 + g + 8 * (e >> 1);
    const int col = c0 + 2 * t + (e & 1);
    d2a[e] = fmaxf((rows.na[row] + cols.na[col]) - 2.f * cross_a[e],
                   kDistClamp);
    d2b[e] = fmaxf((rows.nb[row] + cols.nb[col]) - 2.f * cross_b[e],
                   kDistClamp);
  }
}

// Both tiles of a block staged by its two groups of kTile threads: threads
// [0, kTile) the column tile tj, the others the row tile ti.
__device__ __forceinline__ void stage_pair(Tile& row_tile, Tile& col_tile,
                                           int ti, int tj,
                                           const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           const uint8_t* __restrict__ mask,
                                           size_t base, int n) {
  const int tid = threadIdx.x;
  if (tid < kTile) {
    stage_atom(col_tile, tid, tj, a, b, mask, base, n);
  } else {
    stage_atom(row_tile, tid - kTile, ti, a, b, mask, base, n);
  }
  __syncthreads();
}

// ---------------------------------------------------------------- K4b

__global__ void __launch_bounds__(kThreads)
mxu_tile_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const uint8_t* __restrict__ mask, int n, int n_tiles,
                int n_pairs, float* __restrict__ part_s,
                int* __restrict__ part_c) {
  const int pair = blockIdx.x;
  const int prot = blockIdx.y;
  int ti, tj;
  unrank_pair(pair, n_tiles, &ti, &tj);

  __shared__ Tile row_tile;
  __shared__ Tile col_tile;
  __shared__ float red_s[kWarps];
  __shared__ int red_c[kWarps];

  stage_pair(row_tile, col_tile, ti, tj, a, b, mask,
             static_cast<size_t>(prot) * n, n);

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const WarpRows w = warp_rows(row_tile, (threadIdx.x >> 5) * 16, g, t);

  float s = 0.f;
  int cnt = 0;
  for (int c0 = 0; c0 < kTile; c0 += 8) {
    float d2a[4], d2b[4];
    d2_block(row_tile, col_tile, w, c0, g, t, d2a, d2b);
    for (int e = 0; e < 4; ++e) {
      const int row = w.r0 + g + 8 * (e >> 1);
      const int col = c0 + 2 * t + (e & 1);
      if (row_tile.m[row] && col_tile.m[col] &&
          ti * kTile + row < tj * kTile + col) {
        s += pair_term(d2a[e], d2b[e]);
        cnt += 1;
      }
    }
  }
  block_stat_partial(s, cnt, red_s, red_c, part_s, part_c,
                     static_cast<size_t>(prot) * n_pairs + pair);
}

// ---------------------------------------------------------------- K4c

// One sweep of a tile pair: the atoms of `rows` as the rows of coef, those
// of `cols` as its columns. Writes x_r rowsum(coef) - coef x_c for the 16
// rows of every warp into part (3, kTile). A pair counts where both atoms
// are unmasked and the atom of the row tile (ti) comes before the atom of
// the column tile (tj) in the protein: kRowsFirst says whether `rows` is the
// row tile.
template <bool kRowsFirst>
__device__ __forceinline__ void grad_sweep(const Tile& rows, const Tile& cols,
                                           int row_base, int col_base,
                                           float* __restrict__ part) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const WarpRows w = warp_rows(rows, (threadIdx.x >> 5) * 16, g, t);

  // coef x_c, entry e at (row g + 8 (e / 2), component 2 t + e % 2)
  float m[4] = {0.f, 0.f, 0.f, 0.f};
  // this thread's share of the sums of rows g and g + 8
  float sum_lo = 0.f, sum_hi = 0.f;
  for (int c0 = 0; c0 < kTile; c0 += 8) {
    float d2a[4], d2b[4];
    d2_block(rows, cols, w, c0, g, t, d2a, d2b);
    float coef[4];
    for (int e = 0; e < 4; ++e) {
      const int row = w.r0 + g + 8 * (e >> 1);
      const int col = c0 + 2 * t + (e & 1);
      const int gr = row_base + row;
      const int gc = col_base + col;
      const bool counts = rows.m[row] && cols.m[col] &&
                          (kRowsFirst ? gr < gc : gc < gr);
      coef[e] = counts ? 2.f * (1.f - sqrtf(d2b[e]) * rsqrtf(d2a[e])) : 0.f;
    }
    sum_lo += coef[0] + coef[1];
    sum_hi += coef[2] + coef[3];
    // coef as the left operand: k = t is column 2t, k = t + 4 is column
    // 2t + 1; the right operand's rows follow that order
    SplitFrag<4> left;
    split_tf32(coef[0], &left.head[0], &left.rest[0]);
    split_tf32(coef[2], &left.head[1], &left.rest[1]);
    split_tf32(coef[1], &left.head[2], &left.rest[2]);
    split_tf32(coef[3], &left.head[3], &left.rest[3]);
    SplitFrag<2> right;
    const bool live = g < 3;
    const int c = live ? g : 0;
    const int col = c0 + 2 * t;
    right.head[0] = live ? cols.a_head[c][col] : 0u;
    right.rest[0] = live ? cols.a_rest[c][col] : 0u;
    right.head[1] = live ? cols.a_head[c][col + 1] : 0u;
    right.rest[1] = live ? cols.a_rest[c][col + 1] : 0u;
    mma_split(m, left, right);
  }
  for (int off = 1; off < 4; off <<= 1) {
    sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, off);
    sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, off);
  }
  for (int e = 0; e < 4; ++e) {
    const int c = 2 * t + (e & 1);
    const int row = w.r0 + g + 8 * (e >> 1);
    if (c < 3) {
      part[c * kTile + row] =
          rows.xa[c][row] * ((e >> 1) ? sum_hi : sum_lo) - m[e];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
mxu_grad_tile_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     const uint8_t* __restrict__ mask, int n, int n_tiles,
                     int n_pairs, float* __restrict__ part_row,
                     float* __restrict__ part_col) {
  const int pair = blockIdx.x;
  const int prot = blockIdx.y;
  int ti, tj;
  unrank_pair(pair, n_tiles, &ti, &tj);

  __shared__ Tile row_tile;
  __shared__ Tile col_tile;

  stage_pair(row_tile, col_tile, ti, tj, a, b, mask,
             static_cast<size_t>(prot) * n, n);
  const size_t slot = static_cast<size_t>(prot) * n_pairs + pair;
  grad_sweep<true>(row_tile, col_tile, ti * kTile, tj * kTile,
                   part_row + slot * 3 * kTile);
  grad_sweep<false>(col_tile, row_tile, tj * kTile, ti * kTile,
                    part_col + slot * 3 * kTile);
}

bool bad_shape(int batch, int n) {
  return batch <= 0 || n <= 0 || batch > 65535;
}

// One (S, C) tile kernel over every tile pair of every protein, then the
// per-protein sum of its partials.
using StatsKernel = void (*)(const float*, const float*, const uint8_t*, int,
                             int, int, float*, int*);

int launch_stats(StatsKernel kernel, const float* a, const float* b,
                 const uint8_t* mask, int batch, int n, float* part_s,
                 int* part_c, float* out_s, long long* out_c, void* stream) {
  if (bad_shape(batch, n)) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (n + kTile - 1) / kTile;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<dim3(n_pairs, batch), kThreads, 0, s>>>(a, b, mask, n, n_tiles,
                                                   n_pairs, part_s, part_c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stat_reduce_kernel<<<batch, kReduceThreads, 0, s>>>(part_s, part_c,
                                                      n_pairs, out_s, out_c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int drmsd_variants_tile() { return kTile; }

const char* drmsd_variants_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K4a. a, b: (batch, n, 3) float32, contiguous. mask: (batch, n) uint8 0/1.
// part_s, part_c: (batch, n_pairs) scratch, n_pairs = T (T + 1) / 2 with
// T = ceil(n / drmsd_variants_tile()). out_s: (batch,) float32, out_c:
// (batch,) int64. Launches on `stream`; returns the CUDA error code (0 on
// success).
int drmsd_fwd_sqrt1(const float* a, const float* b, const uint8_t* mask,
                    int batch, int n, float* part_s, int* part_c,
                    float* out_s, long long* out_c, void* stream) {
  return launch_stats(sqrt1_tile_kernel, a, b, mask, batch, n, part_s, part_c,
                      out_s, out_c, stream);
}

// K4b. Arguments as for drmsd_fwd_sqrt1.
int drmsd_fwd_mxu(const float* a, const float* b, const uint8_t* mask,
                  int batch, int n, float* part_s, int* part_c, float* out_s,
                  long long* out_c, void* stream) {
  return launch_stats(mxu_tile_kernel, a, b, mask, batch, n, part_s, part_c,
                      out_s, out_c, stream);
}

// K4c. a, b, mask as above; part_row, part_col: (batch, n_pairs, 3, tile)
// scratch; out_g: (batch, n, 3) float32, dS/da.
int drmsd_grad_a_mxu(const float* a, const float* b, const uint8_t* mask,
                     int batch, int n, float* part_row, float* part_col,
                     float* out_g, void* stream) {
  if (bad_shape(batch, n)) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (n + kTile - 1) / kTile;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mxu_grad_tile_kernel<<<dim3(n_pairs, batch), kThreads, 0, s>>>(
      a, b, mask, n, n_tiles, n_pairs, part_row, part_col);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  grad_gather_kernel<<<dim3(n_tiles, batch), kTile, 0, s>>>(
      part_row, part_col, n, n_tiles, n_pairs, out_g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
