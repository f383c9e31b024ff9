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
// What bounds them on Hopper: arithmetic a pair. K4a's one sqrtf ties
// K1a's two rsqrt; K4b and K4c take two special functions a pair (19.8 us
// for the bench's 41,475,020 pairs at B=8 x 3584). Their matrix products
// are 3 deep (the cross terms) or 3 wide (K4c's coef . x), so the tensor
// cores run at 3/8 of a tile at best, and what is left per pair on the CUDA
// cores (the norms' sum, the clamp, the roots, the mask, and for the split
// two conversions an operand) is of the order of K1's work.
//
// K4a and K4b: grid = (upper-triangular tile pairs,
// proteins), 128 x 128 tile pairs staged with their masks, an integer pair
// count, per-block (S, C) partials summed per protein in a fixed order
// (drmsd_common.cuh). K4b's products run on the tensor cores with
// mma.sync.aligned.m16n8k8 in TF32, the contraction padded from 3 to 8
// with zeros. Plain TF32 keeps ~3 digits, and with coordinates of tens of
// A the cross term is ~10^3 A^2 while a pair's term is ~1 A^2. So every
// operand is split into a TF32 head and a TF32 remainder, and a product is
// three TF32 products, remainder x head, head x remainder and head x head,
// summed in fp32 in that order: what Precision.HIGHEST does on the TPU with
// bf16 passes (mma_tf32.cuh). A warp owns 16 rows of the tile pair and
// walks its 16 column groups of 8.
//
// K4c is built on K1's body (drmsd_common.cuh), so that beside K1b it
// differs only in the form of the term:
//   * K1's grid, its compaction of each tile's valid atoms as they are
//     staged (compact: warp ballot + popcount prefix, tile order kept; a
//     diagonal tile pair counts compacted row < column), K1's (3, 128) row
//     and column partials per tile pair in tile positions (every block
//     writes its partials, zeros included) and K1's epilogue
//     (k1_epilogue_kernel: per atom its row partials, then its column
//     partials, in ascending order). No float atomics: the same bits on
//     every call.
//   * a compacted tile is staged in the layouts its products read: per atom
//     and component one 16-byte word of the split a and b (the cross term's
//     operands), per pair of atoms and component the split a of both (the
//     right operand of coef . a_j in acc_as_left's row order), the fp32 a
//     and both squared norms. Slots past the count are zeros.
//   * one sweep: warp w owns compacted rows 16 w .. 16 w + 15 and walks the
//     valid columns in blocks of 16; each pair's two cross terms, squared
//     distances and coef (sqrt.approx and rsqrt.approx: two special
//     functions) are computed once. The row partial a_i rowsum(coef) -
//     coef a_j accumulates over the blocks: coef leaves its accumulators
//     straight in as the left operand (acc_as_left).
//   * the column partial a_j colsum(coef) - coef^T a_i needs coef
//     transposed: a product's contraction runs over the index its
//     accumulator spreads across a quad (the columns), never over the one
//     it spreads across quads (the rows). Of the two ways, quad shuffles
//     into the left-operand layout (two shuffles and a select a register)
//     or coef as the right operand of a second product (which needs the
//     same transpose), the block of 16 x 16 goes through the warp's own
//     scratch in shared memory instead: two 8-byte writes and four 4-byte
//     reads a lane for each 8 rows, conflict-free with a row stride of 24
//     words, then coef^T is the left operand with 16 columns as its rows:
//     6 TF32 products for 256 pairs, where coef as a right operand would
//     fill 3 of its 16 rows and take twice as many.
//   * the row and column sums come from the same products: the right
//     operands carry ones in their fourth column (head 1, rest 0).
//   * the column partials of a block's eight warps are summed in warp
//     order when the block writes its partials.
// Device time on an NVIDIA H100 80GB HBM3 at 700 W
// (tools/bench_drmsd_kernel.py, PERF.md section 6): K4c 0.139-0.140 ms at
// B=8 x 3584 atoms (a loop of two sweeps a tile pair without compaction:
// 0.261-0.263 in the same call), 1.45x K1b's 0.096, which also gives S
// and C; K4a 0.085, K4b 0.111 beside K1a's 0.058. What holds K4c back is
// not its products: 24 TF32 products a block of 16 x 16 pairs, 3.9
// million for the bench's 41,475,020 pairs, take 25 us at the rate
// mma.sync reaches on the card (tools/bench_mma.py), a fifth of its time,
// at 24 warps an SM (66 registers, 54 KB of shared memory a block); each
// warp's row partial accumulates through the products of every column
// block, and the transpose adds two warp barriers a block.

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

// One staged tile of kTile atoms (K4b): the split coordinates of a and b,
// the squared norms and the mask. Atoms beyond n are zeros with the mask
// off.
struct Tile {
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

// One tile's valid atoms, compacted in tile order as K1 compacts them, in
// the layouts that K4c's products read. Slots past the count hold zeros.
constexpr int kPairStride = kTile / 2 + 4;  // 4 mod 8 words of 16 bytes
struct MxuTile {
  // per component c (c = 3: zeros): {head a_c, rest a_c, head b_c, rest b_c}
  uint4 x[kTile][4];
  // per component c < 3 and pair p of atoms 2p, 2p + 1:
  // {head a_c(2p), head a_c(2p + 1), rest a_c(2p), rest a_c(2p + 1)}
  uint4 a2[3][kPairStride];
  float4 a[kTile];     // a_x, a_y, a_z, 0
  float2 norm[kTile];  // |a|^2, |b|^2
  short idx[kTile];    // compacted index of each tile position, -1: masked
};

// Row stride of a warp's coef scratch [16][kCoefStride]: 8 mod 32 words, so
// that its 8-byte writes and its transposed 4-byte reads hit 32 banks.
constexpr int kCoefStride = 24;

struct MxuShared {
  MxuTile tiles[2];  // [0] the column tile tj, [1] the rows
  float coef[kWarps][16 * kCoefStride];
  float red_row[3][kTile];          // row partials by compacted row
  float red_col[kWarps][3][kTile];  // each warp's column partials
  int warp_count[kWarps];
};

__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float rsqrt_approx(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// Compacted slot k of `tile` from one atom's coordinates; zeros for
// coordinates of zero (the slots past the count).
__device__ __forceinline__ void put_atom(MxuTile& tile, int k,
                                         const float (&xa)[3],
                                         const float (&xb)[3]) {
  uint32_t* a2 = reinterpret_cast<uint32_t*>(&tile.a2[0][k >> 1]);
  for (int c = 0; c < 3; ++c) {
    uint4 w;
    split_tf32(xa[c], &w.x, &w.y);
    split_tf32(xb[c], &w.z, &w.w);
    tile.x[k][c] = w;
    a2[c * kPairStride * 4 + (k & 1)] = w.x;
    a2[c * kPairStride * 4 + 2 + (k & 1)] = w.y;
  }
  tile.x[k][3] = make_uint4(0u, 0u, 0u, 0u);
  tile.a[k] = make_float4(xa[0], xa[1], xa[2], 0.f);
  tile.norm[k] = make_float2(
      fmaf(xa[2], xa[2], fmaf(xa[1], xa[1], xa[0] * xa[0])),
      fmaf(xb[2], xb[2], fmaf(xb[1], xb[1], xb[0] * xb[0])));
}

// Warp w's share of one sweep: compacted rows 16 w .. 16 w + 15 against
// every column, each pair's coef computed once. Writes the rows' partials
// a_i rowsum(coef) - coef a_j into red_row and, per block of 16 columns,
// a_j colsum(coef) - coef^T a_i into red_col[w]. kDiag: rows and columns
// are one tile, and only compacted row < column counts.
template <bool kDiag>
__device__ __forceinline__ void mxu_grad_sweep(MxuShared& sh,
                                               const MxuTile& rows,
                                               const MxuTile& cols, int nr,
                                               int nc) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * w;
  const uint32_t one = __float_as_uint(1.f);
  // the cross terms' left operands: rows r0 + g, r0 + g + 8, component t
  const uint4 lo = rows.x[r0 + g][t], hi = rows.x[r0 + g + 8][t];
  const SplitFrag<4> ra{{lo.x, hi.x, 0u, 0u}, {lo.y, hi.y, 0u, 0u}};
  const SplitFrag<4> rb{{lo.z, hi.z, 0u, 0u}, {lo.w, hi.w, 0u, 0u}};
  const float2 n_lo = rows.norm[r0 + g], n_hi = rows.norm[r0 + g + 8];
  // coef^T a_i's right operand: component g of rows r0 + 8 kk + t and
  // + t + 4; for g = 3 ones, which make column 3 the column sums
  SplitFrag<2> ai[2];
  for (int kk = 0; kk < 2; ++kk)
    for (int q = 0; q < 2; ++q) {
      const uint4 x = rows.x[r0 + 8 * kk + t + 4 * q][g < 3 ? g : 0];
      ai[kk].head[q] = g < 3 ? x.x : g == 3 ? one : 0u;
      ai[kk].rest[q] = g < 3 ? x.y : 0u;
    }
  float* scratch = sh.coef[w];
  // coef a_j: (row g, components 2t, 2t + 1), (row g + 8, ...); column 3
  // is the row sums
  float m_row[4] = {0.f, 0.f, 0.f, 0.f};
  for (int cb = kDiag ? w : 0; 16 * cb < nc; ++cb) {
    float coef[2][4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c0 = 16 * cb + 8 * hh;
      const uint4 xc = cols.x[c0 + g][t];
      float cross_a[4] = {0.f, 0.f, 0.f, 0.f};
      float cross_b[4] = {0.f, 0.f, 0.f, 0.f};
      mma_split(cross_a, ra, SplitFrag<2>{{xc.x, 0u}, {xc.y, 0u}});
      mma_split(cross_b, rb, SplitFrag<2>{{xc.z, 0u}, {xc.w, 0u}});
      // |a|^2, |b|^2 of columns c0 + 2t and c0 + 2t + 1
      const float4 nc2 =
          *reinterpret_cast<const float4*>(&cols.norm[c0 + 2 * t]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + 8 * (e >> 1);
        const int col = c0 + 2 * t + (e & 1);
        const float2 nr2 = (e >> 1) ? n_hi : n_lo;
        const float d2a = fmaxf(
            (nr2.x + ((e & 1) ? nc2.z : nc2.x)) - 2.f * cross_a[e],
            kDistClamp);
        const float d2b = fmaxf(
            (nr2.y + ((e & 1) ? nc2.w : nc2.y)) - 2.f * cross_b[e],
            kDistClamp);
        const bool counts = row < nr && col < nc && (!kDiag || row < col);
        coef[hh][e] =
            counts ? 2.f * (1.f - sqrt_approx(d2b) * rsqrt_approx(d2a))
                   : 0.f;
      }
      // coef a_j: coef from its accumulators as the left operand (column
      // 2t as k = t, 2t + 1 as k = t + 4), a_j's rows in that order
      SplitFrag<2> aj{{0u, 0u}, {0u, 0u}};
      if (g < 3) {
        const uint4 x = cols.a2[g][c0 / 2 + t];
        aj = SplitFrag<2>{{x.x, x.y}, {x.z, x.w}};
      } else if (g == 3) {
        aj.head[0] = aj.head[1] = one;
      }
      mma_split(m_row, acc_as_left(coef[hh]), aj);
    }
    // coef^T a_i: the 16 x 16 coef block through the warp's scratch, read
    // back transposed as the left operand (columns as its rows)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(scratch + (g + 8 * i) * kCoefStride +
                                   8 * hh + 2 * t) =
            make_float2(coef[hh][2 * i], coef[hh][2 * i + 1]);
    __syncwarp();
    float m_col[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const float* p = scratch + (8 * kk + t) * kCoefStride + g;
      SplitFrag<4> a;
      split_tf32(p[0], &a.head[0], &a.rest[0]);
      split_tf32(p[8], &a.head[1], &a.rest[1]);
      split_tf32(p[4 * kCoefStride], &a.head[2], &a.rest[2]);
      split_tf32(p[4 * kCoefStride + 8], &a.head[3], &a.rest[3]);
      mma_split(m_col, a, ai[kk]);
    }
    __syncwarp();
    // (column g, components 2t, 2t + 1), (column g + 8, ...): lane t = 1
    // holds component 2 and the column sums
    const int src = (lane & ~3) | 1;
    const float sum_lo = __shfl_sync(0xffffffffu, m_col[1], src);
    const float sum_hi = __shfl_sync(0xffffffffu, m_col[3], src);
    if (t < 2) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = 16 * cb + g + 8 * i;
        if (col >= nc) continue;
        const float4 x = cols.a[col];
        const float sum = i ? sum_hi : sum_lo;
        if (t == 0) {
          sh.red_col[w][0][col] = x.x * sum - m_col[2 * i];
          sh.red_col[w][1][col] = x.y * sum - m_col[2 * i + 1];
        } else {
          sh.red_col[w][2][col] = x.z * sum - m_col[2 * i];
        }
      }
    }
  }
  const int src = (lane & ~3) | 1;
  const float sum_lo = __shfl_sync(0xffffffffu, m_row[1], src);
  const float sum_hi = __shfl_sync(0xffffffffu, m_row[3], src);
  if (t < 2) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + g + 8 * i;
      if (row >= nr) continue;
      const float4 x = rows.a[row];
      const float sum = i ? sum_hi : sum_lo;
      if (t == 0) {
        sh.red_row[0][row] = x.x * sum - m_row[2 * i];
        sh.red_row[1][row] = x.y * sum - m_row[2 * i + 1];
      } else {
        sh.red_row[2][row] = x.z * sum - m_row[2 * i];
      }
    }
  }
}

// K4c's tile kernel: grid (upper-triangular tile pairs, proteins), K1's
// staging with compaction, one sweep, and K1's (3, kTile) row and column
// partials per tile pair (zeros for masked positions and for a block
// without a pair). sizeof(MxuShared) of dynamic shared memory.
__global__ void __launch_bounds__(kThreads)
mxu_grad_tile_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     const uint8_t* __restrict__ mask, int n, int n_tiles,
                     int n_pairs, float* __restrict__ part_row,
                     float* __restrict__ part_col) {
  extern __shared__ float4 mxu_dynamic[];
  MxuShared& sh = *reinterpret_cast<MxuShared*>(mxu_dynamic);
  const int pair = blockIdx.x;
  const int prot = blockIdx.y;
  int ti, tj;
  unrank_pair(pair, n_tiles, &ti, &tj);
  const bool diag = ti == tj;

  const int tid = threadIdx.x;
  const int group = tid / kTile;
  const int pos = tid % kTile;
  const bool stages = group == 0 || !diag;
  const int atom = (group == 0 ? tj : ti) * kTile + pos;
  const size_t base = static_cast<size_t>(prot) * n;
  float xa[3] = {0.f, 0.f, 0.f}, xb[3] = {0.f, 0.f, 0.f};
  bool ok = false;
  if (stages && atom < n) {
    ok = mask[base + atom] != 0;
    for (int c = 0; c < 3; ++c) {
      xa[c] = a[(base + atom) * 3 + c];
      xb[c] = b[(base + atom) * 3 + c];
    }
  }
  float* red_col = &sh.red_col[0][0][0];
  for (int e = tid; e < kWarps * 3 * kTile; e += kThreads) red_col[e] = 0.f;
  const Compacted cp = compact(ok, diag, sh.warp_count);
  MxuTile& mine = sh.tiles[group];
  if (stages) {
    const int count = group == 0 ? cp.nc : cp.nr;
    if (ok) put_atom(mine, cp.k, xa, xb);
    if (pos >= count) {
      const float zero[3] = {0.f, 0.f, 0.f};
      put_atom(mine, pos, zero, zero);
    }
    mine.idx[pos] = ok ? cp.k : -1;
  }
  __syncthreads();

  const size_t slot = static_cast<size_t>(prot) * n_pairs + pair;
  float* row_out = part_row + slot * 3 * kTile;
  float* col_out = part_col + slot * 3 * kTile;
  if (cp.nr == 0 || cp.nc == 0) {
    for (int e = tid; e < 3 * kTile; e += kThreads) {
      row_out[e] = 0.f;
      col_out[e] = 0.f;
    }
    return;
  }
  const MxuTile& rows = sh.tiles[diag ? 0 : 1];
  const MxuTile& cols = sh.tiles[0];
  if (16 * (tid >> 5) < cp.nr) {
    if (diag)
      mxu_grad_sweep<true>(sh, rows, cols, cp.nr, cp.nc);
    else
      mxu_grad_sweep<false>(sh, rows, cols, cp.nr, cp.nc);
  }
  __syncthreads();
  // tile positions: each warp's column partials summed in warp order
  for (int e = tid; e < 3 * kTile; e += kThreads) {
    const int c = e / kTile, p = e % kTile;
    const int kr = rows.idx[p], kc = cols.idx[p];
    row_out[e] = kr >= 0 ? sh.red_row[c][kr] : 0.f;
    float v = 0.f;
    if (kc >= 0) {
      for (int w = 0; w < kWarps; ++w) v += sh.red_col[w][c][kc];
    }
    col_out[e] = v;
  }
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
  cudaError_t err = cudaFuncSetAttribute(
      mxu_grad_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      sizeof(MxuShared));
  if (err != cudaSuccess) return static_cast<int>(err);
  mxu_grad_tile_kernel<<<dim3(n_pairs, batch), kThreads, sizeof(MxuShared),
                         s>>>(a, b, mask, n, n_tiles, n_pairs, part_row,
                              part_col);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k1_epilogue_kernel<false, true><<<dim3(n_tiles, batch), kEpilogueThreads,
                                    0, s>>>(nullptr, nullptr, part_row,
                                            part_col, n, n_tiles, n_pairs,
                                            nullptr, nullptr, out_g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
