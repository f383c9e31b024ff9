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
// What bounds them on Hopper: arithmetic a pair. K4a and K4b take one
// square root a pair (9.92 us for the bench's 41,475,020 pairs at B=8 x
// 3584), K4c a square root and an rsqrt (19.8 us). K4a's 24 fp32
// operations a pair take longer (14.9 us): it is bound by operations, K4b
// (14 a pair, 8.67 us) and K4c by the special-function unit. Their matrix
// products are 3 deep (the cross terms) or 3 wide (K4c's coef . x), so the
// tensor cores run at 3/8 of a tile at best, and what is left per pair on
// the CUDA cores (the norms' sum, the clamp, the roots, and for the split
// two conversions an operand) is of the order of K1's work.
//
// All three are built on K1's body (drmsd_common.cuh), so that beside K1
// each differs only in the form of the term:
//   * K1's grid (upper-triangular 128 x 128 tile pairs, proteins), its
//     compaction of each tile's valid atoms as they are staged (compact:
//     warp ballot + popcount prefix, tile order kept; a diagonal tile pair
//     counts compacted row < column), the integer pair count nr nc, or
//     nr (nr - 1) / 2 on the diagonal, and K1's epilogue
//     (k1_epilogue_kernel: the (S, C) partials of a protein summed in
//     double in a fixed order; for K4c per atom its row partials, then its
//     column partials, in ascending order). Every block writes its
//     partials, zeros included. No float atomics: the same bits on every
//     call.
//   * K4a is a fourth instance of K1's kernel, k1_tile_kernel<false, true,
//     true>: 16 x 16 threads each own up to 8 compacted rows and 8 columns,
//     swept in two passes of 4 columns held in registers, loop bounds from
//     the counts, and per pair the two squared distances in difference form
//     and the one-root term, all with explicitly rounded intrinsics. K1's
//     own instances compile as before: the term is a template choice.
//   * K4b and K4c stage a compacted tile in the layouts their products
//     read: per atom and component one 16-byte word of the split a and b
//     (the cross term's operands) and both squared norms; K4c also per pair
//     of atoms and component the split a of both (the right operand of
//     coef . a_j in acc_as_left's row order) and the fp32 a. Slots past the
//     count are zeros.
//   * The products run on the tensor cores with mma.sync.aligned.m16n8k8
//     in TF32, the contraction padded from 3 to 8 with zeros. Plain TF32
//     keeps ~3 digits, and with coordinates of tens of A the cross term is
//     ~10^3 A^2 while a pair's term is ~1 A^2. So every operand is split
//     into a TF32 head and a TF32 remainder, and a product is three TF32
//     products, remainder x head, head x remainder and head x head, summed
//     in fp32 in that order: what Precision.HIGHEST does on the TPU with
//     bf16 passes (mma_tf32.cuh).
//   * one sweep: warp w owns compacted rows 16 w .. 16 w + 15 (warps with
//     no valid row do nothing) and walks the valid columns in blocks of 16,
//     on a diagonal tile pair from its own block on; each pair's term is
//     computed once.
//   * K4b: the row norms stay in registers, the column norms are one float4
//     load and the right operands one uint4 load per 8 columns, and the
//     four cross-term products of a block of 16 columns (a and b, two
//     halves: four independent chains of three mma.sync) are issued term by
//     term before their epilogue. An entry counts where its column is
//     below nc (off the diagonal, and its row below nr), on the diagonal
//     where row < column < nc: no mask is read in the sweep.
//   * K4c: coef (sqrt.approx and rsqrt.approx: two special functions). The
//     row partial a_i rowsum(coef) - coef a_j accumulates over the blocks:
//     coef leaves its accumulators straight in as the left operand
//     (acc_as_left).
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
// (tools/bench_drmsd_kernel.py, PERF.md section 6), at B=8 x 3584 atoms:
// K4a 0.072-0.073 ms and K4b 0.079 beside K1a's 0.058 (the loops of one
// thread a row, or of a warp over every entry of the tile pair with its
// mask, before them: 0.085 and 0.112 in the same call). Both pay for the
// IEEE root's fix-up over K1a's two rsqrt.approx; K4b with sqrt.approx
// instead took 0.063 but missed the 1e-5 gate on S (6.7e-5: the root's
// error, ~10^3 times the term that the form cancels down to). K4c
// 0.139-0.140 ms (a loop of two sweeps a tile pair without compaction:
// 0.261-0.263 in the same call), 1.45x K1b's 0.096, which also gives S
// and C. What holds K4c back is not its products: 24 TF32 products a block
// of 16 x 16 pairs, 3.9 million for the bench's 41,475,020 pairs, take 25
// us at the rate mma.sync reaches on the card (tools/bench_mma.py), a
// fifth of its time, at 24 warps an SM (66 registers, 54 KB of shared
// memory a block); each warp's row partial accumulates through the
// products of every column block, and the transpose adds two warp barriers
// a block.

#include "drmsd_common.cuh"
#include "mma_tf32.cuh"

using namespace drmsd;
using namespace tf32;

namespace {

// to_tf32, mma_tf32, SplitFrag, split_tf32 and mma_split: mma_tf32.cuh.

// ------------------------------------------------- the matrix-unit form

// One tile's valid atoms, compacted in tile order as K1 compacts them, in
// the layouts that the products read: K4b reads x and norm, K4c all of it.
// Slots past the count hold zeros.
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

// The cross terms' operands and the squared norms of compacted slot k of
// `tile`, from one atom's coordinates; zeros for coordinates of zero (the
// slots past the count).
__device__ __forceinline__ void put_split(MxuTile& tile, int k,
                                          const float (&xa)[3],
                                          const float (&xb)[3]) {
  for (int c = 0; c < 3; ++c) {
    uint4 w;
    split_tf32(xa[c], &w.x, &w.y);
    split_tf32(xb[c], &w.z, &w.w);
    tile.x[k][c] = w;
  }
  tile.x[k][3] = make_uint4(0u, 0u, 0u, 0u);
  tile.norm[k] = make_float2(
      fmaf(xa[2], xa[2], fmaf(xa[1], xa[1], xa[0] * xa[0])),
      fmaf(xb[2], xb[2], fmaf(xb[1], xb[1], xb[0] * xb[0])));
}

// put_split and what K4c reads besides: the split a in pairs and the fp32 a.
__device__ __forceinline__ void put_atom(MxuTile& tile, int k,
                                         const float (&xa)[3],
                                         const float (&xb)[3]) {
  put_split(tile, k, xa, xb);
  uint32_t* a2 = reinterpret_cast<uint32_t*>(&tile.a2[0][k >> 1]);
  for (int c = 0; c < 3; ++c) {
    uint32_t head, rest;
    split_tf32(xa[c], &head, &rest);
    a2[c * kPairStride * 4 + (k & 1)] = head;
    a2[c * kPairStride * 4 + 2 + (k & 1)] = rest;
  }
  tile.a[k] = make_float4(xa[0], xa[1], xa[2], 0.f);
}

// Stage one atom as K1 does: threads [0, kTile) of a block the column tile
// tj, the others the row tile ti (none on a diagonal tile pair, whose rows
// are its columns). Reads the mask and the coordinates together, one round
// trip; returns whether the thread's atom is valid.
__device__ __forceinline__ bool load_atom(const float* __restrict__ a,
                                          const float* __restrict__ b,
                                          const uint8_t* __restrict__ mask,
                                          int n, size_t base, int atom,
                                          bool stages, float (&xa)[3],
                                          float (&xb)[3]) {
  for (int c = 0; c < 3; ++c) xa[c] = xb[c] = 0.f;
  if (!stages || atom >= n) return false;
  for (int c = 0; c < 3; ++c) {
    xa[c] = a[(base + atom) * 3 + c];
    xb[c] = b[(base + atom) * 3 + c];
  }
  return mask[base + atom] != 0;
}

// ---------------------------------------------------------------- K4b

// Warp w's share of K4b's sweep: compacted rows 16 w .. 16 w + 15 against
// the columns in blocks of 16, each pair's term computed once; returns the
// lane's share of S. kDiag: rows and columns are one tile, only compacted
// row < column counts, and the blocks wholly below the warp's rows are
// skipped.
template <bool kDiag>
__device__ __forceinline__ float mxu_stat_sweep(const MxuTile& rows,
                                                const MxuTile& cols, int nr,
                                                int nc) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * w;
  // the left operands of a's and b's cross terms: rows r0 + g, r0 + g + 8,
  // component t; and those rows' squared norms
  const uint4 lo = rows.x[r0 + g][t], hi = rows.x[r0 + g + 8][t];
  const SplitFrag<4> left[2] = {{{lo.x, hi.x, 0u, 0u}, {lo.y, hi.y, 0u, 0u}},
                                {{lo.z, hi.z, 0u, 0u}, {lo.w, hi.w, 0u, 0u}}};
  const float2 n_row[2] = {rows.norm[r0 + g], rows.norm[r0 + g + 8]};
  // a column counts for row r0 + g + 8 i below lim[i]: nc for a valid row,
  // 0 for one past nr; on the diagonal row < column < nc = nr covers both
  int lim[2];
  for (int i = 0; i < 2; ++i) lim[i] = kDiag || r0 + g + 8 * i < nr ? nc : 0;
  float s = 0.f;
  for (int cb = kDiag ? w : 0; 16 * cb < nc; ++cb) {
    // the right operands, q = 2 hh + (0: a, 1: b): columns 16 cb + 8 hh + g,
    // component t; the squared norms of columns 16 cb + 8 hh + 2 t, + 1
    SplitFrag<2> right[4];
    float4 n_col[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c0 = 16 * cb + 8 * hh;
      const uint4 x = cols.x[c0 + g][t];
      right[2 * hh] = SplitFrag<2>{{x.x, 0u}, {x.y, 0u}};
      right[2 * hh + 1] = SplitFrag<2>{{x.z, 0u}, {x.w, 0u}};
      n_col[hh] = *reinterpret_cast<const float4*>(&cols.norm[c0 + 2 * t]);
    }
    // four independent chains of mma_split's three products, issued term by
    // term so that each product's latency overlaps the other chains'
    float cross[4][4] = {};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      mma_tf32(cross[q], left[q & 1].rest, right[q].head);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      mma_tf32(cross[q], left[q & 1].head, right[q].rest);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      mma_tf32(cross[q], left[q & 1].head, right[q].head);
    // entry e of half hh: row r0 + g + 8 (e / 2), column
    // 16 cb + 8 hh + 2 t + e % 2
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int row = r0 + g + 8 * i;
        const int col = 16 * cb + 8 * hh + 2 * t + (e & 1);
        const float na = (e & 1) ? n_col[hh].z : n_col[hh].x;
        const float nb = (e & 1) ? n_col[hh].w : n_col[hh].y;
        const float d2a = fmaxf(
            fmaf(-2.f, cross[2 * hh][e], n_row[i].x + na), kDistClamp);
        const float d2b = fmaxf(
            fmaf(-2.f, cross[2 * hh + 1][e], n_row[i].y + nb), kDistClamp);
        const float term = fmaf(-2.f, sqrtf(d2a * d2b), d2a + d2b);
        const bool counts = col < lim[i] && (!kDiag || row < col);
        s += counts ? term : 0.f;
      }
  }
  return s;
}

// K4b's tile kernel: grid (upper-triangular tile pairs, proteins), K1's
// staging with compaction, one sweep, and K1's (S, C) partial per tile pair
// (zeros for a block without a pair).
__global__ void __launch_bounds__(kThreads)
mxu_stat_tile_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     const uint8_t* __restrict__ mask, int n, int n_tiles,
                     int n_pairs, float* __restrict__ part_s,
                     int* __restrict__ part_c) {
  __shared__ MxuTile tiles[2];  // [0] the column tile tj, [1] the rows
  __shared__ int warp_count[kWarps];
  __shared__ float red_s[kWarps];
  const int pair = blockIdx.x;
  const int prot = blockIdx.y;
  int ti, tj;
  unrank_pair(pair, n_tiles, &ti, &tj);
  const bool diag = ti == tj;

  const int tid = threadIdx.x;
  const int group = tid / kTile;
  const int pos = tid % kTile;
  const bool stages = group == 0 || !diag;
  float xa[3], xb[3];
  const bool ok = load_atom(a, b, mask, n, static_cast<size_t>(prot) * n,
                            (group == 0 ? tj : ti) * kTile + pos, stages, xa,
                            xb);
  const Compacted cp = compact(ok, diag, warp_count);
  if (stages) {
    if (ok) put_split(tiles[group], cp.k, xa, xb);
    if (pos >= (group == 0 ? cp.nc : cp.nr)) {
      const float zero[3] = {0.f, 0.f, 0.f};
      put_split(tiles[group], pos, zero, zero);
    }
  }
  __syncthreads();

  const size_t slot = static_cast<size_t>(prot) * n_pairs + pair;
  if (cp.nr == 0 || cp.nc == 0) {
    if (tid == 0) {
      part_s[slot] = 0.f;
      part_c[slot] = 0;
    }
    return;
  }
  float s = 0.f;
  if (16 * (tid >> 5) < cp.nr) {
    s = diag ? mxu_stat_sweep<true>(tiles[0], tiles[0], cp.nr, cp.nc)
             : mxu_stat_sweep<false>(tiles[1], tiles[0], cp.nr, cp.nc);
  }
  const float total = block_sum(s, red_s);
  if (tid == 0) {
    part_s[slot] = total;
    part_c[slot] = diag ? cp.nr * (cp.nr - 1) / 2 : cp.nr * cp.nc;
  }
}

// ---------------------------------------------------------------- K4c

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
  float xa[3], xb[3];
  const bool ok = load_atom(a, b, mask, n, static_cast<size_t>(prot) * n,
                            (group == 0 ? tj : ti) * kTile + pos, stages, xa,
                            xb);
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

// The per-protein sum of the (S, C) partials that a tile kernel was just
// launched to write, as K1a sums them (k1_epilogue_kernel<true, false>), or
// that launch's error.
int sum_partials(const float* part_s, const int* part_c, int batch, int n,
                 float* out_s, long long* out_c, cudaStream_t s) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (n + kTile - 1) / kTile;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  k1_epilogue_kernel<true, false><<<dim3(1, batch), kEpilogueThreads, 0, s>>>(
      part_s, part_c, nullptr, nullptr, n, n_tiles, n_pairs, out_s, out_c,
      nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int drmsd_variants_tile() { return kTile; }

const char* drmsd_variants_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K4a. a, b: (batch, n, 3) float32, contiguous. mask: (batch, n) uint8 0/1.
// part_s, part_c: (batch, n_pairs) scratch, any contents, n_pairs =
// T (T + 1) / 2 with T = ceil(n / drmsd_variants_tile()). out_s: (batch,)
// float32, out_c: (batch,) int64. Launches on `stream`; returns the CUDA
// error code (0 on success).
int drmsd_fwd_sqrt1(const float* a, const float* b, const uint8_t* mask,
                    int batch, int n, float* part_s, int* part_c,
                    float* out_s, long long* out_c, void* stream) {
  if (k1_bad_shape(batch, n)) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (n + kTile - 1) / kTile;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  k1_tile_kernel<false, true, true><<<dim3(n_pairs, batch), kThreads, 0, s>>>(
      a, b, mask, n, n_tiles, n_pairs, part_s, part_c, nullptr, nullptr);
  return sum_partials(part_s, part_c, batch, n, out_s, out_c, s);
}

// K4b. Arguments as for drmsd_fwd_sqrt1.
int drmsd_fwd_mxu(const float* a, const float* b, const uint8_t* mask,
                  int batch, int n, float* part_s, int* part_c, float* out_s,
                  long long* out_c, void* stream) {
  if (k1_bad_shape(batch, n)) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (n + kTile - 1) / kTile;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mxu_stat_tile_kernel<<<dim3(n_pairs, batch), kThreads, 0, s>>>(
      a, b, mask, n, n_tiles, n_pairs, part_s, part_c);
  return sum_partials(part_s, part_c, batch, n, out_s, out_c, s);
}

// K4c. a, b, mask as above; part_row, part_col: (batch, n_pairs, 3, tile)
// scratch; out_g: (batch, n, 3) float32, dS/da.
int drmsd_grad_a_mxu(const float* a, const float* b, const uint8_t* mask,
                     int batch, int n, float* part_row, float* part_col,
                     float* out_g, void* stream) {
  if (k1_bad_shape(batch, n)) return static_cast<int>(cudaErrorInvalidValue);
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
