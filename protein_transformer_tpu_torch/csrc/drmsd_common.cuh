// Pieces shared by the dRMSD kernels (drmsd_fwd.cu, drmsd_train.cu,
// drmsd_variants.cu).
//
// The statistic S of a protein must come out with the same bits from the
// forward kernel (K1a) and from the training kernel (K1b), as the two TPU
// kernels agree bit for bit. Both are therefore instances of one kernel
// body, k1_tile_kernel below, with the gradient compiled out of K1a, and
// share its epilogue. The pair arithmetic is written with explicitly
// rounded intrinsics (__fmul_rn, __fsub_rn, __fmaf_rn): nvcc never
// contracts or reorders those, so the same inputs give the same bits in
// every kernel that includes this file, whatever code surrounds them.
//
// The bench's variants (drmsd_variants.cu) build on K1 too: K4a is a
// fourth instance of k1_tile_kernel, with the one-root pair term
// (kOneRoot) in place of K1's two rsqrt; K4b and K4c take K1's compaction
// (compact), partial layout and epilogue (k1_epilogue_kernel) with sweeps
// of their own on the tensor cores.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace drmsd {

constexpr int kTile = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kDistClamp = 1e-30f;

// Squared distance of a difference vector, clamped at kDistClamp.
__device__ __forceinline__ float clamped_d2(float dx, float dy, float dz) {
  return fmaxf(__fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx))),
               kDistClamp);
}

// The clamped squared distance and its rsqrt. The distance is d2 * r.
struct Dist {
  float d2;
  float r;
};

// rsqrt.approx.ftz: the clamped d2 is a normal float, so flushing
// subnormals changes nothing, and the special-function unit's rsqrt needs
// no rescaling around it.
__device__ __forceinline__ Dist clamped_dist(float dx, float dy, float dz) {
  const float d2 = clamped_d2(dx, dy, dz);
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d2));
  return {d2, r};
}

// K4a's pair term (Da - Db)^2 = d2a + d2b - 2 sqrt(d2a d2b): one IEEE
// square root, no rsqrt. 2 sqrt is exact, so the fma rounds once, as the
// plain version's subtraction does.
__device__ __forceinline__ float one_root_term(float d2a, float d2b) {
  return __fmaf_rn(-2.f, __fsqrt_rn(__fmul_rn(d2a, d2b)),
                   __fadd_rn(d2a, d2b));
}

// Da - Db of one pair; the statistic adds its square with __fmaf_rn.
__device__ __forceinline__ float pair_delta(Dist da, Dist db) {
  return __fsub_rn(__fmul_rn(da.d2, da.r), __fmul_rn(db.d2, db.r));
}

// Tile pair (ti, tj), tj >= ti, of the pair-th entry of the upper triangle
// of an n_tiles x n_tiles grid, counted row by row.
__device__ __forceinline__ void unrank_pair(int pair, int n_tiles, int* ti,
                                            int* tj) {
  int row = 0;
  int rem = pair;
  while (rem >= n_tiles - row) {
    rem -= n_tiles - row;
    ++row;
  }
  *ti = row;
  *tj = row + rem;
}

// Index of tile pair (ti, tj), tj >= ti: the inverse of unrank_pair.
__host__ __device__ __forceinline__ int pair_index(int ti, int tj,
                                                  int n_tiles) {
  return ti * n_tiles - ti * (ti - 1) / 2 + (tj - ti);
}

// ---------------------------------------------------------------------------
// K1: the statistic (K1a), with dS/da (K1b) or dS/db alone (K1c).
//
// What bounds it on Hopper: arithmetic on the valid pairs. Per pair two
// rsqrt on the special-function unit (16 a clock per SM: the bound of K1a)
// and 18 (K1a) to 26 (K1b, K1c) fp32 operations; a few MB of coordinates.
// Work on masked atoms is what the design removes:
//   * grid = (upper-triangular tile pairs (ti, tj), proteins). While it
//     stages its two tiles, each block compacts their valid atoms into
//     shared memory, in tile order (warp ballot, popcount prefix), and
//     keeps each tile position's compacted index. It then sweeps valid x
//     valid pairs only, with loop bounds from the compacted counts: no
//     per-pair mask test. Compaction keeps order, so on a diagonal tile
//     pair i < j is the same test on compacted indices. A block without a
//     valid row or a valid column writes zero partials and returns. The
//     pair count of a tile pair is nr * nc, or nr (nr - 1) / 2 on the
//     diagonal: an integer, from the counts alone.
//   * register blocking: the block's 256 threads are 16 x 16; thread
//     (ty, tx) owns compacted rows ty + 16 p and columns tx + 16 q, at most
//     8 of each. It sweeps its columns in two passes of 4, whose
//     coordinates and gradient sums stay in registers through the pass;
//     each row is read from shared memory once a pass and meets up to 4
//     columns. Two passes of 4 rather than one of 8 halve the registers
//     that the columns take, so that K1b and K1c fit 3 blocks an SM and K1a
//     4 (the __launch_bounds__ of k1_tile_kernel).
//   * one sweep: each pair is computed once, with its two rsqrt
//     (rsqrt.approx.ftz: the clamped d2 is never subnormal). The row and the
//     column sums of the gradient are each reduced across the 16 threads
//     that share the row (the column) through shared memory, in a fixed
//     order, and written as (3, kTile) partials in tile positions, zeros for
//     masked atoms.
//   * the epilogue, one launch: per atom the row partials of pairs
//     (t, tj >= t), then the column partials of pairs (ti <= t, t), each in
//     ascending order; one block per protein also sums the (S, C) partials
//     in double, in a fixed order. K1a runs only that sum.
// No float atomics: the same inputs give the same bits on every call.
// Each thread's fp32 chain of S is at most 64 pairs long; sums across tile
// pairs are in double.
//
// K4a (kOneRoot, without the gradient) is the same body with the pair term
// d2a + d2b - 2 sqrt(d2a d2b) of the bench's variant: one IEEE square root
// a pair and no rsqrt, its S summed with __fadd_rn.

constexpr int kSide = 16;                // the block's threads, kSide x kSide
constexpr int kPer = kTile / kSide;      // rows or columns of one thread
constexpr int kCols = kPer / 2;          // columns of one pass
// Row stride of the reduction buffers red[t][3 * k + c]: 2 mod 32 words,
// so that the two half-warps' writes and a warp's reads of 32 compacted
// atoms fall in distinct banks.
constexpr int kRedStride = 3 * kTile + 2;
// K1b's and K1c's two reduction buffers, in dynamic shared memory: with the
// tiles they are over the 48 KB that a launch gets without asking, so the
// launcher raises the function's limit (k1_grad_smem).
constexpr int kRedBytes = 2 * kSide * kRedStride * sizeof(float);

// One tile's valid atoms, compacted in tile order.
struct CompactTile {
  float4 xa[kTile];    // a_x, a_y, a_z, b_x of the k-th valid atom
  float2 xb[kTile];    // b_y, b_z
  short idx[kTile];    // compacted index of each tile position, -1: masked
};

// Compaction of a block's two tiles, in tile order: threads [0, kTile) hold
// the column tile's atoms, the others the row tile's (none on a diagonal
// tile pair, whose rows are its columns); `ok`: this thread's atom is valid.
// Gives the atom's index among its tile's valid atoms (a warp ballot, then
// a popcount prefix over the lanes and the warps before it) and both
// counts. warp_count: kWarps shared ints. Every thread must call it; it
// passes one barrier.
struct Compacted {
  int k;   // this atom's compacted index, where ok
  int nr;  // valid atoms of the row tile (of the column tile on a diagonal)
  int nc;  // valid atoms of the column tile
};

__device__ __forceinline__ Compacted compact(bool ok, bool diag,
                                             int* warp_count) {
  constexpr int kTileWarps = kTile / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned valid = __ballot_sync(0xffffffffu, ok);
  if (lane == 0) warp_count[warp] = __popc(valid);
  __syncthreads();
  Compacted out{__popc(valid & ((1u << lane) - 1u)), 0, 0};
  for (int w = warp / kTileWarps * kTileWarps; w < warp; ++w) {
    out.k += warp_count[w];
  }
  for (int w = 0; w < kTileWarps; ++w) {
    out.nc += warp_count[w];
    out.nr += warp_count[kTileWarps + w];
  }
  if (diag) out.nr = out.nc;
  return out;
}

// Sum of s over the block in a fixed order (warp shuffles, then the warps
// in order); the result is thread 0's. red_s: kWarps shared slots. Every
// thread must call it.
__device__ __forceinline__ float block_sum(float s, float* red_s) {
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
  }
  if ((threadIdx.x & 31) == 0) red_s[threadIdx.x >> 5] = s;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) total += red_s[w];
  }
  return total;
}

// part[c * kTile + pos] for every tile position: the sum over t of
// red[t][3 * idx[pos] + c], zero for a masked position.
__device__ __forceinline__ void write_partial(const float* red,
                                              const short* idx,
                                              float* __restrict__ part) {
  for (int e = threadIdx.x; e < 3 * kTile; e += kThreads) {
    const int c = e / kTile;
    const int k = idx[e % kTile];
    float v = 0.f;
    if (k >= 0) {
      for (int t = 0; t < kSide; ++t) v += red[t * kRedStride + 3 * k + c];
    }
    part[e] = v;
  }
}

// The sweep of one tile pair: returns this thread's share of S and, with
// kGrad, writes the pair's row and column partials. red_row, red_col:
// kSide x kRedStride floats each. kDiag: rows and columns are one tile,
// and only compacted row < column counts. kOneRoot: K4a's pair term (no
// gradient). Every thread must call it.
template <bool kGrad, bool kWrtA, bool kDiag, bool kOneRoot>
__device__ __forceinline__ float k1_sweep(const CompactTile& rows,
                                          const CompactTile& cols, int nr,
                                          int nc, float* red_row,
                                          float* red_col,
                                          float* __restrict__ part_row,
                                          float* __restrict__ part_col) {
  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;
  const int my_cols = nc > tx ? (nc - tx + kSide - 1) / kSide : 0;
  const int my_rows = nr > ty ? (nr - ty + kSide - 1) / kSide : 0;
  float s = 0.f;
#pragma unroll 1
  for (int q0 = 0; q0 < kPer; q0 += kCols) {
    // every thread writes its rows' sums in the first pass, even zeros
    if (q0 > 0 && q0 >= my_cols) break;
    float4 ca[kCols];
    float2 cb[kCols];
    float hx[kCols], hy[kCols], hz[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int l = q0 + j < my_cols ? tx + kSide * (q0 + j) : 0;
      ca[j] = cols.xa[l];
      cb[j] = cols.xb[l];
      hx[j] = hy[j] = hz[j] = 0.f;
    }
    for (int p = 0; p < my_rows; ++p) {
      const int r = ty + kSide * p;
      const float4 ra = rows.xa[r];
      const float2 rb = rows.xb[r];
      float gx = 0.f, gy = 0.f, gz = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        if (q0 + j < my_cols && (!kDiag || r < tx + kSide * (q0 + j))) {
          const float dax = __fsub_rn(ra.x, ca[j].x);
          const float day = __fsub_rn(ra.y, ca[j].y);
          const float daz = __fsub_rn(ra.z, ca[j].z);
          const float dbx = __fsub_rn(ra.w, ca[j].w);
          const float dby = __fsub_rn(rb.x, cb[j].x);
          const float dbz = __fsub_rn(rb.y, cb[j].y);
          if (kOneRoot) {
            s = __fadd_rn(s, one_root_term(clamped_d2(dax, day, daz),
                                           clamped_d2(dbx, dby, dbz)));
            continue;
          }
          const Dist da = clamped_dist(dax, day, daz);
          const Dist db = clamped_dist(dbx, dby, dbz);
          const float d = pair_delta(da, db);
          s = __fmaf_rn(d, d, s);
          if (kGrad) {
            // row i gets coef (x_i - x_j), column j the negative
            const float coef = kWrtA ? 2.f * d * da.r : -2.f * d * db.r;
            const float dx = kWrtA ? dax : dbx;
            const float dy = kWrtA ? day : dby;
            const float dz = kWrtA ? daz : dbz;
            gx = fmaf(coef, dx, gx);
            gy = fmaf(coef, dy, gy);
            gz = fmaf(coef, dz, gz);
            hx[j] = fmaf(-coef, dx, hx[j]);
            hy[j] = fmaf(-coef, dy, hy[j]);
            hz[j] = fmaf(-coef, dz, hz[j]);
          }
        }
      }
      if (kGrad) {
        float* slot = red_row + tx * kRedStride + 3 * r;
        slot[0] = q0 == 0 ? gx : slot[0] + gx;
        slot[1] = q0 == 0 ? gy : slot[1] + gy;
        slot[2] = q0 == 0 ? gz : slot[2] + gz;
      }
    }
    if (kGrad) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        if (q0 + j < my_cols) {
          float* slot =
              red_col + ty * kRedStride + 3 * (tx + kSide * (q0 + j));
          slot[0] = hx[j];
          slot[1] = hy[j];
          slot[2] = hz[j];
        }
      }
    }
  }
  if (kGrad) {
    __syncthreads();
    write_partial(red_row, rows.idx, part_row);
    write_partial(red_col, cols.idx, part_col);
  }
  return s;
}

// K1's tile kernel. K1a: kGrad false (S and C only). K1b: kGrad, kWrtA
// (S, C and the partials of dS/da). K1c: kGrad, !kWrtA (the partials of
// dS/db; no S or C). K4a: kOneRoot, kGrad false. Per tile pair `slot`:
// part_s, part_c (S and C) and part_row, part_col (3, kTile) each. With
// kGrad it takes kRedBytes of dynamic shared memory.
template <bool kGrad, bool kWrtA, bool kOneRoot = false>
__global__ void __launch_bounds__(kThreads, kGrad ? 3 : 4)
k1_tile_kernel(const float* __restrict__ a, const float* __restrict__ b,
               const uint8_t* __restrict__ mask, int n, int n_tiles,
               int n_pairs, float* __restrict__ part_s,
               int* __restrict__ part_c, float* __restrict__ part_row,
               float* __restrict__ part_col) {
  static_assert(!(kOneRoot && kGrad), "K4a has no gradient");
  constexpr bool kStats = !kGrad || kWrtA;
  const int pair = blockIdx.x;
  const int prot = blockIdx.y;
  int ti, tj;
  unrank_pair(pair, n_tiles, &ti, &tj);
  const bool diag = ti == tj;

  __shared__ CompactTile tiles[2];  // [0] the column tile tj, [1] the rows
  __shared__ int warp_count[kWarps];
  __shared__ float red_s[kWarps];
  extern __shared__ float4 k1_dynamic[];
  float* red_row = reinterpret_cast<float*>(k1_dynamic);
  float* red_col = red_row + kSide * kRedStride;

  // Stage and compact: threads [0, kTile) the column tile, the others the
  // row tile (none on a diagonal tile pair, whose rows are its columns).
  // The mask and the coordinates are read together: one round trip.
  const int tid = threadIdx.x;
  const int group = tid / kTile;
  const int pos = tid % kTile;
  const bool stages = group == 0 || !diag;
  const int atom = (group == 0 ? tj : ti) * kTile + pos;
  const size_t base = static_cast<size_t>(prot) * n;
  bool ok = false;
  float4 va = make_float4(0.f, 0.f, 0.f, 0.f);
  float2 vb = make_float2(0.f, 0.f);
  if (stages && atom < n) {
    const uint8_t m = mask[base + atom];
    const float* pa = a + (base + atom) * 3;
    const float* pb = b + (base + atom) * 3;
    va = make_float4(pa[0], pa[1], pa[2], pb[0]);
    vb = make_float2(pb[1], pb[2]);
    ok = m != 0;
  }
  const Compacted cp = compact(ok, diag, warp_count);
  const int k = cp.k, nr = cp.nr, nc = cp.nc;
  CompactTile& mine = tiles[group];
  if (ok) {
    mine.xa[k] = va;
    mine.xb[k] = vb;
  }
  if (kGrad && stages) mine.idx[pos] = ok ? k : -1;
  __syncthreads();

  const size_t slot = static_cast<size_t>(prot) * n_pairs + pair;
  float* row_out = kGrad ? part_row + slot * 3 * kTile : nullptr;
  float* col_out = kGrad ? part_col + slot * 3 * kTile : nullptr;
  if (nr == 0 || nc == 0) {
    if (kStats && tid == 0) {
      part_s[slot] = 0.f;
      part_c[slot] = 0;
    }
    if (kGrad) {
      for (int e = tid; e < 3 * kTile; e += kThreads) {
        row_out[e] = 0.f;
        col_out[e] = 0.f;
      }
    }
    return;
  }
  const float s =
      diag ? k1_sweep<kGrad, kWrtA, true, kOneRoot>(
                 tiles[0], tiles[0], nr, nc, red_row, red_col, row_out,
                 col_out)
           : k1_sweep<kGrad, kWrtA, false, kOneRoot>(
                 tiles[1], tiles[0], nr, nc, red_row, red_col, row_out,
                 col_out);
  if (kStats) {
    const float total = block_sum(s, red_s);
    if (tid == 0) {
      part_s[slot] = total;
      part_c[slot] = diag ? nr * (nr - 1) / 2 : nr * nc;
    }
  }
}

template <bool kWrtA>
inline cudaError_t k1_grad_smem() {
  return cudaFuncSetAttribute(k1_tile_kernel<true, kWrtA>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kRedBytes);
}

// K1's epilogue. Grid (atom tiles, proteins) with kGrad, (1, proteins)
// without; kEpilogueThreads threads. With kGrad, thread (c, k) of block
// (t, p) sums component c of atom t * kTile + k: its row partials of pairs
// (t, tj >= t), then its column partials of pairs (ti <= t, t), each in
// ascending order, into out_g. With kStats, block (0, p) also sums protein
// p's (S, C) partials with its first kTile threads: strided per-thread sums
// in double, then a fixed tree.
constexpr int kEpilogueThreads = 3 * kTile;

template <bool kStats, bool kGrad>
__global__ void __launch_bounds__(kEpilogueThreads)
k1_epilogue_kernel(const float* __restrict__ part_s,
                   const int* __restrict__ part_c,
                   const float* __restrict__ part_row,
                   const float* __restrict__ part_col, int n, int n_tiles,
                   int n_pairs, float* __restrict__ out_s,
                   long long* __restrict__ out_c, float* __restrict__ out_g) {
  const int t = blockIdx.x;
  const int prot = blockIdx.y;
  const int c = threadIdx.x / kTile;
  const int k = threadIdx.x % kTile;
  const size_t base = static_cast<size_t>(prot) * n_pairs;
  if (kGrad) {
    const int atom = t * kTile + k;
    const size_t at = c * kTile + k;
    float acc = 0.f;
    for (int tj = t; tj < n_tiles; ++tj) {
      acc += part_row[(base + pair_index(t, tj, n_tiles)) * 3 * kTile + at];
    }
    for (int ti = 0; ti <= t; ++ti) {
      acc += part_col[(base + pair_index(ti, t, n_tiles)) * 3 * kTile + at];
    }
    if (atom < n) out_g[(static_cast<size_t>(prot) * n + atom) * 3 + c] = acc;
  }
  if (kStats && t == 0) {
    __shared__ double ss[kTile];
    __shared__ long long sc[kTile];
    const int tid = threadIdx.x;
    if (tid < kTile) {
      double s = 0.0;
      long long cnt = 0;
      for (int p = tid; p < n_pairs; p += kTile) {
        s += part_s[base + p];
        cnt += part_c[base + p];
      }
      ss[tid] = s;
      sc[tid] = cnt;
    }
    __syncthreads();
    for (int stride = kTile / 2; stride > 0; stride >>= 1) {
      if (tid < stride) {
        ss[tid] += ss[tid + stride];
        sc[tid] += sc[tid + stride];
      }
      __syncthreads();
    }
    if (tid == 0) {
      out_s[prot] = static_cast<float>(ss[0]);
      out_c[prot] = sc[0];
    }
  }
}

// K1's scratch, one allocation: the (S, C) partials of every (protein, tile
// pair) and, with grad, the (3, kTile) row and column partials; each part
// 256-byte aligned. With base 0 it gives only the size.
struct K1Scratch {
  float* part_s;
  int* part_c;
  float* part_row;
  float* part_col;
  size_t bytes;
};

inline K1Scratch k1_scratch(int batch, int n, bool grad, void* base) {
  const size_t n_tiles = (static_cast<size_t>(n) + kTile - 1) / kTile;
  const size_t slots = static_cast<size_t>(batch) * n_tiles * (n_tiles + 1) /
                       2;
  const uintptr_t start = reinterpret_cast<uintptr_t>(base);
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const uintptr_t at = start + off;
    off += (bytes + 255) / 256 * 256;
    return at;
  };
  K1Scratch out;
  out.part_s = reinterpret_cast<float*>(take(slots * sizeof(float)));
  out.part_c = reinterpret_cast<int*>(take(slots * sizeof(int)));
  const size_t part = grad ? slots * 3 * kTile * sizeof(float) : 0;
  out.part_row = grad ? reinterpret_cast<float*>(take(part)) : nullptr;
  out.part_col = grad ? reinterpret_cast<float*>(take(part)) : nullptr;
  out.bytes = off;
  return out;
}

inline bool k1_bad_shape(int batch, int n) {
  return batch <= 0 || n <= 0 || batch > 65535;
}

}  // namespace drmsd
