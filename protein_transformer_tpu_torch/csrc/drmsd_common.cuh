// Pieces shared by the dRMSD kernels (drmsd_fwd.cu, drmsd_train.cu,
// drmsd_variants.cu).
//
// The statistic S of a protein must come out with the same bits from the
// forward kernel (K1a) and from the training kernel (K1b), as the two TPU
// kernels agree bit for bit. Both therefore take the per-pair arithmetic,
// the block's fixed-order reduction and the per-protein sum from here. The
// pair arithmetic is written with explicitly rounded intrinsics (__fmul_rn,
// __fsub_rn, __fmaf_rn): nvcc never contracts or reorders those, so the
// same inputs give the same bits in every kernel that includes this file,
// whatever code surrounds them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace drmsd {

constexpr int kTile = 128;
constexpr int kThreads = 256;
constexpr int kColGroups = kThreads / kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kReduceThreads = 256;
constexpr float kDistClamp = 1e-30f;

// Squared distance of a difference vector, clamped at kDistClamp, and its
// rsqrt. The distance is d2 * r.
struct Dist {
  float d2;
  float r;
};

__device__ __forceinline__ Dist clamped_dist(float dx, float dy, float dz) {
  float d2 = __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
  d2 = fmaxf(d2, kDistClamp);
  return {d2, rsqrtf(d2)};
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

// The block's (S, C) partial: warp shuffle, then the warps' sums in a fixed
// order by thread 0. red_s / red_c are kWarps shared slots. Ends with every
// thread past a barrier.
__device__ __forceinline__ void block_stat_partial(float s, int cnt,
                                                   float* red_s, int* red_c,
                                                   float* part_s, int* part_c,
                                                   size_t slot) {
  const int tid = threadIdx.x;
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  }
  if ((tid & 31) == 0) {
    red_s[tid >> 5] = s;
    red_c[tid >> 5] = cnt;
  }
  __syncthreads();
  if (tid == 0) {
    float ts = 0.f;
    int tc = 0;
    for (int w = 0; w < kWarps; ++w) {
      ts += red_s[w];
      tc += red_c[w];
    }
    part_s[slot] = ts;
    part_c[slot] = tc;
  }
}

// One block per protein: strided per-thread sums, then a fixed-shape tree.
// Partials are summed in double: there are at most a few thousand of them,
// and the order is fixed, so the result is deterministic.
__global__ void __launch_bounds__(kReduceThreads)
stat_reduce_kernel(const float* __restrict__ part_s,
                   const int* __restrict__ part_c, int n_pairs,
                   float* __restrict__ out_s, long long* __restrict__ out_c) {
  __shared__ double ss[kReduceThreads];
  __shared__ long long sc[kReduceThreads];
  const int prot = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(prot) * n_pairs;
  double s = 0.0;
  long long c = 0;
  for (int p = tid; p < n_pairs; p += kReduceThreads) {
    s += part_s[base + p];
    c += part_c[base + p];
  }
  ss[tid] = s;
  sc[tid] = c;
  __syncthreads();
  for (int stride = kReduceThreads / 2; stride > 0; stride >>= 1) {
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

// The gradient of every atom from the tile pairs' (3, kTile) row and column
// partials, which hold what each tile pair adds to its row atoms and to its
// column atoms. Grid (atom tiles, proteins), one thread per atom: the atom's
// row partials (pairs (t, tj), tj = t .. T-1), then its column partials
// (pairs (ti, t), ti = 0 .. t), each in ascending order.
__global__ void __launch_bounds__(kTile)
grad_gather_kernel(const float* __restrict__ part_row,
                   const float* __restrict__ part_col, int n, int n_tiles,
                   int n_pairs, float* __restrict__ out_g) {
  const int t = blockIdx.x;
  const int prot = blockIdx.y;
  const int k = threadIdx.x;
  const int atom = t * kTile + k;
  const size_t base = static_cast<size_t>(prot) * n_pairs;
  for (int c = 0; c < 3; ++c) {
    float acc = 0.f;
    for (int tj = t; tj < n_tiles; ++tj) {
      const size_t slot = base + pair_index(t, tj, n_tiles);
      acc += part_row[(slot * 3 + c) * kTile + k];
    }
    for (int ti = 0; ti <= t; ++ti) {
      const size_t slot = base + pair_index(ti, t, n_tiles);
      acc += part_col[(slot * 3 + c) * kTile + k];
    }
    if (atom < n) {
      out_g[(static_cast<size_t>(prot) * n + atom) * 3 + c] = acc;
    }
  }
}

}  // namespace drmsd
