// Masked dRMSD statistics, forward only, for a whole batch in one launch.
//
// Replaces the TPU kernel protein_transformer_tpu/ops/drmsd_pallas.py
// (_stats_fwd_impl -> _fwd_kernel_rsqrt). Per protein p, over the valid
// pairs i < j (mask_i and mask_j):
//   S_p = sum (|a_i - a_j| - |b_i - b_j|)^2,   C_p = number of such pairs,
// with every distance taken as d2 * rsqrt(max(d2, 1e-30)). The N x N
// distance matrices are never stored.
//
// What bounds it on Hopper: arithmetic. Each pair costs two 3-vector
// differences, two rsqrt and a handful of FMAs on the CUDA cores, against
// 28 bytes of coordinates and mask per atom, so the kernel reads a few MB
// and does O(N^2) work. K=3 is too thin for tensor cores, and TF32 would
// break the 1e-3 A gate, so the math is plain fp32.
//
// Design:
//   * grid = (upper-triangular tile pairs, proteins): the protein index is
//     in the grid, replacing the TPU code's vmap. Block (ti, tj), tj >= ti,
//     stages tile tj's atoms in shared memory; each thread keeps one row
//     atom of tile ti in registers and sweeps half of the tile's columns.
//     Only i < j counts, which leaves the strict upper triangle on diagonal
//     tiles.
//   * reduction: warp shuffle, then across the block's warps in a fixed
//     order, into partials[protein][pair]. A second kernel sums each
//     protein's partials in a fixed order. No float atomics: the TPU kernel
//     accumulates with += across grid cells, which is race-free only
//     because TPU grid cells run one after another.
//   * the pair arithmetic, the block reduction and the per-protein sum come
//     from drmsd_common.cuh, shared with the training kernel
//     (drmsd_train.cu), so both give S with the same bits.
//   * the pair count is an integer. At L=500 a protein has 7,000 atoms and
//     24.5 M pairs, more than the 2^24 that fp32 counts exactly. This is the
//     one intended difference from the TPU kernel, which counts in fp32.

#include "drmsd_common.cuh"

using namespace drmsd;

namespace {

__global__ void __launch_bounds__(kThreads)
drmsd_tile_kernel(const float* __restrict__ a, const float* __restrict__ b,
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
        const Dist da = clamped_dist(__fsub_rn(ax, sa[0][col]),
                                     __fsub_rn(ay, sa[1][col]),
                                     __fsub_rn(az, sa[2][col]));
        const Dist db = clamped_dist(__fsub_rn(bx, sb[0][col]),
                                     __fsub_rn(by, sb[1][col]),
                                     __fsub_rn(bz, sb[2][col]));
        const float d = pair_delta(da, db);
        s = __fmaf_rn(d, d, s);
        cnt += 1;
      }
    }
  }
  block_stat_partial(s, cnt, red_s, red_c, part_s, part_c,
                     static_cast<size_t>(prot) * n_pairs + pair);
}

}  // namespace

extern "C" {

int drmsd_fwd_tile() { return kTile; }

const char* drmsd_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// a, b: (batch, n, 3) float32, contiguous. mask: (batch, n) uint8 0/1.
// part_s, part_c: (batch, n_pairs) scratch, n_pairs = T (T + 1) / 2 with
// T = ceil(n / drmsd_fwd_tile()). out_s: (batch,) float32, out_c: (batch,)
// int64. Launches on `stream`; returns the CUDA error code (0 on success).
int drmsd_fwd(const float* a, const float* b, const uint8_t* mask, int batch,
              int n, float* part_s, int* part_c, float* out_s,
              long long* out_c, void* stream) {
  if (batch <= 0 || n <= 0 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_tiles = (n + kTile - 1) / kTile;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  drmsd_tile_kernel<<<dim3(n_pairs, batch), kThreads, 0, s>>>(
      a, b, mask, n, n_tiles, n_pairs, part_s, part_c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stat_reduce_kernel<<<batch, kReduceThreads, 0, s>>>(part_s, part_c,
                                                      n_pairs, out_s, out_c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
