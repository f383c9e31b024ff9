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
//     because TPU grid cells run one after another, and the training
//     kernel that comes later must reproduce these sums bit for bit.
//   * the pair count is an integer. At L=500 a protein has 7,000 atoms and
//     24.5 M pairs, more than the 2^24 that fp32 counts exactly. This is the
//     one intended difference from the TPU kernel, which counts in fp32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;
constexpr int kThreads = 256;
constexpr int kColGroups = kThreads / kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kReduceThreads = 256;
constexpr float kDistClamp = 1e-30f;

__device__ __forceinline__ float clamped_dist(float dx, float dy, float dz) {
  float d2 = dx * dx + dy * dy + dz * dz;
  d2 = fmaxf(d2, kDistClamp);
  return d2 * rsqrtf(d2);
}

__global__ void __launch_bounds__(kThreads)
drmsd_tile_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const uint8_t* __restrict__ mask, int n, int n_tiles,
                  int n_pairs, float* __restrict__ part_s,
                  int* __restrict__ part_c) {
  const int pair = blockIdx.x;
  const int prot = blockIdx.y;
  // Unrank the pair index over the upper triangle, row by row.
  int ti = 0;
  int rem = pair;
  while (rem >= n_tiles - ti) {
    rem -= n_tiles - ti;
    ++ti;
  }
  const int tj = ti + rem;

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
        const float da = clamped_dist(ax - sa[0][col], ay - sa[1][col],
                                      az - sa[2][col]);
        const float db = clamped_dist(bx - sb[0][col], by - sb[1][col],
                                      bz - sb[2][col]);
        const float d = da - db;
        s += d * d;
        cnt += 1;
      }
    }
  }

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
    const size_t o = static_cast<size_t>(prot) * n_pairs + pair;
    part_s[o] = ts;
    part_c[o] = tc;
  }
}

// One block per protein: strided per-thread sums, then a fixed-shape tree.
// Partials are summed in double: there are at most a few thousand of them,
// and the order is fixed, so the result is deterministic.
__global__ void __launch_bounds__(kReduceThreads)
drmsd_reduce_kernel(const float* __restrict__ part_s,
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
  drmsd_reduce_kernel<<<batch, kReduceThreads, 0, s>>>(part_s, part_c,
                                                      n_pairs, out_s, out_c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
