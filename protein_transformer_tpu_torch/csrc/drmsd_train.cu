// Masked dRMSD statistics with their coordinate gradients, for a whole batch
// in one launch: the kernels of the training step.
//
// Replaces two TPU kernels of protein_transformer_tpu/ops/drmsd_pallas.py:
//   * drmsd_fwd_grad (K1b) replaces _stats_fwd -> _fused_kernel: S, C and
//     the raw gradient dS/da in one sweep over the pairs;
//   * drmsd_grad_b (K1c) replaces _stats_bwd -> _bwd_kernel_b: dS/db.
// Per protein, over the valid pairs i < j (mask_i and mask_j), with
// D = d2 * rsqrt(max(d2, 1e-30)) and delta = Da - Db:
//   S = sum delta^2, C = number of pairs,
//   g_k = sum_{j>k} coef_kj (x_k - x_j) - sum_{i<k} coef_ik (x_i - x_k),
// where x = a and coef = 2 delta / Da for dS/da, and x = b and
// coef = -2 delta / Db for dS/db (1/D = rsqrt(d2)).
//
// What bounds it on Hopper: arithmetic, as for the forward kernel
// (drmsd_fwd.cu): two rsqrt and about 40 FMAs per pair on the CUDA cores,
// against a few MB of coordinates, masks and partial sums. K=3 is too thin
// for tensor cores, and TF32 would break the gradient gate, so the math is
// plain fp32.
//
// Design. The TPU kernels add each tile pair's row sums and negated column
// sums into one accumulator with +=, which is race-free only because TPU
// grid cells run one after another. Hopper blocks run in no order, and the
// gradient must come out with the same bits on every call, so no float
// atomics:
//   * grid = (upper-triangular tile pairs, proteins), as in drmsd_fwd.cu.
//     Block (ti, tj) stages both tiles in shared memory and sweeps its pairs
//     twice. Sweep 1 gives each thread one row atom and half the columns:
//     the statistic (K1a's sweep, summed in its order) and the row sums.
//     Sweep 2 gives each thread one column atom and half the rows: the
//     column sums. The two half sums of each atom are added in a fixed
//     order through shared memory. Sweeping twice doubles the pair work of
//     the block, and in exchange no per-column reduction across threads is
//     needed.
//   * each block writes one (3, 128) row partial and one negated (3, 128)
//     column partial into scratch. A second kernel (grad_gather_kernel of
//     drmsd_common.cuh) sums, for each (protein, atom tile t), the row
//     partials of pairs (t, tj >= t) and then the column partials of pairs
//     (ti <= t, t), each in ascending order.
//   * S and C: per-block partials and the per-protein sum of
//     drmsd_common.cuh, so S has the same bits as drmsd_fwd's.

#include "drmsd_common.cuh"

using namespace drmsd;

namespace {

template <bool kWrtA>
__global__ void __launch_bounds__(kThreads)
grad_tile_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const uint8_t* __restrict__ mask, int n, int n_tiles,
                 int n_pairs, float* __restrict__ part_s,
                 int* __restrict__ part_c, float* __restrict__ part_row,
                 float* __restrict__ part_col) {
  const int pair = blockIdx.x;
  const int prot = blockIdx.y;
  int ti, tj;
  unrank_pair(pair, n_tiles, &ti, &tj);

  __shared__ float ca[3][kTile];  // column tile tj
  __shared__ float cb[3][kTile];
  __shared__ uint8_t cm[kTile];
  __shared__ float ra[3][kTile];  // row tile ti
  __shared__ float rb[3][kTile];
  __shared__ uint8_t rm[kTile];
  __shared__ float half[kColGroups][3][kTile];
  __shared__ float red_s[kWarps];
  __shared__ int red_c[kWarps];

  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(prot) * n;
  {
    // threads [0, kTile) stage the column tile, the others the row tile
    const int k = tid % kTile;
    const bool col = tid < kTile;
    const int atom = (col ? tj : ti) * kTile + k;
    const bool ok = atom < n;
    const size_t o = (base + (ok ? atom : 0)) * 3;
    float* xa = col ? &ca[0][0] : &ra[0][0];
    float* xb = col ? &cb[0][0] : &rb[0][0];
    for (int c = 0; c < 3; ++c) {
      xa[c * kTile + k] = ok ? a[o + c] : 0.f;
      xb[c * kTile + k] = ok ? b[o + c] : 0.f;
    }
    (col ? cm : rm)[k] = ok ? mask[base + atom] : 0;
  }
  __syncthreads();

  const int k = tid % kTile;
  const int group = tid / kTile;
  const size_t slot = static_cast<size_t>(prot) * n_pairs + pair;

  // Sweep 1: row atom i = ti * kTile + k against half of tile tj's columns.
  float s = 0.f;
  int cnt = 0;
  float gx = 0.f, gy = 0.f, gz = 0.f;
  if (rm[k]) {
    const int i = ti * kTile + k;
    const float ax = ra[0][k], ay = ra[1][k], az = ra[2][k];
    const float bx = rb[0][k], by = rb[1][k], bz = rb[2][k];
    for (int col = group; col < kTile; col += kColGroups) {
      if (cm[col] && i < tj * kTile + col) {
        const float dax = __fsub_rn(ax, ca[0][col]);
        const float day = __fsub_rn(ay, ca[1][col]);
        const float daz = __fsub_rn(az, ca[2][col]);
        const float dbx = __fsub_rn(bx, cb[0][col]);
        const float dby = __fsub_rn(by, cb[1][col]);
        const float dbz = __fsub_rn(bz, cb[2][col]);
        const Dist da = clamped_dist(dax, day, daz);
        const Dist db = clamped_dist(dbx, dby, dbz);
        const float d = pair_delta(da, db);
        s = __fmaf_rn(d, d, s);
        cnt += 1;
        if (kWrtA) {
          const float coef = 2.f * d * da.r;
          gx = fmaf(coef, dax, gx);
          gy = fmaf(coef, day, gy);
          gz = fmaf(coef, daz, gz);
        } else {
          const float coef = -2.f * d * db.r;
          gx = fmaf(coef, dbx, gx);
          gy = fmaf(coef, dby, gy);
          gz = fmaf(coef, dbz, gz);
        }
      }
    }
  }
  if (kWrtA) {
    block_stat_partial(s, cnt, red_s, red_c, part_s, part_c, slot);
  }
  half[group][0][k] = gx;
  half[group][1][k] = gy;
  half[group][2][k] = gz;
  __syncthreads();
  if (tid < kTile) {
    for (int c = 0; c < 3; ++c) {
      part_row[(slot * 3 + c) * kTile + k] = half[0][c][k] + half[1][c][k];
    }
  }
  __syncthreads();

  // Sweep 2: column atom j = tj * kTile + k against half of tile ti's rows.
  float hx = 0.f, hy = 0.f, hz = 0.f;
  if (cm[k]) {
    const int j = tj * kTile + k;
    const float ax = ca[0][k], ay = ca[1][k], az = ca[2][k];
    const float bx = cb[0][k], by = cb[1][k], bz = cb[2][k];
    for (int row = group; row < kTile; row += kColGroups) {
      if (rm[row] && ti * kTile + row < j) {
        const float dax = __fsub_rn(ra[0][row], ax);
        const float day = __fsub_rn(ra[1][row], ay);
        const float daz = __fsub_rn(ra[2][row], az);
        const float dbx = __fsub_rn(rb[0][row], bx);
        const float dby = __fsub_rn(rb[1][row], by);
        const float dbz = __fsub_rn(rb[2][row], bz);
        const Dist da = clamped_dist(dax, day, daz);
        const Dist db = clamped_dist(dbx, dby, dbz);
        const float d = pair_delta(da, db);
        if (kWrtA) {
          const float coef = 2.f * d * da.r;
          hx = fmaf(coef, dax, hx);
          hy = fmaf(coef, day, hy);
          hz = fmaf(coef, daz, hz);
        } else {
          const float coef = -2.f * d * db.r;
          hx = fmaf(coef, dbx, hx);
          hy = fmaf(coef, dby, hy);
          hz = fmaf(coef, dbz, hz);
        }
      }
    }
  }
  half[group][0][k] = hx;
  half[group][1][k] = hy;
  half[group][2][k] = hz;
  __syncthreads();
  if (tid < kTile) {
    for (int c = 0; c < 3; ++c) {
      part_col[(slot * 3 + c) * kTile + k] = -(half[0][c][k] + half[1][c][k]);
    }
  }
}

bool bad_shape(int batch, int n) {
  return batch <= 0 || n <= 0 || batch > 65535;
}

}  // namespace

extern "C" {

int drmsd_train_tile() { return kTile; }

const char* drmsd_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K1b. a, b: (batch, n, 3) float32, contiguous. mask: (batch, n) uint8 0/1.
// With T = ceil(n / drmsd_train_tile()) and n_pairs = T (T + 1) / 2:
// part_s, part_c: (batch, n_pairs) scratch; part_row, part_col:
// (batch, n_pairs, 3, tile) scratch. out_s: (batch,) float32, out_c:
// (batch,) int64, out_g: (batch, n, 3) float32, dS/da. Launches on
// `stream`; returns the CUDA error code (0 on success).
int drmsd_fwd_grad(const float* a, const float* b, const uint8_t* mask,
                   int batch, int n, float* part_s, int* part_c,
                   float* part_row, float* part_col, float* out_s,
                   long long* out_c, float* out_g, void* stream) {
  if (bad_shape(batch, n)) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (n + kTile - 1) / kTile;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  grad_tile_kernel<true><<<dim3(n_pairs, batch), kThreads, 0, s>>>(
      a, b, mask, n, n_tiles, n_pairs, part_s, part_c, part_row, part_col);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stat_reduce_kernel<<<batch, kReduceThreads, 0, s>>>(part_s, part_c,
                                                      n_pairs, out_s, out_c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  grad_gather_kernel<<<dim3(n_tiles, batch), kTile, 0, s>>>(
      part_row, part_col, n, n_tiles, n_pairs, out_g);
  return static_cast<int>(cudaGetLastError());
}

// K1c. Shapes as for drmsd_fwd_grad; out_g: (batch, n, 3) float32, dS/db.
int drmsd_grad_b(const float* a, const float* b, const uint8_t* mask,
                 int batch, int n, float* part_row, float* part_col,
                 float* out_g, void* stream) {
  if (bad_shape(batch, n)) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (n + kTile - 1) / kTile;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  grad_tile_kernel<false><<<dim3(n_pairs, batch), kThreads, 0, s>>>(
      a, b, mask, n, n_tiles, n_pairs, nullptr, nullptr, part_row, part_col);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  grad_gather_kernel<<<dim3(n_tiles, batch), kTile, 0, s>>>(
      part_row, part_col, n, n_tiles, n_pairs, out_g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
