// Masked dRMSD statistics with their coordinate gradients, for a whole batch:
// the kernels of the training step.
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
// (drmsd_fwd.cu): two rsqrt and ~26 fp32 operations a valid pair, against a
// few MB of coordinates, masks and partial sums. K=3 is too thin for tensor
// cores, and TF32 would break the gradient gate, so the math is plain fp32.
//
// Design (drmsd_common.cuh, "K1"). The TPU kernels add each tile pair's row
// sums and negated column sums into one accumulator with +=, which is
// race-free only because TPU grid cells run one after another. Hopper
// blocks run in no order, and the gradient must come out with the same bits
// on every call, so no float atomics: each block of k1_tile_kernel compacts
// its tiles' valid atoms, computes each valid pair once in a register-
// blocked sweep, reduces the row and the column sums through shared memory
// in a fixed order and writes them as (3, 128) partials; one
// k1_epilogue_kernel launch gathers every atom's partials in ascending
// order and, for K1b, sums S and C as K1a's epilogue does, so S has K1a's
// bits. Two launches a call, no fill.

#include "drmsd_common.cuh"

using namespace drmsd;

extern "C" {

const char* drmsd_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of the scratch that drmsd_fwd_grad and drmsd_grad_b take for
// (batch, n).
long long drmsd_train_scratch_bytes(int batch, int n) {
  return static_cast<long long>(k1_scratch(batch, n, true, nullptr).bytes);
}

// K1b. a, b: (batch, n, 3) float32, contiguous. mask: (batch, n) uint8 0/1.
// scratch: drmsd_train_scratch_bytes(batch, n) bytes of device memory, any
// contents. out_s: (batch,) float32, out_c: (batch,) int64, out_g:
// (batch, n, 3) float32, dS/da, each written in full. Launches on `stream`;
// returns the CUDA error code (0 on success).
int drmsd_fwd_grad(const float* a, const float* b, const uint8_t* mask,
                   int batch, int n, void* scratch, float* out_s,
                   long long* out_c, float* out_g, void* stream) {
  if (k1_bad_shape(batch, n)) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (n + kTile - 1) / kTile;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  const K1Scratch sc = k1_scratch(batch, n, true, scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_pairs, batch);
  cudaError_t err = k1_grad_smem<true>();
  if (err != cudaSuccess) return static_cast<int>(err);
  k1_tile_kernel<true, true><<<grid, kThreads, kRedBytes, s>>>(
      a, b, mask, n, n_tiles, n_pairs, sc.part_s, sc.part_c,
      sc.part_row, sc.part_col);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k1_epilogue_kernel<true, true>
      <<<dim3(n_tiles, batch), kEpilogueThreads, 0, s>>>(
      sc.part_s, sc.part_c, sc.part_row, sc.part_col, n, n_tiles, n_pairs,
      out_s, out_c, out_g);
  return static_cast<int>(cudaGetLastError());
}

// K1c. Shapes as for drmsd_fwd_grad; out_g: (batch, n, 3) float32, dS/db,
// written in full.
int drmsd_grad_b(const float* a, const float* b, const uint8_t* mask,
                 int batch, int n, void* scratch, float* out_g,
                 void* stream) {
  if (k1_bad_shape(batch, n)) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (n + kTile - 1) / kTile;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  const K1Scratch sc = k1_scratch(batch, n, true, scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_pairs, batch);
  cudaError_t err = k1_grad_smem<false>();
  if (err != cudaSuccess) return static_cast<int>(err);
  k1_tile_kernel<true, false><<<grid, kThreads, kRedBytes, s>>>(
      a, b, mask, n, n_tiles, n_pairs, nullptr, nullptr,
      sc.part_row, sc.part_col);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k1_epilogue_kernel<false, true>
      <<<dim3(n_tiles, batch), kEpilogueThreads, 0, s>>>(
      nullptr, nullptr, sc.part_row, sc.part_col, n, n_tiles, n_pairs,
      nullptr, nullptr, out_g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
