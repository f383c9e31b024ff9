// Masked dRMSD statistics, forward only, for a whole batch: K1a.
//
// Replaces the TPU kernel protein_transformer_tpu/ops/drmsd_pallas.py
// (_stats_fwd_impl -> _fwd_kernel_rsqrt). Per protein p, over the valid
// pairs i < j (mask_i and mask_j):
//   S_p = sum (|a_i - a_j| - |b_i - b_j|)^2,   C_p = number of such pairs,
// with every distance taken as d2 * rsqrt(max(d2, 1e-30)). The N x N
// distance matrices are never stored.
//
// What bounds it on Hopper: the two rsqrt of every valid pair on the
// special-function unit, then ~18 fp32 operations a pair; the kernel reads
// a few MB. K=3 is too thin for tensor cores, and TF32 would break the
// 1e-3 A gate, so the math is plain fp32.
//
// Design: K1b's kernel body with the gradient compiled out
// (k1_tile_kernel<false, true> of drmsd_common.cuh: in-tile compaction of
// the valid atoms, register-blocked pairs, fixed-order sums), so that K1b's
// S has this kernel's bits; then the per-protein sum of the partials in
// double (k1_epilogue_kernel<true, false>). Two launches, no fill.
//
// The pair count is an integer. At L=500 a protein has 7,000 atoms and
// 24.5 M pairs, more than the 2^24 that fp32 counts exactly. This is the
// one intended difference from the TPU kernel, which counts in fp32.

#include "drmsd_common.cuh"

using namespace drmsd;

extern "C" {

const char* drmsd_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of the scratch that drmsd_fwd takes for (batch, n).
long long drmsd_fwd_scratch_bytes(int batch, int n) {
  return static_cast<long long>(k1_scratch(batch, n, false, nullptr).bytes);
}

// a, b: (batch, n, 3) float32, contiguous. mask: (batch, n) uint8 0/1.
// scratch: drmsd_fwd_scratch_bytes(batch, n) bytes of device memory, any
// contents. out_s: (batch,) float32, out_c: (batch,) int64, both written
// in full. Launches on `stream`; returns the CUDA error code (0 on
// success).
int drmsd_fwd(const float* a, const float* b, const uint8_t* mask, int batch,
              int n, void* scratch, float* out_s, long long* out_c,
              void* stream) {
  if (k1_bad_shape(batch, n)) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (n + kTile - 1) / kTile;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  const K1Scratch sc = k1_scratch(batch, n, false, scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_pairs, batch);
  k1_tile_kernel<false, true><<<grid, kThreads, 0, s>>>(
      a, b, mask, n, n_tiles, n_pairs, sc.part_s, sc.part_c,
      nullptr, nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k1_epilogue_kernel<true, false>
      <<<dim3(1, batch), kEpilogueThreads, 0, s>>>(
      sc.part_s, sc.part_c, nullptr, nullptr, n, n_tiles, n_pairs, out_s,
      out_c, nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
