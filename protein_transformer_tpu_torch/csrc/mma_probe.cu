// A throughput probe of the tensor-core product that K3a, the flash
// backward and K4b / K4c are built from: mma.sync m16n8k8 in TF32
// (mma_tf32.cuh). Not a port of a TPU kernel; the bench tool
// protein_transformer_tpu_torch/tools/bench_mma.py times it to say how far
// those kernels sit from the rate this instruction allows on the card.
//
// Every warp of the grid runs `iters` rounds of kChains independent
// products (one accumulator each, operands in registers, nothing loaded):
// with enough warps and chains the time is the tensor pipe's issue rate for
// this instruction, with one chain a warp it is the product's latency.

#include <cuda_runtime.h>

#include <cstdint>

#include "mma_tf32.cuh"

using namespace tf32;

namespace {

template <int kChains>
__global__ void mma_probe_kernel(int iters, float* __restrict__ out) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = to_tf32(1e-3f * (threadIdx.x + i));
  for (int i = 0; i < 2; ++i) b[i] = to_tf32(1e-3f * (blockIdx.x + i));
  float acc[kChains][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) mma_tf32(acc[c], a, b);
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kChains; ++c)
    s += (acc[c][0] + acc[c][1]) + (acc[c][2] + acc[c][3]);
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" {

const char* mma_probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// `blocks` blocks of `threads` threads (a multiple of 32), each warp
// running iters x chains products (chains 1, 2, 4 or 8); out: blocks x
// threads floats. Launches on `stream`; returns the CUDA error code.
int mma_probe(int chains, int blocks, int threads, int iters, float* out,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks <= 0 || threads <= 0 || threads % 32 != 0 || iters <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (chains) {
    case 1: mma_probe_kernel<1><<<blocks, threads, 0, s>>>(iters, out); break;
    case 2: mma_probe_kernel<2><<<blocks, threads, 0, s>>>(iters, out); break;
    case 4: mma_probe_kernel<4><<<blocks, threads, 0, s>>>(iters, out); break;
    case 8: mma_probe_kernel<8><<<blocks, threads, 0, s>>>(iters, out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
