// The optimizer's update over every parameter tensor as one multi-tensor
// pass, preceded by one pass for the clip's norm (K6). Not a port of a TPU
// kernel: the JAX package's optimizer is an optax chain that XLA fuses. On
// the card it replaces training/optim.py's chain of torch._foreach_* passes,
// twelve full passes over HBM (~112 bytes a parameter) and their temporaries.
//
// What it computes, in fp32, element by element, in the foreach chain's
// order (training/optim.py::Optimizer.update):
//   factor = norm < clip ? 1 : (1 / norm) * clip   (norm of all the
//            gradients; a Python float over a tensor is its reciprocal
//            times the float)
//   g  = g * factor + wd * p
//   Adam: mu = lerp(mu, g, 1 - b1);  nu = b2 * nu + (1 - b2) * g * g;
//         p += lr * (mu * (1 / bc1)) / (sqrt(nu * (1 / bc2)) + eps)
//   SGD:  p += lr * g
// with lr signed (negative) and the bias corrections bc1 = 1 - b1^t and
// bc2 = 1 - b2^t computed on the host. IEEE division and square root, and
// the foreach passes' roundings, one by one: each pass rounds what it stores,
// fuses a product into its sum where PyTorch's kernel does (the alpha of an
// add, addcmul's value, lerp) and divides by a scalar as a product with the
// scalar's float reciprocal, as PyTorch's foreach division does (measured on
// an H100 under torch 2.11), so the intrinsics below name each rounding.
//
// What bounds it on Hopper: bytes. The norm pass reads g (4 bytes a
// parameter); the update reads p, g, mu, nu and writes p, mu, nu (28; SGD
// 12). 32 bytes a parameter at 3.35 TB/s: 23.1 ms for 2.42 B parameters.
//
// Design:
//   * the tensors go to the kernel by a table in its parameter space (up to
//     kMaxTensors a launch; more are split over launches of the same pass):
//     four pointers, the element count, the first tile and the sliced flag of
//     each. A tensor is cut into tiles of kTile elements; the blocks walk the
//     tiles grid-stride and find a tile's tensor by a binary search over the
//     tiles' starts (the same for every thread of the block).
//   * 128-bit loads and stores where a tensor's pointers are all 16-byte
//     aligned (a tile starts at a multiple of kTile elements); scalar ones
//     for the tail and for a misaligned view.
//   * the norm: each block sums the squares of its tiles in fp64, apart for
//     sliced and replicated gradients, and writes its two partials; the last
//     block to finish (a ticket counter, integer atomics) folds the partials
//     in a fixed order into sums[2]. No float atomics: the same bits on
//     every call. Between the passes the caller may sum sums[0] over the
//     ranks that hold the other slices.
//   * the ticket belongs to the call: the norm pass zeroes it on the stream
//     before its first launch (cudaMemsetAsync), so neither a launch that
//     failed halfway nor a call on another stream leaves a later call a
//     stale ticket.
//   * the update: every block reads sums, so all compute the same factor.
//   * the grid: the SMs times the blocks a SM holds, or the tiles if fewer.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 8192;   // elements; a multiple of 4 * kThreads

// The kernel's parameters may fill 32,764 bytes from CUDA 12.1 on, 4,096
// before; the table takes what the scalars leave.
#if CUDART_VERSION >= 12010
constexpr int kParamBytes = 32764;
#else
constexpr int kParamBytes = 4096;
#endif
constexpr int kEntryBytes = 4 * 8 + 8 + 4 + 1;
constexpr int kMaxTensors = (kParamBytes - 256) / kEntryBytes;

struct Table {
  int n;       // tensors
  int tiles;   // tiles over all of them
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  float* mu[kMaxTensors];
  float* nu[kMaxTensors];
  long long numel[kMaxTensors];
  int first[kMaxTensors];   // the tensor's first tile
  unsigned char sliced[kMaxTensors];
};

struct Hyper {
  float clip;   // 0: no clip
  float lr, wd, lerp_w, b2, one_minus_b2, inv_bc1, inv_bc2, eps;
};

// The tensor of tile `tile`: the last k whose first tile is <= tile (a
// tensor without elements has no tile of its own).
__device__ __forceinline__ int tensor_of(const Table& t, int tile) {
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first[mid] <= tile) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b,
                                          const void* c, const void* d) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) &
          15) == 0;
}

// v summed over the block into thread 0, warps in a fixed order.
template <int K>
__device__ __forceinline__ void block_sum(double (&v)[K], double* scratch) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) scratch[warp * K + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      double s = 0.0;
      for (int w = 0; w < kWarps; ++w) s += scratch[w * K + k];
      v[k] = s;
    }
  }
}

// Sums of squares of the gradients, sliced ([0]) and replicated ([1]).
// partials: 2 a block of all the pass's launches, this launch's from
// 2 * block0; the last of the pass's `blocks` blocks to take a ticket
// (zero before the pass) folds them into sums.
__global__ void __launch_bounds__(kThreads)
    adam_norm_kernel(const __grid_constant__ Table t, double* partials,
                     int block0, int blocks, double* sums,
                     unsigned long long* ticket) {
  __shared__ double scratch[kWarps * 2];
  __shared__ bool last;
  double acc[2] = {0.0, 0.0};
  for (int tile = blockIdx.x; tile < t.tiles; tile += gridDim.x) {
    const int k = tensor_of(t, tile);
    const float* g = t.g[k];
    const long long begin = static_cast<long long>(tile - t.first[k]) * kTile;
    const long long end = min(begin + kTile, t.numel[k]);
    double s = 0.0;
    long long i = begin;
    if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
      const long long vend = begin + ((end - begin) & ~3LL);
      for (i = begin + 4 * threadIdx.x; i < vend; i += 4 * kThreads) {
        const float4 x = *reinterpret_cast<const float4*>(g + i);
        s += static_cast<double>(x.x) * x.x + static_cast<double>(x.y) * x.y +
             static_cast<double>(x.z) * x.z + static_cast<double>(x.w) * x.w;
      }
      i = vend;
    }
    for (long long j = i + threadIdx.x; j < end; j += kThreads) {
      const double x = g[j];
      s += x * x;
    }
    if (t.sliced[k]) {
      acc[0] += s;
    } else {
      acc[1] += s;
    }
  }
  block_sum(acc, scratch);
  if (threadIdx.x == 0) {
    const int row = block0 + blockIdx.x;
    partials[2 * row] = acc[0];
    partials[2 * row + 1] = acc[1];
    __threadfence();
    last = atomicAdd(ticket, 1ULL) ==
           static_cast<unsigned long long>(blocks - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double fold[2] = {0.0, 0.0};
  for (int row = threadIdx.x; row < blocks; row += kThreads) {
    fold[0] += __ldcg(partials + 2 * row);
    fold[1] += __ldcg(partials + 2 * row + 1);
  }
  block_sum(fold, scratch);
  if (threadIdx.x == 0) {
    sums[0] = fold[0];
    sums[1] = fold[1];
  }
}

template <bool kAdam>
__device__ __forceinline__ void step(float& p, float g, float& mu, float& nu,
                                     float factor, const Hyper& h) {
  if (h.clip > 0.f) g = __fmul_rn(g, factor);
  if (h.wd != 0.f) g = __fmaf_rn(h.wd, p, g);
  if (kAdam) {
    mu = __fmaf_rn(h.lerp_w, __fsub_rn(g, mu), mu);
    nu = __fmaf_rn(h.one_minus_b2, __fmul_rn(g, g), __fmul_rn(nu, h.b2));
    const float denom =
        __fadd_rn(__fsqrt_rn(__fmul_rn(nu, h.inv_bc2)), h.eps);
    g = __fdiv_rn(__fmul_rn(mu, h.inv_bc1), denom);
  }
  p = __fmaf_rn(h.lr, g, p);
}

// One update of every element; sums from the norm pass (read when clip is
// on).
template <bool kAdam>
__global__ void __launch_bounds__(kThreads)
    adam_update_kernel(const __grid_constant__ Table t, const Hyper h,
                       const double* sums) {
  float factor = 1.f;
  if (h.clip > 0.f) {
    const float norm = static_cast<float>(sqrt(sums[0] + sums[1]));
    factor = norm < h.clip ? 1.f : __fmul_rn(__frcp_rn(norm), h.clip);
  }
  for (int tile = blockIdx.x; tile < t.tiles; tile += gridDim.x) {
    const int k = tensor_of(t, tile);
    float* p = t.p[k];
    const float* g = t.g[k];
    float* mu = t.mu[k];
    float* nu = t.nu[k];
    const long long begin = static_cast<long long>(tile - t.first[k]) * kTile;
    const long long end = min(begin + kTile, t.numel[k]);
    long long i = begin;
    if (kAdam ? aligned16(p, g, mu, nu) : aligned16(p, g, p, g)) {
      const long long vend = begin + ((end - begin) & ~3LL);
      for (i = begin + 4 * threadIdx.x; i < vend; i += 4 * kThreads) {
        float4 pv = *reinterpret_cast<const float4*>(p + i);
        const float4 gv = *reinterpret_cast<const float4*>(g + i);
        float4 mv = make_float4(0.f, 0.f, 0.f, 0.f), nv = mv;
        if (kAdam) {
          mv = *reinterpret_cast<const float4*>(mu + i);
          nv = *reinterpret_cast<const float4*>(nu + i);
        }
        step<kAdam>(pv.x, gv.x, mv.x, nv.x, factor, h);
        step<kAdam>(pv.y, gv.y, mv.y, nv.y, factor, h);
        step<kAdam>(pv.z, gv.z, mv.z, nv.z, factor, h);
        step<kAdam>(pv.w, gv.w, mv.w, nv.w, factor, h);
        *reinterpret_cast<float4*>(p + i) = pv;
        if (kAdam) {
          *reinterpret_cast<float4*>(mu + i) = mv;
          *reinterpret_cast<float4*>(nu + i) = nv;
        }
      }
      i = vend;
    }
    for (long long j = i + threadIdx.x; j < end; j += kThreads) {
      float pj = p[j], mj = 0.f, nj = 0.f;
      if (kAdam) {
        mj = mu[j];
        nj = nu[j];
      }
      step<kAdam>(pj, g[j], mj, nj, factor, h);
      p[j] = pj;
      if (kAdam) {
        mu[j] = mj;
        nu[j] = nj;
      }
    }
  }
}

// Blocks a launch of `kernel` keeps resident over the current device,
// asked once per device and kernel (`slot`); 0 if the runtime says no.
constexpr int kMaxDevices = 64;

template <typename K>
int grid_cap(K kernel, int slot) {
  static int cache[kMaxDevices][3];
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 0;
  const bool cached = device < kMaxDevices;
  if (cached && cache[device][slot] > 0) return cache[device][slot];
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    0) != cudaSuccess) {
    return 0;
  }
  const int cap = sms * (per_sm > 0 ? per_sm : 1);
  if (cached) cache[device][slot] = cap;
  return cap;
}

// The table of tensors [begin, end): ptrs holds (p, g, mu, nu) a tensor.
void fill(Table& t, const uint64_t* ptrs, const long long* numel,
          const unsigned char* sliced, int begin, int end) {
  t.n = end - begin;
  long long tiles = 0;
  for (int k = 0; k < t.n; ++k) {
    const uint64_t* q = ptrs + 4 * (begin + k);
    t.p[k] = reinterpret_cast<float*>(q[0]);
    t.g[k] = reinterpret_cast<const float*>(q[1]);
    t.mu[k] = reinterpret_cast<float*>(q[2]);
    t.nu[k] = reinterpret_cast<float*>(q[3]);
    t.numel[k] = numel[begin + k];
    t.first[k] = static_cast<int>(tiles);
    t.sliced[k] = sliced ? sliced[begin + k] : 0;
    tiles += (numel[begin + k] + kTile - 1) / kTile;
  }
  t.tiles = static_cast<int>(tiles);
}

// The launches of one pass over n tensors: ceil(n / kMaxTensors), fewer by
// those whose tensors hold no element.
int chunks(int n) { return (n + kMaxTensors - 1) / kMaxTensors; }

// The grid of each launch of a pass over the tensors, and their total.
template <typename K>
int plan(K kernel, int slot, const long long* numel, int n, int* grids) {
  const int cap = grid_cap(kernel, slot);
  int total = 0;
  for (int c = 0; c < chunks(n); ++c) {
    const int end = c * kMaxTensors + kMaxTensors < n
                        ? c * kMaxTensors + kMaxTensors : n;
    long long tiles = 0;
    for (int k = c * kMaxTensors; k < end; ++k) {
      tiles += (numel[k] + kTile - 1) / kTile;
    }
    grids[c] = static_cast<int>(tiles < cap ? tiles : cap);
    total += grids[c];
  }
  return total;
}

}  // namespace

extern "C" {

const char* adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The most tensors one launch takes; a pass over more makes more launches.
int adam_max_tensors(void) { return kMaxTensors; }

// The most blocks a launch of the norm pass has on the current device: the
// partials hold 2 doubles a block of each of the pass's launches.
int adam_norm_blocks(void) { return grid_cap(adam_norm_kernel, 0); }

// The norm pass over n gradients. ptrs: (p, g, mu, nu) a tensor as integers
// (only g is read); numel, sliced: a tensor's element count and whether it is
// a slice over the 'model' axis. partials: 2 * adam_norm_blocks() doubles a
// launch; sums: 2 doubles, written (sliced, replicated); ticket: one uint64,
// zeroed here on the stream before the first launch. *launches gets the
// kernel launches made. Returns the CUDA error code (0 on success).
int adam_norm(const uint64_t* ptrs, const long long* numel,
              const unsigned char* sliced, int n, double* partials,
              double* sums, unsigned long long* ticket, int* launches,
              void* stream) {
  *launches = 0;
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  int grids[kParamBytes / kEntryBytes + 1];
  if (chunks(n) > static_cast<int>(sizeof(grids) / sizeof(int))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = plan(adam_norm_kernel, 0, numel, n, grids);
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(*ticket), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  Table t;
  int block0 = 0;
  for (int c = 0; c < chunks(n); ++c) {
    if (grids[c] == 0) continue;
    const int end = c * kMaxTensors + kMaxTensors < n
                        ? c * kMaxTensors + kMaxTensors : n;
    fill(t, ptrs, numel, sliced, c * kMaxTensors, end);
    adam_norm_kernel<<<grids[c], kThreads, 0, s>>>(t, partials, block0,
                                                   blocks, sums, ticket);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    block0 += grids[c];
    ++*launches;
  }
  return 0;
}

// The update pass over n tensors (adam: Adam, else SGD, whose mu and nu
// pointers are not read). sums: the norm pass's, read when clip > 0; the
// scalars as the kernel's Hyper, the bias corrections as their float
// reciprocals. As adam_norm otherwise.
int adam_update(const uint64_t* ptrs, const long long* numel, int n,
                const double* sums, float clip, float lr, float wd,
                float lerp_w, float b2, float one_minus_b2, float bc1,
                float bc2, float eps, int adam, int* launches,
                void* stream) {
  *launches = 0;
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  int grids[kParamBytes / kEntryBytes + 1];
  if (chunks(n) > static_cast<int>(sizeof(grids) / sizeof(int))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks =
      adam ? plan(adam_update_kernel<true>, 1, numel, n, grids)
           : plan(adam_update_kernel<false>, 2, numel, n, grids);
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  const Hyper h{clip, lr, wd, lerp_w, b2, one_minus_b2,
                1.0f / bc1, 1.0f / bc2, eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Table t;
  for (int c = 0; c < chunks(n); ++c) {
    if (grids[c] == 0) continue;
    const int end = c * kMaxTensors + kMaxTensors < n
                        ? c * kMaxTensors + kMaxTensors : n;
    fill(t, ptrs, numel, nullptr, c * kMaxTensors, end);
    if (adam) {
      adam_update_kernel<true><<<grids[c], kThreads, 0, s>>>(t, h, sums);
    } else {
      adam_update_kernel<false><<<grids[c], kThreads, 0, s>>>(t, h, sums);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }
  return 0;
}

}  // extern "C"
