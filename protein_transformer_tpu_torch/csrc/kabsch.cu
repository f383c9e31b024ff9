// Weighted Kabsch superposition RMSD of a batch of point sets, one launch
// (K5, forward only). Not a port of a TPU kernel: the JAX package computes
// this metric with XLA's SVD (protein_transformer_tpu/losses.py). On the
// card it replaces torch.linalg.svd, whose cuSOLVER call waits for the
// stream twice, and the tensor operations around it: 57 device operations
// become one.
//
// Per protein p, over its N points with 0/1 weights w (the same mathematics
// as losses.py::kabsch_rmsd_masked, in this order):
//   total = max(sum w, 1);  a_bar, b_bar the weighted centroids;
//   H = sum_n (w (a - a_bar)) (w (b - b_bar))^T, 3x3;
//   R = U diag(1, 1, sign det(U V^T)) V^T from the SVD H = U S V^T;
//   out = sqrt(sum_n w |(a - a_bar) R - (b - b_bar)|^2 / total),
// with points as row vectors. The residual is summed over the points, not
// taken from the closed form E0 - 2 tr(S): that cancels badly on a good fit.
// An all-zero w gives 0; a reflection is never fitted; NaN or Inf anywhere
// in a protein's points gives NaN (its centroid carries it to every point),
// as the tensor version.
//
// What bounds it on Hopper: bytes. The points and the mask are read once,
// B * N * (24 + the mask's bytes): ~5.6 MB at B = 32, N = 7,000 with a bool
// mask, ~1.7 us at 3.35 TB/s. The second and third reads come from L2.
//
// Design:
//   * one block of 512 threads a protein, three passes over its points
//     (weighted sums, centred covariance, residual), each point's terms in
//     fp64 from its fp32 coordinates, reduced over the block by warp
//     shuffles and a fixed-order sum of the warps' partials: the same bits
//     on every call, no atomics.
//   * the 3x3 SVD by one thread in fp64: one-sided Jacobi on the columns of
//     H (each rotation orthogonalises two columns; V accumulates the
//     rotations), at most kMaxSweeps sweeps, so that NaN input ends and
//     cannot hang. The columns are then ordered by norm, a swap negating
//     one column, so V stays a rotation. U's first two columns are the
//     normalised columns (a column of norm 0, or one left along the first,
//     is replaced by a unit vector orthogonal to it) and its third their
//     cross product, so U is a rotation too: H = U diag(s1, s2, +-s3) V^T,
//     and R = U V^T is the Kabsch rotation, the sign correction folded into
//     the smallest singular value, the one the tensor version flips.
//     Rank-deficient H (one, two, collinear or coplanar points) needs no
//     branch beyond the replacement: every completion is an optimum.
//   * w is the caller's bool atom mask, read as it is (one byte a point).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSweeps = 16;
constexpr double kEps = 2.220446049250313e-16;  // fp64 machine epsilon

// v summed over the block, the result in every thread. `scratch` holds
// kWarps * K doubles; the leading barrier lets a previous call's readers
// finish with it.
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
#pragma unroll
  for (int k = 0; k < K; ++k) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += scratch[w * K + k];
    v[k] = s;
  }
}

// A unit vector orthogonal to the unit vector u: the axis along which u is
// shortest, less its component along u.
__device__ void orthogonal_to(const double (&u)[3], double (&out)[3]) {
  int k = 0;
  if (fabs(u[1]) < fabs(u[k])) k = 1;
  if (fabs(u[2]) < fabs(u[k])) k = 2;
  double n2 = 0.0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out[i] = (i == k ? 1.0 : 0.0) - u[k] * u[i];
    n2 += out[i] * out[i];
  }
  const double inv = 1.0 / sqrt(n2);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] *= inv;
}

// The Kabsch rotation of the 3x3 covariance h (row-major): rot[i * 3 + j]
// maps a centred row vector x to sum_i x_i rot[i][j].
__device__ void kabsch_rotation(const double (&h)[9], double* rot) {
  double a[3][3], v[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      a[i][j] = h[i * 3 + j];
      v[i][j] = i == j ? 1.0 : 0.0;
    }
  }
  const int pairs[3][2] = {{0, 1}, {0, 2}, {1, 2}};
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    bool rotated = false;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int p = pairs[r][0], q = pairs[r][1];
      double alpha = 0.0, beta = 0.0, gamma = 0.0;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        alpha += a[k][p] * a[k][p];
        beta += a[k][q] * a[k][q];
        gamma += a[k][p] * a[k][q];
      }
      // false for NaN: no rotation, and the sweeps end
      if (!(fabs(gamma) > kEps * sqrt(alpha * beta))) continue;
      const double zeta = (beta - alpha) / (2.0 * gamma);
      const double t = copysign(1.0, zeta) /
                       (fabs(zeta) + sqrt(1.0 + zeta * zeta));
      const double c = 1.0 / sqrt(1.0 + t * t);
      const double s = c * t;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const double ap = a[k][p], aq = a[k][q];
        a[k][p] = c * ap - s * aq;
        a[k][q] = s * ap + c * aq;
        const double vp = v[k][p], vq = v[k][q];
        v[k][p] = c * vp - s * vq;
        v[k][q] = s * vp + c * vq;
      }
      rotated = true;
    }
    if (!rotated) break;
  }
  double sig[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    sig[j] = sqrt(a[0][j] * a[0][j] + a[1][j] * a[1][j] + a[2][j] * a[2][j]);
  }
  // columns by norm, largest first; (p, q) <- (q, -p) keeps det V = +1
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int p = r == 1 ? 1 : 0, q = p + 1;
    if (sig[q] > sig[p]) {
      const double t = sig[p];
      sig[p] = sig[q];
      sig[q] = t;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const double ap = a[k][p], vp = v[k][p];
        a[k][p] = a[k][q];
        a[k][q] = -ap;
        v[k][p] = v[k][q];
        v[k][q] = -vp;
      }
    }
  }
  double u0[3], u1[3], u2[3];
  if (sig[0] > 0.0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) u0[k] = a[k][0] / sig[0];
  } else {
    u0[0] = 1.0;
    u0[1] = u0[2] = 0.0;
  }
  double along = 0.0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    u1[k] = sig[1] > 0.0 ? a[k][1] / sig[1] : 0.0;
    along += u0[k] * u1[k];
  }
  double n2 = 0.0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    u1[k] -= along * u0[k];
    n2 += u1[k] * u1[k];
  }
  if (n2 > 0.25) {
    const double inv = 1.0 / sqrt(n2);
#pragma unroll
    for (int k = 0; k < 3; ++k) u1[k] *= inv;
  } else {
    orthogonal_to(u0, u1);
  }
  u2[0] = u0[1] * u1[2] - u0[2] * u1[1];
  u2[1] = u0[2] * u1[0] - u0[0] * u1[2];
  u2[2] = u0[0] * u1[1] - u0[1] * u1[0];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      rot[i * 3 + j] = u0[i] * v[j][0] + u1[i] * v[j][1] + u2[i] * v[j][2];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    kabsch_rmsd_kernel(const float* __restrict__ a,
                       const float* __restrict__ b,
                       const uint8_t* __restrict__ w, int n,
                       float* __restrict__ out) {
  __shared__ double scratch[kWarps * 9];
  __shared__ double rot[9];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * n;
  const float* pa = a + base * 3;
  const float* pb = b + base * 3;
  const uint8_t* pw = w + base;

  // pass 1: the weight and the weighted sums of a and b
  double s[7] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const double wi = pw[i];
    s[0] += wi;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s[1 + c] += static_cast<double>(pa[3 * i + c]) * wi;
      s[4 + c] += static_cast<double>(pb[3 * i + c]) * wi;
    }
  }
  block_sum(s, scratch);
  // clamp(total, min=1), NaN kept
  const double total = s[0] < 1.0 ? 1.0 : s[0];
  double am[3], bm[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    am[c] = s[1 + c] / total;
    bm[c] = s[4 + c] / total;
  }

  // pass 2: the centred, masked covariance
  double h[9] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const double wi = pw[i];
    double ac[3], bc[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      ac[c] = (static_cast<double>(pa[3 * i + c]) - am[c]) * wi;
      bc[c] = (static_cast<double>(pb[3 * i + c]) - bm[c]) * wi;
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) h[r * 3 + c] += ac[r] * bc[c];
    }
  }
  block_sum(h, scratch);
  if (threadIdx.x == 0) kabsch_rotation(h, rot);
  __syncthreads();
  double r[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) r[k] = rot[k];

  // pass 3: the residual of the fit, point by point
  double res[1] = {0.0};
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const double wi = pw[i];
    double ac[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      ac[c] = static_cast<double>(pa[3 * i + c]) - am[c];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const double d = (ac[0] * r[c] + ac[1] * r[3 + c] + ac[2] * r[6 + c] -
                        (static_cast<double>(pb[3 * i + c]) - bm[c])) * wi;
      res[0] += d * d;
    }
  }
  block_sum(res, scratch);
  if (threadIdx.x == 0) {
    out[blockIdx.x] = static_cast<float>(sqrt(res[0] / total));
  }
}

}  // namespace

extern "C" {

const char* kabsch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// a, b (batch, n, 3) float32 and w (batch, n) bool, all contiguous; out
// (batch,) float32, every element written. Launches on `stream`; returns the
// CUDA error code (0 on success).
int kabsch_rmsd_fwd(const float* a, const float* b, const uint8_t* w,
                    float* out, int batch, int n, void* stream) {
  if (batch < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  kabsch_rmsd_kernel<<<batch, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a, b, w, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
