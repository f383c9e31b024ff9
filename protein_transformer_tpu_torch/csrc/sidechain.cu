// Fused sidechain build: the 10-slot NeRF chain of every residue of a batch
// in one launch (forward), and its reverse replay in one more (backward).
//
// Replaces the TPU kernels of protein_transformer_tpu/ops/sidechain_pallas.py
// (_run_fwd -> _fwd_kernel, _sc_build_bwd -> _bwd_kernel). Per residue there
// is a buffer of 15 points: 0..3 backbone (N, CA, C, O), 4..13 the sidechain
// atoms in build order, 14 the anchor (previous C, or next N for the first
// residue). Slot s < n_sc places point 4 + s by NeRF from three buffer points
// named by frame_idx[s] (backbone, earlier sidechain atoms or the anchor) and
// the slot's bond length, bond angle and torsion; slots s >= n_sc stay exactly
// zero. The backward pass gets the output's cotangent and the built points,
// recomputes each slot's frame from them, last slot first, and accumulates
// the cotangents of the backbone, the anchor and the torsions. Bond lengths
// and angles are constants and get none.
//
// What bounds it on Hopper: the launch. A residue reads ~0.3 KB and writes
// 168 bytes (forward), for ~1.5 kflop: 4,096 residues move ~2 MB and do a few
// Mflop, microseconds of either. What the kernels save is the ~300 small
// launches of the same chain written in tensor ops, and as many again in its
// autograd backward.
//
// Design:
//   * one thread per residue over the flattened (batch, length) axis; the
//     batch is in the grid, where the TPU code used vmap. Residues are
//     independent: no reduction across threads, no atomics, no barrier, the
//     same bits on every call.
//   * the point buffer is indexed by values read at run time (frame_idx), so
//     it cannot live in registers. Each thread owns one column of a shared
//     array pts[45][kThreads] (row = point * 3 + component): neighbouring
//     threads hit neighbouring banks, so there are no bank conflicts. The
//     backward kernel holds the cotangent buffer the same way (46 KB for
//     both at 128 threads, static). The TPU kernel's other choice, a
//     select-sum over every legal candidate, would cost 15 compares and
//     multiplies per coordinate where this is one shared-memory load.
//   * the chain stops at the residue's n_sc: later slots are dead and their
//     zeros are already in the buffer, so padded rows cost nothing.
//   * inputs are the caller's own contiguous tensors, integers as int32; no
//     lane-major packing and no float-coded indices as on the TPU.
//   * fp32 throughout, IEEE division and square root, sincosf (never
//     fast-math): the coordinate gate is 1e-4 A on 1.5 A bonds.
//   * the forward chain runs in coordinates relative to the residue's CA and
//     adds CA back once per atom at the end. The build is translation
//     invariant, and a protein's coordinates reach hundreds of A, where one
//     fp32 rounding is ~1e-5 A: ten chained placements at that magnitude
//     drift by several 1e-5 A (as the plain version does), ten placements
//     within a few A of the origin do not. The backbone passes through
//     untouched, bit for bit.
//   * normalize() clamps the squared norm at eps^2 = 1e-24 and its
//     derivative has a zero branch there, as ops/nerf.py and the TPU kernel.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSlots = 10;       // sidechain atoms per residue, at most
constexpr int kPoints = 15;      // 4 backbone + 10 sidechain + anchor
constexpr int kOutPoints = 14;   // the anchor is not part of the output
constexpr int kAnchor = 14;
constexpr float kEps2 = 1e-24f;  // (1e-12)^2, the clamp of normalize()

struct Vec {
  float x, y, z;
};

__device__ __forceinline__ Vec operator+(Vec a, Vec b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ Vec operator-(Vec a, Vec b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ Vec operator*(float s, Vec a) {
  return {s * a.x, s * a.y, s * a.z};
}
__device__ __forceinline__ float dot(Vec a, Vec b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ Vec cross(Vec a, Vec b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

// 1 / max(|v|, eps), from the clamped squared norm.
__device__ __forceinline__ float inv_norm(Vec v) {
  return 1.0f / sqrtf(fmaxf(dot(v, v), kEps2));
}

// Cotangent of v given the cotangent g of normalize(v):
// r g - [|v|^2 > eps^2] (v . g) r^3 v.
__device__ __forceinline__ Vec normalize_vjp(Vec v, Vec g) {
  const float n2 = dot(v, v);
  const float r = 1.0f / sqrtf(fmaxf(n2, kEps2));
  const float coef = n2 > kEps2 ? dot(v, g) * (r * r * r) : 0.0f;
  return r * g - coef * v;
}

// One thread's column of a [kPoints * 3][kThreads] shared buffer.
struct Column {
  float* base;  // &buffer[0][threadIdx.x]
  __device__ __forceinline__ Vec get(int point) const {
    const float* p = base + point * 3 * kThreads;
    return {p[0], p[kThreads], p[2 * kThreads]};
  }
  __device__ __forceinline__ void set(int point, Vec v) const {
    float* p = base + point * 3 * kThreads;
    p[0] = v.x;
    p[kThreads] = v.y;
    p[2 * kThreads] = v.z;
  }
  __device__ __forceinline__ void add(int point, Vec v) const {
    set(point, get(point) + v);
  }
};

// A frame index from the table, kept inside the buffer whatever it holds.
__device__ __forceinline__ int frame_point(const int* fidx, int slot, int f) {
  return min(max(fidx[slot * 3 + f], 0), kPoints - 1);
}

struct Frame {
  Vec w, x, w_hat, x_hat, z_raw, z_hat, y_hat;
};

// The NeRF frame of atoms a, b, c (the arithmetic of ops/nerf.py::nerf).
__device__ __forceinline__ Frame frame_axes(Vec a, Vec b, Vec c) {
  Frame f;
  f.w = b - a;
  f.x = c - b;
  f.w_hat = inv_norm(f.w) * f.w;
  f.x_hat = inv_norm(f.x) * f.x;
  f.z_raw = cross(f.w_hat, f.x_hat);
  f.z_hat = inv_norm(f.z_raw) * f.z_raw;
  f.y_hat = cross(f.z_hat, f.x_hat);
  return f;
}

// The placed atom's offset from c in the frame's axes: (u1, u2, u3).
__device__ __forceinline__ void local_offset(float len, float ang, float tor,
                                             float* u1, float* u2,
                                             float* u3) {
  float sa, ca, st, ct;
  sincosf(ang, &sa, &ca);
  sincosf(tor, &st, &ct);
  const float lst = len * sa;
  *u1 = -len * ca;
  *u2 = lst * ct;
  *u3 = lst * st;
}

__global__ void __launch_bounds__(kThreads)
sidechain_fwd_kernel(const float* __restrict__ bb,
                     const float* __restrict__ anchor,
                     const float* __restrict__ tor,
                     const float* __restrict__ blen,
                     const float* __restrict__ bang,
                     const int* __restrict__ nsc,
                     const int* __restrict__ fidx, int n_res,
                     float* __restrict__ out) {
  __shared__ float pts_buf[kPoints * 3][kThreads];
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_res) return;
  const Column pts{&pts_buf[0][threadIdx.x]};

  // The buffer holds positions relative to CA (point 1). Entries that no
  // slot has built yet read as zero, as in the plain version; a frame index
  // that points at one is outside the tables' contract either way.
  const float* my_bb = bb + static_cast<size_t>(r) * 12;
  const Vec origin = {my_bb[3], my_bb[4], my_bb[5]};
  for (int k = 0; k < 4; ++k) {
    const float* q = my_bb + 3 * k;
    pts.set(k, Vec{q[0], q[1], q[2]} - origin);
  }
  for (int k = 12; k < 42; ++k) pts.base[k * kThreads] = 0.0f;
  const float* my_anchor = anchor + static_cast<size_t>(r) * 3;
  pts.set(kAnchor, Vec{my_anchor[0], my_anchor[1], my_anchor[2]} - origin);

  const size_t row = static_cast<size_t>(r) * kSlots;
  const int* my_fidx = fidx + row * 3;
  const int n_live = min(nsc[r], kSlots);
  for (int s = 0; s < n_live; ++s) {
    const Vec c = pts.get(frame_point(my_fidx, s, 2));
    const Frame f = frame_axes(pts.get(frame_point(my_fidx, s, 0)),
                               pts.get(frame_point(my_fidx, s, 1)), c);
    float u1, u2, u3;
    local_offset(blen[row + s], bang[row + s], tor[row + s], &u1, &u2, &u3);
    pts.set(4 + s, c + u1 * f.x_hat + u2 * f.y_hat + u3 * f.z_hat);
  }

  // Backbone as given; live atoms moved back by CA; dead slots exactly zero.
  float* my_out = out + static_cast<size_t>(r) * kOutPoints * 3;
  for (int k = 0; k < 12; ++k) my_out[k] = my_bb[k];
  for (int s = 0; s < kSlots; ++s) {
    const Vec p = s < n_live ? pts.get(4 + s) + origin : Vec{0.f, 0.f, 0.f};
    my_out[12 + 3 * s] = p.x;
    my_out[12 + 3 * s + 1] = p.y;
    my_out[12 + 3 * s + 2] = p.z;
  }
}

__global__ void __launch_bounds__(kThreads)
sidechain_bwd_kernel(const float* __restrict__ built,
                     const float* __restrict__ anchor,
                     const float* __restrict__ tor,
                     const float* __restrict__ blen,
                     const float* __restrict__ bang,
                     const int* __restrict__ nsc,
                     const int* __restrict__ fidx,
                     const float* __restrict__ g_out, int n_res,
                     float* __restrict__ g_bb, float* __restrict__ g_anchor,
                     float* __restrict__ g_tor) {
  __shared__ float pts_buf[kPoints * 3][kThreads];
  __shared__ float g_buf[kPoints * 3][kThreads];
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_res) return;
  const Column pts{&pts_buf[0][threadIdx.x]};
  const Column g{&g_buf[0][threadIdx.x]};

  // The finished buffer reproduces every frame: slot s only ever refers to
  // points before 4 + s and to the anchor. The output's backbone points pass
  // through, so their cotangent starts from g_out; the anchor's from zero.
  const size_t o = static_cast<size_t>(r) * kOutPoints * 3;
  for (int k = 0; k < kOutPoints * 3; ++k) {
    pts.base[k * kThreads] = built[o + k];
    g.base[k * kThreads] = g_out[o + k];
  }
  const float* my_anchor = anchor + static_cast<size_t>(r) * 3;
  pts.set(kAnchor, {my_anchor[0], my_anchor[1], my_anchor[2]});
  g.set(kAnchor, {0.0f, 0.0f, 0.0f});

  const size_t row = static_cast<size_t>(r) * kSlots;
  const int* my_fidx = fidx + row * 3;
  const int n_live = min(nsc[r], kSlots);
  for (int s = kSlots - 1; s >= n_live; --s) g_tor[row + s] = 0.0f;
  for (int s = n_live - 1; s >= 0; --s) {
    const int ia = frame_point(my_fidx, s, 0);
    const int ib = frame_point(my_fidx, s, 1);
    const int ic = frame_point(my_fidx, s, 2);
    const Frame f = frame_axes(pts.get(ia), pts.get(ib), pts.get(ic));
    float u1, u2, u3;
    local_offset(blen[row + s], bang[row + s], tor[row + s], &u1, &u2, &u3);

    // pt = c + u1 x^ + u2 y^ + u3 z^, with u2 = l sin(ang) cos(tor) and
    // u3 = l sin(ang) sin(tor): d pt / d tor = -u3 y^ + u2 z^.
    const Vec gp = g.get(4 + s);
    g_tor[row + s] = -u3 * dot(gp, f.y_hat) + u2 * dot(gp, f.z_hat);

    const Vec g_y_hat = u2 * gp;
    // y^ = z^ x x^
    const Vec g_z_hat = u3 * gp + cross(f.x_hat, g_y_hat);
    Vec g_x_hat = u1 * gp + cross(g_y_hat, f.z_hat);
    // z^ = normalize(z_raw), z_raw = w^ x x^
    const Vec g_z_raw = normalize_vjp(f.z_raw, g_z_hat);
    const Vec g_w_hat = cross(f.x_hat, g_z_raw);
    g_x_hat = g_x_hat + cross(g_z_raw, f.w_hat);
    // w^ = normalize(b - a), x^ = normalize(c - b)
    const Vec g_w = normalize_vjp(f.w, g_w_hat);
    const Vec g_x = normalize_vjp(f.x, g_x_hat);
    g.add(ia, -1.0f * g_w);
    g.add(ib, g_w - g_x);
    g.add(ic, gp + g_x);
  }

  float* my_g_bb = g_bb + static_cast<size_t>(r) * 12;
  for (int k = 0; k < 12; ++k) my_g_bb[k] = g.base[k * kThreads];
  const Vec ga = g.get(kAnchor);
  float* my_g_anchor = g_anchor + static_cast<size_t>(r) * 3;
  my_g_anchor[0] = ga.x;
  my_g_anchor[1] = ga.y;
  my_g_anchor[2] = ga.z;
}

}  // namespace

extern "C" {

const char* sidechain_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Forward. All tensors contiguous over n_res = batch * length residues:
// bb (n_res, 4, 3), anchor (n_res, 3), tor / blen / bang (n_res, 10) float32;
// nsc (n_res,) and fidx (n_res, 10, 3) int32; out (n_res, 14, 3) float32.
// Launches on `stream`; returns the CUDA error code (0 on success).
int sidechain_fwd(const float* bb, const float* anchor, const float* tor,
                  const float* blen, const float* bang, const int* nsc,
                  const int* fidx, int n_res, float* out, void* stream) {
  if (n_res <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_res + kThreads - 1) / kThreads;
  sidechain_fwd_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      bb, anchor, tor, blen, bang, nsc, fidx, n_res, out);
  return static_cast<int>(cudaGetLastError());
}

// Backward. built (n_res, 14, 3) is the forward's output, g_out its
// cotangent; the other inputs as in the forward. Writes g_bb (n_res, 4, 3),
// g_anchor (n_res, 3) and g_tor (n_res, 10), every element of each.
int sidechain_bwd(const float* built, const float* anchor, const float* tor,
                  const float* blen, const float* bang, const int* nsc,
                  const int* fidx, const float* g_out, int n_res, float* g_bb,
                  float* g_anchor, float* g_tor, void* stream) {
  if (n_res <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_res + kThreads - 1) / kThreads;
  sidechain_bwd_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      built, anchor, tor, blen, bang, nsc, fidx, g_out, n_res, g_bb,
      g_anchor, g_tor);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
