// Fused sidechain build for Hopper: the 10-slot NeRF chain of every residue
// of a batch in one launch (K2a, forward), and its reverse replay in one more
// (K2b, backward). Each block looks up its residues' force-field records
// itself.
//
// Replaces the TPU kernels of protein_transformer_tpu/ops/sidechain_pallas.py
// (_run_fwd -> _fwd_kernel, _sc_build_bwd -> _bwd_kernel). Those receive
// per-residue tables gathered ahead of the call, as a TPU's scalar prefetch
// wants; here the inputs are the backbone (n_res, 4, 3), the angles
// (n_res, 12), the sequence (n_res,) as int32 or int64, and the packed table
// (24 residue types x kRecord floats, ops/sidechain.py::pack_table), over the
// flattened (batch, length) axis in rows of `length` residues.
//
// Per residue there is a buffer of 15 points: 0..3 backbone (N, CA, C, O),
// 4..13 the sidechain atoms in build order, 14 the anchor. Slot s < n_sc
// places point 4 + s by NeRF from three buffer points named by the record's
// frame indices, with the slot's bond length, bond angle and torsion; slots
// s >= n_sc stay exactly zero. Inside the kernel, per residue:
//   * the type: the sequence id clamped to [0, 23];
//   * residue 0 of a row frames its slot 0 by (anchor, C, CA);
//   * the anchor: N of residue 1 for residue 0 of a row, C of residue i - 1
//     otherwise, the residue's own C when length == 1: always inside the
//     residue's own row;
//   * the torsion: angles[6 + src] (the column clamped to [0, 11]) where the
//     record says the slot's torsion is predicted, else its constant, minus
//     its pi offset.
// The backward gets the output's cotangent and the built points, replays
// each slot's frame from them, last slot first, and returns the cotangents
// of the backbone, the anchor's folded into the atom it was, and of the
// angles: each column the sum over the slots that read it, in slot order;
// zero where no slot reads it. Bond lengths and angles are constants.
//
// What bounds it on Hopper: not bytes. A residue moves 272 bytes forward
// (bb 48, angles 48, an int64 id 8, output 168; the anchor is a neighbour's
// bb) and 488 backward (built points and their cotangent 336, angles 48,
// id 8, the two cotangents 96), plus the 9 KB table once: ~1.1 and ~2 MB at
// B=16 x L=256, under a microsecond at 3.35 TB/s. The floor is the launch
// and the dependent chain of ten placements that one thread runs for its
// residue: forward, each placement two normalisations (IEEE square root and
// division) deep; backward, each slot's replay a few dozen dependent
// multiply-adds once the frames are known.
//
// Design:
//   * a block of ten warps serves 32 residues forward and 30 backward, whose
//     32 chain lanes hold one halo residue at each end: 128 and 137 blocks at
//     B=16 x L=256, so every SM has a chain warp.
//   * what a block reads and writes goes through shared memory in 16-byte
//     accesses over contiguous ranges: the table (staged by every block, from
//     L2 after the first), the block's backbone or built rows with their
//     neighbours, its angles, its output rows or its cotangents.
//   * the 20 (sin, cos) of a residue depend on no placement: warp s computes
//     slot s's two before the chain, into the slot's offset (u1, u2, u3),
//     beside its three frame points. Warp 0 then runs the chains, one lane a
//     residue, in shared memory; all warps then finish the rows.
//   * in the backward the built points give every slot's frame at once, so
//     warp s computes slot s's frame too (w, x and three inverse norms); the
//     serial replay is left with multiplications and additions, no square
//     root or division, and each lane sums its torsions' cotangents into its
//     angles' row as it goes.
//   * the forward builds relative to the residue's CA inside the block's
//     output rows and adds CA back once per atom: a protein's coordinates
//     reach hundreds of A, where one fp32 rounding is ~1e-5 A, and ten chained
//     placements there drift by several. The backbone passes through bit for
//     bit.
//   * the backward folds each anchor's cotangent into its neighbour's C (or
//     into N of residue 1) itself: each block replays the two halo residues
//     whose anchors are its own atoms. No atomics, no second pass: the same
//     bits on every call.
//   * fp32 throughout, IEEE division and square root, sincosf (never
//     fast-math): the coordinate gate is 1e-4 A on 1.5 A bonds. normalize()
//     clamps the squared norm at eps^2 = 1e-24 and its derivative has a zero
//     branch there, as ops/nerf.py and the TPU kernel.
//   * occupancy (nvcc -Xptxas -v, sm_90a): 48 registers a thread in both
//     kernels, no spills; static shared memory 23,200 bytes a forward block
//     and 42,336 a backward block. An SM could hold four blocks of 320
//     threads (registers bound it); these shapes give it one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 10;                 // sidechain atoms, at most
constexpr int kWarps = kSlots;             // warp s computes slot s
constexpr int kThreads = 32 * kWarps;
constexpr int kLanes = 32;                 // chain lanes of a block: warp 0
constexpr int kFwdResidues = kLanes;       // output rows of a forward block
constexpr int kBwdResidues = kLanes - 2;   // of a backward block
constexpr unsigned char kNoColumn = 0xff;  // a torsion that reads no angle
constexpr int kBb = 12;                    // floats of a residue's backbone
constexpr int kRow = 42;                   // floats of its output row
constexpr int kAngles = 12;
constexpr int kChi0 = 6;                   // column of chi0 in the angles
constexpr int kAnchor = 14;                // the anchor's buffer point
constexpr int kTypes = 24;
constexpr float kEps2 = 1e-24f;            // (1e-12)^2, the clamp of normalize()

// A record of the packed table, one per residue type, in floats; the
// integers are exact. ops/sidechain.py::TABLE_LAYOUT has the same offsets.
constexpr int kRecord = 96;
constexpr int kBondLen = 0;
constexpr int kBondAng = 10;
constexpr int kTorConst = 20;
constexpr int kTorOffset = 30;
constexpr int kTorType = 40;               // 1: predicted, 0: constant
constexpr int kTorSrc = 50;
constexpr int kFrame = 60;                 // 10 x 3 buffer points
constexpr int kNumAtoms = 90;

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
__device__ __forceinline__ Vec load3(const float* p) {
  return {p[0], p[1], p[2]};
}

// 1 / max(|v|, eps), from the clamped squared norm.
__device__ __forceinline__ float inv_norm(Vec v) {
  return 1.0f / sqrtf(fmaxf(dot(v, v), kEps2));
}

// Cotangent of v given the cotangent g of normalize(v) and r = inv_norm(v):
// r g - [|v|^2 > eps^2] (v . g) r^3 v.
__device__ __forceinline__ Vec normalize_vjp(Vec v, float r, Vec g) {
  const float coef = dot(v, v) > kEps2 ? dot(v, g) * (r * r * r) : 0.0f;
  return r * g - coef * v;
}

// The NeRF frame of atoms a, b, c (the arithmetic of ops/nerf.py::nerf).
// w = b - a, x = c - b and the inverse norms of w, x and z_raw determine
// it: the nine floats the backward keeps per slot. axes() gives the rest
// with multiplications and cross products alone.
struct Frame {
  Vec w, x;
  float r_w, r_x, r_z;
  Vec w_hat, x_hat, z_raw, z_hat, y_hat;

  __device__ __forceinline__ void axes() {
    w_hat = r_w * w;
    x_hat = r_x * x;
    z_raw = cross(w_hat, x_hat);
    z_hat = r_z * z_raw;
    y_hat = cross(z_hat, x_hat);
  }
};

__device__ __forceinline__ Frame frame_of(Vec a, Vec b, Vec c) {
  Frame f;
  f.w = b - a;
  f.x = c - b;
  f.r_w = inv_norm(f.w);
  f.r_x = inv_norm(f.x);
  f.r_z = inv_norm(cross(f.r_w * f.w, f.r_x * f.x));
  f.axes();
  return f;
}

// A frame's nine floats in rows 9 s .. 9 s + 8 of a [9 kSlots][kLanes]
// shared array, one column a lane.
__device__ __forceinline__ void put_frame(float (*rows)[kLanes], int s,
                                          int lane, const Frame& f) {
  const float v[9] = {f.w.x, f.w.y, f.w.z, f.x.x, f.x.y, f.x.z,
                      f.r_w, f.r_x, f.r_z};
#pragma unroll
  for (int k = 0; k < 9; ++k) rows[9 * s + k][lane] = v[k];
}

__device__ __forceinline__ Frame get_frame(float (*rows)[kLanes],
                                           int s, int lane) {
  Frame f;
  f.w = {rows[9 * s][lane], rows[9 * s + 1][lane], rows[9 * s + 2][lane]};
  f.x = {rows[9 * s + 3][lane], rows[9 * s + 4][lane],
         rows[9 * s + 5][lane]};
  f.r_w = rows[9 * s + 6][lane];
  f.r_x = rows[9 * s + 7][lane];
  f.r_z = rows[9 * s + 8][lane];
  f.axes();
  return f;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// dst[0, n) = src[0, n), shared memory from device memory, by every thread
// of the block: 16-byte accesses where both ends are 16-byte aligned (the
// callers' offsets keep them so on the caching allocator's tensors), one
// float at a time otherwise and for the last n % 4.
__device__ __forceinline__ void stage(float* dst,
                                      const float* __restrict__ src, int n) {
  int done = 0;
  if (aligned16(dst) && aligned16(src)) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < n / 4; i += kThreads) d4[i] = __ldg(s4 + i);
    done = n / 4 * 4;
  }
  for (int i = done + threadIdx.x; i < n; i += kThreads)
    dst[i] = __ldg(src + i);
}

// dst[0, n) = src[0, n), device memory from shared memory, likewise.
__device__ __forceinline__ void unstage(float* __restrict__ dst,
                                        const float* src, int n) {
  int done = 0;
  if (aligned16(dst) && aligned16(src)) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < n / 4; i += kThreads) d4[i] = s4[i];
    done = n / 4 * 4;
  }
  for (int i = done + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

// The residue type of residue r: its id clamped to the table.
__device__ __forceinline__ int residue_type(const void* seq, int seq64,
                                            long long r) {
  const long long id = seq64 ? static_cast<const long long*>(seq)[r]
                             : static_cast<const int*>(seq)[r];
  return static_cast<int>(min(max(id, 0LL), (long long)(kTypes - 1)));
}

__device__ __forceinline__ int as_int(float v) { return __float2int_rn(v); }

__device__ __forceinline__ int live_slots(const float* rec) {
  return min(max(as_int(rec[kNumAtoms]), 0), kSlots);
}

__device__ __forceinline__ bool predicted(const float* rec, int s) {
  return as_int(rec[kTorType + s]) == 1;
}

// The column of the angles that a predicted torsion of slot s reads.
__device__ __forceinline__ int chi_column(const float* rec, int s) {
  return min(max(kChi0 + as_int(rec[kTorSrc + s]), 0), kAngles - 1);
}

// Frame point f of slot s, kept inside the buffer whatever the table holds;
// residue 0 of a row frames its slot 0 by (anchor, C, CA).
__device__ __forceinline__ int frame_point(const float* rec, int s, int f,
                                           bool first) {
  if (first && s == 0) return f == 0 ? kAnchor : (f == 1 ? 2 : 1);
  return min(max(as_int(rec[kFrame + 3 * s + f]), 0), kAnchor);
}

// Slot s's offset from its frame's c along the frame's axes (u1, u2, u3):
// the slot's two sincosf, which no placement feeds.
__device__ __forceinline__ void slot_offset(const float* rec,
                                            const float* angles, int s,
                                            float* u1, float* u2, float* u3) {
  const float chi = predicted(rec, s) ? angles[chi_column(rec, s)]
                                      : rec[kTorConst + s];
  const float len = rec[kBondLen + s];
  float sa, ca, st, ct;
  sincosf(rec[kBondAng + s], &sa, &ca);
  sincosf(chi - rec[kTorOffset + s], &st, &ct);
  const float lst = len * sa;
  *u1 = -len * ca;
  *u2 = lst * ct;
  *u3 = lst * st;
}

// Where a residue's anchor lies, given a pointer p to its row of rows of
// `stride` floats whose backbone starts each row, and its position in its
// protein's row.
__device__ __forceinline__ const float* anchor_at(const float* p, int stride,
                                                  int pos, int length) {
  if (pos != 0) return p - stride + 6;      // C of residue i - 1
  return length == 1 ? p + 6 : p + stride;  // own C, or N of residue 1
}

__global__ void __launch_bounds__(kThreads)
sidechain_fwd_kernel(const float* __restrict__ bb,
                     const float* __restrict__ angles,
                     const void* __restrict__ seq, int seq64,
                     const float* __restrict__ table, int n_res, int length,
                     float* __restrict__ out) {
  __shared__ __align__(16) float s_table[kTypes * kRecord];
  // row i: the backbone of residue r0 - 1 + i
  __shared__ __align__(16) float s_bb[(kFwdResidues + 2) * kBb];
  __shared__ __align__(16) float s_angles[kFwdResidues * kAngles];
  // the block's output rows; the chain runs in them relative to CA
  __shared__ __align__(16) float s_rows[kFwdResidues * kRow];
  __shared__ float s_u[3 * kSlots][kLanes];
  __shared__ unsigned char s_idx[3 * kSlots][kLanes];  // frame points
  __shared__ float s_anchor[3][kLanes];
  __shared__ int s_type[kLanes];
  __shared__ int s_live[kLanes];

  const int r0 = blockIdx.x * kFwdResidues;
  const int n = min(kFwdResidues, n_res - r0);
  const int lo = max(r0 - 1, 0);
  const int hi = min(r0 + kFwdResidues + 1, n_res);
  stage(s_table, table, kTypes * kRecord);
  stage(s_bb + (lo - (r0 - 1)) * kBb, bb + static_cast<size_t>(lo) * kBb,
        (hi - lo) * kBb);
  stage(s_angles, angles + static_cast<size_t>(r0) * kAngles, n * kAngles);
  if (threadIdx.x < n)
    s_type[threadIdx.x] = residue_type(seq, seq64, r0 + threadIdx.x);
  __syncthreads();

  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  float* row = s_rows + lane * kRow;
  if (lane < n) {
    const float* rec = s_table + s_type[lane] * kRecord;
    const int n_live = live_slots(rec);
    const int s = warp;
    if (s < n_live) {
      slot_offset(rec, s_angles + lane * kAngles, s, &s_u[3 * s][lane],
                  &s_u[3 * s + 1][lane], &s_u[3 * s + 2][lane]);
      const bool first = (r0 + lane) % length == 0;
      for (int f = 0; f < 3; ++f)
        s_idx[3 * s + f][lane] = frame_point(rec, s, f, first);
    }
    // The buffer relative to CA: the backbone, zeros where the slots go
    // (an entry no slot has built yet reads as zero, as in the plain
    // version), and the anchor; by the warps of the slots that fewest
    // residues have.
    const float* own = s_bb + (lane + 1) * kBb;
    if (warp == kWarps - 1) {
      for (int k = 0; k < kBb; ++k) row[k] = own[k] - own[3 + k % 3];
    } else if (warp == kWarps - 2) {
      for (int k = kBb; k < kRow; ++k) row[k] = 0.0f;
    } else if (warp == kWarps - 3) {
      const float* a = anchor_at(own, kBb, (r0 + lane) % length, length);
      for (int c = 0; c < 3; ++c) s_anchor[c][lane] = a[c] - own[3 + c];
    } else if (warp == 0) {
      s_live[lane] = n_live;
    }
  }
  __syncthreads();

  if (warp == 0 && lane < n) {
    const int n_live = s_live[lane];
    const Vec anchor = {s_anchor[0][lane], s_anchor[1][lane],
                        s_anchor[2][lane]};
    auto point = [&](int p) {
      return p == kAnchor ? anchor : load3(row + 3 * p);
    };
    // Unrolled, so that the next slot's indices and offsets load while
    // this slot's atom is placed.
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (s >= n_live) break;
      const Vec c = point(s_idx[3 * s + 2][lane]);
      const Frame f = frame_of(point(s_idx[3 * s][lane]),
                               point(s_idx[3 * s + 1][lane]), c);
      const Vec p = c + s_u[3 * s][lane] * f.x_hat
                  + s_u[3 * s + 1][lane] * f.y_hat
                  + s_u[3 * s + 2][lane] * f.z_hat;
      row[kBb + 3 * s] = p.x;
      row[kBb + 3 * s + 1] = p.y;
      row[kBb + 3 * s + 2] = p.z;
    }
  }
  __syncthreads();
  // Backbone as given; live atoms moved back by CA; dead slots stay zero.
  for (int e = threadIdx.x; e < n * kRow; e += kThreads) {
    const int j = e / kRow;
    const int k = e % kRow;
    const float* own = s_bb + (j + 1) * kBb;
    if (k < kBb) {
      s_rows[e] = own[k];
    } else if (k < kBb + 3 * s_live[j]) {
      s_rows[e] += own[3 + k % 3];
    }
  }
  __syncthreads();
  unstage(out + static_cast<size_t>(r0) * kRow, s_rows, n * kRow);
}

__global__ void __launch_bounds__(kThreads)
sidechain_bwd_kernel(const float* __restrict__ built,
                     const float* __restrict__ angles,
                     const void* __restrict__ seq, int seq64,
                     const float* __restrict__ table,
                     const float* __restrict__ g_out, int n_res, int length,
                     float* __restrict__ g_bb, float* __restrict__ g_angles) {
  __shared__ __align__(16) float s_table[kTypes * kRecord];
  // row i: the built points of residue r0 - 2 + i, and their cotangent,
  // which the replay accumulates into
  __shared__ __align__(16) float s_built[(kLanes + 2) * kRow];
  __shared__ __align__(16) float s_g[(kLanes + 2) * kRow];
  // lane j replays residue r0 - 1 + j: row j of the angles, j + 1 above
  __shared__ __align__(16) float s_angles[kLanes * kAngles];
  __shared__ __align__(16) float s_g_bb[kBwdResidues * kBb];
  __shared__ __align__(16) float s_g_angles[kBwdResidues * kAngles];
  __shared__ float s_u[3 * kSlots][kLanes];
  __shared__ unsigned char s_idx[3 * kSlots][kLanes];  // frame points
  __shared__ unsigned char s_col[kSlots][kLanes];      // chi_column or none
  __shared__ float s_frame[9 * kSlots][kLanes];        // see put_frame
  __shared__ float s_g_anchor[3][kLanes];
  __shared__ int s_type[kLanes];
  __shared__ int s_pos[kLanes];                        // in the protein

  const int r0 = blockIdx.x * kBwdResidues;
  const int n = min(kBwdResidues, n_res - r0);
  {
    const int lo = max(r0 - 2, 0);
    const int hi = min(r0 + kLanes, n_res);
    const int at = (lo - (r0 - 2)) * kRow;
    stage(s_table, table, kTypes * kRecord);
    stage(s_built + at, built + static_cast<size_t>(lo) * kRow,
          (hi - lo) * kRow);
    stage(s_g + at, g_out + static_cast<size_t>(lo) * kRow,
          (hi - lo) * kRow);
    const int a_lo = max(r0 - 1, 0);
    const int a_hi = min(r0 + kLanes - 1, n_res);
    stage(s_angles + (a_lo - (r0 - 1)) * kAngles,
          angles + static_cast<size_t>(a_lo) * kAngles,
          (a_hi - a_lo) * kAngles);
  }
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int r = r0 - 1 + lane;
  const int pos = r >= 0 ? r % length : 0;
  // The lanes that replay: the block's residues, and a halo residue whose
  // anchor is one of their atoms (N of residue 1 for residue 0 on the
  // left, C of residue i - 1 on the right).
  const bool runs = r >= 0 && r < n_res &&
                    ((lane >= 1 && lane <= n) ||
                     (lane == 0 && pos == 0 && length > 1) ||
                     (lane == n + 1 && pos != 0));
  if (warp == 0) {
    s_pos[lane] = pos;
    if (runs) s_type[lane] = residue_type(seq, seq64, r);
  }
  __syncthreads();

  if (runs) {
    // The built points reproduce every frame: slot s only ever refers to
    // points before 4 + s and to the anchor. So the frames, with their
    // square roots and divisions, are all computed here, on every warp, and
    // the replay below is multiplications and additions.
    const float* rec = s_table + s_type[lane] * kRecord;
    const int n_live = live_slots(rec);
    const float* pts = s_built + (lane + 1) * kRow;
    const Vec anchor = load3(anchor_at(pts, kRow, pos, length));
    auto point = [&](int p) {
      return p == kAnchor ? anchor : load3(pts + 3 * p);
    };
    const int s = warp;
    if (s < n_live) {
      slot_offset(rec, s_angles + lane * kAngles, s, &s_u[3 * s][lane],
                  &s_u[3 * s + 1][lane], &s_u[3 * s + 2][lane]);
      s_col[s][lane] = predicted(rec, s) ? chi_column(rec, s) : kNoColumn;
      int idx[3];
      for (int f = 0; f < 3; ++f) {
        idx[f] = frame_point(rec, s, f, pos == 0);
        s_idx[3 * s + f][lane] = idx[f];
      }
      put_frame(s_frame, s, lane,
                frame_of(point(idx[0]), point(idx[1]), point(idx[2])));
    }
  }
  __syncthreads();

  if (warp == 0 && runs) {
    // The output's backbone points pass through, so their cotangent starts
    // from g_out; the anchor's from zero. A residue of the block sums its
    // torsions' cotangents into its angles' row, last slot first; a halo
    // residue keeps only its anchor's.
    const int n_live = live_slots(s_table + s_type[lane] * kRecord);
    float* g = s_g + (lane + 1) * kRow;
    Vec g_anchor = {0.0f, 0.0f, 0.0f};
    const bool own_row = lane >= 1 && lane <= n;
    float* g_ang = s_g_angles + (lane - 1) * kAngles;
    if (own_row)
      for (int k = 0; k < kAngles; ++k) g_ang[k] = 0.0f;
    auto add = [&](int p, Vec v) {
      if (p == kAnchor) {
        g_anchor = g_anchor + v;
      } else {
        g[3 * p] += v.x;
        g[3 * p + 1] += v.y;
        g[3 * p + 2] += v.z;
      }
    };
    // Unrolled, so that a slot's frame, offsets and indices load while the
    // slot after it is replayed.
#pragma unroll
    for (int s = kSlots - 1; s >= 0; --s) {
      if (s >= n_live) continue;
      const int ia = s_idx[3 * s][lane];
      const int ib = s_idx[3 * s + 1][lane];
      const int ic = s_idx[3 * s + 2][lane];
      const Frame f = get_frame(s_frame, s, lane);
      const float u1 = s_u[3 * s][lane];
      const float u2 = s_u[3 * s + 1][lane];
      const float u3 = s_u[3 * s + 2][lane];

      // pt = c + u1 x^ + u2 y^ + u3 z^, with u2 = l sin(ang) cos(tor) and
      // u3 = l sin(ang) sin(tor): d pt / d tor = -u3 y^ + u2 z^.
      const Vec gp = load3(g + 3 * (4 + s));
      const int col = s_col[s][lane];
      if (own_row && col != kNoColumn)
        g_ang[col] += -u3 * dot(gp, f.y_hat) + u2 * dot(gp, f.z_hat);

      const Vec g_y_hat = u2 * gp;
      // y^ = z^ x x^
      const Vec g_z_hat = u3 * gp + cross(f.x_hat, g_y_hat);
      Vec g_x_hat = u1 * gp + cross(g_y_hat, f.z_hat);
      // z^ = normalize(z_raw), z_raw = w^ x x^
      const Vec g_z_raw = normalize_vjp(f.z_raw, f.r_z, g_z_hat);
      const Vec g_w_hat = cross(f.x_hat, g_z_raw);
      g_x_hat = g_x_hat + cross(g_z_raw, f.w_hat);
      // w^ = normalize(b - a), x^ = normalize(c - b)
      const Vec g_w = normalize_vjp(f.w, f.r_w, g_w_hat);
      const Vec g_x = normalize_vjp(f.x, f.r_x, g_x_hat);
      add(ia, -1.0f * g_w);
      add(ib, g_w - g_x);
      add(ic, gp + g_x);
    }
    s_g_anchor[0][lane] = g_anchor.x;
    s_g_anchor[1][lane] = g_anchor.y;
    s_g_anchor[2][lane] = g_anchor.z;
  }
  __syncthreads();

  // The block's residue i (lane i + 1, row i + 2 of s_g): its backbone's
  // cotangent plus, in that order, the cotangent of the anchor that is one
  // of its atoms: its own C's for a lone residue, else the next residue's
  // (its C) or, for residue 1 of a row, residue 0's (its N).
  for (int e = threadIdx.x; e < n * kBb; e += kThreads) {
    const int i = e / kBb;
    const int k = e % kBb;
    const int p = s_pos[i + 1];
    float v = s_g[(i + 2) * kRow + k];
    if (k >= 6 && k < 9) {
      if (length == 1) {
        v += s_g_anchor[k - 6][i + 1];
      } else if (p != length - 1) {
        v += s_g_anchor[k - 6][i + 2];
      }
    } else if (k < 3 && p == 1) {
      v += s_g_anchor[k][i];
    }
    s_g_bb[e] = v;
  }
  __syncthreads();
  unstage(g_bb + static_cast<size_t>(r0) * kBb, s_g_bb, n * kBb);
  unstage(g_angles + static_cast<size_t>(r0) * kAngles, s_g_angles,
          n * kAngles);
}

int check_shape(int n_res, int length) {
  if (n_res <= 0 || length <= 0 || n_res % length != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

extern "C" {

const char* sidechain_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Forward (K2a). Contiguous tensors over n_res = batch * length residues:
// bb (n_res, 4, 3) and angles (n_res, 12) float32, seq (n_res,) int64 when
// seq64 else int32, table (24, 96) float32; out (n_res, 14, 3) float32,
// every element written. Launches on `stream`; returns the CUDA error code
// (0 on success).
int sidechain_fwd(const float* bb, const float* angles, const void* seq,
                  int seq64, const float* table, int n_res, int length,
                  float* out, void* stream) {
  if (int err = check_shape(n_res, length)) return err;
  const int blocks = (n_res + kFwdResidues - 1) / kFwdResidues;
  sidechain_fwd_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      bb, angles, seq, seq64, table, n_res, length, out);
  return static_cast<int>(cudaGetLastError());
}

// Backward (K2b). built (n_res, 14, 3) is the forward's output, g_out its
// cotangent; the other inputs as in the forward. Writes every element of
// g_bb (n_res, 4, 3) and g_angles (n_res, 12).
int sidechain_bwd(const float* built, const float* angles, const void* seq,
                  int seq64, const float* table, const float* g_out,
                  int n_res, int length, float* g_bb, float* g_angles,
                  void* stream) {
  if (int err = check_shape(n_res, length)) return err;
  const int blocks = (n_res + kBwdResidues - 1) / kBwdResidues;
  sidechain_bwd_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      built, angles, seq, seq64, table, g_out, n_res, length, g_bb,
      g_angles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
