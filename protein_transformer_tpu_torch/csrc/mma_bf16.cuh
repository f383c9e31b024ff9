// bf16 products on the tensor cores with fp32 accumulation: mma.sync
// m16n8k16, the operand fragments it takes, and ldmatrix to load them.
//
// One m16n8k16 takes a 16 x 16 left operand and a 16 x 8 right operand of
// bf16 values and adds their product, summed exactly and accumulated in
// fp32, to a 16 x 8 fp32 tile: the TPU's bf16 matrix unit with
// preferred_element_type=float32. Used by attention.cu (the bf16 instances
// of K3a and the flash backward).
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace bf16 {

// d += a b, one warp. Per thread, with g = lane / 4 and t = lane % 4, each
// register holds two bf16 values, the lower column (or row) in the low
// half:
//   a[0] (g, 2t..2t+1), a[1] (g + 8, 2t..2t+1), a[2] (g, 2t+8..2t+9),
//   a[3] (g + 8, 2t+8..2t+9) of the 16 x 16 left operand (row major);
//   b[0] (2t..2t+1, g), b[1] (2t+8..2t+9, g) of the 16 x 8 right operand;
//   d as mma_tf32's: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// lo and hi rounded to bf16 (to nearest, ties to even), lo in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __float22bfloat162_rn(make_float2(lo, hi));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The two bf16 values of a word, as floats: (low, high).
__device__ __forceinline__ float2 unpack(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// Two neighbouring fp32 accumulator tiles, columns c0 .. c0 + 7 (lo) and
// c0 + 8 .. c0 + 15 (hi), rounded to bf16 as the left operand of a product
// that contracts over those 16 columns: a thread's accumulator registers
// are exactly its registers of the left operand, no data moves.
__device__ __forceinline__ void acc_as_left(const float (&lo)[4],
                                            const float (&hi)[4],
                                            uint32_t (&a)[4]) {
  a[0] = pack(lo[0], lo[1]);
  a[1] = pack(lo[2], lo[3]);
  a[2] = pack(hi[0], hi[1]);
  a[3] = pack(hi[2], hi[3]);
}

// The left operand at (row0, col0) of a bf16 tile in shared memory with a
// row stride of S elements.
template <int S>
__device__ __forceinline__ void left(const __nv_bfloat16* tile, int row0,
                                     int col0, int g, int t,
                                     uint32_t (&a)[4]) {
  const __nv_bfloat16* p = tile + (row0 + g) * S + col0 + 2 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * S);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * S + 8);
}

// The right operand of A B^T from a tile that holds B's columns as rows:
// n = tile row n0 + g, k = columns k0 + 2t.. and k0 + 2t + 8..
template <int S>
__device__ __forceinline__ void right_t(const __nv_bfloat16* tile, int n0,
                                        int k0, int g, int t, uint32_t* b0,
                                        uint32_t* b1) {
  const __nv_bfloat16* p = tile + (n0 + g) * S + k0 + 2 * t;
  *b0 = *reinterpret_cast<const uint32_t*>(p);
  *b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

// The right operands of A B for two neighbouring 8-column tiles of B, from
// a tile that holds B's rows (rows k0 .. k0 + 15, columns n0 .. n0 + 15):
// b[0], b[1] for columns n0 .. n0 + 7 and b[2], b[3] for n0 + 8 .. n0 + 15.
// A pair of B's values along k lies in two rows, so it takes ldmatrix's
// transposing load: lane l gives the address of row k0 + 8 ((l / 8) % 2) +
// l % 8 at column n0 + 8 (l / 16), one 8 x 8 matrix per group of 8 lanes.
template <int S>
__device__ __forceinline__ void right_rows(const __nv_bfloat16* tile, int k0,
                                           int n0, int lane,
                                           uint32_t (&b)[4]) {
  const __nv_bfloat16* row =
      tile + (k0 + 8 * ((lane >> 3) & 1) + (lane & 7)) * S + n0
      + 8 * (lane >> 4);
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(addr));
}

}  // namespace bf16
