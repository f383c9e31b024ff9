// fp32-accurate matrix products on the tensor cores: TF32 mma.sync with
// each operand split into a TF32 head and the TF32 of what the head leaves.
//
// Plain TF32 keeps 10 explicit mantissa bits (~3 decimal digits). Splitting
// x into head = tf32(x) and rest = tf32(x - head) keeps ~21 bits, and a
// product a b is taken as three TF32 products, rest x head, head x rest and
// head x head, summed in fp32 in that order (the small terms first; rest x
// rest is below fp32's own rounding). Used by drmsd_variants.cu (K4b, K4c)
// and attention.cu (K3a and the flash backward).
#pragma once

#include <cstdint>

namespace tf32 {

// x rounded to TF32 (10 explicit mantissa bits, ties away from zero), as the
// bits of a float.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d += a b, one warp: a is 16 x 8 (row major), b is 8 x 8 (column major),
// both TF32; d is 16 x 8 in fp32. Per thread, with g = lane / 4 and
// t = lane % 4: a holds (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4);
// b holds (t, g), (t + 4, g); d holds (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An operand split into its TF32 head and the TF32 of what the head leaves.
template <int kRegs>
struct SplitFrag {
  uint32_t head[kRegs];
  uint32_t rest[kRegs];
};

__device__ __forceinline__ void split_tf32(float x, uint32_t* head,
                                           uint32_t* rest) {
  *head = to_tf32(x);
  *rest = to_tf32(x - __uint_as_float(*head));
}

// d += a b to fp32 accuracy: the two cross terms first, the heads last.
__device__ __forceinline__ void mma_split(float (&d)[4],
                                          const SplitFrag<4>& a,
                                          const SplitFrag<2>& b) {
  mma_tf32(d, a.rest, b.head);
  mma_tf32(d, a.head, b.rest);
  mma_tf32(d, a.head, b.head);
}

// An accumulator tile (16 x 8; a thread holds (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1)) as the left operand of the next product,
// split. The contraction runs over its 8 columns, so their order is free:
// column 2t becomes k = t and column 2t + 1 becomes k = t + 4, which puts
// every value in the register of its own thread that mma.sync reads.
__device__ __forceinline__ SplitFrag<4> acc_as_left(const float (&c)[4]) {
  SplitFrag<4> a;
  split_tf32(c[0], &a.head[0], &a.rest[0]);
  split_tf32(c[2], &a.head[1], &a.rest[1]);
  split_tf32(c[1], &a.head[2], &a.rest[2]);
  split_tf32(c[3], &a.head[3], &a.rest[3]);
  return a;
}

}  // namespace tf32
