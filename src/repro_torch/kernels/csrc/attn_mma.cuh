// Tensor-core pieces shared by the bf16 attention kernels
// (flash_prefill.cu, decode_attention.cu), for sm_90a.
//
// The Pallas bodies compute q.k and p.v in f32 with p kept in f32.  Both
// products run here on bf16 `mma.sync.m16n8k16` with f32 accumulation
// without changing that function:
//   - q and k are bf16, so each product q_d * k_d is exact in f32;
//   - an f32 probability p is exactly p_hi + p_mid + p_lo, three bf16 terms
//     (split3 below): p_hi = bf16_rn(p), p_mid = bf16_rn(p - p_hi), p_lo =
//     p - p_hi - p_mid.  Each residual is exact in f32 and 3 x 8 significand
//     bits cover f32's 24, for p >= 2^-100; below that the part dropped is
//     under 2^-120, nothing against a row sum l >= 1.  v is bf16, so each
//     p_x * v is exact in f32, and three mma's give the f32 p.v up to the
//     order of the sums.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16), lane = 4 gid + tig:
//   A (16 x 16, row)  a[0]: (gid, 2 tig + {0,1})      a[1]: (gid + 8, same)
//                     a[2]: (gid, 2 tig + 8 + {0,1})  a[3]: (gid + 8, same)
//   B (16 x 8, col)   b[0]: (k 2 tig + {0,1}, n gid)  b[1]: (k + 8, n gid)
//   C (16 x 8, f32)   c[0..1]: (gid, 2 tig + {0,1})   c[2..3]: (gid + 8, ...)
// so the C fragments of two neighbouring 8-column score tiles are, element
// for element, the A fragment of P over those 16 keys (the FlashAttention-2
// register reuse): P never goes through shared memory.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace attn {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, bypassing L1; zero-filled where !valid (the
// source is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// `n` rows of HDP columns into a shared tile of stride LD from global rows
// row(r), zero where !ok(r) and past hd: 16-byte cp.async when `vec` (hd a
// multiple of 8, 16-byte aligned rows), else element by element.
template <int HDP, int LD, typename RowFn, typename OkFn>
__device__ __forceinline__ void stage_rows(bf16* dst, int n, int hd, int vec,
                                           RowFn row, OkFn ok, int tid,
                                           int threads) {
  if (vec) {
    constexpr int CPR = HDP / 8;            // 16-byte chunks per row
    for (int c = tid; c < n * CPR; c += threads) {
      const int r = c / CPR, j = c % CPR;
      const bool valid = ok(r) && j * 8 < hd;
      cp_async16(dst + r * LD + j * 8, valid ? row(r) + j * 8 : row(0),
                 valid);
    }
  } else {
    for (int e = tid; e < n * HDP; e += threads) {
      const int r = e / HDP, d = e % HDP;
      dst[r * LD + d] = (ok(r) && d < hd) ? row(r)[d] : __float2bfloat16(0.f);
    }
  }
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.  Non-transposed: r[i] holds (row gid, cols
// 2 tig + {0,1}) of matrix i, as A fragments and, from K's rows, as B.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// Transposed: r[i] holds (rows 2 tig + {0,1}, col gid) of matrix i, the B
// fragment of a row-major (keys x dims) V tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a . b on the tensor cores, bf16 in, f32 accumulate.  Not volatile:
// the compiler may interleave independent products (a volatile asm keeps
// program order, and back-to-back products on one accumulator stall).
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) rounded to bf16 and packed, x0 in the low half; back as f32.
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1,
                                              float2* back) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  *back = __bfloat1622float2(h);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The exact three-term split of the pair (x0, x1): hi + mid + lo == x.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t* hi,
                                       uint32_t* mid, uint32_t* lo) {
  float2 b;
  *hi = pack_bf16(x0, x1, &b);
  const float r0 = x0 - b.x, r1 = x1 - b.y;          // exact
  *mid = pack_bf16(r0, r1, &b);
  *lo = pack_bf16(r0 - b.x, r1 - b.y, &b);           // exact: <= 8 bits left
}

// P over 16 keys as three A fragments, from the C fragments s0 (keys
// 0..7) and s1 (keys 8..15) of one 16-row score tile.
__device__ __forceinline__ void p_fragments(const float s0[4],
                                            const float s1[4],
                                            uint32_t hi[4], uint32_t mid[4],
                                            uint32_t lo[4]) {
  split3(s0[0], s0[1], &hi[0], &mid[0], &lo[0]);
  split3(s0[2], s0[3], &hi[1], &mid[1], &lo[1]);
  split3(s1[0], s1[1], &hi[2], &mid[2], &lo[2]);
  split3(s1[2], s1[3], &hi[3], &mid[3], &lo[3]);
}

// acc += P . V over 16 keys for two 8-column dim tiles (b from one
// ldmatrix_x4_trans: b[0..1] the first tile, b[2..3] the second).
__device__ __forceinline__ void pv_mma(float acc0[4], float acc1[4],
                                       const uint32_t hi[4],
                                       const uint32_t mid[4],
                                       const uint32_t lo[4],
                                       const uint32_t b[4]) {
  mma_bf16(acc0, hi, b[0], b[1]);
  mma_bf16(acc1, hi, b[2], b[3]);
  mma_bf16(acc0, mid, b[0], b[1]);
  mma_bf16(acc1, mid, b[2], b[3]);
  mma_bf16(acc0, lo, b[0], b[1]);
  mma_bf16(acc1, lo, b[2], b[3]);
}

// 2^x in one SFU instruction.  It flushes results under 2^-126 to 0, which
// drops nothing the kernels keep: such a p is below what the three-term
// split holds anyway (2^-120), against a row sum l >= 1.  exp2f is the same
// instruction plus a rescaling to keep those subnormal results.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Max and sum over the four lanes of a quad (the lanes that share a row of
// a C fragment).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace attn
