// Coarse GAM LM-head scores: out[b, v] = (sum_d h[b, d] * pat[d, v]) * inv[v].
//
// Replaces the Pallas kernel `gam_coarse` of src/repro/kernels/gam_coarse.py
// (pl.pallas_call at :43, body `_kernel` at :23): h (B, d) f32 against the
// int8 ternary patterns (d, V) of the unembedding rows, scaled by
// 1/sqrt(nnz) (V,) f32, into (B, V) f32.  Any int8 value is taken, not only
// {-1, 0, 1}.
//
// Bound on an H100: bytes at decode batch sizes.  The patterns are d V
// bytes and everything else is small beside them (B 8, d 2,048, V 32,000:
// 66.7 MB, 19.9 us at 3.35 TB/s).  The Pallas kernel walks V in tiles with
// every query row resident ("queries ride whole"); so does this one: each
// pattern byte is read from device memory once for B <= 256 (a larger B
// takes one pass over the patterns per 256 rows).
//
// The products run on the tensor cores in bf16 with f32 accumulation,
// without changing the function:
//   - h is split before the main kernel (split_h_kernel) into three bf16
//     terms (attn::split3): h = hi + mid + lo exactly for |h| >= 2^-110
//     (below that bf16's subnormal grid drops at most 2^-134 a term);
//   - every int8 value is a bf16 number (8 significand bits); each byte is
//     converted exactly by bit operations, two bytes to a register:
//     X = prmt(two words), A = (X & 0x7f) | 0x4300 = 128 + low 7 bits,
//     S = (X & 0x80) | 0x4300 = 128 or 256 by the sign bit, x = A - S
//     (one bf16x2 fma, exact as the difference is a bf16 number); about two
//     instructions a byte, against a convert and eight fma a byte on the
//     CUDA cores (a CUDA-core build of this layout was 1.3-1.9x slower at
//     B 1 and 8 in tools/coarse_sweep.py);
//   - each product of two bf16 numbers is exact in f32, so the three
//     products of a 16-deep step add h.p to the f32 accumulator with only
//     the tensor core's own rounding of its sum, a few ulp of the partial
//     sum, and an output takes 3 d / 16 of them: inside the first-order
//     bound of two d-term f32 sums that `coarse_tolerance` allows.
// Routes (the plan's config): up to 16 query rows, mma.sync.m16n8k16, each
// warp loading its h fragments by ldmatrix; past 16, wgmma m64nNk16 with
// the patterns' fragments in registers and h read from shared memory by the
// tensor cores.  mma.sync is faster at B <= 16 and wgmma past it (the
// sweep: 0.030 against 0.034 ms at B 8, 0.049 against 0.063 at B 64),
// where the warps' h fragment loads (6 KB a warp a step at B 64) and the
// 3 x 2 B d V operations bound mma.sync.
//
// Layout.  A CTA takes V tiles of GC_TV = 128 columns in turn (persistent:
// the grid is one or two CTAs an SM, from the wrapper's plan) and walks d
// in chunks of KD rows through a STAGES-deep ring in shared memory, one
// mbarrier a slot: one thread copies the chunk's pattern tile by TMA (a
// tensor map on the (d, V) matrix: zero past d and V, 128-byte swizzle) and
// the chunk's split h for the pass's B_PASS rows by a bulk copy.  The main
// kernel is launched as a programmatic dependent of the split kernel, so its
// first pattern copies overlap it (in turns in tools/coarse_sweep.py: 3.4
// us of 0.034 ms at B 16, 0.7 of 0.0115 at d 512, none at B 1, 8, 64).
// Warp wm of a warpgroup owns 32 columns (two 16-row m-tiles; wgmma's
// 64-row tiles take one 16-row slice from each warp); lane (gid, tig) reads
// rows 2 tig + {0, 1, 8, 9} of a 16-deep step, four columns 4 gid.. each,
// so m-row gid / gid + 8 of tile t is column
// 4 gid + 2t / + 1 and the k-slots are the rows: the swizzle puts the four
// rows a lane group reads on disjoint banks.  The C fragments then hold four
// adjacent columns of two query rows: 16-byte stores (the scales are read
// one float at a time, so inv may lie at any 4-byte offset).  Each output
// is one accumulator summed over d in order; no atomics, and reruns are
// bit-identical.
//
// VEC (the plan's choice): V % 16 == 0, V < 2^31 and a 16-byte aligned
// pattern pointer, for the tensor map; otherwise the same kernel stages the
// pattern tile by byte loads (a view at any offset, any V) and stores by
// element.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include "attn_mma.cuh"

#define GC_TV 128            // V columns a tile: 4 warp columns of 32

namespace {

using attn::mma_bf16;
using attn::smem_addr;

// Four (lanes 0-31 give the rows) or two (lanes 0-15) 8 x 8 bf16 matrices
// from shared memory: register i holds (row gid, cols 2 tig, 2 tig + 1) of
// matrix i, the B fragment of mma.m16n8k16 from a K-major core matrix.
__device__ __forceinline__ void ldmatrix_x4_at(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t r[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

// Two bytes (byte j of w0, byte j of w1) as an exact bf16x2, w0's low.
__device__ __forceinline__ uint32_t i8pair_bf16x2(uint32_t w0, uint32_t w1,
                                                  int j) {
  const uint32_t x = __byte_perm(w0, w1, (uint32_t)(j | ((4 + j) << 8)));
  const uint32_t a = (x & 0x007f007fu) | 0x43004300u;   // 128 + low 7 bits
  const uint32_t s = (x & 0x00800080u) | 0x43004300u;   // 128 or 256
  uint32_t r;
  // r = s * -1 + a, exact: a - s is an integer in [-128, 127]
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r) : "r"(s), "r"(0xbf80bf80u), "r"(a));
  return r;
}

// Byte offset of row r, 16-byte piece c of a stage's pattern tile: TMA's
// 128-byte swizzle (piece c ^ (r % 8)) on a 1024-byte aligned stage.
__device__ __forceinline__ int pat_off(int row, int c) {
  return row * GC_TV + ((c ^ (row & 7)) << 4);
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
// rows x 128 bytes of the pattern matrix at (col, row) by the tensor map.
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* tm,
                                         int col, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(tm)), "r"(bar), "r"(col),
        "r"(row) : "memory");
}
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

template <int NT, int WN, int KD, int STAGES>
struct Cfg {
  static constexpr int THREADS = 128 * WN;            // WN warpgroups
  static constexpr int B_PASS = 8 * NT * WN;          // query rows a pass
  static constexpr int STEPS = KD / 16;
  static constexpr int PAT_BYTES = KD * GC_TV;
  static constexpr int H_BYTES = STEPS * 3 * B_PASS * 32;
  static constexpr int STAGE_BYTES =
      (PAT_BYTES + H_BYTES + 1023) / 1024 * 1024;
  // + 1024 to align the ring, + the stages' barriers
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 64;
};

// wgmma: acc (64 x 8 NT, f32, this thread's part: NT n-tiles x 4) += A (64
// x 16 bf16, this warp's 16 rows in registers, the mma.m16n8k16 A layout)
// . B (16 x 8 NT bf16 in shared memory, K-major core matrices, `desc`).
template <int NT>
__device__ __forceinline__ void wgmma_bf16(float (&d)[NT][4],
                                           const uint32_t (&a)[4],
                                           uint64_t desc);
template <>
__device__ __forceinline__ void wgmma_bf16<1>(float (&d)[1][4],
                                              const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %9, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3 "
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<2>(float (&d)[2][4],
                                              const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<4>(float (&d)[4][4],
                                              const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<8>(float (&d)[8][4],
                                              const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accesses of the accumulators across the
// asynchronous products.
template <int NT>
__device__ __forceinline__ void fence_acc(float (&acc)[2][NT][4]) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        asm volatile("" : "+f"(acc[t][n][e])::"memory");
      }
}
// Shared-memory matrix descriptor, no swizzle: start address, the byte
// offsets between core matrices along K (leading) and along N (stride).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// (local tile, pass, chunk) of a CTA's walk, advanced one chunk at a time.
struct Walk {
  int lt, pass, chunk;
  __device__ __forceinline__ void next(int n_passes, int n_chunks) {
    if (++chunk == n_chunks) {
      chunk = 0;
      if (++pass == n_passes) { pass = 0; ++lt; }
    }
  }
};

// h (B, D) f32 -> hs, per pass p and step s of 16 d, for each term x (hi,
// mid, lo) the wgmma B operand of the pass's b_pass rows: K-major core
// matrices of 8 rows x 8 k (16 bytes a row), [row group][k half][row][k],
// so 128 bytes apart along k and 256 along the rows; zero past B and D.
__global__ void split_h_kernel(const float* __restrict__ h,
                               uint32_t* __restrict__ hs, int B, int D,
                               int n_steps, int b_pass, int passes) {
  // the main kernel may start now: it waits for this grid's writes before
  // its first copy of them (programmatic dependent launch)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int64_t n = (int64_t)passes * n_steps * b_pass * 8;
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; idx < n;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int i = (int)(idx & 7);                 // the pair d = 2i, 2i + 1
    int64_t rest = idx >> 3;
    const int qq = (int)(rest % b_pass);
    rest /= b_pass;
    const int64_t s = rest % n_steps, pass = rest / n_steps;
    const int64_t q = pass * b_pass + qq;
    const int64_t d = s * 16 + 2 * i;
    float x0 = 0.0f, x1 = 0.0f;
    if (q < B) {
      const float* row = h + q * D;
      if (d < D) x0 = row[d];
      if (d + 1 < D) x1 = row[d + 1];
    }
    uint32_t t[3];
    attn::split3(x0, x1, &t[0], &t[1], &t[2]);
    // word (i & 3) of row qq % 8 in core matrix (qq / 8, i / 4)
    const int pos = (((qq >> 3) * 2 + (i >> 2)) * 8 + (qq & 7)) * 4 + (i & 3);
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      hs[((pass * n_steps + s) * 3 + x) * b_pass * 8 + pos] = t[x];
    }
  }
}

template <int NT, int WN, int KD, int STAGES, bool VEC, bool WG>
__global__ void __launch_bounds__(128 * WN)
    coarse_mma_kernel(const __grid_constant__ CUtensorMap tmap,
                      const int8_t* __restrict__ pat,
                      const uint16_t* __restrict__ hs,
                      const float* __restrict__ inv, float* __restrict__ out,
                      int B, int D, int64_t V, int n_tiles, int n_chunks,
                      int n_passes) {
  using C = Cfg<NT, WN, KD, STAGES>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t bars = smem_addr(smem + STAGES * C::STAGE_BYTES);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;     // warp in its warpgroup, group
  const int my_tiles = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                       (int)gridDim.x;
  const int total = my_tiles * n_passes * n_chunks;
  const int64_t h_pass = (int64_t)n_chunks * C::H_BYTES;   // bytes a pass

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Stage the walk's position `w` into ring slot `slot`: one thread issues
  // the copies; on the byte-load route every thread also stores its pieces.
  // The patterns' first copies go out while the split kernel may still run;
  // the first copy of its output waits for it.
  bool split_done = false;
  auto stage = [&](const Walk& w, int slot) {
    uint8_t* ps = smem + slot * C::STAGE_BYTES;
    const int tile = (int)blockIdx.x + w.lt * (int)gridDim.x;
    const uint32_t bar = bars + 8 * slot;
    if (tid == 0) {
      mbar_expect(bar, (VEC ? C::PAT_BYTES : 0) + C::H_BYTES);
      if (VEC) tma_tile(smem_addr(ps), &tmap, tile * GC_TV, w.chunk * KD, bar);
      if (!split_done) {
        asm volatile("griddepcontrol.wait;\n" ::: "memory");
        split_done = true;
      }
      bulk_copy(smem_addr(ps + C::PAT_BYTES),
                reinterpret_cast<const uint8_t*>(hs) + w.pass * h_pass +
                    (int64_t)w.chunk * C::H_BYTES,
                C::H_BYTES, bar);
    }
    if (!VEC) {
      const int64_t col0 = (int64_t)tile * GC_TV;
      for (int p = tid; p < KD * (GC_TV / 16); p += C::THREADS) {
        const int row = p >> 3, c = p & 7;
        const int64_t d = (int64_t)w.chunk * KD + row;
        const int64_t col = col0 + 16 * c;
        uint32_t wd[4] = {0u, 0u, 0u, 0u};
        if (d < D) {
          const int8_t* src = pat + d * V + col;
          for (int j = 0; j < 16; ++j) {
            if (col + j < V) {
              wd[j >> 2] |= (uint32_t)(uint8_t)src[j] << (8 * (j & 3));
            }
          }
        }
        *reinterpret_cast<uint4*>(ps + pat_off(row, c)) =
            make_uint4(wd[0], wd[1], wd[2], wd[3]);
      }
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][n][e] = 0.0f;

  // This lane reads rows 2 tig + {0, 1, 8, 9} of a step (k-slots 2 tig +
  // {0, 1} and 2 tig + 8 + {0, 1}), piece 2 wm + gid / 4, word gid % 4;
  // the swizzle XORs the piece with 2 tig (even rows) or 2 tig + 1 (odd).
  // Warp wm holds rows 16 wm .. 16 wm + 15 of each 64-row wgmma tile t:
  // m-row gid / gid + 8 is column 32 wm + 4 gid + 2 t / + 1 of the tile.
  const int piece = 2 * wm + (gid >> 2);
  const int lane_even = 2 * tig * GC_TV + ((piece ^ (2 * tig)) << 4) +
                        4 * (gid & 3);
  const int lane_odd = (2 * tig + 1) * GC_TV +
                       ((piece ^ (2 * tig + 1)) << 4) + 4 * (gid & 3);
  const int group_h = wn * NT * 256;     // this warpgroup's rows of the pass
  // mma.sync route: lane l gives row l % 8 of core matrix l / 8 to
  // ldmatrix: (hi, k 0-7), (hi, k 8-15), (mid, ...), then (lo, ...)
  const int lane_hm = (lane >> 4) * C::B_PASS * 32 + ((lane >> 3) & 1) * 128 +
                      (lane & 7) * 16;
  const int lane_lo = 2 * C::B_PASS * 32 + ((lane >> 3) & 1) * 128 +
                      (lane & 7) * 16;

  Walk pw = {0, 0, 0}, cw = {0, 0, 0};        // producer, consumer
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < total) {
      stage(pw, i);
      pw.next(n_passes, n_chunks);
    }
  }
  int slot = 0, pslot = STAGES - 1;
  uint32_t phase = 0;
  for (int it = 0; it < total; ++it) {
    __syncthreads();          // slot it - 1 read by all (and, byte-load
                              // route, this slot's pieces stored)
    if (it + STAGES - 1 < total) {
      stage(pw, pslot);
      pw.next(n_passes, n_chunks);
    }
    pslot = pslot + 1 == STAGES ? 0 : pslot + 1;
    mbar_wait(bars + 8 * slot, phase);
    const uint8_t* ps = smem + slot * C::STAGE_BYTES;
    const uint32_t hsm = smem_addr(ps + C::PAT_BYTES) + group_h;
    if (++slot == STAGES) {
      slot = 0;
      phase ^= 1u;
    }
    uint32_t a[2][2][4];                       // two steps' A in flight
#pragma unroll
    for (int s = 0; s < C::STEPS; ++s) {
      const uint8_t* pr = ps + s * 16 * GC_TV;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(pr + lane_even);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(pr + lane_odd);
      const uint32_t w2 =
          *reinterpret_cast<const uint32_t*>(pr + 8 * GC_TV + lane_even);
      const uint32_t w3 =
          *reinterpret_cast<const uint32_t*>(pr + 8 * GC_TV + lane_odd);
      uint32_t(&as)[2][4] = a[s & 1];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        as[t][0] = i8pair_bf16x2(w0, w1, 2 * t);
        as[t][1] = i8pair_bf16x2(w0, w1, 2 * t + 1);
        as[t][2] = i8pair_bf16x2(w2, w3, 2 * t);
        as[t][3] = i8pair_bf16x2(w2, w3, 2 * t + 1);
      }
      if (WG) {
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int x = 0; x < 3; ++x) {              // hi, mid, lo
          const uint64_t desc =
              smem_desc(hsm + (s * 3 + x) * C::B_PASS * 32, 128, 256);
          wgmma_bf16<NT>(acc[0], as[0], desc);
          wgmma_bf16<NT>(acc[1], as[1], desc);
        }
        wgmma_commit();
        wgmma_wait<1>();                          // step s - 1 done
        fence_acc(acc);
      } else {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint32_t row = hsm + s * 3 * C::B_PASS * 32 + n * 256;
          uint32_t b[4], l[2];
          ldmatrix_x4_at(b, row + lane_hm);       // hi and mid
          ldmatrix_x2(l, row + lane_lo);          // lo
          mma_bf16(acc[0][n], as[0], b[0], b[1]);
          mma_bf16(acc[1][n], as[1], b[0], b[1]);
          mma_bf16(acc[0][n], as[0], b[2], b[3]);
          mma_bf16(acc[1][n], as[1], b[2], b[3]);
          mma_bf16(acc[0][n], as[0], l[0], l[1]);
          mma_bf16(acc[1][n], as[1], l[0], l[1]);
        }
      }
    }
    if (WG) {
      wgmma_wait<0>();                          // the slot is read
      fence_acc(acc);
    }
    if (cw.chunk == n_chunks - 1) {             // the tile's pass is done
      const int64_t v0 = (int64_t)((int)blockIdx.x + cw.lt * (int)gridDim.x) *
                             GC_TV + 32 * wm + 4 * gid;
      float sc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[j] = v0 + j < V ? inv[v0 + j] : 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {           // query rows 2 tig + e
          const int q =
              cw.pass * C::B_PASS + wn * 8 * NT + n * 8 + 2 * tig + e;
          const float o[4] = {acc[0][n][e] * sc[0], acc[0][n][e + 2] * sc[1],
                              acc[1][n][e] * sc[2], acc[1][n][e + 2] * sc[3]};
          if (q < B) {
            float* dst = out + (int64_t)q * V + v0;
            if (VEC) {
              if (v0 < V) {
                *reinterpret_cast<float4*>(dst) =
                    make_float4(o[0], o[1], o[2], o[3]);
              }
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                if (v0 + j < V) dst[j] = o[j];
              }
            }
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            acc[j][n][e] = 0.0f;
            acc[j][n][e + 2] = 0.0f;
          }
        }
      }
    }
    cw.next(n_passes, n_chunks);
  }
}

// The driver's tensor-map encoder, found through the runtime (no -lcuda).
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
    }
  }
  return fn;
}

template <int NT, int WN, int KD, int STAGES, bool WG, bool VEC>
int launch_main(const void* h, void* hs, const int8_t* pat, const float* inv,
                float* out, int B, int D, int64_t V, int n_tiles, int grid,
                cudaStream_t st) {
  using C = Cfg<NT, WN, KD, STAGES>;
  auto kern = coarse_mma_kernel<NT, WN, KD, STAGES, VEC, WG>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int n_chunks = ((D + 15) / 16 + C::STEPS - 1) / C::STEPS;
  const int n_passes = (B + C::B_PASS - 1) / C::B_PASS;
  CUtensorMap tmap = {};
  if (VEC) {
    PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[2] = {(cuuint64_t)V, (cuuint64_t)D};
    const cuuint64_t strides[1] = {(cuuint64_t)V};
    const cuuint32_t box[2] = {GC_TV, KD};
    const cuuint32_t elem[2] = {1, 1};
    if (encode(&tmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, (void*)pat, dims,
               strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const int64_t pairs =
      (int64_t)n_passes * n_chunks * C::STEPS * C::B_PASS * 8;
  const int64_t blocks = (pairs + 255) / 256;
  split_h_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(
      (const float*)h, (uint32_t*)hs, B, D, n_chunks * C::STEPS, C::B_PASS,
      n_passes);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // launched as a programmatic dependent of the split kernel
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t lc = {};
  lc.gridDim = dim3((unsigned)grid);
  lc.blockDim = dim3(C::THREADS);
  lc.dynamicSmemBytes = C::SMEM;
  lc.stream = st;
  lc.attrs = attr;
  lc.numAttrs = 1;
  e = cudaLaunchKernelEx(&lc, kern, tmap, pat, (const uint16_t*)hs, inv, out,
                         B, D, V, n_tiles, n_chunks, n_passes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The configs of the wrapper's plan (`gam_coarse.CONFIGS`, in this order):
// (NT, WN, KD, STAGES, WG), query rows a pass 8 NT WN, WG: the wgmma route
// (else mma.sync).
#define GC_CONFIGS(X)        \
  X(0, 1, 1, 128, 3, false)  \
  X(1, 2, 1, 128, 3, false)  \
  X(2, 4, 1, 64, 4, true)    \
  X(3, 8, 1, 64, 3, true)    \
  X(4, 8, 2, 32, 3, true)    \
  X(5, 8, 4, 32, 3, true)

}  // namespace

// hs: scratch of the plan's `scratch` bf16 elements (the split h, padded to
// whole passes and chunks); cfg and grid from the wrapper's plan
// (`gam_coarse.coarse_plan`); vec: the TMA route (V % 16 == 0 and pat
// 16-byte aligned, V < 2^31; checked again here), else pieces by byte
// loads.
extern "C" int gam_coarse_f32(const void* h, void* hs, const void* pat,
                              const void* inv, void* out, int B, int D,
                              int64_t V, int cfg, int vec, int grid,
                              void* stream) {
  if (B < 1 || D < 1 || V < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  const int64_t n_tiles = (V + GC_TV - 1) / GC_TV;
  if (n_tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  if (vec && (V % 16 != 0 || V >= (1LL << 31) || (uintptr_t)pat % 16 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* p = (const int8_t*)pat;
  const float* s = (const float*)inv;
  float* o = (float*)out;
#define GC_CASE(I, N, W, K, S, G)                                           \
  case I:                                                                   \
    return vec ? launch_main<N, W, K, S, G, true>(h, hs, p, s, o, B, D, V,  \
                                                  (int)n_tiles, grid, st)  \
               : launch_main<N, W, K, S, G, false>(h, hs, p, s, o, B, D, V, \
                                                   (int)n_tiles, grid, st);
  switch (cfg) {
    GC_CONFIGS(GC_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef GC_CASE
}

// Resident CTAs an SM of the main kernel for (cfg, vec), as the card
// reckons it from registers, threads and shared memory; for the sweep.
extern "C" int gam_coarse_occupancy(int cfg, int vec, int* blocks) {
  *blocks = 0;
  auto occ = [&](auto kern, int threads, int smem) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern,
                                                               threads, smem);
  };
#define GC_OCC(I, N, W, K, S, G)                                     \
  case I:                                                            \
    return vec ? occ(coarse_mma_kernel<N, W, K, S, true, G>,         \
                     Cfg<N, W, K, S>::THREADS, Cfg<N, W, K, S>::SMEM) \
               : occ(coarse_mma_kernel<N, W, K, S, false, G>,        \
                     Cfg<N, W, K, S>::THREADS, Cfg<N, W, K, S>::SMEM);
  switch (cfg) {
    GC_CONFIGS(GC_OCC)
    default: return (int)cudaErrorInvalidValue;
  }
#undef GC_OCC
}
