// Coarse GAM LM-head scores: out[b, v] = (sum_d h[b, d] * pat[d, v]) * inv[v].
//
// Replaces the Pallas kernel `gam_coarse` of src/repro/kernels/gam_coarse.py
// (pl.pallas_call at :43, body `_kernel` at :23): h (B, d) f32 against the
// int8 ternary patterns (d, V) of the unembedding rows, scaled by
// 1/sqrt(nnz) (V,) f32, into (B, V) f32.  Any int8 value is taken, not only
// {-1, 0, 1}.
//
// On the TPU the grid walked V in tiles of bv columns with the (B, d) query
// block resident, and padded V to whole tiles.  Here each thread owns one
// column of V for up to GC_B query rows (grid.y covers B); the ragged tail of
// V is masked in the kernel.  The sum over d is one sequential f32 fma loop
// per output, as the port's other kernels compute their dot products, so the
// only parallelism is over outputs (32,000 columns at the LM head: about two
// CTAs an SM).  To keep the memory system busy anyway, the pattern rows of a
// CTA's 128 columns are staged in shared memory by cp.async in chunks of
// GC_TD rows, GC_STAGES - 1 chunks ahead of the one being summed (16-byte
// copies, coalesced, no registers held), when V is a multiple of 16; other
// widths load their chunk with plain byte loads.  h is staged in shared
// memory in tiles of GC_DT coordinates, laid out [d][row] so one d's rows
// are two 16-byte broadcast reads.
//
// Bound on an H100: bytes.  The patterns are d V bytes, read once; h, inv
// and the (B, V) f32 output are small beside them at decode batch sizes
// (B 8, d 2,048, V 32,000: 66.7 MB, 19.9 us at 3.35 TB/s); the 2 B d V
// operations (1.05 GFLOP) take 15.6 us at the f32 rate.  The kernel reads
// every pattern byte once, with up to (GC_STAGES - 1) * GC_TD * 128 bytes of
// each CTA in flight, and its fma count equals the function's.
#include <cuda_runtime.h>
#include <stdint.h>

#define GC_THREADS 128  // columns per CTA, one a thread
#define GC_B 8           // query rows per CTA (grid.y covers B)
#define GC_DT 256        // h coordinates staged per shared-memory tile
#define GC_TD 64         // pattern rows per pipeline chunk
#define GC_STAGES 4      // chunks in shared memory (GC_STAGES - 1 ahead)

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Chunk c (pattern rows c*GC_TD.. of the CTA's columns) into buf; VEC: by
// 16-byte cp.async pieces (V % 16 == 0, so a piece is all in or all out of
// V), else by byte loads.
template <bool VEC>
__device__ __forceinline__ void load_chunk(int8_t (*buf)[GC_THREADS],
                                          const int8_t* __restrict__ pat,
                                          int c, int D, int64_t V,
                                          int64_t col0, int tid) {
  const int d0 = c * GC_TD;
  if (VEC) {
    constexpr int PIECES = GC_TD * GC_THREADS / 16;
    for (int i = tid; i < PIECES; i += GC_THREADS) {
      const int r = i / (GC_THREADS / 16), j = i % (GC_THREADS / 16);
      const int64_t col = col0 + 16 * j;
      if (d0 + r < D && col < V) {
        cp_async16(&buf[r][16 * j], pat + (int64_t)(d0 + r) * V + col);
      }
    }
  } else {
    const int64_t col = col0 + tid;
    for (int r = 0; r < GC_TD; ++r) {
      buf[r][tid] = (d0 + r < D && col < V) ? pat[(int64_t)(d0 + r) * V + col]
                                            : (int8_t)0;
    }
  }
}

// grid (ceil(V / GC_THREADS), ceil(B / GC_B))
template <bool VEC>
__global__ void __launch_bounds__(GC_THREADS)
    gam_coarse_kernel(const float* __restrict__ h,
                      const int8_t* __restrict__ pat,
                      const float* __restrict__ inv, float* __restrict__ out,
                      int B, int D, int64_t V) {
  __shared__ float4 hs[GC_DT][GC_B / 4];
  __shared__ __align__(16) int8_t ps[GC_STAGES][GC_TD][GC_THREADS];
  const int tid = threadIdx.x;
  const int b0 = blockIdx.y * GC_B;
  const int nb = min(GC_B, B - b0);
  const int64_t col0 = (int64_t)blockIdx.x * GC_THREADS;
  const int64_t col = col0 + tid;
  const int n_chunks = (D + GC_TD - 1) / GC_TD;
  float acc[GC_B];
#pragma unroll
  for (int r = 0; r < GC_B; ++r) acc[r] = 0.0f;
#pragma unroll
  for (int s = 0; s < GC_STAGES - 1; ++s) {
    if (s < n_chunks) load_chunk<VEC>(ps[s], pat, s, D, V, col0, tid);
    cp_async_commit();
  }
  int hd0 = 0;
  for (int c = 0; c < n_chunks; ++c) {
    const int d0 = c * GC_TD;
    if (d0 % GC_DT == 0) {          // the next h tile (after the last use)
      hd0 = d0;
      float* hsf = reinterpret_cast<float*>(hs);
      for (int idx = tid; idx < GC_B * GC_DT; idx += GC_THREADS) {
        const int d = idx / GC_B, r = idx % GC_B;
        hsf[idx] = (r < nb && d0 + d < D)
                       ? h[(int64_t)(b0 + r) * D + d0 + d] : 0.0f;
      }
    }
    const int ahead = c + GC_STAGES - 1;
    if (ahead < n_chunks) {
      load_chunk<VEC>(ps[ahead % GC_STAGES], pat, ahead, D, V, col0, tid);
    }
    cp_async_commit();
    cp_async_wait<GC_STAGES - 1>();
    __syncthreads();
    const int8_t(*buf)[GC_THREADS] = ps[c % GC_STAGES];
    const int rows = min(GC_TD, D - d0);
#pragma unroll 8
    for (int r = 0; r < rows; ++r) {
      const float p = (float)buf[r][tid];
      const float4 h0 = hs[d0 - hd0 + r][0], h1 = hs[d0 - hd0 + r][1];
      acc[0] = __fmaf_rn(h0.x, p, acc[0]);
      acc[1] = __fmaf_rn(h0.y, p, acc[1]);
      acc[2] = __fmaf_rn(h0.z, p, acc[2]);
      acc[3] = __fmaf_rn(h0.w, p, acc[3]);
      acc[4] = __fmaf_rn(h1.x, p, acc[4]);
      acc[5] = __fmaf_rn(h1.y, p, acc[5]);
      acc[6] = __fmaf_rn(h1.z, p, acc[6]);
      acc[7] = __fmaf_rn(h1.w, p, acc[7]);
    }
    __syncthreads();                // buf and hs are rewritten next
  }
  if (col >= V) return;
  const float s = inv[col];
#pragma unroll
  for (int r = 0; r < GC_B; ++r) {
    if (r < nb) out[(int64_t)(b0 + r) * V + col] = acc[r] * s;
  }
}

extern "C" int gam_coarse_f32(const void* h, const void* pat, const void* inv,
                              void* out, int B, int D, int64_t V,
                              void* stream) {
  if (B < 1 || D < 1 || V < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t gx = (V + GC_THREADS - 1) / GC_THREADS;
  const int gy = (B + GC_B - 1) / GC_B;
  if (gx > 2147483647LL || gy > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)gx, gy);
  if (V % 16 == 0 && (uintptr_t)pat % 16 == 0) {
    gam_coarse_kernel<true><<<grid, GC_THREADS, 0, st>>>(
        (const float*)h, (const int8_t*)pat, (const float*)inv, (float*)out,
        B, D, V);
  } else {
    gam_coarse_kernel<false><<<grid, GC_THREADS, 0, st>>>(
        (const float*)h, (const int8_t*)pat, (const float*)inv, (float*)out,
        B, D, V);
  }
  return (int)cudaGetLastError();
}
