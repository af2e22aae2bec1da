// Dense masked MIPS scoring: out[q, n] = mask[q, n] ? u[q] . v[n] : NEG.
//
// Replaces the Pallas kernel `gam_score` of src/repro/kernels/gam_score.py
// (pl.pallas_call at :60, kernel body `_kernel` at :32).  It is the dense
// oracle the fused retrieval kernel is held against, so its arithmetic is the
// same as that kernel's: a fixed-order loop of f32 fused multiply-adds over k
// (__fmaf_rn), starting from 0, which is also what the reference's dot does.
// bf16 inputs are widened to f32 first.
//
// Bound on an H100: bytes.  Every call writes the (Q, N) f32 score matrix and
// reads the (Q, N) int8 mask, 5 bytes per output against 2k flops, which at
// the paper's k = 10 is far below the f32 rate.  The design keeps the writes
// and mask reads coalesced along n (threadIdx.x walks n) and stages u and v
// tiles through shared memory so each factor row is read once per tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 32
#define ROWS_PER_THREAD 4
#define NEG_SCORE (-1e30f)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// block (TILE, TILE / ROWS_PER_THREAD); tile TILE queries x TILE items
template <typename T>
__global__ void gam_score_kernel(const T* __restrict__ u,
                                 const T* __restrict__ v,
                                 const int8_t* __restrict__ mask,
                                 float* __restrict__ out, int q, int64_t n,
                                 int k) {
  __shared__ float us[TILE][TILE + 1];
  __shared__ float vs[TILE][TILE + 1];
  const int tx = threadIdx.x;          // item within the tile
  const int ty = threadIdx.y;          // query group within the tile
  const int64_t n0 = (int64_t)blockIdx.x * TILE;
  const int q0 = blockIdx.y * TILE;
  float acc[ROWS_PER_THREAD];
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) acc[r] = 0.0f;
  for (int d0 = 0; d0 < k; d0 += TILE) {
    // stage u[q0:q0+TILE, d0:d0+TILE] and v[n0:n0+TILE, d0:d0+TILE]
    for (int r = ty; r < TILE; r += blockDim.y) {
      int qq = q0 + r;
      int d = d0 + tx;
      us[r][tx] = (qq < q && d < k) ? to_f32(u[(int64_t)qq * k + d]) : 0.0f;
      int64_t nn = n0 + r;
      vs[r][tx] = (nn < n && d < k) ? to_f32(v[nn * k + d]) : 0.0f;
    }
    __syncthreads();
    int dmax = min(TILE, k - d0);
    for (int dd = 0; dd < dmax; ++dd) {
      float vv = vs[tx][dd];
#pragma unroll
      for (int r = 0; r < ROWS_PER_THREAD; ++r) {
        acc[r] = __fmaf_rn(us[ty + r * blockDim.y][dd], vv, acc[r]);
      }
    }
    __syncthreads();
  }
  int64_t nn = n0 + tx;
  if (nn >= n) return;
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) {
    int qq = q0 + ty + r * blockDim.y;
    if (qq < q) {
      int64_t idx = (int64_t)qq * n + nn;
      out[idx] = mask[idx] != 0 ? acc[r] : NEG_SCORE;
    }
  }
}

template <typename T>
static int launch(const void* u, const void* v, const void* mask, void* out,
                  int q, int64_t n, int k, void* stream) {
  if (q > 0 && n > 0) {
    dim3 block(TILE, TILE / ROWS_PER_THREAD);
    dim3 grid((unsigned)((n + TILE - 1) / TILE), (q + TILE - 1) / TILE);
    gam_score_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const T*)u, (const T*)v, (const int8_t*)mask, (float*)out, q, n, k);
  }
  return (int)cudaGetLastError();
}

extern "C" int gam_score_f32(const void* u, const void* v, const void* mask,
                             void* out, int q, int64_t n, int k,
                             void* stream) {
  return launch<float>(u, v, mask, out, q, n, k, stream);
}

extern "C" int gam_score_bf16(const void* u, const void* v, const void* mask,
                              void* out, int q, int64_t n, int k,
                              void* stream) {
  return launch<__nv_bfloat16>(u, v, mask, out, q, n, k, stream);
}
