// Causal GQA flash attention for prefill, f32 or bf16 in, f32 arithmetic.
//
// Replaces the Pallas kernel `flash_prefill` of
// src/repro/kernels/flash_prefill.py (pl.pallas_call at :91, body `_kernel`
// at :29).  Layout as there: q (B, S, Hkv, G, hd), k/v (B, S, Hkv, hd), out
// like q.  For each query position i, kv head h and query head g of its group
//     s[j] = (q[b,i,h,g,:] . k[b,j,h,:]) * hd^-0.5        j <= i, in f32
//     out  = sum_j e^(s[j] - m) v[b,j,h,:] / max(sum_j e^(s[j] - m), 1e-30)
// with the running (m, l, acc) of an online softmax over KV tiles, as the
// Pallas body keeps it.  q, k and v are widened to f32 and the probabilities
// stay f32 for p.v, as the Pallas body casts them: rounding p to bf16 for a
// bf16 mma would compute another function, so both products run on the CUDA
// cores in f32.
//
// On the TPU the KV axis was the sequential innermost grid axis, carrying
// (m, l, acc) in VMEM across grid steps.  Hopper runs blocks in parallel, so
// one CTA owns one (batch row, kv head, query tile) and walks the KV tiles in
// a loop, keeping (m, l) in shared memory and acc in registers.  A query
// tile is FP_ROWS = 128 (query position, query head) rows: 128 / G positions
// of all G heads of the kv head (16 positions at G = 8), so each K/V tile is
// loaded once per CTA and used by every query head of its group.  KV tiles
// are FP_BK = 64 positions; tiles that start past the query tile's last
// position are never loaded (causal pruning), and the ragged tail of S is
// masked in the kernel (no whole-tile fallback as on the TPU).  Query tiles
// are issued last-first, so the longest walks start earliest.
//
// Per KV tile (128 threads, each owning 8 rows x 8 keys of the score tile
// and 8 rows x HDP / 8 dims of acc, rows strided 16 and columns 8 apart so
// the shared-memory reads do not conflict):
//   1. K and V rows are staged in shared memory as f32 (zero past S and hd);
//   2. scores: a sequential f32 fma loop over d, scaled, masked to -1e30
//      where j > i or j >= S, written to shared memory;
//   3. one thread per row takes the tile max, m_new, the correction
//      e^(m - m_new) and l, and turns the scores into p = e^(s - m_new);
//   4. acc = acc * correction + p . V, a sequential fma loop over the tile.
//
// Bound on an H100: operations.  At the serving shape (B 8, S 1,024, Hkv 4,
// G 8, hd 64, bf16) the causal work is about 34 GFLOP against 75 MB of
// inputs and outputs; on the CUDA cores in f32 (67 TFLOP/s) that is 0.5 ms,
// on the tensor cores in bf16 it would be 35 us.  This first kernel keeps f32
// on the CUDA cores (see above); each fma reads one shared-memory operand per
// four fmas from registers (8 x 8 register tiles).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FP_THREADS 128   // threads per CTA
#define FP_ROWS 128      // (query position, query head) rows per CTA
#define FP_BK 64         // KV positions per tile
#define FP_RT 8          // rows per thread (strided FP_ROWS / FP_RT = 16)
#define FP_CT 8          // score columns per thread (strided 8)
#define FP_NEG (-1e30f)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* o) { *o = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(x);
}

template <int HDP>
struct FpSmem {
  static constexpr int QST = HDP + 1;   // padded row strides (floats)
  static constexpr int KST = HDP + 1;
  static constexpr int VST = HDP;
  static constexpr int SST = FP_BK + 1;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + FP_ROWS * QST;
  static constexpr int V_OFF = K_OFF + FP_BK * KST;
  static constexpr int S_OFF = V_OFF + FP_BK * VST;
  static constexpr int M_OFF = S_OFF + FP_ROWS * SST;
  static constexpr int L_OFF = M_OFF + FP_ROWS;
  static constexpr int C_OFF = L_OFF + FP_ROWS;
  static constexpr int FLOATS = C_OFF + FP_ROWS;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

// grid (query tiles, Hkv, B); block FP_THREADS; dynamic smem FpSmem::BYTES.
// bq = query positions per tile (rows = bq * G <= FP_ROWS).
template <typename T, int HDP>
__global__ void __launch_bounds__(FP_THREADS)
    flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out, int S,
                         int hkv, int G, int hd, int bq, float scale) {
  using L = FpSmem<HDP>;
  extern __shared__ float smem[];
  float* Qs = smem + L::Q_OFF;
  float* Ks = smem + L::K_OFF;
  float* Vs = smem + L::V_OFF;
  float* Ss = smem + L::S_OFF;
  float* Ms = smem + L::M_OFF;
  float* Ls = smem + L::L_OFF;
  float* Cs = smem + L::C_OFF;

  const int tid = threadIdx.x;
  const int rg = tid >> 3;        // row group: rows rg + 16 i
  const int cg = tid & 7;         // column group: columns / dims cg + 8 j
  const int qt = gridDim.x - 1 - blockIdx.x;   // longest walks first
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int q0 = qt * bq;
  const int rows = bq * G;
  const int64_t pos_stride = (int64_t)hkv * G * hd;   // q between positions
  const int64_t kv_stride = (int64_t)hkv * hd;        // k/v between positions
  const T* qb = q + b * S * pos_stride + (int64_t)h * G * hd;
  const T* kb = k + b * S * kv_stride + (int64_t)h * hd;
  const T* vb = v + b * S * kv_stride + (int64_t)h * hd;

  // the query tile, f32, zero past hd and on padding rows
  for (int idx = tid; idx < FP_ROWS * HDP; idx += FP_THREADS) {
    const int r = idx / HDP, d = idx % HDP;
    const int pos = q0 + r / G;
    float x = 0.0f;
    if (r < rows && pos < S && d < hd) {
      x = to_f32(qb[(int64_t)pos * pos_stride + (r % G) * hd + d]);
    }
    Qs[r * L::QST + d] = x;
  }
  if (tid < FP_ROWS) {
    Ms[tid] = FP_NEG;
    Ls[tid] = 0.0f;
  }
  // the query position of each of this thread's rows (-1: padding, masked)
  int qpos[FP_RT];
#pragma unroll
  for (int i = 0; i < FP_RT; ++i) {
    const int r = rg + 16 * i;
    const int pos = q0 + r / G;
    qpos[i] = (r < rows && pos < S) ? pos : -1;
  }
  constexpr int DT = HDP / 8;     // acc dims per thread
  float acc[FP_RT][DT];
#pragma unroll
  for (int i = 0; i < FP_RT; ++i) {
#pragma unroll
    for (int j = 0; j < DT; ++j) acc[i][j] = 0.0f;
  }

  const int last = min(q0 + bq - 1, S - 1);   // last key any row attends to
  const int n_tiles = last / FP_BK + 1;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * FP_BK;
    __syncthreads();   // the previous tile's V and p are no longer read
    for (int idx = tid; idx < FP_BK * HDP; idx += FP_THREADS) {
      const int c = idx / HDP, d = idx % HDP;
      const int pos = k0 + c;
      float kx = 0.0f, vx = 0.0f;
      if (pos < S && d < hd) {
        kx = to_f32(kb[(int64_t)pos * kv_stride + d]);
        vx = to_f32(vb[(int64_t)pos * kv_stride + d]);
      }
      Ks[c * L::KST + d] = kx;
      Vs[c * L::VST + d] = vx;
    }
    __syncthreads();

    // scores: sequential fma over d
    float s[FP_RT][FP_CT];
#pragma unroll
    for (int i = 0; i < FP_RT; ++i) {
#pragma unroll
      for (int j = 0; j < FP_CT; ++j) s[i][j] = 0.0f;
    }
#pragma unroll 4
    for (int d = 0; d < HDP; ++d) {
      float qv[FP_RT], kv[FP_CT];
#pragma unroll
      for (int i = 0; i < FP_RT; ++i) qv[i] = Qs[(rg + 16 * i) * L::QST + d];
#pragma unroll
      for (int j = 0; j < FP_CT; ++j) kv[j] = Ks[(cg + 8 * j) * L::KST + d];
#pragma unroll
      for (int i = 0; i < FP_RT; ++i) {
#pragma unroll
        for (int j = 0; j < FP_CT; ++j) s[i][j] = __fmaf_rn(qv[i], kv[j],
                                                            s[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < FP_RT; ++i) {
#pragma unroll
      for (int j = 0; j < FP_CT; ++j) {
        const int kpos = k0 + cg + 8 * j;
        const bool keep = kpos <= qpos[i] && kpos < S;
        Ss[(rg + 16 * i) * L::SST + cg + 8 * j] =
            keep ? s[i][j] * scale : FP_NEG;
      }
    }
    __syncthreads();

    // online softmax, one thread per row
    if (tid < FP_ROWS) {
      float* srow = Ss + tid * L::SST;
      const float m_prev = Ms[tid];
      float mx = srow[0];
      for (int c = 1; c < FP_BK; ++c) mx = fmaxf(mx, srow[c]);
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int c = 0; c < FP_BK; ++c) {
        const float p = expf(srow[c] - m_new);
        srow[c] = p;
        sum += p;
      }
      const float corr = expf(m_prev - m_new);
      Ls[tid] = Ls[tid] * corr + sum;
      Ms[tid] = m_new;
      Cs[tid] = corr;
    }
    __syncthreads();

    // acc = acc * corr + p . V, sequential fma over the tile's positions
#pragma unroll
    for (int i = 0; i < FP_RT; ++i) {
      const float corr = Cs[rg + 16 * i];
#pragma unroll
      for (int j = 0; j < DT; ++j) acc[i][j] *= corr;
    }
#pragma unroll 2
    for (int c = 0; c < FP_BK; ++c) {
      float pv[FP_RT], vv[DT];
#pragma unroll
      for (int i = 0; i < FP_RT; ++i) pv[i] = Ss[(rg + 16 * i) * L::SST + c];
#pragma unroll
      for (int j = 0; j < DT; ++j) vv[j] = Vs[c * L::VST + cg + 8 * j];
#pragma unroll
      for (int i = 0; i < FP_RT; ++i) {
#pragma unroll
        for (int j = 0; j < DT; ++j) acc[i][j] = __fmaf_rn(pv[i], vv[j],
                                                           acc[i][j]);
      }
    }
  }
  __syncthreads();   // the last tile's l

#pragma unroll
  for (int i = 0; i < FP_RT; ++i) {
    if (qpos[i] < 0) continue;
    const int r = rg + 16 * i;
    const float inv_l = 1.0f / fmaxf(Ls[r], 1e-30f);
    T* orow = out + b * S * pos_stride + (int64_t)qpos[i] * pos_stride +
              (int64_t)h * G * hd + (r % G) * hd;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int d = cg + 8 * j;
      if (d < hd) from_f32(acc[i][j] * inv_l, orow + d);
    }
  }
}

template <typename T, int HDP>
static int launch_hd(const void* q, const void* k, const void* v, void* out,
                     int B, int S, int hkv, int G, int hd, int bq,
                     float scale, cudaStream_t st) {
  const size_t smem = FpSmem<HDP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<T, HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + bq - 1) / bq, hkv, B);
  flash_prefill_kernel<T, HDP><<<grid, FP_THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, hkv, G, hd, bq,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int B, int S, int hkv, int G, int hd, int bq, float scale,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || S < 1 || hkv < 1 || G < 1 || hd < 1 || bq < 1 ||
      bq * G > FP_ROWS || hkv > 65535 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (hd <= 32) return launch_hd<T, 32>(q, k, v, out, B, S, hkv, G, hd, bq,
                                        scale, st);
  if (hd <= 64) return launch_hd<T, 64>(q, k, v, out, B, S, hkv, G, hd, bq,
                                        scale, st);
  if (hd <= 128) return launch_hd<T, 128>(q, k, v, out, B, S, hkv, G, hd, bq,
                                          scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_prefill_f32(const void* q, const void* k, const void* v,
                                 void* out, int B, int S, int hkv, int G,
                                 int hd, int bq, float scale, void* stream) {
  return launch<float>(q, k, v, out, B, S, hkv, G, hd, bq, scale, stream);
}

extern "C" int flash_prefill_bf16(const void* q, const void* k, const void* v,
                                  void* out, int B, int S, int hkv, int G,
                                  int hd, int bq, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, B, S, hkv, G, hd, bq, scale,
                               stream);
}
