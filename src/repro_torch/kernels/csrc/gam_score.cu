// Dense masked MIPS scoring: out[q, n] = mask[q, n] ? u[q] . v[n] : NEG.
//
// Replaces the Pallas kernel `gam_score` of src/repro/kernels/gam_score.py
// (pl.pallas_call at :60, kernel body `_kernel` at :32).  It is the dense
// oracle the fused retrieval kernel is held against, so its arithmetic is the
// same as that kernel's: one chain of f32 fused multiply-adds (__fmaf_rn) an
// output over d = 0, 1, ..., starting from 0, k padded with zeros (a zero
// term leaves the sum as it is: the chain never holds -0).  bf16 inputs are
// widened to f32 first.
//
// Bound on an H100: bytes.  At the oracle's shape (Q 256, N 1M, k 10) every
// call reads the (Q, N) int8 mask and writes the (Q, N) f32 scores, 5 bytes
// an output against 2k flops, and the output is 20x the L2.  At the GAM LM
// head's (Q 8, N 32,000, k 512) the 65.5 MB read of v sets it.  Two routes:
//
//  * register route (k <= REG_MAX_K): a thread owns REG_ITEMS consecutive
//    items, holds their rows in registers (k padded to a multiple of 4) and
//    walks the CTA's queries, whose rows lie in shared memory (the real
//    queries of the chunk, no padded rows).  Per query a thread reads its 4
//    mask bytes as one word (the next REG_MROWS rows' words in flight while
//    a batch is scored) and writes its 4 scores by one 16-byte streaming
//    store (__stcs); ragged N falls back to bytes and scalars.  The query
//    chunk is cut so the grid has enough CTAs when N is small.
//  * staged route (wider k): a CTA owns STG_ITEMS * STG_THREADS items and
//    STG_QC queries, and streams k in chunks of STG_KC dims through a ring
//    of STG_STAGES shared-memory stages filled by 16-byte cp.async (f32 rows
//    16-byte aligned; otherwise loads that widen to f32), so v is read once
//    per query chunk.  A thread owns items t, t + STG_THREADS, ... (one at
//    the GAM head's shape: 250 CTAs of 128 items fill the 132 SMs better
//    than 125 of 256), reads each as float4 (conflict free at a row stride
//    of STG_KC + 4) and keeps STG_QC sums an item.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_SCORE (-1e30f)
#define REG_MAX_K 32
#define REG_THREADS 128
#define REG_ITEMS 4
#define REG_MAX_QC 256          // queries a register-route CTA walks
#define REG_MIN_CTAS 1024       // the query chunk is cut to reach this many
#define REG_MROWS 8             // query rows a batch of mask words
#define STG_THREADS 128
#define STG_ITEMS 1
#define STG_NB (STG_THREADS * STG_ITEMS)
#define STG_QC 8
#define STG_KC 32
#define STG_LD (STG_KC + 4)
#define STG_STAGES 3            // the cp.async ring

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------- register route

// grid (items / (REG_THREADS * REG_ITEMS), query chunks of qc); shared
// memory: qc rows of 4 * K4 floats.  `vec`: n % 4 == 0 and mask, out aligned
template <typename T, int K4>
__global__ void __launch_bounds__(REG_THREADS)
    score_reg_kernel(const T* __restrict__ u, const T* __restrict__ v,
                     const int8_t* __restrict__ mask, float* __restrict__ out,
                     int q, int64_t n, int k, int qc, int vec) {
  extern __shared__ float4 us4[];
  float* us = (float*)us4;
  const int q0 = blockIdx.y * qc;
  const int qn = min(qc, q - q0);
  for (int e = threadIdx.x; e < qn * 4 * K4; e += REG_THREADS) {
    const int r = e / (4 * K4), d = e % (4 * K4);
    us[e] = d < k ? to_f32(u[(int64_t)(q0 + r) * k + d]) : 0.0f;
  }
  const int64_t n0 =
      ((int64_t)blockIdx.x * REG_THREADS + threadIdx.x) * REG_ITEMS;
  float vr[REG_ITEMS][4 * K4];
#pragma unroll
  for (int i = 0; i < REG_ITEMS; ++i) {
    const int64_t item = n0 + i;
#pragma unroll
    for (int d = 0; d < 4 * K4; ++d)
      vr[i][d] = (item < n && d < k) ? to_f32(__ldg(v + item * k + d)) : 0.0f;
  }
  __syncthreads();
  if (n0 >= n) return;
  const int8_t* mrow = mask + (int64_t)q0 * n + n0;
  float* orow = out + (int64_t)q0 * n + n0;
  const int live = (int)min((int64_t)REG_ITEMS, n - n0);
  // the mask words of rows r .. r + REG_MROWS - 1 (0 past qn)
  auto load_masks = [&](int r, uint32_t (&m)[REG_MROWS]) {
#pragma unroll
    for (int j = 0; j < REG_MROWS; ++j) {
      m[j] = 0;
      if (r + j < qn) {
        const int8_t* mp = mrow + (int64_t)(r + j) * n;
        if (vec) {
          m[j] = __ldcs((const unsigned int*)mp);
        } else {
#pragma unroll
          for (int i = 0; i < REG_ITEMS; ++i)
            if (i < live)
              m[j] |= (uint32_t)(uint8_t)__ldcs(mp + i) << (8 * i);
        }
      }
    }
  };
  // the next REG_MROWS rows' mask words are in flight while these are
  // scored and stored
  uint32_t m[REG_MROWS], next[REG_MROWS];
  load_masks(0, m);
  for (int r0 = 0; r0 < qn; r0 += REG_MROWS) {
    load_masks(r0 + REG_MROWS, next);
#pragma unroll
    for (int j = 0; j < REG_MROWS; ++j) {
      const int r = r0 + j;
      if (r < qn) {
        float acc[REG_ITEMS];
#pragma unroll
        for (int i = 0; i < REG_ITEMS; ++i) acc[i] = 0.0f;
#pragma unroll
        for (int d4 = 0; d4 < K4; ++d4) {
          const float4 uu = us4[r * K4 + d4];
#pragma unroll
          for (int i = 0; i < REG_ITEMS; ++i) {
            acc[i] = __fmaf_rn(uu.x, vr[i][4 * d4], acc[i]);
            acc[i] = __fmaf_rn(uu.y, vr[i][4 * d4 + 1], acc[i]);
            acc[i] = __fmaf_rn(uu.z, vr[i][4 * d4 + 2], acc[i]);
            acc[i] = __fmaf_rn(uu.w, vr[i][4 * d4 + 3], acc[i]);
          }
        }
        float o[REG_ITEMS];
#pragma unroll
        for (int i = 0; i < REG_ITEMS; ++i)
          o[i] = ((m[j] >> (8 * i)) & 0xffu) ? acc[i] : NEG_SCORE;
        float* op = orow + (int64_t)r * n;
        if (vec) {
          __stcs((float4*)op, make_float4(o[0], o[1], o[2], o[3]));
        } else {
#pragma unroll
          for (int i = 0; i < REG_ITEMS; ++i)
            if (i < live) __stcs(op + i, o[i]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < REG_MROWS; ++j) m[j] = next[j];
  }
}

// ------------------------------------------------------------ staged route

// grid (items / STG_NB, query chunks of STG_QC); shared memory: a ring of
// STG_STAGES stages of STG_NB item rows x STG_LD floats and STG_QC query rows
// x STG_KC floats.
// `async16`: f32, k % 4 == 0 and u, v 16-byte aligned
template <typename T>
__global__ void __launch_bounds__(STG_THREADS)
    score_staged_kernel(const T* __restrict__ u, const T* __restrict__ v,
                        const int8_t* __restrict__ mask,
                        float* __restrict__ out, int q, int64_t n, int k,
                        int async16) {
  extern __shared__ __align__(16) float sm[];
  float* vs = sm;
  float* us = sm + STG_STAGES * STG_NB * STG_LD;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.y * STG_QC;
  const int qn = min(STG_QC, q - q0);
  const int64_t nb = (int64_t)blockIdx.x * STG_NB;
  const int chunks = (k + STG_KC - 1) / STG_KC;

  // stage chunk c (dims c * STG_KC ...) into buffer b; zero past k, n, q
  auto stage = [&](int c, int b) {
    const int d0 = c * STG_KC;
    float* vb = vs + b * STG_NB * STG_LD;
    float* ub = us + b * STG_QC * STG_KC;
    if (async16) {
      const float* vf = (const float*)v;
      const float* uf = (const float*)u;
      for (int e = tid; e < STG_NB * (STG_KC / 4); e += STG_THREADS) {
        const int it = e / (STG_KC / 4), d = (e % (STG_KC / 4)) * 4;
        const int64_t item = nb + it;
        const bool ok = item < n && d0 + d < k;
        cp_async16(vb + it * STG_LD + d, ok ? vf + item * k + d0 + d : vf,
                   ok ? 16 : 0);
      }
      for (int e = tid; e < STG_QC * (STG_KC / 4); e += STG_THREADS) {
        const int r = e / (STG_KC / 4), d = (e % (STG_KC / 4)) * 4;
        const bool ok = r < qn && d0 + d < k;
        cp_async16(ub + r * STG_KC + d,
                   ok ? uf + (int64_t)(q0 + r) * k + d0 + d : uf, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < STG_NB * STG_KC; e += STG_THREADS) {
        const int it = e / STG_KC, d = e % STG_KC;
        const int64_t item = nb + it;
        vb[it * STG_LD + d] =
            (item < n && d0 + d < k) ? to_f32(v[item * k + d0 + d]) : 0.0f;
      }
      for (int e = tid; e < STG_QC * STG_KC; e += STG_THREADS) {
        const int r = e / STG_KC, d = e % STG_KC;
        ub[r * STG_KC + d] = (r < qn && d0 + d < k)
                                 ? to_f32(u[(int64_t)(q0 + r) * k + d0 + d])
                                 : 0.0f;
      }
    }
    cp_async_commit();
  };

  float acc[STG_ITEMS][STG_QC];
#pragma unroll
  for (int j = 0; j < STG_ITEMS; ++j)
#pragma unroll
    for (int r = 0; r < STG_QC; ++r) acc[j][r] = 0.0f;

  for (int c = 0; c < STG_STAGES - 1; ++c) {
    if (c < chunks) {
      stage(c, c);
    } else {
      cp_async_commit();
    }
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<STG_STAGES - 2>();
    __syncthreads();
    // refill the buffer every thread finished reading before the barrier
    const int next = c + STG_STAGES - 1;
    if (next < chunks) {
      stage(next, next % STG_STAGES);
    } else {
      cp_async_commit();
    }
    const float* vb = vs + (c % STG_STAGES) * STG_NB * STG_LD;
    const float* ub = us + (c % STG_STAGES) * STG_QC * STG_KC;
    const int dn = min(STG_KC, k - c * STG_KC);   // zeros past it to a 4
    for (int d = 0; d < dn; d += 4) {
      float4 vv[STG_ITEMS];
#pragma unroll
      for (int j = 0; j < STG_ITEMS; ++j)
        vv[j] = *(const float4*)(vb + (tid + j * STG_THREADS) * STG_LD + d);
#pragma unroll
      for (int r = 0; r < STG_QC; ++r) {
        const float4 uu = *(const float4*)(ub + r * STG_KC + d);
#pragma unroll
        for (int j = 0; j < STG_ITEMS; ++j) {
          acc[j][r] = __fmaf_rn(uu.x, vv[j].x, acc[j][r]);
          acc[j][r] = __fmaf_rn(uu.y, vv[j].y, acc[j][r]);
          acc[j][r] = __fmaf_rn(uu.z, vv[j].z, acc[j][r]);
          acc[j][r] = __fmaf_rn(uu.w, vv[j].w, acc[j][r]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < STG_QC; ++r) {
    if (r < qn) {
#pragma unroll
      for (int j = 0; j < STG_ITEMS; ++j) {
        const int64_t item = nb + tid + j * STG_THREADS;
        if (item < n) {
          const int64_t idx = (int64_t)(q0 + r) * n + item;
          __stcs(out + idx, __ldcs(mask + idx) != 0 ? acc[j][r] : NEG_SCORE);
        }
      }
    }
  }
}

// ------------------------------------------------------------------ entry

template <typename T, int K4>
static int launch_reg(const T* u, const T* v, const int8_t* mask, float* out,
                      int q, int64_t n, int k, cudaStream_t st) {
  const int64_t bx = (n + REG_THREADS * REG_ITEMS - 1) / (REG_THREADS * REG_ITEMS);
  int qc = q < REG_MAX_QC ? q : REG_MAX_QC;
  if (bx < REG_MIN_CTAS) {                 // more query chunks, more CTAs
    const int64_t want = (REG_MIN_CTAS + bx - 1) / bx;
    const int64_t cut = q / want;          // at least `want` chunks
    if (cut < qc) qc = (int)(cut > 0 ? cut : 1);
  }
  const int64_t by = (q + qc - 1) / qc;
  if (by > 65535) return (int)cudaErrorInvalidValue;
  const int vec = (n % 4 == 0) && ((uintptr_t)mask % 4 == 0) &&
                  ((uintptr_t)out % 16 == 0);
  const size_t smem = (size_t)qc * 4 * K4 * sizeof(float);
  score_reg_kernel<T, K4><<<dim3((unsigned)bx, (unsigned)by), REG_THREADS,
                            smem, st>>>(u, v, mask, out, q, n, k, qc, vec);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_staged(const T* u, const T* v, const int8_t* mask,
                         float* out, int q, int64_t n, int k,
                         cudaStream_t st) {
  static bool attr_set = false;
  const size_t smem = (size_t)STG_STAGES * (STG_NB * STG_LD + STG_QC * STG_KC) *
                      sizeof(float);
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        score_staged_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int64_t bx = (n + STG_NB - 1) / STG_NB;
  const int64_t by = (q + STG_QC - 1) / STG_QC;
  if (by > 65535) return (int)cudaErrorInvalidValue;
  const int async16 = sizeof(T) == 4 && k % 4 == 0 &&
                      (((uintptr_t)u | (uintptr_t)v) % 16 == 0);
  score_staged_kernel<T><<<dim3((unsigned)bx, (unsigned)by), STG_THREADS,
                           smem, st>>>(u, v, mask, out, q, n, k, async16);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* u, const void* v, const void* mask, void* out,
                  int q, int64_t n, int k, void* stream) {
  if (q <= 0 || n <= 0) return (int)cudaGetLastError();
  const T* ut = (const T*)u;
  const T* vt = (const T*)v;
  const int8_t* m = (const int8_t*)mask;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  static_assert(REG_MAX_K == 4 * 8, "one case below for each K4 <= 8");
  switch ((k + 3) / 4) {
    case 1: return launch_reg<T, 1>(ut, vt, m, o, q, n, k, st);
    case 2: return launch_reg<T, 2>(ut, vt, m, o, q, n, k, st);
    case 3: return launch_reg<T, 3>(ut, vt, m, o, q, n, k, st);
    case 4: return launch_reg<T, 4>(ut, vt, m, o, q, n, k, st);
    case 5: return launch_reg<T, 5>(ut, vt, m, o, q, n, k, st);
    case 6: return launch_reg<T, 6>(ut, vt, m, o, q, n, k, st);
    case 7: return launch_reg<T, 7>(ut, vt, m, o, q, n, k, st);
    case 8: return launch_reg<T, 8>(ut, vt, m, o, q, n, k, st);
    default: return launch_staged<T>(ut, vt, m, o, q, n, k, st);
  }
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
