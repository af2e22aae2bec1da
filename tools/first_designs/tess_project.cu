// Algorithm 2 (ternary tessellation projection): two kernels, one per row
// width class.
//
// Replaces the Pallas kernel `tess_project` of src/repro/kernels/tess_project.py
// (pl.pallas_call at :57, kernel body `_kernel` at :25).  On the TPU the sort
// of |z| ran in XLA before the kernel; here it is fused: a row's |z| is
// ranked (descending, ties by index ascending, as a stable argsort), the
// running sum is taken in rank order in f32, divided by sqrtf(t+1), the
// FIRST argmax t* is kept, and the signed int8 pattern is written on
// rank <= t* with a = pattern / sqrtf(t*+1).
//
//  * tess_project_kernel, one thread per row (k <= TESS_THREAD_MAX_K): the
//    row in local memory, O(k^2) compares per thread.  It carries the
//    paper's catalogs (k = 10), where the kernel is bound by bytes.
//  * tess_project_wide_kernel, one CTA of TESS_WIDE_THREADS per row (any k
//    whose three k-long arrays fit in shared memory, 12k bytes): |z| is
//    staged in shared memory, the ranks are counted in parallel (each
//    thread ranks some coordinates against the whole row, read as
//    broadcasts), the row is scattered into rank order, ONE thread takes
//    the running sum in order (each step one rounded f32 add, the
//    arithmetic of the plain version), then the division by sqrtf(t+1) and
//    the first-argmax reduction run in parallel, and the pattern and `a`
//    are written in parallel.  Wider rows raise in the wrapper, naming the
//    size; streaming them is not implemented.  At k = 512..2048 this is
//    bound by the O(k^2) compares, not by bytes.
//
// Built without --use_fast_math: IEEE sqrtf and division are what make the
// patterns equal those of the plain PyTorch version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#define TESS_THREAD_MAX_K 256
#define TESS_WIDE_THREADS 256

__global__ void tess_project_kernel(const float* __restrict__ z,
                                    int8_t* __restrict__ pat,
                                    float* __restrict__ a, int64_t rows,
                                    int k) {
  int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const float* zr = z + row * k;
  float az[TESS_THREAD_MAX_K];
  float down[TESS_THREAD_MAX_K];
  int rank[TESS_THREAD_MAX_K];
  for (int i = 0; i < k; ++i) az[i] = fabsf(zr[i]);
  for (int i = 0; i < k; ++i) {
    int r = 0;
    for (int j = 0; j < k; ++j) {
      r += (az[j] > az[i]) || (az[j] == az[i] && j < i);
    }
    rank[i] = r;
    down[r] = az[i];
  }
  float run = 0.0f;
  float best = 0.0f;
  int t_star = 0;
  for (int t = 0; t < k; ++t) {
    run = __fadd_rn(run, down[t]);
    float zs = __fdiv_rn(run, __fsqrt_rn((float)(t + 1)));
    if (t == 0 || zs > best) {
      best = zs;
      t_star = t;
    }
  }
  float norm = __fsqrt_rn((float)(t_star + 1));
  int8_t* pr = pat + row * k;
  float* ar = a + row * k;
  for (int i = 0; i < k; ++i) {
    int8_t s = 0;
    if (rank[i] <= t_star) s = zr[i] >= 0.0f ? 1 : -1;
    pr[i] = s;
    ar[i] = __fdiv_rn((float)s, norm);
  }
}

// (value, index) pair that wins the first-argmax order: larger value, then
// smaller index
__device__ __forceinline__ bool wins(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void tess_project_wide_kernel(const float* __restrict__ z,
                                         int8_t* __restrict__ pat,
                                         float* __restrict__ a, int k) {
  extern __shared__ float smem[];
  float* az = smem;                       // |z| in index order
  float* down = az + k;                   // |z| in rank order -> running sums
  int* rank = (int*)(down + k);
  __shared__ float red_v[TESS_WIDE_THREADS];
  __shared__ int red_i[TESS_WIDE_THREADS];
  const int64_t row = blockIdx.x;
  const float* zr = z + row * k;
  const int tid = threadIdx.x;
  for (int i = tid; i < k; i += TESS_WIDE_THREADS) az[i] = fabsf(zr[i]);
  __syncthreads();
  for (int i = tid; i < k; i += TESS_WIDE_THREADS) {
    const float ai = az[i];
    int r = 0;
    for (int j = 0; j < k; ++j) {
      const float aj = az[j];
      r += (aj > ai) || (aj == ai && j < i);
    }
    rank[i] = r;
    down[r] = ai;
  }
  __syncthreads();
  if (tid == 0) {
    float run = 0.0f;
    for (int t = 0; t < k; ++t) {
      run = __fadd_rn(run, down[t]);
      down[t] = run;
    }
  }
  __syncthreads();
  float bv = 0.0f;
  int bi = k;                             // no entry yet
  for (int t = tid; t < k; t += TESS_WIDE_THREADS) {
    const float zs = __fdiv_rn(down[t], __fsqrt_rn((float)(t + 1)));
    if (bi == k || zs > bv) {             // t ascending: keep the first max
      bv = zs;
      bi = t;
    }
  }
  red_v[tid] = bv;
  red_i[tid] = bi;
  __syncthreads();
  for (int w = TESS_WIDE_THREADS / 2; w > 0; w >>= 1) {
    if (tid < w) {
      const float ov = red_v[tid + w];
      const int oi = red_i[tid + w];
      if (oi < k && (red_i[tid] == k || wins(ov, oi, red_v[tid], red_i[tid]))) {
        red_v[tid] = ov;
        red_i[tid] = oi;
      }
    }
    __syncthreads();
  }
  const int t_star = red_i[0];
  const float norm = __fsqrt_rn((float)(t_star + 1));
  int8_t* pr = pat + row * k;
  float* ar = a + row * k;
  for (int i = tid; i < k; i += TESS_WIDE_THREADS) {
    int8_t s = 0;
    if (rank[i] <= t_star) s = zr[i] >= 0.0f ? 1 : -1;
    pr[i] = s;
    ar[i] = __fdiv_rn((float)s, norm);
  }
}

// One thread per row for k <= TESS_THREAD_MAX_K, else one CTA per row.
extern "C" int tess_project_f32(const void* z, void* pat, void* a,
                                int64_t rows, int k, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows <= 0) return (int)cudaGetLastError();
  if (k <= TESS_THREAD_MAX_K) {
    int threads = 128;
    int64_t blocks = (rows + threads - 1) / threads;
    tess_project_kernel<<<(unsigned)blocks, threads, 0, st>>>(
        (const float*)z, (int8_t*)pat, (float*)a, rows, k);
    return (int)cudaGetLastError();
  }
  if (rows > 2147483647LL) return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)12 * k;          // az, down, rank
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        tess_project_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  tess_project_wide_kernel<<<(unsigned)rows, TESS_WIDE_THREADS, smem, st>>>(
      (const float*)z, (int8_t*)pat, (float*)a, k);
  return (int)cudaGetLastError();
}
