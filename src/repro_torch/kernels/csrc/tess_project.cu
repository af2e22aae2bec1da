// Algorithm 2 (ternary tessellation projection), one thread per row.
//
// Replaces the Pallas kernel `tess_project` of src/repro/kernels/tess_project.py
// (pl.pallas_call at :57, kernel body `_kernel` at :25).  On the TPU the sort
// of |z| ran in XLA before the kernel; here it is fused: each thread ranks
// its row's |z| (descending, ties by index ascending, as a stable argsort),
// takes the running sum in rank order in f32, divides it by sqrtf(t+1),
// keeps the FIRST argmax t*, and writes the signed int8 pattern on
// rank <= t* and a = pattern / sqrtf(t*+1).
//
// Bound on an H100: bytes.  It reads 4k bytes and writes 5k bytes per row and
// does O(k^2) compares for the ranks, which at k = 10 is far below the f32
// rate, so one thread per row with the row in local memory is enough.
// Built without --use_fast_math: IEEE sqrtf and division are what make the
// patterns equal those of the plain PyTorch version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#define TESS_MAX_K 256

__global__ void tess_project_kernel(const float* __restrict__ z,
                                    int8_t* __restrict__ pat,
                                    float* __restrict__ a, int64_t rows,
                                    int k) {
  int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const float* zr = z + row * k;
  float az[TESS_MAX_K];
  float down[TESS_MAX_K];
  int rank[TESS_MAX_K];
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

extern "C" int tess_project_f32(const void* z, void* pat, void* a,
                                int64_t rows, int k, void* stream) {
  if (rows > 0) {
    int threads = 128;
    int64_t blocks = (rows + threads - 1) / threads;
    tess_project_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
        (const float*)z, (int8_t*)pat, (float*)a, rows, k);
  }
  return (int)cudaGetLastError();
}
