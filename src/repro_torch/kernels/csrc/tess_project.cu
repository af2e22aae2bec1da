// Algorithm 2 (ternary tessellation projection) on Hopper: three routes by
// row width, one sort.
//
// Replaces the Pallas kernel `tess_project` of src/repro/kernels/tess_project.py
// (pl.pallas_call at :57, kernel body `_kernel` at :25).  On the TPU the sort
// of |z| ran in XLA before the kernel; here it is fused.  The order is the
// plain version's stable argsort: |z| descending, ties by index ascending.
// A bitonic network in its flip form (every comparator puts the larger value
// at the lower position, so pads at the end never move and comparators that
// reach them are dropped) sorts each row; then, in rank order, one rounded
// f32 add a step (__fadd_rn) and __fdiv_rn(run, sqrt(t + 1)), the arithmetic
// of the plain version, and the FIRST argmax t*.  The support is the ranks
// <= t*, with sign(z_i), and a = pattern / sqrtf(t* + 1).
//
//  * narrow route, k <= TESS_NARROW_MAX_K: one thread per row, a kernel per
//    k, the row's |z| bits sorted in registers (the network fully unrolled
//    over exactly k values).  A CTA's slab of TESS_ROWS rows (rows * k * 4
//    contiguous bytes) is staged in shared memory by 16-byte loads; each
//    thread reads its row rotated by its row index (no bank conflicts at
//    k = 16 or 32), and the pattern and a are written back through shared
//    memory by 16-byte streaming stores.  Bound by bytes (9 bytes an
//    element) at the paper's k = 10.
//  * warp route, k <= TESS_WARP_MAX_K: one warp per row, TESS_WARPS rows a
//    CTA, the |z| bits sorted over 32 * E positions: position p = lane * E
//    + s in register s of `lane`; compare-exchanges within a lane stay in
//    registers, across lanes they go through __shfl_xor_sync.  The running
//    sum goes lane by lane (E adds each, the carry passed by a shuffle), the
//    divisions run in parallel and t* comes from a first-argmax by shuffles.
//    O(k log^2 k) work a row instead of the O(k^2) compare count.
//  * Both sort the 32-bit |z| bits alone (half the work of 64-bit keys): the
//    index order of equal values matters only for values equal to the one
//    at rank t*, thr; of those, the t* + 1 - (count above thr) with the
//    lowest indices are in the support (ballots in index order in the warp
//    route; in the narrow route a second pass over the row, taken only when
//    a value equal to thr also lies past rank t*).
//  * CTA route, wider rows: one CTA per row, the same network over k 64-bit
//    keys (|z| bits << 32) | ~index (distinct, so their order is the stable
//    argsort's) in shared memory (8k bytes), the running sums beside them
//    (4k bytes), one thread taking the sum in order; the support is the keys
//    at least the one at rank t*.  Rows past TESS_MAX_K (12k bytes over the
//    232,448 a block can have) raise in the wrapper, naming the size.
//
// The running sum stays serial in every route: its rounding decides t*, and
// that is what makes the patterns equal the plain version's bit for bit.
// Built without --use_fast_math: IEEE sqrtf and division.
#include <cuda_runtime.h>
#include <stdint.h>

#define TESS_NARROW_MAX_K 32
#define TESS_WARP_MAX_K 1024
#define TESS_ROWS 128           // rows (threads) of a narrow-route CTA
#define TESS_WARPS 4            // rows (warps) of a warp-route CTA
#define TESS_CTA_THREADS 512    // threads of a CTA-route CTA

// sqrtf(t + 1) for t = 0..31, correctly rounded (what __fsqrt_rn gives)
__constant__ float c_sqrt[32] = {
    0x1.000000p+0f, 0x1.6a09e6p+0f, 0x1.bb67aep+0f, 0x1.000000p+1f,
    0x1.1e377ap+1f, 0x1.3988e2p+1f, 0x1.52a7fap+1f, 0x1.6a09e6p+1f,
    0x1.800000p+1f, 0x1.94c584p+1f, 0x1.a8872ap+1f, 0x1.bb67aep+1f,
    0x1.cd82b4p+1f, 0x1.deeea2p+1f, 0x1.efbdecp+1f, 0x1.000000p+2f,
    0x1.07e0f6p+2f, 0x1.0f876cp+2f, 0x1.16f834p+2f, 0x1.1e377ap+2f,
    0x1.2548ecp+2f, 0x1.2c2fc6p+2f, 0x1.32eee8p+2f, 0x1.3988e2p+2f,
    0x1.400000p+2f, 0x1.465656p+2f, 0x1.4c8dc2p+2f, 0x1.52a7fap+2f,
    0x1.58a68ap+2f, 0x1.5e8adep+2f, 0x1.645640p+2f, 0x1.6a09e6p+2f};

// (value, rank) that wins the first-argmax order: larger value, then
// smaller rank; bt < 0 is "no entry"
__device__ __forceinline__ bool wins(float v, int t, float bv, int bt) {
  return t >= 0 && (bt < 0 || v > bv || (v == bv && t < bt));
}

// ------------------------------------------------------------ narrow route

__host__ __device__ constexpr int pow2_at_least(int k) {
  return k <= 1 ? 1 : 2 * pow2_at_least((k + 1) / 2);
}

// |z| bits of one row sorted descending in registers: the flip-form network
// over the power of two at or above K, the comparators that reach a
// position >= K dropped at compile time (absent pads never move)
template <int K>
__device__ __forceinline__ void sort_values_desc(uint32_t (&v)[K]) {
  constexpr int W = pow2_at_least(K);
#pragma unroll
  for (int size = 2; size <= W; size <<= 1) {
#pragma unroll
    for (int p = 0; p < K; ++p) {
      const int q = p ^ (size - 1);
      if ((p & (size >> 1)) == 0 && q < K) {
        const uint32_t a = v[p], b = v[q < K ? q : p];
        v[p] = max(a, b);
        v[q < K ? q : p] = min(a, b);
      }
    }
#pragma unroll
    for (int j = size >> 2; j > 0; j >>= 1) {
#pragma unroll
      for (int p = 0; p < K; ++p) {
        const int q = p | j;
        if ((p & j) == 0 && q < K) {
          const uint32_t a = v[p], b = v[q < K ? q : p];
          v[p] = max(a, b);
          v[q < K ? q : p] = min(a, b);
        }
      }
    }
  }
}

// One row of the narrow route: the staged row zr read rotated by rot (slot
// i holds coordinate (i + rot) % K), its |z| bits sorted, the running sum,
// t*; pattern and a written into the CTA's output slabs pr, ar.  The
// support is every coordinate whose |z| is at least the value thr at rank
// t*, unless values equal to thr also lie past rank t* ("ties cut", rare:
// duplicates at the cut); then of the coordinates equal to thr only the
// t* + 1 - (count above thr) with the lowest indices are in it.
template <int K>
__device__ __forceinline__ void narrow_row(const float* zr, int8_t* pr,
                                           float* ar, int rot) {
  uint32_t v[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    int j = i + rot;
    if (j >= K) j -= K;
    v[i] = __float_as_uint(zr[j]) & 0x7fffffffu;
  }
  sort_values_desc<K>(v);
  float run = 0.0f, best = 0.0f;
  int t_star = 0;
  uint32_t thr = v[0];
  bool cut = false;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    run = __fadd_rn(run, __uint_as_float(v[t]));
    const float zs_t = __fdiv_rn(run, c_sqrt[t]);
    if (t == 0 || zs_t > best) {
      best = zs_t;
      t_star = t;
      thr = v[t];
      cut = t + 1 < K && v[t + 1 < K ? t + 1 : t] == v[t];
    }
  }
  const float inv = __fdiv_rn(1.0f, __fsqrt_rn((float)(t_star + 1)));
#pragma unroll
  for (int i = 0; i < K; ++i) {
    int j = i + rot;
    if (j >= K) j -= K;
    const float zj = zr[j];
    const bool on = (__float_as_uint(zj) & 0x7fffffffu) >= thr;
    const bool pos = zj >= 0.0f;
    pr[j] = on ? (pos ? 1 : -1) : 0;
    ar[j] = on ? (pos ? inv : -inv) : 0.0f;
  }
  if (cut) {
    int need = t_star + 1;
#pragma unroll
    for (int t = 0; t < K; ++t) need -= v[t] > thr;
    for (int j = 0; j < K; ++j) {         // index order
      const float zj = zr[j];
      if ((__float_as_uint(zj) & 0x7fffffffu) == thr) {
        const bool pos = zj >= 0.0f;
        pr[j] = need > 0 ? (pos ? 1 : -1) : 0;
        ar[j] = need > 0 ? (pos ? inv : -inv) : 0.0f;
        --need;
      }
    }
  }
}

// A CTA's slab of TESS_ROWS rows: staged from the aligned address at or
// below its start (a view may start anywhere a float can) by 16-byte loads,
// one row a thread, written back through shared memory by 16-byte
// streaming stores.  Shared memory: the slab (TESS_ROWS * k + 4 floats),
// a (TESS_ROWS * k floats), the pattern (TESS_ROWS * k bytes).
template <int K>
__global__ void __launch_bounds__(TESS_ROWS)
    tess_narrow_kernel(const float* __restrict__ z, int8_t* __restrict__ pat,
                       float* __restrict__ a, int64_t rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * TESS_ROWS;
  const int nrows = (int)min((int64_t)TESS_ROWS, rows - row0);
  const int n = nrows * K;
  float* zs = (float*)smem;
  float* as = zs + TESS_ROWS * K + 4;
  int8_t* ps = (int8_t*)(as + TESS_ROWS * K);

  const uintptr_t src = (uintptr_t)(z + row0 * K);
  const float4* g4 = (const float4*)(src & ~(uintptr_t)15);
  const int lead = (int)((src & 15) >> 2);
  const int chunks = (lead + n + 3) >> 2;
  for (int c = tid; c < chunks; c += TESS_ROWS)
    ((float4*)zs)[c] = __ldcs(g4 + c);
  __syncthreads();
  if (tid < nrows)
    narrow_row<K>(zs + lead + tid * K, ps + tid * K, as + tid * K, tid % K);
  __syncthreads();

  // the outputs' slabs start 16-byte aligned (row0 is a multiple of 128)
  int8_t* gp = pat + row0 * K;
  const int pchunks = n >> 4;
  for (int c = tid; c < pchunks; c += TESS_ROWS)
    __stcs((int4*)gp + c, ((const int4*)ps)[c]);
  for (int e = (pchunks << 4) + tid; e < n; e += TESS_ROWS) gp[e] = ps[e];
  float* ga = a + row0 * K;
  const int achunks = n >> 2;
  for (int c = tid; c < achunks; c += TESS_ROWS)
    __stcs((float4*)ga + c, ((const float4*)as)[c]);
  for (int e = (achunks << 2) + tid; e < n; e += TESS_ROWS) ga[e] = as[e];
}

// -------------------------------------------------------------- warp route

// |z| bits (sign cleared) sorted descending over 32 * E positions; position
// p = lane * E + s in v[s] of `lane`; the same network as sort_values_desc
template <int E>
__device__ __forceinline__ void warp_sort_desc(uint32_t (&v)[E], int lane) {
  const unsigned full = 0xffffffffu;
#pragma unroll
  for (int size = 2; size <= 32 * E; size <<= 1) {
    if (size <= E) {
#pragma unroll
      for (int s = 0; s < E; ++s)
        if ((s & (size >> 1)) == 0) {
          const uint32_t a = v[s], b = v[s ^ (size - 1)];
          v[s] = max(a, b);
          v[s ^ (size - 1)] = min(a, b);
        }
    } else {
      // partner (lane ^ m, E - 1 - s); this lane holds the lower positions
      // when its bit of size / 2 is clear
      const int m = size / E - 1;
      const bool low = (lane & (size / (2 * E))) == 0;
#pragma unroll
      for (int s = 0; s < E / 2; ++s) {
        const int r = E - 1 - s;
        const uint32_t o0 = __shfl_xor_sync(full, v[r], m);
        const uint32_t o1 = __shfl_xor_sync(full, v[s], m);
        v[s] = low ? max(v[s], o0) : min(v[s], o0);
        v[r] = low ? max(v[r], o1) : min(v[r], o1);
      }
    }
#pragma unroll
    for (int j = size >> 2; j > 0; j >>= 1) {
      if (j < E) {
#pragma unroll
        for (int s = 0; s < E; ++s)
          if ((s & j) == 0) {
            const uint32_t a = v[s], b = v[s | j];
            v[s] = max(a, b);
            v[s | j] = min(a, b);
          }
      } else {
        const int m = j / E;
        const bool low = (lane & m) == 0;
#pragma unroll
        for (int s = 0; s < E; ++s) {
          const uint32_t o = __shfl_xor_sync(full, v[s], m);
          v[s] = low ? max(v[s], o) : min(v[s], o);
        }
      }
    }
  }
}

template <int E>
__global__ void __launch_bounds__(32 * TESS_WARPS)
    tess_warp_kernel(const float* __restrict__ z, int8_t* __restrict__ pat,
                     float* __restrict__ a, int64_t rows, int k) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * TESS_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;                // the whole warp
  const float* zr = z + row * k;
  uint32_t bits[E], v[E], pos = 0;        // coordinate s * 32 + lane in s
#pragma unroll
  for (int s = 0; s < E; ++s) {
    const int i = s * 32 + lane;
    const float zi = i < k ? __ldg(zr + i) : 0.0f;
    bits[s] = __float_as_uint(zi) & 0x7fffffffu;
    v[s] = bits[s];                       // pads are 0: they sort last
    pos |= (uint32_t)(zi >= 0.0f) << s;
  }
  warp_sort_desc<E>(v, lane);

  // the running sum in rank order: lane by lane, E adds each (a pad adds 0)
  float run[E];
  float carry = 0.0f;
  const int lanes = (k + E - 1) / E;
  for (int l = 0; l < lanes; ++l) {
    if (lane == l) {
#pragma unroll
      for (int s = 0; s < E; ++s) {
        carry = __fadd_rn(carry, __uint_as_float(v[s]));
        run[s] = carry;
      }
    }
    carry = __shfl_sync(full, carry, l);
  }
  // first argmax of run_t / sqrt(t + 1) (t ascending within a lane)
  float bv = 0.0f;
  int bt = -1;
  uint32_t thr = 0;
#pragma unroll
  for (int s = 0; s < E; ++s) {
    const int t = lane * E + s;
    if (t < k) {
      const float zs_t = __fdiv_rn(run[s], __fsqrt_rn((float)(t + 1)));
      if (bt < 0 || zs_t > bv) {
        bv = zs_t;
        bt = t;
        thr = v[s];
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(full, bv, off);
    const int ot = __shfl_xor_sync(full, bt, off);
    const uint32_t oth = __shfl_xor_sync(full, thr, off);
    if (wins(ov, ot, bv, bt)) {
      bv = ov;
      bt = ot;
      thr = oth;
    }
  }
  // coordinates above the value at rank t*, then the tied ones to take
  int above = 0;
#pragma unroll
  for (int s = 0; s < E; ++s) above += s * 32 + lane < k && bits[s] > thr;
  const int need = bt + 1 - (int)__reduce_add_sync(full, (unsigned)above);
  const float inv = __fdiv_rn(1.0f, __fsqrt_rn((float)(bt + 1)));
  const unsigned before = (1u << lane) - 1u;
  int8_t* pr = pat + row * k;
  float* ar = a + row * k;
  int taken = 0;
#pragma unroll
  for (int s = 0; s < E; ++s) {
    const int i = s * 32 + lane;
    const bool tie = i < k && bits[s] == thr;
    const unsigned ties = __ballot_sync(full, tie);
    const bool on = bits[s] > thr || (tie && taken + __popc(ties & before) < need);
    taken += __popc(ties);
    if (i < k) {
      const bool p = (pos >> s) & 1u;
      __stcs(pr + i, (int8_t)(on ? (p ? 1 : -1) : 0));
      __stcs(ar + i, on ? (p ? inv : -inv) : 0.0f);
    }
  }
}

// --------------------------------------------------------------- CTA route

// (|z_i| bits << 32) | ~i: distinct keys in the stable argsort's order
__device__ __forceinline__ uint64_t tess_key(float z, int i) {
  return ((uint64_t)(__float_as_uint(z) & 0x7fffffffu) << 32) |
         (uint32_t)~(uint32_t)i;
}

__device__ __forceinline__ float key_abs(uint64_t key) {
  return __uint_as_float((uint32_t)(key >> 32));
}

// larger key to a, smaller to b
__device__ __forceinline__ void cx(uint64_t& a, uint64_t& b) {
  const uint64_t hi = a > b ? a : b;
  const uint64_t lo = a > b ? b : a;
  a = hi;
  b = lo;
}

// shared memory: k keys (8k bytes), then k running sums (4k bytes)
__global__ void __launch_bounds__(TESS_CTA_THREADS)
    tess_cta_kernel(const float* __restrict__ z, int8_t* __restrict__ pat,
                    float* __restrict__ a, int k) {
  extern __shared__ uint64_t keys[];
  float* runs = (float*)(keys + k);
  __shared__ float red_v[TESS_CTA_THREADS / 32];
  __shared__ int red_t[TESS_CTA_THREADS / 32];
  __shared__ uint64_t red_k[TESS_CTA_THREADS / 32];
  const unsigned full = 0xffffffffu;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row = blockIdx.x;
  const float* zr = z + row * k;
  for (int i = tid; i < k; i += TESS_CTA_THREADS) keys[i] = tess_key(zr[i], i);
  __syncthreads();
  int width = 1;
  while (width < k) width <<= 1;
  const int half = width >> 1;
  for (int size = 2; size <= width; size <<= 1) {
    const int hs = size >> 1;
    for (int c = tid; c < half; c += TESS_CTA_THREADS) {
      const int p = (c / hs) * size + (c % hs);
      const int q = p ^ (size - 1);
      if (q < k) cx(keys[p], keys[q]);
    }
    __syncthreads();
    for (int j = size >> 2; j > 0; j >>= 1) {
      for (int c = tid; c < half; c += TESS_CTA_THREADS) {
        const int p = (c / j) * 2 * j + (c % j);
        if (p + j < k) cx(keys[p], keys[p + j]);
      }
      __syncthreads();
    }
  }
  if (tid == 0) {
    float run = 0.0f;
#pragma unroll 8
    for (int t = 0; t < k; ++t) {
      run = __fadd_rn(run, key_abs(keys[t]));
      runs[t] = run;
    }
  }
  __syncthreads();
  float bv = 0.0f;
  int bt = -1;
  for (int t = tid; t < k; t += TESS_CTA_THREADS) {
    const float zs_t = __fdiv_rn(runs[t], __fsqrt_rn((float)(t + 1)));
    if (bt < 0 || zs_t > bv) {             // t ascending: keep the first max
      bv = zs_t;
      bt = t;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(full, bv, off);
    const int ot = __shfl_xor_sync(full, bt, off);
    if (wins(ov, ot, bv, bt)) {
      bv = ov;
      bt = ot;
    }
  }
  if (lane == 0) {
    red_v[warp] = bv;
    red_t[warp] = bt;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < TESS_CTA_THREADS / 32; ++w)
      if (wins(red_v[w], red_t[w], bv, bt)) {
        bv = red_v[w];
        bt = red_t[w];
      }
    red_t[0] = bt;
    red_k[0] = keys[bt];
  }
  __syncthreads();
  const int t_star = red_t[0];
  const uint64_t thr = red_k[0];
  const float inv = __fdiv_rn(1.0f, __fsqrt_rn((float)(t_star + 1)));
  int8_t* pr = pat + row * k;
  float* ar = a + row * k;
  for (int i = tid; i < k; i += TESS_CTA_THREADS) {
    const float zi = zr[i];
    const bool on = tess_key(zi, i) >= thr;
    const bool pos = zi >= 0.0f;
    __stcs(pr + i, (int8_t)(on ? (pos ? 1 : -1) : 0));
    __stcs(ar + i, on ? (pos ? inv : -inv) : 0.0f);
  }
}

// ------------------------------------------------------------------ entry

template <int K>
static int launch_narrow(const float* z, int8_t* pat, float* a, int64_t rows,
                         cudaStream_t st) {
  const int64_t blocks = (rows + TESS_ROWS - 1) / TESS_ROWS;
  const size_t smem = (size_t)TESS_ROWS * K * 9 + 16;
  tess_narrow_kernel<K><<<(unsigned)blocks, TESS_ROWS, smem, st>>>(
      z, pat, a, rows);
  return (int)cudaGetLastError();
}

template <int E>
static int launch_warp(const float* z, int8_t* pat, float* a, int64_t rows,
                       int k, cudaStream_t st) {
  const int64_t blocks = (rows + TESS_WARPS - 1) / TESS_WARPS;
  tess_warp_kernel<E><<<(unsigned)blocks, 32 * TESS_WARPS, 0, st>>>(
      z, pat, a, rows, k);
  return (int)cudaGetLastError();
}

// The route by k: narrow (k <= 32), warp (k <= 1024), CTA (wider).  The
// outputs must be 16-byte aligned (the wrapper allocates them).
extern "C" int tess_project_f32(const void* z, void* pat, void* a,
                                int64_t rows, int k, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows <= 0) return (int)cudaGetLastError();
  if (((uintptr_t)pat | (uintptr_t)a) & 15) return (int)cudaErrorMisalignedAddress;
  const float* zf = (const float*)z;
  int8_t* p = (int8_t*)pat;
  float* af = (float*)a;
  static_assert(TESS_NARROW_MAX_K == 32, "one case below for each k <= 32");
  switch (k) {
#define TESS_NARROW_CASE(K) \
  case K:                   \
    return launch_narrow<K>(zf, p, af, rows, st);
    TESS_NARROW_CASE(1) TESS_NARROW_CASE(2) TESS_NARROW_CASE(3)
    TESS_NARROW_CASE(4) TESS_NARROW_CASE(5) TESS_NARROW_CASE(6)
    TESS_NARROW_CASE(7) TESS_NARROW_CASE(8) TESS_NARROW_CASE(9)
    TESS_NARROW_CASE(10) TESS_NARROW_CASE(11) TESS_NARROW_CASE(12)
    TESS_NARROW_CASE(13) TESS_NARROW_CASE(14) TESS_NARROW_CASE(15)
    TESS_NARROW_CASE(16) TESS_NARROW_CASE(17) TESS_NARROW_CASE(18)
    TESS_NARROW_CASE(19) TESS_NARROW_CASE(20) TESS_NARROW_CASE(21)
    TESS_NARROW_CASE(22) TESS_NARROW_CASE(23) TESS_NARROW_CASE(24)
    TESS_NARROW_CASE(25) TESS_NARROW_CASE(26) TESS_NARROW_CASE(27)
    TESS_NARROW_CASE(28) TESS_NARROW_CASE(29) TESS_NARROW_CASE(30)
    TESS_NARROW_CASE(31) TESS_NARROW_CASE(32)
#undef TESS_NARROW_CASE
    default:
      break;
  }
  if (k <= 64) return launch_warp<2>(zf, p, af, rows, k, st);
  if (k <= 128) return launch_warp<4>(zf, p, af, rows, k, st);
  if (k <= 256) return launch_warp<8>(zf, p, af, rows, k, st);
  if (k <= 512) return launch_warp<16>(zf, p, af, rows, k, st);
  if (k <= TESS_WARP_MAX_K) return launch_warp<32>(zf, p, af, rows, k, st);
  if (rows > 2147483647LL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)12 * k;     // keys, running sums
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        tess_cta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  tess_cta_kernel<<<(unsigned)rows, TESS_CTA_THREADS, smem, st>>>(zf, p, af, k);
  return (int)cudaGetLastError();
}
