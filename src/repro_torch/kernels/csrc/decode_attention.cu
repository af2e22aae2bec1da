// One-token GQA attention over a KV cache (flash-decoding), f32 or bf16.
//
// Replaces the Pallas kernel `decode_attention` of
// src/repro/kernels/decode_attention.py (pl.pallas_call at :77, body
// `_kernel` at :25).  For each batch row b, kv head h and query head g of
// its group it computes
//     s[t] = (q[b,h,g,:] . k[b,t,h,:]) * hd^-0.5        in f32
//     over positions t <= length (later positions contribute nothing),
//     out  = sum_t softmax(s)[t] * v[b,t,h,:]            in f32,
// rounded once to q's dtype.  `length` is read from device memory, so the
// caller never synchronises with the host to learn it.
//
// On the TPU the S axis was the sequential innermost grid axis, carrying the
// running (max, sum, accumulator) in VMEM.  Hopper runs blocks in parallel,
// so S is cut into `n_split` chunks of whole tiles and the grid is (split,
// kv head, batch x query-head block), sized to fill the 132 SMs: at the
// serving shape (B 8, Hkv 4) one CTA per (b, h) would give 32 CTAs.  Each
// CTA keeps its own online softmax over its chunk and writes the partial
// (m, l, acc) in f32; decode_merge_kernel combines the splits,
//     M = max m_s, L = sum l_s e^(m_s - M), out = sum acc_s e^(m_s - M) / L,
// which is the plain softmax up to rounding.  Chunks past `length` do no
// loads and write (-inf, 0, 0).
//
// Bound on an H100: bytes.  It must read the K and V rows at positions
// <= length once (2 (length+1) Hkv hd elements per batch row) and q, and
// write out; its operations are 4 G hd per position.
//
// bf16 (decode_mma_kernel, on the tensor cores; attn_mma.cuh says why the
// function is unchanged: bf16 q.k products are exact in f32, and p is split
// exactly into three bf16 terms for p.v).  A CTA takes DM_HEADS = 16 query
// heads of one kv head, the rows of one mma tile (zero rows past G; a wider
// group takes several head blocks, each reading the chunk again), and 4
// warps.  Each warp walks its own tiles of the chunk (tiles w, w + 4, ... of
// DmShape::T positions, so the CTA reads one contiguous stretch at a time)
// through its own ring of DM_STAGES tiles in shared memory, filled by 16-byte
// cp.async and zero-filled past the chunk: two tiles in flight while it
// computes the third, and only __syncwarp inside the loop.  Per tile:
// S = q K^T by mma (q's A fragments held in registers), the online softmax
// in registers (a head's scores lie in one quad of lanes), acc += P V by
// three mma per (16 positions, 8 dims) on p_hi, p_mid, p_lo.  The warps'
// (m, l, acc) merge once through shared memory at the end.  With one
// instruction stream per 16 heads x T positions, not per position, the
// loads in flight, not instruction issue, set the pace: about 4 x 2 x 9 KB
// a CTA at hd 64, two CTAs an SM.
//
// f32 (decode_partial_kernel, on the CUDA cores: an f32 q.k on bf16 tensor
// cores would compute another function).  128 threads walk the chunk in
// tiles of `tile` positions (64, or fewer where wide rows would not fit).
// The K and V rows of the next tile are copied into shared memory with
// cp.async (16-byte chunks, coalesced) while the current tile is computed.
// Per tile: each thread scores one position against GC query heads at a
// time (its K row read from shared memory as 16-byte vectors, rows padded by
// 16 bytes so the reads do not conflict; the query rows, staged once in f32,
// read as broadcasts); four warps update (m, l) per query head and turn the
// scores into e^(s - m) in place; each thread adds the tile's V rows into
// its (query head, dim) accumulators, kept in registers (at most 16 a
// thread, so a CTA serves a block of at most 2048 / hd query heads; a wider
// group takes several CTAs, each reading the chunk's K/V again).  The
// wrapper picks GC so that every thread group scores: at G = 8, 64
// positions x 2 groups of 4 heads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_mma.cuh"

#define DA_THREADS 128   // threads per CTA
#define DA_ACC 16        // (query head, dim) accumulators per thread
#define DA_WARPS (DA_THREADS / 32)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void from_f32(float x, float* o) { *o = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(x);
}

// 16 bytes of elements as f32; p is 16-byte aligned
__device__ __forceinline__ void load16(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
}

using attn::cp_async16;
using attn::cp_async_commit;
using attn::cp_async_wait;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Row stride in shared memory, in elements: hd plus 16 bytes of padding.
template <typename T>
__host__ __device__ __forceinline__ int kv_ld(int hd) {
  return hd + 16 / (int)sizeof(T);
}

// Dynamic shared memory of decode_partial_kernel, in bytes.
template <typename T>
__host__ __device__ __forceinline__ size_t decode_smem(int tile, int gpad,
                                                       int hd) {
  const int hd4 = (hd + 3) / 4 * 4;
  return (size_t)4 * tile * kv_ld<T>(hd) * sizeof(T)   // 2 stages x (K, V)
         + (size_t)(gpad * hd4 + gpad * tile + 3 * gpad) * sizeof(float);
}

// Copy rows [t0, t0 + n) of this (b, h)'s K and V into a stage: 16-byte
// cp.async chunks when `vec`, else element by element.
template <typename T>
__device__ __forceinline__ void load_tile(T* ks, T* vs, const T* kb,
                                          const T* vb, int64_t row_stride,
                                          int t0, int n, int hd, int ld,
                                          int vec) {
  if (vec) {
    const int per_row = hd * (int)sizeof(T) / 16;
    const int per_mat = n * per_row;
    for (int c = threadIdx.x; c < 2 * per_mat; c += DA_THREADS) {
      const int m = c / per_mat, r = (c % per_mat) / per_row;
      const int j = c % per_row;
      const T* src = (m ? vb : kb) + (int64_t)(t0 + r) * row_stride;
      T* dst = (m ? vs : ks) + r * ld;
      cp_async16(reinterpret_cast<char*>(dst) + 16 * j,
                 reinterpret_cast<const char*>(src) + 16 * j);
    }
  } else {
    for (int e = threadIdx.x; e < 2 * n * hd; e += DA_THREADS) {
      const int m = e / (n * hd), r = (e % (n * hd)) / hd, d = e % hd;
      (m ? vs : ks)[r * ld + d] =
          (m ? vb : kb)[(int64_t)(t0 + r) * row_stride + d];
    }
  }
}

// q (B, Hkv, G, hd); k, v (B, S, Hkv, hd); partials indexed
// ((b Hkv + h) G + g) n_split + split.  gpad = gblk rounded up to GC;
// `tile` divides DA_THREADS and `chunk`.
template <typename T, int GC>
__global__ void __launch_bounds__(DA_THREADS) decode_partial_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int32_t* __restrict__ length,
    float* __restrict__ part_acc, float* __restrict__ part_m,
    float* __restrict__ part_l, int S, int hkv, int G, int hd, int gblk,
    int n_gblk, int chunk, int n_split, int tile, int vec, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z / n_gblk;
  const int g0 = (blockIdx.z % n_gblk) * gblk;
  const int gb = min(gblk, G - g0);
  const int gpad = (gblk + GC - 1) / GC * GC;
  const int hd4 = (hd + 3) / 4 * 4;
  const int ld = kv_ld<T>(hd);
  T* const kvbase = reinterpret_cast<T*>(smem_raw);   // [stage][K, V][tile][ld]
  float* qs = reinterpret_cast<float*>(kvbase + 4 * tile * ld);  // (gpad, hd4)
  float* sc = qs + gpad * hd4;                                   // (gpad, tile)
  float* m_s = sc + gpad * tile;
  float* l_s = m_s + gpad;
  float* corr_s = l_s + gpad;

  const int64_t qbase = ((int64_t)b * hkv + h) * G + g0;
  for (int i = tid; i < gpad * hd; i += DA_THREADS) {
    const int g = i / hd, d = i % hd;
    qs[g * hd4 + d] = g < gb ? to_f32(q[(qbase + g) * hd + d]) : 0.0f;
  }
  for (int g = tid; g < gpad; g += DA_THREADS) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.0f;
  }
  // this thread's accumulators: pair i <-> (g, d) = divmod(tid + i T, hd),
  // for i < n_acc (the last may lie past gpad * hd)
  const int n_pairs = gpad * hd;
  const int n_acc = (n_pairs + DA_THREADS - 1) / DA_THREADS;
  const bool same_d = DA_THREADS % hd == 0;     // one dim for all its pairs
  float acc[DA_ACC];
  int acc_g[DA_ACC], acc_d[DA_ACC];
#pragma unroll
  for (int i = 0; i < DA_ACC; ++i) {
    const int pair = min(tid + i * DA_THREADS, n_pairs - 1);
    acc[i] = 0.0f;
    acc_g[i] = pair / hd;
    acc_d[i] = pair - acc_g[i] * hd;
  }

  const int last = min(*length, S - 1);        // attend to positions <= last
  const int s_begin = split * chunk;
  const int s_end = min(min(S, s_begin + chunk), last + 1);
  const int64_t row_stride = (int64_t)hkv * hd; // elements between positions
  const T* kb = k + ((int64_t)b * S * hkv + h) * hd;
  const T* vb = v + ((int64_t)b * S * hkv + h) * hd;
  const int n_tiles = s_end > s_begin ? (s_end - s_begin + tile - 1) / tile : 0;
  // score mapping: position t_own of the tile, query-head group grp
  const int t_own = tid % tile, grp = tid / tile, n_grp = DA_THREADS / tile;
  const int warp = tid / 32, lane = tid % 32;

  if (n_tiles > 0) {
    load_tile(kvbase, kvbase + tile * ld, kb, vb, row_stride, s_begin,
              min(tile, s_end - s_begin), hd, ld, vec);
  }
  cp_async_commit();
  __syncthreads();                              // qs, m_s, l_s written

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = s_begin + it * tile;
    const int n_t = min(tile, s_end - t0);
    if (it + 1 < n_tiles) {                     // prefetch the next tile
      const int t1 = t0 + tile;
      T* nk = kvbase + (size_t)((it + 1) & 1) * 2 * tile * ld;
      load_tile(nk, nk + tile * ld, kb, vb, row_stride, t1,
                min(tile, s_end - t1), hd, ld, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                            // this tile's K/V landed
    const T* ks = kvbase + (size_t)(it & 1) * 2 * tile * ld;
    const T* vs = ks + tile * ld;

    // --- scores: thread (t_own, grp) takes GC query heads at a time
    for (int gc0 = grp * GC; gc0 < gpad; gc0 += n_grp * GC) {
      float s[GC];
#pragma unroll
      for (int g = 0; g < GC; ++g) s[g] = 0.0f;
      if (t_own < n_t) {
        const T* kr = ks + t_own * ld;
        if (vec) {
          constexpr int E = 16 / sizeof(T);
          for (int d = 0; d < hd; d += E) {
            float kv[E];
            load16(kr + d, kv);
#pragma unroll
            for (int g = 0; g < GC; ++g) {
              const float* qr = qs + (gc0 + g) * hd4 + d;
#pragma unroll
              for (int e = 0; e < E; e += 4) {
                const float4 qv = *reinterpret_cast<const float4*>(qr + e);
                s[g] = fmaf(qv.x, kv[e], s[g]);
                s[g] = fmaf(qv.y, kv[e + 1], s[g]);
                s[g] = fmaf(qv.z, kv[e + 2], s[g]);
                s[g] = fmaf(qv.w, kv[e + 3], s[g]);
              }
            }
          }
        } else {
          for (int d = 0; d < hd; ++d) {
            const float kd = to_f32(kr[d]);
#pragma unroll
            for (int g = 0; g < GC; ++g) {
              s[g] = fmaf(qs[(gc0 + g) * hd4 + d], kd, s[g]);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        sc[(gc0 + g) * tile + t_own] = t_own < n_t ? s[g] * scale : -INFINITY;
      }
    }
    __syncthreads();
    // --- online softmax update, one warp per query head
    for (int g = warp; g < gpad; g += DA_WARPS) {
      float* row = sc + g * tile;
      float mx = -INFINITY;
      for (int j = lane; j < tile; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int j = lane; j < tile; j += 32) {
        const float p = expf(row[j] - m_new);    // masked: e^-inf = 0
        row[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_old - m_new);     // first tile: e^-inf = 0
        corr_s[g] = c;
        l_s[g] = l_s[g] * c + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // --- accumulate the tile's V rows (in position order per accumulator;
    // unrolled by hand: a partial `#pragma unroll` of this loop miscompiled)
#pragma unroll
    for (int i = 0; i < DA_ACC; ++i) {
      if (i < n_acc) acc[i] *= corr_s[acc_g[i]];
    }
    int tt = 0;
    if (same_d) {                               // 4 positions a step
      const T* vcol = vs + acc_d[0];
      for (; tt + 4 <= n_t; tt += 4) {
        float vd[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) vd[u] = to_f32(vcol[(tt + u) * ld]);
#pragma unroll
        for (int i = 0; i < DA_ACC; ++i) {
          if (i < n_acc) {
            const float4 p =
                *reinterpret_cast<const float4*>(sc + acc_g[i] * tile + tt);
            acc[i] = fmaf(p.x, vd[0], acc[i]);
            acc[i] = fmaf(p.y, vd[1], acc[i]);
            acc[i] = fmaf(p.z, vd[2], acc[i]);
            acc[i] = fmaf(p.w, vd[3], acc[i]);
          }
        }
      }
    }
    for (; tt < n_t; ++tt) {
#pragma unroll
      for (int i = 0; i < DA_ACC; ++i) {
        if (i < n_acc) {
          acc[i] = fmaf(sc[acc_g[i] * tile + tt],
                        to_f32(vs[tt * ld + acc_d[i]]), acc[i]);
        }
      }
    }
    __syncthreads();                            // stage free for a prefetch
  }

  const int64_t pbase = qbase * n_split + split;   // (b, h, g0, split)
#pragma unroll
  for (int i = 0; i < DA_ACC; ++i) {
    if (i < n_acc && tid + i * DA_THREADS < n_pairs && acc_g[i] < gb) {
      part_acc[(pbase + (int64_t)acc_g[i] * n_split) * hd + acc_d[i]] = acc[i];
    }
  }
  for (int g = tid; g < gb; g += DA_THREADS) {
    part_m[pbase + (int64_t)g * n_split] = m_s[g];
    part_l[pbase + (int64_t)g * n_split] = l_s[g];
  }
}

// One CTA per (b, h, g): combine the splits' partials and round to T.
template <typename T>
__global__ void decode_merge_kernel(const float* __restrict__ part_acc,
                                    const float* __restrict__ part_m,
                                    const float* __restrict__ part_l,
                                    T* __restrict__ out, int hd,
                                    int n_split) {
  const int64_t row = blockIdx.x;               // (b Hkv + h) G + g
  const float* pm = part_m + row * n_split;
  const float* pl = part_l + row * n_split;
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, pm[s]);
  float l = 0.0f;
  for (int s = 0; s < n_split; ++s) {
    if (pl[s] > 0.0f) l += pl[s] * expf(pm[s] - mx);
  }
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float a = 0.0f;
    for (int s = 0; s < n_split; ++s) {
      if (pl[s] > 0.0f) {
        a += part_acc[(row * n_split + s) * hd + d] * expf(pm[s] - mx);
      }
    }
    from_f32(a / l, out + row * hd + d);
  }
}

template <typename T, int GC>
static int launch_partial(const void* q, const void* k, const void* v,
                          const void* length, void* part_acc, void* part_m,
                          void* part_l, int B, int S, int hkv, int G, int hd,
                          int gblk, int n_gblk, int chunk, int n_split,
                          int tile, int vec, float scale, cudaStream_t st) {
  const int gpad = (gblk + GC - 1) / GC * GC;
  const size_t smem = decode_smem<T>(tile, gpad, hd);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_partial_kernel<T, GC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(n_split, hkv, B * n_gblk);
  decode_partial_kernel<T, GC><<<grid, DA_THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int32_t*)length,
      (float*)part_acc, (float*)part_m, (float*)part_l, S, hkv, G, hd, gblk,
      n_gblk, chunk, n_split, tile, vec, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* q, const void* k, const void* v,
                  const void* length, void* out, void* part_acc, void* part_m,
                  void* part_l, int B, int S, int hkv, int G, int hd, int gc,
                  int gblk, int n_gblk, int chunk, int n_split, int tile,
                  float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (gblk < 1 || (gblk + gc - 1) / gc * gc * hd > DA_THREADS * DA_ACC ||
      tile < 1 || DA_THREADS % tile != 0 || chunk % tile != 0) {
    return (int)cudaErrorInvalidValue;
  }
  // 16-byte copies need 16-byte rows and base pointers
  const int vec = (hd * (int)sizeof(T)) % 16 == 0 &&
                  (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0;
  int err;
  switch (gc) {
    case 1:
      err = launch_partial<T, 1>(q, k, v, length, part_acc, part_m, part_l, B,
                                 S, hkv, G, hd, gblk, n_gblk, chunk, n_split,
                                 tile, vec, scale, st);
      break;
    case 2:
      err = launch_partial<T, 2>(q, k, v, length, part_acc, part_m, part_l, B,
                                 S, hkv, G, hd, gblk, n_gblk, chunk, n_split,
                                 tile, vec, scale, st);
      break;
    case 4:
      err = launch_partial<T, 4>(q, k, v, length, part_acc, part_m, part_l, B,
                                 S, hkv, G, hd, gblk, n_gblk, chunk, n_split,
                                 tile, vec, scale, st);
      break;
    case 8:
      err = launch_partial<T, 8>(q, k, v, length, part_acc, part_m, part_l, B,
                                 S, hkv, G, hd, gblk, n_gblk, chunk, n_split,
                                 tile, vec, scale, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  decode_merge_kernel<T><<<(unsigned)((int64_t)B * hkv * G), 64, 0, st>>>(
      (const float*)part_acc, (const float*)part_m, (const float*)part_l,
      (T*)out, hd, n_split);
  return (int)cudaGetLastError();
}

extern "C" int decode_attention_f32(
    const void* q, const void* k, const void* v, const void* length,
    void* out, void* part_acc, void* part_m, void* part_l, int B, int S,
    int hkv, int G, int hd, int gc, int gblk, int n_gblk, int chunk,
    int n_split, int tile, float scale, void* stream) {
  return launch<float>(q, k, v, length, out, part_acc, part_m, part_l, B, S,
                       hkv, G, hd, gc, gblk, n_gblk, chunk, n_split, tile,
                       scale, stream);
}

// ------------------------------------------------- bf16, tensor cores

#define DM_WARPS 4
#define DM_THREADS (DM_WARPS * 32)
#define DM_HEADS 16      // query heads of a CTA: the rows of one mma tile
#define DM_STAGES 3      // ring depth of each warp

using attn::bf16;

// HDP: hd rounded up to 32, 64, 128 or 256 (the zero-padded tile width).
template <int HDP>
struct DmShape {
  static constexpr int T = HDP >= 128 ? 16 : 32;   // positions of a tile
  static constexpr int LD = HDP + 8;      // bf16 row stride: 16-byte pad
  static constexpr int STAGE = 2 * T * LD;         // K then V, elements
  static constexpr int RING = DM_WARPS * DM_STAGES * STAGE;
  static constexpr size_t BYTES = (size_t)(RING + DM_HEADS * LD) * 2;
};

// q (B, Hkv, G, hd); k, v (B, S, Hkv, hd); partials as decode_partial_kernel
// writes them.  grid (n_split, Hkv, B x n_gblk); `chunk` a multiple of T.
template <int HDP>
__global__ void __launch_bounds__(DM_THREADS) decode_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int32_t* __restrict__ length,
    float* __restrict__ part_acc, float* __restrict__ part_m,
    float* __restrict__ part_l, int S, int hkv, int G, int hd, int n_gblk,
    int chunk, int n_split, int vec, float scale) {
  using L = DmShape<HDP>;
  constexpr int T = L::T, LD = L::LD, NS = DM_STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* const Qs = ring + L::RING;                    // (DM_HEADS, LD)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z / n_gblk;
  const int g0 = (blockIdx.z % n_gblk) * DM_HEADS;
  const int gb = min(DM_HEADS, G - g0);
  const int64_t qbase = ((int64_t)b * hkv + h) * G + g0;

  for (int i = tid; i < DM_HEADS * HDP; i += DM_THREADS) {
    const int g = i / HDP, d = i % HDP;
    Qs[g * LD + d] = (g < gb && d < hd) ? q[(qbase + g) * hd + d]
                                        : __float2bfloat16(0.f);
  }

  const int last = min(*length, S - 1);        // attend to positions <= last
  const int s_begin = split * chunk;
  const int s_end = min(min(S, s_begin + chunk), last + 1);
  const int n_tiles = s_end > s_begin ? (s_end - s_begin + T - 1) / T : 0;
  const int n_my =
      n_tiles > warp ? (n_tiles - warp + DM_WARPS - 1) / DM_WARPS : 0;
  const int64_t row_stride = (int64_t)hkv * hd; // elements between positions
  const bf16* kb = k + ((int64_t)b * S * hkv + h) * hd;
  const bf16* vb = v + ((int64_t)b * S * hkv + h) * hd;
  bf16* const my = ring + warp * NS * L::STAGE;

  // the warp's i-th tile (chunk tile warp + 4 i) into ring stage st, zero
  // past the chunk's end and past hd
  auto load = [&](int st, int i) {
    const int t0 = s_begin + (warp + i * DM_WARPS) * T;
    const int n = min(T, s_end - t0);
    bf16* ks = my + st * L::STAGE;
    auto ok = [&](int r) { return r < n; };
    attn::stage_rows<HDP, LD>(
        ks, T, hd, vec, [&](int r) { return kb + (t0 + r) * row_stride; },
        ok, lane, 32);
    attn::stage_rows<HDP, LD>(
        ks + T * LD, T, hd, vec,
        [&](int r) { return vb + (t0 + r) * row_stride; }, ok, lane, 32);
  };
#pragma unroll
  for (int st = 0; st < NS - 1; ++st) {
    if (st < n_my) load(st, st);
    attn::cp_async_commit();
  }
  __syncthreads();                              // Qs written

  uint32_t qf[HDP / 16][4];
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    attn::ldmatrix_x4(qf[kk], Qs + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                  kk * 16 + (lane >> 4) * 8);
  }
  float o[HDP / 8][4];
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  // rows gid and gid + 8 of the tile: query heads g0 + gid, g0 + gid + 8
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int i = 0; i < n_my; ++i) {
    attn::cp_async_wait<NS - 2>();
    __syncwarp();            // tile i landed; tile i - 1 is no longer read
    {
      const int in = i + NS - 1;                // into the stage i-1 held
      if (in < n_my) load(in % NS, in);
      attn::cp_async_commit();
    }
    const int n = min(T, s_end - (s_begin + (warp + i * DM_WARPS) * T));
    const bf16* ks = my + (i % NS) * L::STAGE;
    const bf16* vs = ks + T * LD;

    float s[T / 8][4];
#pragma unroll
    for (int nt = 0; nt < T / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < T / 16; ++np) {
        uint32_t kf[4];
        attn::ldmatrix_x4(
            kf, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                    ((lane >> 3) & 1) * 8);
        attn::mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
        attn::mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < T / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + tig * 2 + (e & 1);
        s[nt][e] = col < n ? s[nt][e] * scale : -INFINITY;
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < T / 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    // position 0 of the tile is kept, so the new max is finite; the first
    // tile's correction is e^-inf = 0
    const float mn0 = fmaxf(m0, attn::quad_max(mx0));
    const float mn1 = fmaxf(m1, attn::quad_max(mx1));
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < T / 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - mn0);          // masked: e^-inf = 0
      s[nt][1] = expf(s[nt][1] - mn0);
      s[nt][2] = expf(s[nt][2] - mn1);
      s[nt][3] = expf(s[nt][3] - mn1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * c0 + sum0;                        // this lane's share of the row
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      o[j][0] *= c0;
      o[j][1] *= c0;
      o[j][2] *= c1;
      o[j][3] *= c1;
    }
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) {
      uint32_t ph[4], pm[4], pl[4];
      attn::p_fragments(s[2 * kk], s[2 * kk + 1], ph, pm, pl);
#pragma unroll
      for (int np = 0; np < HDP / 16; ++np) {
        uint32_t vf[4];
        attn::ldmatrix_x4_trans(
            vf, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                    np * 16 + (lane >> 4) * 8);
        attn::pv_mma(o[2 * np], o[2 * np + 1], ph, pm, pl, vf);
      }
    }
  }
  attn::cp_async_wait<0>();
  l0 = attn::quad_sum(l0);
  l1 = attn::quad_sum(l1);

  // merge the warps through shared memory (the ring is no longer read)
  __syncthreads();
  float* mw = reinterpret_cast<float*>(smem_raw);   // (DM_WARPS, DM_HEADS)
  float* lw = mw + DM_WARPS * DM_HEADS;
  float* aw = lw + DM_WARPS * DM_HEADS;             // (.., .., HDP)
  const int w0 = warp * DM_HEADS + gid, w1 = w0 + 8;
  if (tig == 0) {
    mw[w0] = m0;
    mw[w1] = m1;
    lw[w0] = l0;
    lw[w1] = l1;
  }
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int d = j * 8 + tig * 2;
    aw[w0 * HDP + d] = o[j][0];
    aw[w0 * HDP + d + 1] = o[j][1];
    aw[w1 * HDP + d] = o[j][2];
    aw[w1 * HDP + d + 1] = o[j][3];
  }
  __syncthreads();
  const int64_t pbase = qbase * n_split + split;    // (b, h, g0, split)
  for (int i = tid; i < gb * hd; i += DM_THREADS) {
    const int g = i / hd, d = i % hd;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < DM_WARPS; ++w) mx = fmaxf(mx, mw[w * DM_HEADS + g]);
    float a = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < DM_WARPS; ++w) {
      const float mwg = mw[w * DM_HEADS + g];
      if (mwg != -INFINITY) {                   // a warp with no tiles adds 0
        const float c = expf(mwg - mx);
        a += aw[(w * DM_HEADS + g) * HDP + d] * c;
        l += lw[w * DM_HEADS + g] * c;
      }
    }
    part_acc[(pbase + (int64_t)g * n_split) * hd + d] = a;
    if (d == 0) {
      part_m[pbase + (int64_t)g * n_split] = mx;
      part_l[pbase + (int64_t)g * n_split] = l;
    }
  }
}

template <int HDP>
static int launch_mma(const void* q, const void* k, const void* v,
                      const void* length, void* out, void* part_acc,
                      void* part_m, void* part_l, int B, int S, int hkv,
                      int G, int hd, int n_gblk, int chunk, int n_split,
                      float scale, cudaStream_t st) {
  if (chunk % DmShape<HDP>::T != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = DmShape<HDP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      decode_mma_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies need rows of a multiple of 8 elements and aligned bases
  const int vec = hd % 8 == 0 && (uintptr_t)k % 16 == 0 &&
                  (uintptr_t)v % 16 == 0;
  dim3 grid(n_split, hkv, B * n_gblk);
  decode_mma_kernel<HDP><<<grid, DM_THREADS, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int32_t*)length,
      (float*)part_acc, (float*)part_m, (float*)part_l, S, hkv, G, hd, n_gblk,
      chunk, n_split, vec, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_merge_kernel<bf16><<<(unsigned)((int64_t)B * hkv * G), 64, 0, st>>>(
      (const float*)part_acc, (const float*)part_m, (const float*)part_l,
      (bf16*)out, hd, n_split);
  return (int)cudaGetLastError();
}

extern "C" int decode_attention_bf16(
    const void* q, const void* k, const void* v, const void* length,
    void* out, void* part_acc, void* part_m, void* part_l, int B, int S,
    int hkv, int G, int hd, int n_gblk, int chunk, int n_split, float scale,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || S < 1 || hkv < 1 || G < 1 || hd < 1 || hd > 256 ||
      n_gblk * DM_HEADS < G || chunk < 1 || n_split < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (hd <= 32) return launch_mma<32>(q, k, v, length, out, part_acc, part_m,
                                      part_l, B, S, hkv, G, hd, n_gblk, chunk,
                                      n_split, scale, st);
  if (hd <= 64) return launch_mma<64>(q, k, v, length, out, part_acc, part_m,
                                      part_l, B, S, hkv, G, hd, n_gblk, chunk,
                                      n_split, scale, st);
  if (hd <= 128) return launch_mma<128>(q, k, v, length, out, part_acc,
                                        part_m, part_l, B, S, hkv, G, hd,
                                        n_gblk, chunk, n_split, scale, st);
  return launch_mma<256>(q, k, v, length, out, part_acc, part_m, part_l, B,
                         S, hkv, G, hd, n_gblk, chunk, n_split, scale, st);
}
