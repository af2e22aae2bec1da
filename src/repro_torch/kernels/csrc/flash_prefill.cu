// Causal GQA flash attention for prefill, f32 or bf16 in, f32 arithmetic.
//
// Replaces the Pallas kernel `flash_prefill` of
// src/repro/kernels/flash_prefill.py (pl.pallas_call at :91, body `_kernel`
// at :29).  Layout as there: q (B, S, Hkv, G, hd), k/v (B, S, Hkv, hd), out
// like q.  For each query position i, kv head h and query head g of its group
//     s[j] = (q[b,i,h,g,:] . k[b,j,h,:]) * hd^-0.5        j <= i, in f32
//     out  = sum_j e^(s[j] - m) v[b,j,h,:] / max(sum_j e^(s[j] - m), 1e-30)
// with the running (m, l, acc) of an online softmax over KV tiles, as the
// Pallas body keeps it; the probabilities stay f32 for p.v, as the Pallas
// body casts them.
//
// On the TPU the KV axis was the sequential innermost grid axis, carrying
// (m, l, acc) in VMEM across grid steps.  Hopper runs blocks in parallel, so
// one CTA owns one (batch row, kv head, query tile) and walks the KV tiles in
// a loop.  A query tile is FP_ROWS = 128 (query position, query head) rows:
// 128 / G positions of all G heads of the kv head (16 positions at G = 8),
// so each K/V tile is loaded once per CTA and used by every query head of
// its group.  KV tiles are FP_BK = 64 positions; tiles that start past the
// query tile's last position are never loaded (causal pruning), and the
// ragged tail of S is masked in the kernel (no whole-tile fallback as on the
// TPU).  Query tiles are issued last-first, so the longest walks start
// earliest.
//
// Two kernels share that work split.
//
// bf16 (flash_prefill_mma_kernel, on the tensor cores; attn_mma.cuh says
// why the function is unchanged: bf16 q.k products are exact in f32, and p
// is split exactly into three bf16 terms for p.v).  8 warps, each owning 16
// of the 128 rows, its Q held in registers as mma A fragments for the whole
// walk.  K/V tiles stay bf16 in shared memory (rows padded by 16 bytes, so
// ldmatrix does not conflict), in a ring of 3 stages (2 at hd 128) filled
// by 16-byte cp.async (zero-filled past S and hd), the next tiles loading
// while the current one computes: one __syncthreads a tile.  Two CTAs share
// an SM at hd <= 64 (128 registers a thread).  Per tile and warp:
//   1. S = Q K^T by mma (ldmatrix of K rows as B), masked to -1e30 only on
//      tiles that reach past the CTA's first query position;
//   2. the online softmax in registers, in base 2: p = 2^(s c - m') with c
//      = hd^-0.5 log2(e) in one fma and one ex2 on the SFU, which is
//      e^(s hd^-0.5 - m) up to f32 rounding (attn::ex2 says what it
//      flushes).  A row's 64 scores lie in one quad of lanes, so its max is
//      two shuffles; l is summed per lane and reduced once at the end;
//   3. acc = acc * correction + P V: the score fragments, turned into p,
//      are the A fragments of P (FlashAttention-2 register reuse), split
//      into p_hi, p_mid, p_lo: three mma per (16 keys, 8 dims), V's B
//      fragments by ldmatrix.trans.
// A warp whose rows all precede the tile skips it.  The epilogue divides by
// max(l, 1e-30) and rounds once to bf16.
//
// f32 (flash_prefill_kernel, on the CUDA cores: an f32 q.k on bf16 tensor
// cores would compute another function).  128 threads, each owning 8 rows x
// 8 keys of the score tile and 8 rows x HDP / 8 dims of acc, rows strided 16
// and columns 8 apart so the shared-memory reads do not conflict; per KV
// tile:
//   1. K and V rows are staged in shared memory as f32 (zero past S and hd);
//   2. scores: a sequential f32 fma loop over d, scaled, masked to -1e30
//      where j > i or j >= S, written to shared memory;
//   3. one thread per row takes the tile max, m_new, the correction
//      e^(m - m_new) and l, and turns the scores into p = e^(s - m_new);
//   4. acc = acc * correction + p . V, a sequential fma loop over the tile.
//
// Bound on an H100: operations.  At tinyllama's prefill (B 8, S 1,024, Hkv
// 4, G 8, hd 64) the causal work is 17.2 GFLOP for q.k and as much for p.v,
// against 75 MB of inputs and outputs (22.5 us at 3.35 TB/s).  The bf16
// kernel runs q.k once and p.v three times at the bf16 tensor-core rate
// (989 TFLOP/s): 69.6 us.  The f32 kernel runs both at the f32 rate of the
// CUDA cores (67 TFLOP/s): 0.51 ms.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_mma.cuh"

#define FP_THREADS 128   // threads per CTA
#define FP_ROWS 128      // (query position, query head) rows per CTA
#define FP_BK 64         // KV positions per tile
#define FP_RT 8          // rows per thread (strided FP_ROWS / FP_RT = 16)
#define FP_CT 8          // score columns per thread (strided 8)
#define FP_NEG (-1e30f)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void from_f32(float x, float* o) { *o = x; }

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

// ------------------------------------------------- bf16, tensor cores

#define FM_WARPS (FP_ROWS / 16)     // a warp owns 16 rows
#define FM_THREADS (FM_WARPS * 32)

using attn::bf16;

template <int HDP>
struct FmSmem {
  static constexpr int LD = HDP + 8;      // bf16 row stride: 16-byte pad
  static constexpr int STAGES = HDP <= 64 ? 3 : 2;
  static constexpr int TILE = FP_BK * LD;  // one K or V tile, elements
  static constexpr int KV_OFF = FP_ROWS * LD;
  static constexpr size_t BYTES =
      (size_t)(KV_OFF + 2 * STAGES * TILE) * sizeof(bf16);
};

// grid (query tiles, Hkv, B); block FM_THREADS; dynamic smem FmSmem::BYTES.
template <int HDP>
__global__ void __launch_bounds__(FM_THREADS, HDP <= 64 ? 2 : 1)
    flash_prefill_mma_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v, bf16* __restrict__ out,
                             int S, int hkv, int G, int hd, int bq,
                             float scale, int vec) {
  using L = FmSmem<HDP>;
  constexpr int LD = L::LD, NS = L::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* KVs = Qs + L::KV_OFF;                 // [stage][K, V][FP_BK][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest walks first
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int q0 = qt * bq;
  const int rows = bq * G;
  const int64_t pos_stride = (int64_t)hkv * G * hd;   // q between positions
  const int64_t kv_stride = (int64_t)hkv * hd;        // k/v between positions
  const bf16* qb = q + b * S * pos_stride + (int64_t)h * G * hd;
  const bf16* kb = k + b * S * kv_stride + (int64_t)h * hd;
  const bf16* vb = v + b * S * kv_stride + (int64_t)h * hd;
  const int last = min(q0 + bq - 1, S - 1);   // last key any row attends to
  const int n_tiles = last / FP_BK + 1;
  // scores in base 2: e^(s - m) = 2^(s log2(e) - m log2(e))
  const float scale2 = scale * 1.4426950408889634f;

  // this thread's 16-byte chunks of a K or V tile: rows ld_r + i RP at
  // column ld_c, the same in every tile (the copy's addresses are set up
  // once: per tile it issues little more than its cp.async)
  constexpr int CPR = HDP / 8, RP = FM_THREADS / CPR;
  const int ld_r = tid / CPR, ld_c = tid % CPR * 8;
  auto load_kv = [&](int stage, int t) {
    const int k0 = t * FP_BK;
    bf16* ks = KVs + stage * 2 * L::TILE;
    if (vec) {
      const int64_t off = (k0 + ld_r) * kv_stride + ld_c;
#pragma unroll
      for (int i = 0; i < FP_BK / RP; ++i) {
        const bool ok = k0 + ld_r + i * RP < S && ld_c < hd;
        const int64_t g = ok ? off + i * RP * kv_stride : 0;
        bf16* d = ks + (ld_r + i * RP) * LD + ld_c;
        attn::cp_async16(d, kb + g, ok);
        attn::cp_async16(d + L::TILE, vb + g, ok);
      }
    } else {
      auto ok = [&](int r) { return k0 + r < S; };
      attn::stage_rows<HDP, LD>(
          ks, FP_BK, hd, 0, [&](int r) { return kb + (k0 + r) * kv_stride; },
          ok, tid, FM_THREADS);
      attn::stage_rows<HDP, LD>(
          ks + L::TILE, FP_BK, hd, 0,
          [&](int r) { return vb + (k0 + r) * kv_stride; }, ok, tid,
          FM_THREADS);
    }
  };
  // the query tile, zero past hd and on padding rows; it lands with tile 0
  attn::stage_rows<HDP, LD>(
      Qs, FP_ROWS, hd, vec,
      [&](int r) { return qb + (q0 + r / G) * pos_stride + (r % G) * hd; },
      [&](int r) { return r < rows && q0 + r / G < S; }, tid, FM_THREADS);
#pragma unroll
  for (int st = 0; st < NS - 1; ++st) {
    if (st < n_tiles) load_kv(st, st);
    attn::cp_async_commit();
  }

  // this lane's two rows (gid, gid + 8 of the warp's 16): query position,
  // -1 on padding rows (masked everywhere; never written)
  const int r0 = warp * 16 + gid, r1 = r0 + 8;
  const int qpos0 = (r0 < rows && q0 + r0 / G < S) ? q0 + r0 / G : -1;
  const int qpos1 = (r1 < rows && q0 + r1 / G < S) ? q0 + r1 / G : -1;
  const int warp_rows = min(warp * 16 + 16, rows);
  const int warp_last =
      warp * 16 < rows ? min(q0 + (warp_rows - 1) / G, S - 1) : -1;

  uint32_t qf[HDP / 16][4];
  float o[HDP / 8][4];
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = FP_NEG, m1 = FP_NEG, l0 = 0.f, l1 = 0.f;
  int st_cur = 0, st_next = NS - 1;   // ring stages of tiles t, t + NS - 1

  for (int t = 0; t < n_tiles; ++t) {
    attn::cp_async_wait<NS - 2>();
    __syncthreads();          // tile t landed; tile t - 1 is no longer read
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        attn::ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 7) +
                                        ((lane >> 3) & 1) * 8) * LD +
                                       kk * 16 + (lane >> 4) * 8);
      }
    }
    if (t + NS - 1 < n_tiles) load_kv(st_next, t + NS - 1);  // tile t-1's
    attn::cp_async_commit();
    const bf16* ks = KVs + st_cur * 2 * L::TILE;
    const bf16* vs = ks + L::TILE;
    st_cur = st_cur + 1 == NS ? 0 : st_cur + 1;
    st_next = st_next + 1 == NS ? 0 : st_next + 1;
    const int k0 = t * FP_BK;
    if (k0 > warp_last) continue;           // every key after its rows

    // 1. scores, 16 rows x 64 keys: s[nt] covers keys 8 nt .. 8 nt + 7
    float s[FP_BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < FP_BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < FP_BK / 16; ++np) {
        uint32_t kf[4];
        attn::ldmatrix_x4(
            kf, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                    ((lane >> 3) & 1) * 8);
        attn::mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
        attn::mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }
    if (k0 + FP_BK - 1 > q0) {               // some key after some row
#pragma unroll
      for (int nt = 0; nt < FP_BK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + nt * 8 + tig * 2 + (e & 1);
          if (kpos > (e < 2 ? qpos0 : qpos1)) s[nt][e] = FP_NEG;
        }
      }
    }

    // 2. online softmax in registers, on the scores scaled into base 2
    float mx0 = FP_NEG, mx1 = FP_NEG;
#pragma unroll
    for (int nt = 0; nt < FP_BK / 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    const float mn0 = fmaxf(m0, attn::quad_max(mx0) * scale2);
    const float mn1 = fmaxf(m1, attn::quad_max(mx1) * scale2);
    const float c0 = attn::ex2(m0 - mn0), c1 = attn::ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < FP_BK / 8; ++nt) {
      s[nt][0] = attn::ex2(fmaf(s[nt][0], scale2, -mn0));
      s[nt][1] = attn::ex2(fmaf(s[nt][1], scale2, -mn0));
      s[nt][2] = attn::ex2(fmaf(s[nt][2], scale2, -mn1));
      s[nt][3] = attn::ex2(fmaf(s[nt][3], scale2, -mn1));
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * c0 + sum0;                    // this lane's share of the row
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      o[j][0] *= c0;
      o[j][1] *= c0;
      o[j][2] *= c1;
      o[j][3] *= c1;
    }

    // 3. acc += P V, p as three bf16 terms
#pragma unroll
    for (int kk = 0; kk < FP_BK / 16; ++kk) {
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
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qpos = half ? qpos1 : qpos0;
    if (qpos < 0) continue;
    const int r = half ? r1 : r0;
    const float inv_l = 1.0f / fmaxf(half ? l1 : l0, 1e-30f);
    bf16* orow = out + b * S * pos_stride + (int64_t)qpos * pos_stride +
                 (int64_t)h * G * hd + (r % G) * hd;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int d = j * 8 + tig * 2;
      const float x0 = o[j][2 * half] * inv_l, x1 = o[j][2 * half + 1] * inv_l;
      if (d + 1 < hd && (hd & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(orow + d) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (d < hd) orow[d] = __float2bfloat16_rn(x0);
        if (d + 1 < hd) orow[d + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

// ------------------------------------------------------------ launchers

template <int HDP>
static int launch_f32(const void* q, const void* k, const void* v, void* out,
                      int B, int S, int hkv, int G, int hd, int bq,
                      float scale, cudaStream_t st) {
  const size_t smem = FpSmem<HDP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<float, HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + bq - 1) / bq, hkv, B);
  flash_prefill_kernel<float, HDP><<<grid, FP_THREADS, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, S, hkv,
      G, hd, bq, scale);
  return (int)cudaGetLastError();
}

template <int HDP>
static int launch_bf16(const void* q, const void* k, const void* v, void* out,
                       int B, int S, int hkv, int G, int hd, int bq,
                       float scale, cudaStream_t st) {
  const size_t smem = FmSmem<HDP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_mma_kernel<HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies need rows of a multiple of 8 elements and aligned bases
  const int vec = hd % 8 == 0 && (uintptr_t)q % 16 == 0 &&
                  (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0;
  dim3 grid((S + bq - 1) / bq, hkv, B);
  flash_prefill_mma_kernel<HDP><<<grid, FM_THREADS, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, S, hkv, G,
      hd, bq, scale, vec);
  return (int)cudaGetLastError();
}

static bool valid_shape(int B, int S, int hkv, int G, int hd, int bq) {
  return B >= 1 && S >= 1 && hkv >= 1 && G >= 1 && hd >= 1 && hd <= 128 &&
         bq >= 1 && bq * G <= FP_ROWS && hkv <= 65535 && B <= 65535;
}

extern "C" int flash_prefill_f32(const void* q, const void* k, const void* v,
                                 void* out, int B, int S, int hkv, int G,
                                 int hd, int bq, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!valid_shape(B, S, hkv, G, hd, bq)) return (int)cudaErrorInvalidValue;
  if (hd <= 32) return launch_f32<32>(q, k, v, out, B, S, hkv, G, hd, bq,
                                      scale, st);
  if (hd <= 64) return launch_f32<64>(q, k, v, out, B, S, hkv, G, hd, bq,
                                      scale, st);
  return launch_f32<128>(q, k, v, out, B, S, hkv, G, hd, bq, scale, st);
}

extern "C" int flash_prefill_bf16(const void* q, const void* k, const void* v,
                                  void* out, int B, int S, int hkv, int G,
                                  int hd, int bq, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!valid_shape(B, S, hkv, G, hd, bq)) return (int)cudaErrorInvalidValue;
  if (hd <= 32) return launch_bf16<32>(q, k, v, out, B, S, hkv, G, hd, bq,
                                       scale, st);
  if (hd <= 64) return launch_bf16<64>(q, k, v, out, B, S, hkv, G, hd, bq,
                                       scale, st);
  return launch_bf16<128>(q, k, v, out, B, S, hkv, G, hd, bq, scale, st);
}
