// Fused candidate-pruned top-kappa MIPS: the gam-device query hot loop.
//
// Replaces two Pallas kernels of src/repro/kernels/gam_retrieve.py, which
// share one body (`_kernel` :306, `_overlap` :263, `_merge_topk` :278):
//  * `_gam_retrieve` (pl.pallas_call at :384), f32 factor rows, entry
//    gam_retrieve_f32;
//  * `_gam_retrieve_q` (pl.pallas_call at :444, `_kernel` with
//    quantized=True), an int8 (n_pad, k) slab with one f32 scale per item
//    block, decoded in the inner loop, entry gam_retrieve_i8.  Its kappa is
//    the re-rank pool width; the exact f32 re-rank runs after it, in torch.
// For each query q and item j it computes
//     cand = (popcount(q_bits & item_bits[j]) >= min_overlap | spill[j]) & alive[j]
// and, for candidates only, the f32 score u[q] . v[j]; it keeps the top kappa
// under the total order (score desc, row asc), the per-(query, item block)
// candidate counts, and the (query tile, item block) skip map of the
// block-union prepass.  Empty slots come back as (NEG, -1).
//
// Three kernels, launched in order on one stream by either entry:
//  1. skip_kernel: one thread per (query tile, item block) pops the query
//     bits against the block's union pattern; a tile whose bound is below
//     min_overlap for every query in it and holds no spill row is skipped.
//     The tile height is the reference's effective_bq, so the skip map is the
//     one `explain` reports.
//  2. retrieve_kernel<T>, templated on the factor row type (float or
//     int8_t): on the TPU the item axis was a sequential grid axis
//     carrying a running top-kappa in VMEM; Hopper runs blocks in parallel in
//     no order, so the item axis is cut into `splits` ranges of whole item
//     blocks and the grid is (query group of 8 x split), sized to fill the
//     132 SMs.  One warp owns one query inside its range: lanes walk the
//     items of each unskipped block 32 at a time, reading the transposed
//     bitsets along n so the loads coalesce, popcount with __popc, and score
//     candidates with a fixed-order loop of f32 fused multiply-adds over k
//     (__fmaf_rn), the arithmetic of the reference's dot.  An int8 element
//     is decoded as __fmul_rn((float)q, scale), the reference's
//     `v.astype(f32) * sc` (:335): the explicit round-to-nearest multiply
//     keeps nvcc from contracting the decode into the FMA, which would skip
//     that rounding and part from the plain version.  A warp loads its
//     block's scale once per unskipped block (splits are whole blocks).
//     The warp's kappa-list lives in shared memory; a candidate is inserted
//     only when it beats the current kappa-th entry, one lane at a time under
//     a ballot, so the list stays sorted.  The count of each
//     (query, block) is written by the one warp that owns it, with no atomics.
//     Past the shared-memory widths (kappa > SMEM_KAPPA, k > SMEM_K) the
//     kernel is instantiated without them: the kappa-list is kept in place
//     in the warp's slice of the global part_s/part_r output (lane 0 inserts,
//     __syncwarp orders its stores before the other lanes read the kappa-th
//     entry), and the query row is read from global memory (each lane the
//     same address, so one broadcast load through L1).  Both are slower and
//     serve any kappa and k; the shared-memory instantiation is the fast
//     path and its code is unchanged.
//  3. merge_kernel: one block per query merges the per-split sorted lists.
//     An entry's final position is its own index plus, for every other split,
//     the number of entries there that beat it (a binary search).  The order
//     is total on distinct rows, so the answer does not depend on `splits`.
//
// Bound on an H100, each input counted once: the bytes are the pattern
// bitsets and spill/alive flags of every unskipped block and the factor rows
// of the candidates (4k bytes a row in f32; k bytes in int8, plus one 4-byte
// scale per unskipped block); the f32 operations are 2k per (query,
// candidate) pair, plus in int8 one decode multiply per element of a
// candidate row, since the decoded row does not depend on the query.  At a
// few hundred queries the operations set the bound.  The kernel is far
// above it: each query's warp re-reads its tiles' bitsets and decodes its
// candidates' rows on its own, and skipped tiles cost one flag read per warp.
// The int8 slab cuts the row bytes 4x; its rows are k bytes, unaligned, and
// are read a byte at a time.  Making the block reuse the bitsets across its
// 8 queries from shared memory, and using wider loads, is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#define WARPS 8
#define SMEM_KAPPA 128   // widest kappa-list kept in shared memory
#define SMEM_K 1024      // widest query row staged in shared memory
#define FULL_MASK 0xffffffffu
#define NEG_SCORE (-1e30f)

__device__ __forceinline__ bool beats(float s, int r, float ts, int tr) {
  return s > ts || (s == ts && r < tr);
}

__global__ void skip_kernel(const int32_t* __restrict__ qbits,
                            const int32_t* __restrict__ block_union,
                            const uint8_t* __restrict__ block_spill,
                            uint8_t* __restrict__ skip, int q, int words,
                            int bq, int qblocks, int nb, int min_overlap) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)qblocks * nb) return;
  int i = (int)(idx / nb);
  int b = (int)(idx % nb);
  bool possible = block_spill[b] != 0;
  int qend = min(q, (i + 1) * bq);
  for (int qq = i * bq; qq < qend && !possible; ++qq) {
    int ub = 0;
    for (int w = 0; w < words; ++w) {
      ub += __popc(qbits[(int64_t)qq * words + w] &
                   block_union[(int64_t)b * words + w]);
    }
    possible = ub >= min_overlap;
  }
  skip[idx] = possible ? 0 : 1;
}

__device__ __forceinline__ float decode(float v, float) { return v; }

__device__ __forceinline__ float decode(int8_t v, float scale) {
  return __fmul_rn((float)v, scale);
}

// U_SMEM: the query row is staged in shared memory; L_SMEM: the kappa-list
// lives in shared memory (else in place in part_s/part_r).
template <typename T, bool U_SMEM, bool L_SMEM>
__global__ void retrieve_kernel(
    const float* __restrict__ users, const T* __restrict__ factors,
    const float* __restrict__ scales, const int32_t* __restrict__ qbits,
    const int32_t* __restrict__ item_bits_t,
    const int8_t* __restrict__ spill8, const int8_t* __restrict__ alive8,
    const uint8_t* __restrict__ skip, float* __restrict__ part_s,
    int32_t* __restrict__ part_r, int32_t* __restrict__ counts, int q, int k,
    int words, int64_t n_pad, int bn, int nb, int bq, int kappa,
    int min_overlap, int blocks_per_split) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int qq = blockIdx.x * WARPS + warp;
  if (qq >= q) return;
  const int split = blockIdx.y;
  const int64_t out = ((int64_t)split * q + qq) * kappa;
  float* wsm = smem + warp * ((U_SMEM ? k : 0) + (L_SMEM ? 2 * kappa : 0));
  float* ls = L_SMEM ? wsm + (U_SMEM ? k : 0) : part_s + out;
  int* lr = L_SMEM ? (int*)(ls + kappa) : part_r + out;
  const float* u;
  if (U_SMEM) {
    for (int d = lane; d < k; d += 32) wsm[d] = users[(int64_t)qq * k + d];
    u = wsm;
  } else {
    u = users + (int64_t)qq * k;
  }
  for (int t = lane; t < kappa; t += 32) {
    ls[t] = NEG_SCORE;
    lr[t] = -1;
  }
  __syncwarp();
  float ts = NEG_SCORE;
  int tr = -1;
  const int b0 = split * blocks_per_split;
  const int b1 = min(nb, b0 + blocks_per_split);
  const int32_t* qb = qbits + (int64_t)qq * words;
  const uint8_t* skip_row = skip + (int64_t)(qq / bq) * nb;
  for (int b = b0; b < b1; ++b) {
    int cnt = 0;
    if (!skip_row[b]) {
      const float scale = scales != nullptr ? __ldg(scales + b) : 1.0f;
      const int64_t j0 = (int64_t)b * bn;
      for (int jj = 0; jj < bn; jj += 32) {
        const int64_t j = j0 + jj + lane;
        bool cand = false;
        float s = NEG_SCORE;
        if (jj + lane < bn && alive8[j]) {
          int ov = 0;
          for (int w = 0; w < words; ++w) {
            ov += __popc(__ldg(qb + w) & __ldg(item_bits_t + w * n_pad + j));
          }
          cand = ov >= min_overlap || spill8[j] != 0;
        }
        if (cand) {
          ++cnt;
          const T* vr = factors + j * k;
          s = 0.0f;
          for (int d = 0; d < k; ++d) {
            s = __fmaf_rn(u[d], decode(vr[d], scale), s);
          }
        }
        const int row = (int)j;
        bool want = cand && beats(s, row, ts, tr);
        unsigned m = __ballot_sync(FULL_MASK, want);
        while (m) {
          const int src = __ffs(m) - 1;
          const float cs = __shfl_sync(FULL_MASK, s, src);
          const int cr = __shfl_sync(FULL_MASK, row, src);
          if (lane == 0) {
            int pos = kappa - 1;
            while (pos > 0 && beats(cs, cr, ls[pos - 1], lr[pos - 1])) {
              ls[pos] = ls[pos - 1];
              lr[pos] = lr[pos - 1];
              --pos;
            }
            ls[pos] = cs;
            lr[pos] = cr;
          }
          __syncwarp();
          ts = ls[kappa - 1];
          tr = lr[kappa - 1];
          __syncwarp();
          if (lane == src) want = false;
          want = want && beats(s, row, ts, tr);
          m = __ballot_sync(FULL_MASK, want);
        }
      }
      cnt = __reduce_add_sync(FULL_MASK, cnt);
    }
    if (lane == 0) counts[(int64_t)qq * nb + b] = cnt;
  }
  if (L_SMEM) {
    __syncwarp();
    for (int t = lane; t < kappa; t += 32) {
      part_s[out + t] = ls[t];
      part_r[out + t] = lr[t];
    }
  }
}

__global__ void merge_kernel(const float* __restrict__ part_s,
                             const int32_t* __restrict__ part_r,
                             float* __restrict__ vals,
                             int32_t* __restrict__ rows, int q, int splits,
                             int kappa) {
  const int qq = blockIdx.x;
  for (int t = threadIdx.x; t < kappa; t += blockDim.x) {
    vals[(int64_t)qq * kappa + t] = NEG_SCORE;
    rows[(int64_t)qq * kappa + t] = -1;
  }
  __syncthreads();
  const int entries = splits * kappa;
  for (int e = threadIdx.x; e < entries; e += blockDim.x) {
    const int sp = e / kappa;
    const int t = e % kappa;
    const int64_t off = ((int64_t)sp * q + qq) * kappa + t;
    const int r = part_r[off];
    if (r < 0) continue;                       // empty slot
    const float s = part_s[off];
    int rank = t;
    for (int sp2 = 0; sp2 < splits; ++sp2) {
      if (sp2 == sp) continue;
      const int64_t base = ((int64_t)sp2 * q + qq) * kappa;
      int lo = 0, hi = kappa;                  // count entries that beat (s, r)
      while (lo < hi) {
        const int mid = (lo + hi) / 2;
        const int r2 = part_r[base + mid];
        if (r2 >= 0 && beats(part_s[base + mid], r2, s, r)) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      rank += lo;
      if (rank >= kappa) break;
    }
    if (rank < kappa) {
      vals[(int64_t)qq * kappa + rank] = s;
      rows[(int64_t)qq * kappa + rank] = r;
    }
  }
}

template <typename T>
static int launch(const void* users, const void* factors, const void* scales,
                  const void* qbits, const void* item_bits_t,
                  const void* block_union, const void* block_spill,
                  const void* spill8, const void* alive8, void* skip,
                  void* counts, void* part_s, void* part_r, void* vals,
                  void* rows, int q, int k, int words, int64_t n_pad, int bn,
                  int nb, int bq, int qblocks, int kappa, int min_overlap,
                  int splits, int blocks_per_split, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int64_t tiles = (int64_t)qblocks * nb;
  skip_kernel<<<(unsigned)((tiles + 255) / 256), 256, 0, st>>>(
      (const int32_t*)qbits, (const int32_t*)block_union,
      (const uint8_t*)block_spill, (uint8_t*)skip, q, words, bq, qblocks, nb,
      min_overlap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((q + WARPS - 1) / WARPS, splits);
  const bool u_smem = k <= SMEM_K;
  const bool l_smem = kappa <= SMEM_KAPPA;
  size_t smem = (size_t)WARPS * ((u_smem ? k : 0) + (l_smem ? 2 * kappa : 0))
                * sizeof(float);
#define RETRIEVE_LAUNCH(U, L)                                                 \
  retrieve_kernel<T, U, L><<<grid, WARPS * 32, smem, st>>>(                   \
      (const float*)users, (const T*)factors, (const float*)scales,           \
      (const int32_t*)qbits, (const int32_t*)item_bits_t,                     \
      (const int8_t*)spill8, (const int8_t*)alive8, (const uint8_t*)skip,     \
      (float*)part_s, (int32_t*)part_r, (int32_t*)counts, q, k, words, n_pad, \
      bn, nb, bq, kappa, min_overlap, blocks_per_split)
  if (u_smem && l_smem) {
    RETRIEVE_LAUNCH(true, true);
  } else if (u_smem) {
    RETRIEVE_LAUNCH(true, false);
  } else if (l_smem) {
    RETRIEVE_LAUNCH(false, true);
  } else {
    RETRIEVE_LAUNCH(false, false);
  }
#undef RETRIEVE_LAUNCH
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<q, 128, 0, st>>>((const float*)part_s,
                                  (const int32_t*)part_r, (float*)vals,
                                  (int32_t*)rows, q, splits, kappa);
  return (int)cudaGetLastError();
}

// f32 factor rows (n_rows, k); no scales.
extern "C" int gam_retrieve_f32(
    const void* users, const void* factors, const void* qbits,
    const void* item_bits_t, const void* block_union, const void* block_spill,
    const void* spill8, const void* alive8, void* skip, void* counts,
    void* part_s, void* part_r, void* vals, void* rows, int q, int k,
    int words, int64_t n_pad, int bn, int nb, int bq, int qblocks, int kappa,
    int min_overlap, int splits, int blocks_per_split, void* stream) {
  return launch<float>(users, factors, nullptr, qbits, item_bits_t,
                       block_union, block_spill, spill8, alive8, skip, counts,
                       part_s, part_r, vals, rows, q, k, words, n_pad, bn, nb,
                       bq, qblocks, kappa, min_overlap, splits,
                       blocks_per_split, stream);
}

// int8 slab (n_pad, k) and its (n_blocks,) f32 scales; kappa is the pool.
extern "C" int gam_retrieve_i8(
    const void* users, const void* factors_q, const void* scales,
    const void* qbits, const void* item_bits_t, const void* block_union,
    const void* block_spill, const void* spill8, const void* alive8,
    void* skip, void* counts, void* part_s, void* part_r, void* vals,
    void* rows, int q, int k, int words, int64_t n_pad, int bn, int nb,
    int bq, int qblocks, int kappa, int min_overlap, int splits,
    int blocks_per_split, void* stream) {
  return launch<int8_t>(users, factors_q, scales, qbits, item_bits_t,
                        block_union, block_spill, spill8, alive8, skip,
                        counts, part_s, part_r, vals, rows, q, k, words, n_pad,
                        bn, nb, bq, qblocks, kappa, min_overlap, splits,
                        blocks_per_split, stream);
}
