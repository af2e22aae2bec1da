// Fused candidate-pruned top-kappa MIPS: the gam-device query hot loop.
//
// Replaces two Pallas kernels of src/repro/kernels/gam_retrieve.py, which
// share one body (`_kernel` :306, `_overlap` :263, `_merge_topk` :278):
//  * `_gam_retrieve` (pl.pallas_call at :384), f32 factor rows, entry
//    gam_retrieve_f32;
//  * `_gam_retrieve_q` (pl.pallas_call at :444, `_kernel` with
//    quantized=True), an int8 (n_pad, k) slab with one f32 scale per item
//    block, entry gam_retrieve_i8.  Its kappa is the re-rank pool width; the
//    exact f32 re-rank runs after it, in torch.
// For each query q and item j it computes
//     cand = (popcount(q_bits & item_bits[j]) >= min_overlap | spill[j]) & alive[j]
// and, for candidates, the f32 score u[q] . v[j] as one sequential
// __fmaf_rn chain over d = 0..k-1 (an int8 element decoded as
// __fmul_rn((float)q, scale), the reference's `v.astype(f32) * sc`, :335;
// the explicit multiply keeps nvcc from contracting it into the fma).  It
// keeps the top kappa under the total order (score desc, row asc), the
// per-(query, item block) candidate counts and the (query tile, item block)
// skip map of the block-union prepass.  Empty slots come back as (NEG, -1).
//
// Four kernels, launched in order on one stream by either entry:
//  1. pack_kernel: the query patterns as bitsets, one thread a word.
//  2. skip_kernel: one thread per (bq-tile of queries, item block) pops the
//     query bits against the block's union pattern; a tile whose bound is
//     below min_overlap for every query in it and holds no spill row is
//     skipped.  bq is the reference's effective_bq, so the skip map is the
//     one `explain` reports.
//  3. the retrieval kernel, by one of two routes chosen by shape
//     (gam_retrieve_plan):
//     * tile_kernel<T, MT>, the fast route: kappa <= SMEM_KAPPA and
//       the CTA's tiles fit in shared memory (rows up to a few tens of
//       floats at 64-query tiles: k 10 takes 62 KB).  The reference's
//       tiling made parallel: one CTA of 8 warps owns a tile of QT = 16 MT
//       queries (16, 32 or 64: the smallest that covers Q, 64 past 32)
//       against the item blocks of one split, walking them in item tiles of
//       TN = 256 / MT items that never cross a block.  The grid is (query
//       tiles x splits), splits chosen so the CTAs fill the card at the
//       occupancy the shared memory allows.  The query rows and bitsets sit
//       in shared memory for the whole walk.  Each item tile (its words x
//       TN slice of item_bits_t, its alive and spill bytes, its factor rows)
//       is staged once per CTA by cp.async in a ring of 3 stages, two tiles
//       in flight while one computes, so an item byte is read Q / QT times
//       (4 at Q = 256) instead of Q times.  Arrays are staged in 16-byte
//       chunks (rows in chunks of four elements) from the aligned address
//       at or below their start, so views at any byte (the service's per
//       group slices, int8 blocks at b bn k bytes) need no copy; reads past
//       an array's end are cut by cp.async's source size.  Each thread turns
//       the row chunks it staged into the tile's f32 rows of k_pad (int8
//       decoded here, once per CTA, not once per query) before the tile's
//       one barrier.  Warp w owns 16 queries (m-tile w % MT) x 32 items
//       (w / MT) of the tile; lane (g = lane / 4, t = lane % 4) owns queries
//       g and g + 8 x items 8 n + 2 t + {0, 1}, n = 0..3: 16 pairs, the C
//       fragments of four mma tiles.
//       a. Overlaps on the 1-bit tensor cores:
//          mma.sync.m16n8k256.row.col.s32.b1.b1.s32.and.popc gives
//          sum_w popc(qbits[q][w] & bits_t[w][j]) for 16 queries x 8 items
//          x 256 bits (BMMA in the SASS).  Fragments (PTX ISA, m16n8k256
//          .b1): A's registers are words t and t + 4 of query rows g and
//          g + 8 of a 256-bit chunk; B's two registers are words t and t + 4
//          of item column g, which is item_bits_t[w][j] as it lies, so
//          nothing is re-laid out; C holds (g, 2t + {0,1}) and
//          (g + 8, 2t + {0,1}).  Query words past `words` are zero in shared
//          memory, so p > 256 loops over chunks on one s32 accumulator and
//          the items' pad words count nothing.  The counts are exact
//          integers: candidate sets and blk_counts are bit-identical to the
//          plain version.  (The same overlaps by __popc on the CUDA cores
//          were slower at every shape tools/retrieve_sweep.py times.)
//       b. Candidates: bounds (item in the block, query < Q: pad rows and
//          items are never candidates, also at min_overlap 0), alive and
//          spill from two warp ballots over the warp's 32 items.
//       c. Scores, dense over the warp's 16 x 32 pairs when any of them is
//          a candidate: each lane runs its 16 sequential __fmaf_rn chains
//          over d in float4 steps (rows padded to a multiple of 4 with
//          zeros: fma(0, 0, s) = s, and s is never -0, so the chain equals
//          the k-step one bit for bit).  Scoring every pair of a kept tile
//          costs less than divergent candidate-only work.
//       d. Top-kappa: each query row keeps a sorted kappa-list of the split
//          in shared memory.  A candidate that beats the list's last entry
//          is appended to the row's survivor buffer (room for 1.5 tiles).
//          After a tile that left a row more than MERGE_AT survivors (never
//          more than the room less one tile), and when the split ends,
//          every row's list and survivors merge at once by rank in their
//          union: a list entry ranks by its slot and the survivors that beat
//          it, a survivor by a binary search of the list and the survivors
//          that beat it; the first kappa ranks are the new list (two list
//          buffers alternate).  The order is total on distinct rows, so the
//          lists are the exact top kappa of the split.  Merging every tile,
//          one thread or one warp a row, cost more than the tiles' compute
//          (tools/retrieve_sweep.py's history in PERF.md).
//       e. Counts: a lane counts its candidates per query over the block's
//          tiles; at the block's last tile the 4 lanes of a quad and the
//          warps of a query reduce in shared memory and one thread writes
//          blk_counts[q][b] once: no atomics across CTAs.  A block is
//          skipped (counts 0, nothing staged) only when every bq-tile the
//          CTA's queries touch skips it; skipping is a bound, so computing
//          a block some of those tiles skip changes no output.
//     * wide_kernel<T, U_SMEM, L_SMEM> (kappa > SMEM_KAPPA, or rows too
//       wide for the fast route's shared memory): the earlier warp-per-query
//       kernel, kept for those shapes.  The grid is (query group of 8 x
//       split); a warp walks its query's items 32 at a time with __popc and
//       the same fma chain, inserting into a kappa-list in shared memory
//       (L_SMEM) or in place in its slice of part_s/part_r, the query row in
//       shared memory (U_SMEM: k <= SMEM_K) or read from global memory.  It
//       re-reads every kept tile once per query.
//  4. merge_kernel: one warp a query merges the per-split sorted lists by a
//     tournament over their heads, kappa rounds of a warp arg-max.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s f32, 132 SMs at 1.98 GHz), each
// input counted once: the bytes are the bitsets and flags of the unskipped
// blocks and the factor rows of the candidates (4k bytes a row in f32; k in
// int8, plus a 4-byte scale per kept block); the operations are 2k per
// (query, candidate) pair, plus in int8 one decode multiply per element of a
// candidate row.  At gam_mf-1M (Q 256, k 10, p 210: 7 words, 43% of pairs
// candidates) that is 0.034 ms, set by the operations.  Other floors at that
// shape: one pass over the catalog's 73 MB of bitsets, flags and rows 0.022
// ms (Q / QT = 4 passes 0.088 ms, most of them from L2: the 4 CTAs of a
// split run side by side); dense scoring of every pair 0.08 ms; overlaps by
// __popc 256 x 2^20 x 7 = 1.9e9 popcounts at 16 a clock an SM, 0.45 ms,
// which is why they run on the tensor cores.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define WARPS 8
#define SMEM_KAPPA 128   // widest kappa-list kept in shared memory
#define SMEM_K 1024      // widest query row the wide route stages
#define FULL_MASK 0xffffffffu
#define NEG_SCORE (-1e30f)

#define FT 256           // threads of a fast-route CTA (8 warps)
#define FSTAGES 3        // item tiles in the cp.async ring
#define MERGE_AT 32      // a row's survivors that call a merge (clamped to cap - TN)
#define MAX_SMEM 232448  // shared memory a block may use on sm_90

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

// ------------------------------------------------------------ fast route

struct TileLayout {     // shared memory of a fast CTA, byte offsets
  int qt, tn, cap, k4, k_pad, words_pad, qb_ld, bits_ld;
  int u, qb, ls, lr, ss, sr, sn, cnt, vdec;
  int stage0, stage_bytes, st_bits, st_alive, st_spill, st_v;
  int total;
};

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__host__ __device__ inline int take(int& off, int bytes) {
  const int at = off;
  off += round_up(bytes, 16);
  return at;
}

// MT m-tiles of 16 queries; k, words, kappa of the call; i8: int8 slab.
__host__ __device__ inline TileLayout tile_layout(int mt, int k, int words,
                                                  int kappa, bool i8) {
  TileLayout L;
  L.qt = 16 * mt;
  L.tn = 256 / mt;
  L.k4 = round_up(k, 4);
  // rows an odd number of float4 apart: the float4 reads of items 2t + e
  // (t = 0..3) fall in distinct bank groups
  L.k_pad = (L.k4 / 4) % 2 ? L.k4 : L.k4 + 4;
  L.words_pad = round_up(words, 8);
  L.qb_ld = L.words_pad + 4;          // 4 mod 8: A fragment loads conflict-free
  L.bits_ld = L.tn + 8;               // 8 mod 32: B fragment loads likewise
  L.cap = L.tn + L.tn / 2;            // survivors a row holds between merges
  int off = 0;
  L.u = take(off, L.qt * L.k_pad * 4);
  L.qb = take(off, L.qt * L.qb_ld * 4);
  L.ls = take(off, 2 * L.qt * kappa * 4);  // two lists: merges alternate
  L.lr = take(off, 2 * L.qt * kappa * 4);
  L.ss = take(off, L.qt * L.cap * 4);
  L.sr = take(off, L.qt * L.cap * 4);
  L.sn = take(off, L.qt * 4);
  L.cnt = take(off, 2 * L.qt * 4);          // two: block ends alternate
  L.vdec = take(off, 2 * L.tn * L.k_pad * 4);  // two: tiles alternate
  int st = 0;
  L.st_bits = take(st, L.words_pad * L.bits_ld * 4);
  L.st_alive = take(st, L.tn + 32);
  L.st_spill = take(st, L.tn + 32);
  L.st_v = take(st, L.tn * k * (i8 ? 1 : 4) + 32);
  L.stage0 = off;
  L.stage_bytes = st;
  L.total = off + FSTAGES * st;
  return L;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Bytes [begin, begin + count) of the array at `src` into `dst`, as the
// CH-byte chunks (16 or 4) from the aligned one at or below src + begin
// (the array may be a view at any byte; the bytes before it are its
// allocation's); the caller reads them at shift_of<CH>(src + begin).  Bytes
// at or past `limit` (the array's size) are not read: zero-filled.  Chunk
// c is copied by thread tid = c mod step.
template <int CH>
__device__ __forceinline__ int shift_of(const void* p) {
  return (int)((uintptr_t)p & (CH - 1));
}
template <int CH>
__device__ __forceinline__ void stage_bytes(unsigned char* dst,
                                            const unsigned char* src,
                                            int64_t begin, int count,
                                            int64_t limit, int tid,
                                            int step) {
  const unsigned char* from = src + begin;
  const unsigned char* a0 = from - shift_of<CH>(from);
  const unsigned char* end = src + limit;
  const int nc = (shift_of<CH>(from) + count + CH - 1) / CH;
  for (int c = tid; c < nc; c += step) {
    const unsigned char* a = a0 + CH * c;
    const int64_t left = end - a;
    const int n = left >= CH ? CH : (left > 0 ? (int)left : 0);
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst + CH * c);
    if (CH == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                   "l"(n ? a : a0), "r"(n));
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                   "l"(n ? a : a0), "r"(n));
    }
  }
}

// D += A . B over 256 bits, AND then popcount (16 x 8 x 256, s32).
__device__ __forceinline__ void mma_and_popc(int (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T, int MT>
__global__ void __launch_bounds__(FT, 2) tile_kernel(
    const float* __restrict__ users, const T* __restrict__ factors,
    const float* __restrict__ scales, const int32_t* __restrict__ qbits,
    const int32_t* __restrict__ item_bits_t,
    const int8_t* __restrict__ spill8, const uint8_t* __restrict__ alive,
    const uint8_t* __restrict__ skip, float* __restrict__ part_s,
    int32_t* __restrict__ part_r, int32_t* __restrict__ counts, int q, int k,
    int words, int64_t n_pad, int64_t n_rows, int64_t fac_rows, int bn,
    int nb, int bq, int kappa, int min_overlap, int blocks_per_split) {
  constexpr bool I8 = sizeof(T) == 1;
  constexpr int QT = 16 * MT, TN = 256 / MT;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int need_merge[2];  // the tile (by parity) that filled a row
  const TileLayout L = tile_layout(MT, k, words, kappa, I8);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * QT;
  const int split = blockIdx.y;
  const int b0 = split * blocks_per_split;
  const int b1 = min(nb, b0 + blocks_per_split);
  const int tpb = (bn + TN - 1) / TN;        // item tiles of a block
  float* u_s = (float*)(smem + L.u);
  int32_t* qb_s = (int32_t*)(smem + L.qb);
  // the sorted kappa-lists, [slot][row], and the other list a merge writes
  float* ls = (float*)(smem + L.ls);
  int* lr = (int*)(smem + L.lr);
  float* ls2 = ls + QT * kappa;
  int* lr2 = lr + QT * kappa;
  float* ss = (float*)(smem + L.ss);        // survivors, [slot][row]
  int* sr = (int*)(smem + L.sr);
  int* sn = (int*)(smem + L.sn);            // survivors a row holds
  int* cnt_s = (int*)(smem + L.cnt);        // [buf][row]: a block's candidates
  float* vdec = (float*)(smem + L.vdec);

  for (int e = tid; e < QT * L.k_pad; e += FT) {
    const int r = e / L.k_pad, d = e - r * L.k_pad;
    u_s[e] = (q0 + r < q && d < k) ? users[(int64_t)(q0 + r) * k + d] : 0.f;
  }
  for (int e = tid; e < QT * L.qb_ld; e += FT) {
    const int r = e / L.qb_ld, w = e - r * L.qb_ld;
    qb_s[e] = (q0 + r < q && w < words)
                  ? qbits[(int64_t)(q0 + r) * words + w] : 0;
  }
  for (int e = tid; e < QT * kappa; e += FT) {
    ls[e] = NEG_SCORE;
    lr[e] = -1;
  }
  for (int r = tid; r < 2 * QT; r += FT) {
    sn[r % QT] = 0;
    cnt_s[r] = 0;
  }
  if (tid < 2) need_merge[tid] = -1;
  // the pad columns k..k_pad of the row tiles: never written, zero
  for (int e = tid; e < 2 * TN * (L.k_pad - k); e += FT) {
    const int i = e / (L.k_pad - k), d = k + e % (L.k_pad - k);
    vdec[i * L.k_pad + d] = 0.f;
  }
  // e / k by a multiply: exact for e, k < 2^16 (TN k < 2^16 on this route)
  const uint64_t kmagic = (0x100000000ull + k - 1) / k;

  // a block is skipped only when every bq-tile of the CTA's queries skips it
  const int qb_lo = q0 / bq, qb_hi = (min(q, q0 + QT) - 1) / bq;
  auto keep = [&](int b) {
    for (int i = qb_lo; i <= qb_hi; ++i)
      if (!skip[(int64_t)i * nb + b]) return true;
    return false;
  };
  for (int b = b0; b < b1; ++b) {
    if (keep(b)) continue;
    for (int r = tid; r < QT; r += FT)
      if (q0 + r < q) counts[(int64_t)(q0 + r) * nb + b] = 0;
  }
  auto next_kept = [&](int b) {
    while (b < b1 && !keep(b)) ++b;
    return b;
  };
  auto advance = [&](int& b, int& t) {
    if (++t == tpb) {
      t = 0;
      b = next_kept(b + 1);
    }
  };

  // stage item tile (b, t): its bits, flags and factor rows
  auto issue = [&](int s, int b, int t) {
    unsigned char* st = smem + L.stage0 + s * L.stage_bytes;
    const int64_t j0 = (int64_t)b * bn + (int64_t)t * TN;
    const int valid = min(TN, bn - t * TN);
    // one warp a word row of the bitsets (rows of n_pad int32)
    for (int w = warp; w < words; w += FT / 32)
      stage_bytes<16>(st + L.st_bits + 4 * w * L.bits_ld,
                  (const unsigned char*)item_bits_t,
                  4 * ((int64_t)w * n_pad + j0), 4 * valid,
                  4 * (int64_t)words * n_pad, lane, 32);
    if (alive != nullptr)
      stage_bytes<16>(st + L.st_alive, alive, j0, valid, n_rows, tid, FT);
    stage_bytes<16>(st + L.st_spill, (const unsigned char*)spill8, j0, valid,
                    n_pad, tid, FT);
    // rows in chunks of four elements, so the decode spreads over threads
    stage_bytes<4 * sizeof(T)>(st + L.st_v, (const unsigned char*)factors,
                j0 * k * (int64_t)sizeof(T), valid * k * (int)sizeof(T),
                fac_rows * k * (int64_t)sizeof(T), tid, FT);
  };

  // tile (b, t)'s factor rows into the f32 row tile dst (rows of k_pad,
  // int8 decoded once per CTA): each thread the 16-byte chunks it staged,
  // so its own cp.async wait suffices and the tile's barrier publishes them
  auto decode_own = [&](int s, int b, int t, float* dst) {
    const unsigned char* st = smem + L.stage0 + s * L.stage_bytes + L.st_v;
    const int64_t j0 = (int64_t)b * bn + (int64_t)t * TN;
    const int count = min(TN, bn - t * TN) * k;
    const float scale = I8 ? __ldg(scales + b) : 1.0f;
    constexpr int CH = 4 * sizeof(T);        // four elements a chunk
    const int shift = shift_of<CH>((const T*)factors + j0 * k);
    const int nc = (shift + count * (int)sizeof(T) + CH - 1) / CH;
    for (int c = tid; c < nc; c += FT) {
      const T* chunk = (const T*)(st + CH * c);
      const int e0 = (CH * c - shift) / (int)sizeof(T);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int e = e0 + x;
        if (e < 0 || e >= count) continue;
        const int i = (int)(((uint64_t)e * kmagic) >> 32);
        dst[i * L.k_pad + e - i * k] = decode(chunk[x], scale);
      }
    }
  };

  // every row's survivors into its list, by rank in the union: a list entry
  // ranks by its slot and the survivors that beat it, a survivor by the
  // list entries that beat it (a binary search: the list is sorted) and
  // the survivors that beat it.  Rows are distinct, and equal (empty) list
  // entries keep their slots' order, so the ranks are a permutation and the
  // first kappa of them are the new list
  auto merge = [&]() {
    // survivors of row r that beat (s0, w0), four loads at a time
    auto beaten_by = [&](int r, int n, float s0, int w0) {
      int c = 0, i = 0;
      for (; i + 4 <= n; i += 4) {
        float s4[4];
        int r4[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          s4[x] = ss[(i + x) * QT + r];
          r4[x] = sr[(i + x) * QT + r];
        }
#pragma unroll
        for (int x = 0; x < 4; ++x) c += beats(s4[x], r4[x], s0, w0);
      }
      for (; i < n; ++i) c += beats(ss[i * QT + r], sr[i * QT + r], s0, w0);
      return c;
    };
    // a warp takes one entry of consecutive rows (the lists are [slot][row]),
    // the rows turned by the entry, so a row with many survivors spreads
    // over many threads
    for (int e = tid; e < QT * (kappa + L.cap); e += FT) {
      const int x = e / QT, r = (e + x) % QT;
      const int n = sn[r];
      float s0;
      int w0, rank;
      if (x < kappa) {
        s0 = ls[x * QT + r];
        w0 = lr[x * QT + r];
        rank = x + (n ? beaten_by(r, n, s0, w0) : 0);
      } else {
        if (x - kappa >= n) continue;
        s0 = ss[(x - kappa) * QT + r];
        w0 = sr[(x - kappa) * QT + r];
        int lo = 0, hi = kappa;
        while (lo < hi) {
          const int mid = (lo + hi) / 2;
          if (beats(ls[mid * QT + r], lr[mid * QT + r], s0, w0)) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
        rank = lo + beaten_by(r, n, s0, w0);
      }
      if (rank < kappa) {
        ls2[rank * QT + r] = s0;
        lr2[rank * QT + r] = w0;
      }
    }
    __syncthreads();
    float* ts = ls;
    ls = ls2;
    ls2 = ts;
    int* tr = lr;
    lr = lr2;
    lr2 = tr;
    for (int r = tid; r < QT; r += FT) sn[r] = 0;
    __syncthreads();
  };

  int pb = next_kept(b0), pt = 0;            // next tile to stage
  int cb = pb, ct = 0;                       // next tile to compute
  for (int s = 0; s < FSTAGES - 1; ++s) {
    if (pb < b1) {
      issue(s, pb, pt);
      advance(pb, pt);
    }
    cp_async_commit();
  }

  const int mrow = (warp % MT) * 16;         // the warp's m-tile
  const int ibase = (warp / MT) * 32;        // the warp's 32 items
  const int r0 = mrow + g, r1 = r0 + 8;      // the lane's two query rows
  const int chunks = L.words_pad / 8;
  const int merge_at = min(MERGE_AT, L.cap - TN);
  int cnt0 = 0, cnt1 = 0;                    // candidates of rows r0, r1
  int done_b = -1;                 // a block whose counts wait in cnt_s
  __syncthreads();

  int it = 0;
  for (; cb < b1; ++it) {
    cp_async_wait<FSTAGES - 2>();
    float* vs = vdec + (it & 1) * TN * L.k_pad;
    decode_own(it % FSTAGES, cb, ct, vs);
    __syncthreads();
    // merge when the last tile left a row unable to take another tile's
    // survivors (the stamp names the tile, so it needs no reset)
    if (it > 0 && need_merge[(it - 1) & 1] == it - 1) merge();
    if (done_b >= 0) {                       // the last block's counts
      const int cbuf = (it - 1) & 1;
      for (int r = tid; r < QT; r += FT) {
        if (q0 + r < q)
          counts[(int64_t)(q0 + r) * nb + done_b] = cnt_s[cbuf * QT + r];
        cnt_s[cbuf * QT + r] = 0;
      }
    }
    if (pb < b1) {
      issue((it + FSTAGES - 1) % FSTAGES, pb, pt);
      advance(pb, pt);
    }
    cp_async_commit();

    const unsigned char* st = smem + L.stage0 + (it % FSTAGES) * L.stage_bytes;
    const int64_t j0 = (int64_t)cb * bn + (int64_t)ct * TN;
    const int valid = min(TN, bn - ct * TN);
    const int32_t* bs = (const int32_t*)(st + L.st_bits);
    // word row w of the tile: its staged row, at the row's 16-byte shift
    auto brow = [&](int w) {
      return bs + w * L.bits_ld +
             (shift_of<16>(item_bits_t + (int64_t)w * n_pad + j0) >> 2);
    };
    const unsigned char* al =
        alive != nullptr ? st + L.st_alive + shift_of<16>(alive + j0) : nullptr;
    const unsigned char* sp = st + L.st_spill + shift_of<16>(spill8 + j0);

    // a. overlaps of the lane's 16 pairs: ov[n][c], c = (row, item) as the
    //    mma C fragment: (r0, 2t), (r0, 2t + 1), (r1, 2t), (r1, 2t + 1)
    int ov[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) ov[n][c] = 0;
    for (int c = 0; c < chunks; ++c) {
      const int w = 8 * c + t4;
      uint32_t a[4];
      a[0] = qb_s[r0 * L.qb_ld + w];
      a[1] = qb_s[r1 * L.qb_ld + w];
      a[2] = qb_s[r0 * L.qb_ld + w + 4];
      a[3] = qb_s[r1 * L.qb_ld + w + 4];
      const int32_t* lo = brow(w);
      const int32_t* hi = brow(w + 4);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int item = ibase + 8 * n + g;
        mma_and_popc(ov[n], a, lo[item], hi[item]);
      }
    }

    // b. candidates: bit 4n + c of cmask; the flags of the warp's 32 items
    //    as two ballots (item ibase + l on lane l)
    const unsigned live_m = __ballot_sync(
        FULL_MASK, ibase + lane < valid &&
                       (al != nullptr ? al[ibase + lane] != 0
                                      : j0 + ibase + lane < n_rows));
    const unsigned spill_m = __ballot_sync(FULL_MASK, sp[ibase + lane] != 0);
    unsigned cmask = 0;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = 8 * n + 2 * t4 + e;
        const unsigned lb = (live_m >> idx) & 1u, sb = (spill_m >> idx) & 1u;
        cmask |= (lb & ((unsigned)(ov[n][e] >= min_overlap) | sb))
                 << (4 * n + e);
        cmask |= (lb & ((unsigned)(ov[n][2 + e] >= min_overlap) | sb))
                 << (4 * n + 2 + e);
      }
    if (q0 + r0 >= q) cmask &= 0xccccu;      // pad query rows
    if (q0 + r1 >= q) cmask &= 0x3333u;
    cnt0 += __popc(cmask & 0x3333u);
    cnt1 += __popc(cmask & 0xccccu);

    // c. scores and d. survivors, when the warp has a candidate
    if (__any_sync(FULL_MASK, cmask)) {
      float acc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
      const float* u0 = u_s + r0 * L.k_pad;
      const float* u1 = u_s + r1 * L.k_pad;
      const float* v0 = vs + (ibase + 2 * t4) * L.k_pad;
      for (int d = 0; d < L.k4; d += 4) {
        const float4 a = *(const float4*)(u0 + d);
        const float4 b = *(const float4*)(u1 + d);
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float4 v = *(const float4*)(v0 + (8 * n + e) * L.k_pad + d);
            float s0 = acc[n][e], s1 = acc[n][2 + e];
            s0 = __fmaf_rn(a.x, v.x, s0);
            s1 = __fmaf_rn(b.x, v.x, s1);
            s0 = __fmaf_rn(a.y, v.y, s0);
            s1 = __fmaf_rn(b.y, v.y, s1);
            s0 = __fmaf_rn(a.z, v.z, s0);
            s1 = __fmaf_rn(b.z, v.z, s1);
            s0 = __fmaf_rn(a.w, v.w, s0);
            s1 = __fmaf_rn(b.w, v.w, s1);
            acc[n][e] = s0;
            acc[n][2 + e] = s1;
          }
      }
      // each row's threshold: its list's last entry
      const float ts0 = ls[(kappa - 1) * QT + r0];
      const float ts1 = ls[(kappa - 1) * QT + r1];
      const int tr0 = lr[(kappa - 1) * QT + r0];
      const int tr1 = lr[(kappa - 1) * QT + r1];
      // the lane's best candidate scores against the thresholds first
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (cmask >> (4 * n + e) & 1u) mx0 = fmaxf(mx0, acc[n][e]);
          if (cmask >> (4 * n + 2 + e) & 1u) mx1 = fmaxf(mx1, acc[n][2 + e]);
        }
      unsigned bm = 0;                       // the pairs that beat
      if (mx0 >= ts0 || mx1 >= ts1) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int item = (int)j0 + ibase + 8 * n + 2 * t4 + (c & 1);
            bm |= (unsigned)beats(acc[n][c], item, c < 2 ? ts0 : ts1,
                                  c < 2 ? tr0 : tr1) << (4 * n + c);
          }
        bm &= cmask;
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (!(bm >> (4 * n + c) & 1u)) continue;
          const int row = c < 2 ? r0 : r1;
          const int item = (int)j0 + ibase + 8 * n + 2 * t4 + (c & 1);
          const float s = acc[n][c];
          const int pos = atomicAdd(sn + row, 1);
          ss[pos * QT + row] = s;
          sr[pos * QT + row] = item;
          if (pos >= merge_at) need_merge[it & 1] = it;
        }
    }

    // e. the block's counts, at its last tile: written at the next step
    done_b = -1;
    if (ct == tpb - 1) {
      cnt0 += __shfl_xor_sync(FULL_MASK, cnt0, 1);
      cnt0 += __shfl_xor_sync(FULL_MASK, cnt0, 2);
      cnt1 += __shfl_xor_sync(FULL_MASK, cnt1, 1);
      cnt1 += __shfl_xor_sync(FULL_MASK, cnt1, 2);
      if (t4 == 0) {
        atomicAdd(cnt_s + (it & 1) * QT + r0, cnt0);
        atomicAdd(cnt_s + (it & 1) * QT + r1, cnt1);
      }
      cnt0 = cnt1 = 0;
      done_b = cb;
    }
    advance(cb, ct);
  }
  cp_async_wait<0>();
  __syncthreads();
  merge();
  if (done_b >= 0) {           // the walk's last tile ends a block
    const int cbuf = (it - 1) & 1;
    for (int r = tid; r < QT; r += FT)
      if (q0 + r < q)
        counts[(int64_t)(q0 + r) * nb + done_b] = cnt_s[cbuf * QT + r];
  }
  for (int e = tid; e < QT * kappa; e += FT) {
    const int r = e % QT, i = e / QT;
    if (q0 + r >= q) continue;
    const int64_t out = ((int64_t)split * q + q0 + r) * kappa + i;
    part_s[out] = ls[e];
    part_r[out] = lr[e];
  }
}

// ------------------------------------------------------------ wide route

// U_SMEM: the query row is staged in shared memory; L_SMEM: the kappa-list
// lives in shared memory (else in place in part_s/part_r).
template <typename T, bool U_SMEM, bool L_SMEM>
__global__ void wide_kernel(
    const float* __restrict__ users, const T* __restrict__ factors,
    const float* __restrict__ scales, const int32_t* __restrict__ qbits,
    const int32_t* __restrict__ item_bits_t,
    const int8_t* __restrict__ spill8, const uint8_t* __restrict__ alive,
    const uint8_t* __restrict__ skip, float* __restrict__ part_s,
    int32_t* __restrict__ part_r, int32_t* __restrict__ counts, int q, int k,
    int words, int64_t n_pad, int64_t n_rows, int bn, int nb, int bq,
    int kappa, int min_overlap, int blocks_per_split) {
  extern __shared__ float smem_w[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int qq = blockIdx.x * WARPS + warp;
  if (qq >= q) return;
  const int split = blockIdx.y;
  const int64_t out = ((int64_t)split * q + qq) * kappa;
  float* wsm = smem_w + warp * ((U_SMEM ? k : 0) + (L_SMEM ? 2 * kappa : 0));
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
        if (jj + lane < bn && j < n_rows &&
            (alive == nullptr || alive[j] != 0)) {
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

// One warp a query: a tournament over the splits' sorted lists.  Lane l
// holds the heads of splits l, l + 32, ... (their positions in shared
// memory) and its best head; each round a warp arg-max under (score desc,
// row asc) takes the winner, and its lane advances that split's head.  Rows
// of distinct splits are distinct, so the order is total and the answer
// does not depend on `splits`.
#define MERGE_WARPS 4
__global__ void merge_kernel(const float* __restrict__ part_s,
                             const int32_t* __restrict__ part_r,
                             float* __restrict__ vals,
                             int32_t* __restrict__ rows, int q, int splits,
                             int kappa) {
  extern __shared__ int heads[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qq = blockIdx.x * MERGE_WARPS + warp;
  if (qq >= q) return;
  int* head = heads + warp * splits;
  for (int t = lane; t < kappa; t += 32) {
    vals[(int64_t)qq * kappa + t] = NEG_SCORE;
    rows[(int64_t)qq * kappa + t] = -1;
  }
  for (int sp = lane; sp < splits; sp += 32) head[sp] = 0;
  float bs = NEG_SCORE;
  int br = -1, bsp = -1;
  auto lane_best = [&]() {
    br = -1;
    for (int sp = lane; sp < splits; sp += 32) {
      const int h = head[sp];
      if (h >= kappa) continue;
      const int64_t off = ((int64_t)sp * q + qq) * kappa + h;
      const int r = part_r[off];
      if (r < 0) continue;                     // the split is exhausted
      const float s = part_s[off];
      if (br < 0 || beats(s, r, bs, br)) {
        bs = s;
        br = r;
        bsp = sp;
      }
    }
  };
  lane_best();
  for (int t = 0; t < kappa; ++t) {
    float s = bs;
    int r = br, sp = bsp;
    for (int o = 16; o; o >>= 1) {
      const float s2 = __shfl_xor_sync(FULL_MASK, s, o);
      const int r2 = __shfl_xor_sync(FULL_MASK, r, o);
      const int sp2 = __shfl_xor_sync(FULL_MASK, sp, o);
      if (r2 >= 0 && (r < 0 || beats(s2, r2, s, r))) {
        s = s2;
        r = r2;
        sp = sp2;
      }
    }
    if (r < 0) break;                          // every split exhausted
    if (lane == 0) {
      vals[(int64_t)qq * kappa + t] = s;
      rows[(int64_t)qq * kappa + t] = r;
    }
    if (sp % 32 == lane) {
      ++head[sp];
      lane_best();
    }
  }
}

// ------------------------------------------------------------- host side

template <typename T>
using TileFn = void (*)(const float*, const T*, const float*, const int32_t*,
                        const int32_t*, const int8_t*, const uint8_t*,
                        const uint8_t*, float*, int32_t*, int32_t*, int, int,
                        int, int64_t, int64_t, int64_t, int, int, int, int,
                        int, int);

// The fast-route instantiation for MT m-tiles of 16 queries.
template <typename T>
static TileFn<T> tile_fn(int mt) {
  switch (mt) {
    case 1: return tile_kernel<T, 1>;
    case 2: return tile_kernel<T, 2>;
    case 4: return tile_kernel<T, 4>;
  }
  return nullptr;
}

static int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Route and grid of a call: the fast route with 16, 32 or 64-query tiles
// (the smallest that covers q, 64 past 32) where its tiles fit, else the
// wide route.  out: {route (1 fast, 0 wide), MT, splits, blocks_per_split,
// shared memory bytes, CTAs an SM}.
extern "C" int gam_retrieve_plan(int q, int k, int words, int kappa,
                                 int is_i8, int nb, int* out) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int mt = q <= 16 ? 1 : q <= 32 ? 2 : 4;
  const TileLayout L = tile_layout(mt, k, words, kappa, is_i8 != 0);
  int per_sm = 0;
  if (kappa <= SMEM_KAPPA && L.total <= MAX_SMEM && L.tn * k < 65536) {
    const void* fn = is_i8 ? (const void*)tile_fn<int8_t>(mt)
                           : (const void*)tile_fn<float>(mt);
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L.total);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, FT,
                                                        L.total);
    if (err != cudaSuccess) return (int)err;
  }
  int splits, per;
  if (per_sm > 0) {
    const int qtiles = ceil_div(q, 16 * mt);
    splits = ceil_div(sms * per_sm, qtiles);
    splits = splits < 1 ? 1 : (splits > nb ? nb : splits);
    out[0] = 1;
    out[4] = L.total;
  } else {
    const int groups = ceil_div(q, WARPS);
    splits = ceil_div(sms * WARPS, groups);
    splits = splits < 1 ? 1 : (splits > nb ? nb : splits);
    out[0] = 0;
    out[4] = WARPS * ((k <= SMEM_K ? k : 0) +
                      (kappa <= SMEM_KAPPA ? 2 * kappa : 0)) * 4;
    mt = 0;
  }
  per = ceil_div(nb, splits);
  out[1] = mt;
  out[2] = ceil_div(nb, per);
  out[3] = per;
  out[5] = per_sm;
  return 0;
}

// The query patterns as bitsets: one thread a (query, word) ORs the bits
// of the query's kept coordinates that fall in its word.
__global__ void pack_kernel(const int32_t* __restrict__ tau,
                            const uint8_t* __restrict__ mask,
                            int32_t* __restrict__ bits, int q, int k,
                            int words) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)q * words) return;
  const int64_t qq = idx / words;
  const int w = (int)(idx % words);
  uint32_t v = 0;
  for (int d = 0; d < k; ++d) {
    const int t = tau[qq * k + d];
    if (mask[qq * k + d] && (t >> 5) == w) v |= 1u << (t & 31);
  }
  bits[idx] = (int32_t)v;
}

struct Args {            // one call: its arrays and shape
  const float* users;
  const void* factors;
  const float* scales;
  const int32_t* q_tau;
  const uint8_t* q_mask;
  const int32_t* item_bits_t;
  const int32_t* block_union;
  const uint8_t* block_spill;
  const int8_t* spill8;
  const uint8_t* alive;              // (n_rows,) bool, or null: all alive
  int32_t* qbits;                    // (q, words) scratch
  uint8_t* skip;
  int32_t* counts;
  float* part_s;
  int32_t* part_r;
  float* vals;
  int32_t* rows;
  int q, k, words;
  int64_t n_pad, n_rows, fac_rows;
  int bn, nb, bq, qblocks, kappa, min_overlap;
  int route, mt, splits, blocks_per_split;
};

template <typename T>
static int launch(const Args& a, cudaStream_t st) {
  const int64_t pq = (int64_t)a.q * a.words;
  pack_kernel<<<(unsigned)((pq + 255) / 256), 256, 0, st>>>(
      a.q_tau, a.q_mask, a.qbits, a.q, a.k, a.words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (int64_t)a.qblocks * a.nb;
  skip_kernel<<<(unsigned)((tiles + 255) / 256), 256, 0, st>>>(
      a.qbits, a.block_union, a.block_spill, a.skip, a.q, a.words, a.bq,
      a.qblocks, a.nb, a.min_overlap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const T* factors = (const T*)a.factors;
  if (a.route == 1) {
    const TileFn<T> fn = tile_fn<T>(a.mt);
    if (fn == nullptr || a.kappa > SMEM_KAPPA)
      return (int)cudaErrorInvalidValue;
    const TileLayout L =
        tile_layout(a.mt, a.k, a.words, a.kappa, sizeof(T) == 1);
    if (L.total > MAX_SMEM || L.tn * a.k >= 65536)
      return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute((const void*)fn,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L.total);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(ceil_div(a.q, 16 * a.mt), a.splits);
    fn<<<grid, FT, L.total, st>>>(
        a.users, factors, a.scales, a.qbits, a.item_bits_t, a.spill8,
        a.alive, a.skip, a.part_s, a.part_r, a.counts, a.q, a.k, a.words,
        a.n_pad, a.n_rows, a.fac_rows, a.bn, a.nb, a.bq, a.kappa,
        a.min_overlap, a.blocks_per_split);
  } else {
    dim3 grid((a.q + WARPS - 1) / WARPS, a.splits);
    const bool u_smem = a.k <= SMEM_K;
    const bool l_smem = a.kappa <= SMEM_KAPPA;
    size_t smem = (size_t)WARPS *
                  ((u_smem ? a.k : 0) + (l_smem ? 2 * a.kappa : 0)) *
                  sizeof(float);
#define WIDE_LAUNCH(U, LS)                                                  \
  wide_kernel<T, U, LS><<<grid, WARPS * 32, smem, st>>>(                    \
      a.users, factors, a.scales, a.qbits, a.item_bits_t, a.spill8,         \
      a.alive, a.skip, a.part_s, a.part_r, a.counts, a.q, a.k, a.words,     \
      a.n_pad, a.n_rows, a.bn, a.nb, a.bq, a.kappa, a.min_overlap,          \
      a.blocks_per_split)
    if (u_smem && l_smem) {
      WIDE_LAUNCH(true, true);
    } else if (u_smem) {
      WIDE_LAUNCH(true, false);
    } else if (l_smem) {
      WIDE_LAUNCH(false, true);
    } else {
      WIDE_LAUNCH(false, false);
    }
#undef WIDE_LAUNCH
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<ceil_div(a.q, MERGE_WARPS), 32 * MERGE_WARPS,
                 MERGE_WARPS * a.splits * sizeof(int), st>>>(
      a.part_s, a.part_r, a.vals, a.rows, a.q, a.splits, a.kappa);
  return (int)cudaGetLastError();
}

// The two entries.  Pointers: users (q, k) f32; the factor rows (f32
// (n_rows, k); or the int8 slab (n_pad, k) and its (n_blocks,) f32
// scales); q_tau (q, k) int32 and q_mask (q, k) bool; item_bits_t (words,
// n_pad) int32; block_union (n_blocks, words) int32; block_spill
// (n_blocks,) bool; spill8 (n_pad,) int8; alive (n_rows,) bool or null;
// scratch qbits (q, words) int32; outputs skip (qblocks, n_blocks) bool,
// counts (q, n_blocks) int32, part_s / part_r (splits, q, kappa), vals /
// rows (q, kappa).  route .. blocks_per_split come from gam_retrieve_plan.
#define ENTRY_ARGS                                                          \
  const void *users, const void *factors, const void *scales,              \
      const void *q_tau, const void *q_mask, const void *item_bits_t,      \
      const void *block_union, const void *block_spill, const void *spill8, \
      const void *alive, void *qbits, void *skip, void *counts,            \
      void *part_s, void *part_r, void *vals, void *rows, int q, int k,    \
      int words, int64_t n_pad, int64_t n_rows, int bn, int nb, int bq,    \
      int qblocks, int kappa, int min_overlap, int route, int mt,          \
      int splits, int blocks_per_split, void *stream
#define MAKE_ARGS(FAC_ROWS)                                                 \
  Args a{(const float*)users, factors, (const float*)scales,               \
         (const int32_t*)q_tau, (const uint8_t*)q_mask,                    \
         (const int32_t*)item_bits_t, (const int32_t*)block_union,         \
         (const uint8_t*)block_spill, (const int8_t*)spill8,               \
         (const uint8_t*)alive, (int32_t*)qbits, (uint8_t*)skip,           \
         (int32_t*)counts, (float*)part_s, (int32_t*)part_r, (float*)vals, \
         (int32_t*)rows, q, k, words, n_pad, n_rows, FAC_ROWS, bn, nb, bq, \
         qblocks, kappa, min_overlap, route, mt, splits, blocks_per_split}

// f32 factor rows (n_rows, k); `scales` is ignored.
extern "C" int gam_retrieve_f32(ENTRY_ARGS) {
  MAKE_ARGS(n_rows);
  return launch<float>(a, (cudaStream_t)stream);
}

// int8 slab (n_pad, k) and its scales; kappa is the re-rank pool.
extern "C" int gam_retrieve_i8(ENTRY_ARGS) {
  MAKE_ARGS(n_pad);
  return launch<int8_t>(a, (cudaStream_t)stream);
}
