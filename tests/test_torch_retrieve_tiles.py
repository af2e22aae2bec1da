"""The fast route of ``csrc/gam_retrieve.cu`` modelled on the CPU.

The CUDA kernel cannot run here, so this file writes its tile walk as a
small torch function and holds it against the JAX reference
(``repro.kernels.gam_retrieve`` in interpret mode, as
``tests/test_gam_retrieve.py`` runs it) and the port's plain versions, on
the same seeded numpy inputs.  What the model keeps of the kernel:

- a CTA is a tile of ``q_tile`` queries (16, 32 or 64 by Q, or 128) against
  the whole item blocks of one split; it walks each kept block in item tiles
  of ``256 / (q_tile / 16)`` items that never cross a block; a block is
  skipped only when every bq-tile of the CTA's queries skips it;
- overlaps are summed over 256-bit chunks of 8 words, as the 1-bit ``mma``
  sums them: the query's words past ``words`` are zero, the items' are
  garbage (random bits here), which the AND must cancel;
- pad query rows and items past the block are never candidates, also at
  ``min_overlap=0``;
- scores are one fma chain over k padded with zeros to a multiple of 4;
- each row keeps a sorted kappa-list; a tile's candidates that beat the
  list's last entry are appended to the row's survivor buffer (room for
  1.5 tiles); after a tile that left some row more than 32 survivors
  (never more than the room less one tile), and when the split ends, every
  row's list and survivors are merged by rank in their union (the
  threshold is therefore stale between merges);
- the splits' sorted lists merge by a tournament over their heads.

Rows, counts and skip maps must equal the reference and the plain version
bit for bit, and scores the plain version's bit for bit (the same fma
chain) and the reference's within 4 ulp of the dot product's scale
(``test_torch_gam_retrieve.assert_scores_close``: the reference's dot is
not one fixed order).  On the int8 path the reference's pool may differ
from the plain version's on rows that tie the pool's edge within that
tolerance, as ``test_torch_gam_retrieve`` allows; the model equals the plain
version exactly.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from conftest import CFG, unit_factors  # noqa: E402
from test_torch_gam_retrieve import (_assert_pool_close,  # noqa: E402
                                     _assert_retrieve_equal, _mapped, _metas,
                                     _q_metas, _t, jgr)

from repro.core.inverted_index import DeviceIndex as JDeviceIndex  # noqa: E402
from repro_torch.compress.quantize import dequantize_int8  # noqa: E402
tgr = importlib.import_module("repro_torch.kernels.gam_retrieve")  # noqa: E402
from repro_torch.kernels.gam_score import NEG, fma_dot  # noqa: E402


def _beats(s, r, ts, tr):
    return (s > ts) | ((s == ts) & (r < tr))


def _skip_map(q_bits, meta, min_overlap, bq):
    """skip_kernel: a (bq-tile, block) is skipped when no query in it can
    reach min_overlap against the block's union and it holds no spill row."""
    q = q_bits.shape[0]
    ub = tgr.popcount32(q_bits[:, None, :] & meta.block_union[None]).sum(-1)
    possible = (ub >= min_overlap) | meta.block_spill[None]
    qblocks = -(-q // bq)
    return torch.stack([~possible[i * bq:(i + 1) * bq].any(0)
                        for i in range(qblocks)])


def _merge(lst_s, lst_r, buf):
    """The kernel's merge: ranks in the union of a sorted list and its
    survivors; the first kappa ranks are the new list."""
    kappa = len(lst_s)
    out_s, out_r = [NEG] * kappa, [-1] * kappa
    for x in range(kappa):                  # list entries: slot + survivors
        rank = x + sum(s_ > lst_s[x] or (s_ == lst_s[x] and r_ < lst_r[x])
                       for s_, r_ in buf)
        if rank < kappa:
            out_s[rank], out_r[rank] = lst_s[x], lst_r[x]
    for s0, r0 in buf:                      # survivors: list + survivors
        rank = sum(lst_s[j] > s0 or (lst_s[j] == s0 and lst_r[j] < r0)
                   for j in range(kappa))
        rank += sum(s_ > s0 or (s_ == s0 and r_ < r0) for s_, r_ in buf)
        if rank < kappa:
            out_s[rank], out_r[rank] = s0, r0
    return out_s, out_r


def tile_walk(users, rows_f32, q_tau, q_mask, meta, kappa, *, min_overlap,
              alive=None, bq=32, q_tile=0, splits=0, seed=0):
    """The fast route's answer: (vals, rows, blk_counts, skipped).

    ``rows_f32``: the f32 rows scored, (n_rows, k) f32 or the int8 slab
    decoded, (n_pad, k); ``q_tile`` 0 picks as the kernel does; ``splits``
    0 gives one split a CTA's worth of blocks (4 blocks)."""
    q, k = users.shape
    bq = tgr.effective_bq(q, bq)
    qt = q_tile or (16 if q <= 16 else 32 if q <= 32 else 64)
    tn = 256 // (qt // 16)
    nb, bn, words = meta.n_blocks, meta.bn, meta.words
    chunks = -(-words // 8)
    q_bits = tgr.pack_patterns(q_tau, q_mask, meta.p)
    skip = _skip_map(q_bits, meta, min_overlap, bq)
    per = -(-nb // (splits or -(-nb // 4)))
    n_splits = -(-nb // per)
    qtiles = -(-q // qt)
    k4 = -(-k // 4) * 4
    u = torch.zeros((qtiles * qt, k4))
    u[:q, :k] = users
    qb = torch.zeros((qtiles * qt, 8 * chunks), dtype=torch.int32)
    qb[:q, :words] = q_bits                          # pad words zero
    rng = np.random.default_rng(seed)
    ib = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (8 * chunks,
                                                           meta.n_pad),
                                       dtype=np.int64).astype(np.int32))
    ib[:words] = meta.item_bits_t                    # pad words garbage
    v = torch.zeros((meta.n_pad + tn, k4))
    v[:rows_f32.shape[0], :k] = rows_f32
    alive8 = tgr._alive8(alive, meta, "cpu")
    spill8 = meta.spill8[0]
    counts = torch.zeros((q, nb), dtype=torch.int32)
    part_s = np.full((n_splits, q, kappa), NEG, np.float32)
    part_r = np.full((n_splits, q, kappa), -1, np.int64)
    for i in range(qtiles):
        rows = torch.arange(i * qt, (i + 1) * qt)
        qok = rows < q
        lo, hi = i * qt // bq, (min(q, (i + 1) * qt) - 1) // bq
        for sp in range(n_splits):
            lists = [([NEG] * kappa, [-1] * kappa) for _ in range(qt)]
            bufs = [[] for _ in range(qt)]
            cap = tn + tn // 2
            for b in range(sp * per, min(nb, (sp + 1) * per)):
                if skip[lo:hi + 1, b].all():
                    continue                         # counts stay 0
                cnt = torch.zeros(qt, dtype=torch.int32)
                for t in range(-(-bn // tn)):
                    if any(len(x) > min(32, cap - tn) for x in bufs):
                        lists = [_merge(*lists[r_], bufs[r_])
                                 for r_ in range(qt)]
                        bufs = [[] for _ in range(qt)]
                    j0 = b * bn + t * tn
                    valid = min(tn, bn - t * tn)
                    items = torch.arange(j0, j0 + tn)
                    cols = items.clamp(max=meta.n_pad - 1)
                    ov = torch.zeros((qt, tn), dtype=torch.int32)
                    for c in range(chunks):
                        a = qb[rows, 8 * c:8 * c + 8]
                        bb = ib[8 * c:8 * c + 8, cols]
                        ov += tgr.popcount32(a[:, None, :]
                                             & bb.T[None]).sum(-1)
                    live = (torch.arange(tn) < valid) & (alive8[cols] != 0)
                    cand = (live[None] & qok[:, None]
                            & ((ov >= min_overlap)
                               | (spill8[cols] != 0)[None]))
                    cnt += cand.sum(1, dtype=torch.int32)
                    sc = fma_dot(u[rows][:, None, :], v[items][None])
                    ts = torch.tensor([x[0][-1] for x in lists],
                                      dtype=torch.float32)
                    tr = torch.tensor([x[1][-1] for x in lists])
                    surv = cand & _beats(sc, items[None], ts[:, None],
                                         tr[:, None])
                    for r_ in range(qt):
                        bufs[r_] += [(float(sc[r_, c_]), int(items[c_]))
                                     for c_ in torch.nonzero(surv[r_])[:, 0]]
                    assert all(len(x) <= cap for x in bufs)
                valid_rows = rows[qok]
                counts[valid_rows, b] = cnt[qok]
            for r_ in range(qt):
                if i * qt + r_ < q:
                    s_, w_ = _merge(*lists[r_], bufs[r_])
                    part_s[sp, i * qt + r_] = s_
                    part_r[sp, i * qt + r_] = w_
    # the tournament over the splits' heads
    vals = np.full((q, kappa), NEG, np.float32)
    out = np.full((q, kappa), -1, np.int64)
    for qq in range(q):
        head = [0] * n_splits
        for t in range(kappa):
            best = None
            for sp in range(n_splits):
                h = head[sp]
                if h >= kappa or part_r[sp, qq, h] < 0:
                    continue
                cand = (part_s[sp, qq, h], part_r[sp, qq, h], sp)
                if best is None or cand[0] > best[0] or (
                        cand[0] == best[0] and cand[1] < best[1]):
                    best = cand
            if best is None:
                break
            vals[qq, t], out[qq, t] = best[0], best[1]
            head[best[2]] += 1
    return tgr.GamRetrieveResult(torch.from_numpy(vals),
                                 torch.from_numpy(out.astype(np.int32)),
                                 counts, skip)


def _assert_equal(got, want):
    for name in ("vals", "rows", "blk_counts", "skipped"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name).numpy(), name)


def _spill(tau, mask, bucket):
    return np.asarray(JDeviceIndex.build(tau, CFG.p, bucket, mask=mask).spill)


# n, q, kappa, min_overlap, bucket, bn, bq, q_tile, splits
F32_CASES = [
    (350, 16, 10, 2, 512, 128, 32, 0, 0),
    (300, 7, 5, 1, 4, 64, 8, 0, 3),          # spill rows
    (123, 3, 50, 3, 256, 32, 8, 0, 0),       # kappa past the candidates
    (513, 11, 17, 2, 8, 96, 8, 0, 2),        # n_rows cuts into a block
    (200, 9, 10, 0, 512, 64, 12, 0, 0),      # min_overlap 0: pad rows/items
    (600, 40, 12, 2, 512, 128, 32, 64, 0),   # 64-query tile, 24 pad rows
    (600, 40, 12, 2, 512, 128, 8, 16, 5),    # three 16-query tiles
    (400, 33, 10, 1, 512, 256, 32, 128, 1),  # one 128-query tile, one split
    (257, 17, 8, 0, 512, 8, 8, 32, 0),       # bn 8: tiles mostly padding
]


@pytest.mark.parametrize("n,q,kappa,mo,bucket,bn,bq,q_tile,splits",
                         F32_CASES)
def test_tile_walk_equals_reference_and_plain(n, q, kappa, mo, bucket, bn, bq,
                                              q_tile, splits):
    items = unit_factors(n, 16, n)
    users = unit_factors(q, 16, n + 1)
    tau, mask = _mapped(items)
    q_tau, q_mask = _mapped(users)
    jm, tm = _metas(tau, mask, _spill(tau, mask, bucket), bn)
    assert tm.words == 17                     # three 256-bit chunks
    alive = np.ones(n, bool)
    alive[::5] = False
    kappa = min(kappa, n)
    want = jgr.gam_retrieve(users, items, q_tau, q_mask, jm, kappa,
                            min_overlap=mo, alive=alive, bq=bq,
                            interpret=True, loop_merge=False)
    args = (_t(users), _t(items), _t(q_tau), _t(q_mask), tm, kappa)
    kw = dict(min_overlap=mo, alive=_t(alive), bq=bq)
    got = tile_walk(*args, **kw, q_tile=q_tile, splits=splits, seed=n)
    _assert_retrieve_equal(got, want, users, items)
    _assert_equal(got, tgr.gam_retrieve_plain(*args, **kw))


def test_tile_walk_ties_break_by_lowest_row():
    """Eight copies of each row: equal scores come back by row ascending,
    across tiles and splits (the reference's
    test_score_ties_break_by_lowest_row, on the tile walk)."""
    base = unit_factors(8, 16, 0)
    items = np.concatenate([base] * 40)             # rows i, i + 8, ... tie
    users = base[:4]
    tau, mask = _mapped(items)
    q_tau, q_mask = _mapped(users)
    jm, tm = _metas(tau, mask, _spill(tau, mask, 512), 16)
    want = jgr.gam_retrieve(users, items, q_tau, q_mask, jm, 12,
                            interpret=True, loop_merge=False, bq=8)
    args = (_t(users), _t(items), _t(q_tau), _t(q_mask), tm, 12)
    for splits in (1, 3, 20):
        got = tile_walk(*args, min_overlap=1, bq=8, splits=splits)
        _assert_retrieve_equal(got, want, users, items)
        _assert_equal(got, tgr.gam_retrieve_plain(*args, min_overlap=1,
                                                  bq=8))
        rows, vals = got.rows.numpy(), got.vals.numpy()
        for qi in range(4):
            for a in range(11):
                if vals[qi, a] == vals[qi, a + 1]:
                    assert rows[qi, a] < rows[qi, a + 1]


def test_tile_walk_skips_a_block_only_when_every_bq_tile_does():
    """A clustered catalog with bq 8 and a 32-query tile: blocks skipped by
    some bq-tiles of a CTA and not by others are computed, and leave the
    counts and lists of the skipping tiles unchanged."""
    rng = np.random.default_rng(2)
    centers = unit_factors(8, 16, 7)
    items = np.repeat(centers, 64, axis=0) + \
        0.04 * rng.normal(size=(512, 16)).astype(np.float32)
    items /= np.linalg.norm(items, axis=1, keepdims=True)
    sel = np.repeat(np.arange(4), 8)                 # bq-tile i: cluster i
    users = centers[sel] + 0.04 * rng.normal(size=(32, 16)).astype(np.float32)
    users /= np.linalg.norm(users, axis=1, keepdims=True)
    tau, mask = _mapped(items)
    q_tau, q_mask = _mapped(users)
    jm, tm = _metas(tau, mask, _spill(tau, mask, 4096), 64)
    want = jgr.gam_retrieve(users, items, q_tau, q_mask, jm, 10,
                            min_overlap=4, bq=8, interpret=True,
                            loop_merge=False)
    sk = np.asarray(want.skipped)
    mixed = sk.any(axis=0) & ~sk.all(axis=0)
    assert mixed.any(), "no block is skipped by one bq-tile and not another"
    args = (_t(users), _t(items), _t(q_tau), _t(q_mask), tm, 10)
    got = tile_walk(*args, min_overlap=4, bq=8, q_tile=32)
    _assert_retrieve_equal(got, want, users, items)
    _assert_equal(got, tgr.gam_retrieve_plain(*args, min_overlap=4, bq=8))


# n, n_rows, q, pool, min_overlap, bn, bq, q_tile
I8_CASES = [
    (350, None, 16, 40, 2, 128, 32, 0),
    (513, None, 11, 17, 2, 96, 8, 0),
    (200, None, 9, 30, 0, 64, 12, 0),
    (250, 300, 20, 24, 1, 8, 8, 32),        # bn 8, n_rows past the patterns
    (300, None, 40, 64, 2, 12, 32, 64),     # bn 12, not a power of two
]


@pytest.mark.parametrize("n,n_rows,q,pool,mo,bn,bq,q_tile", I8_CASES)
def test_tile_walk_int8_equals_reference_and_plain(n, n_rows, q, pool, mo, bn,
                                                   bq, q_tile):
    items = unit_factors(n, 16, 90 + n)
    users = unit_factors(q, 16, 91 + n)
    tau, mask = _mapped(items)
    q_tau, q_mask = _mapped(users)
    jm, tm = _q_metas(tau, mask, None, bn, items, n_rows)
    pool = min(pool, tm.n_pad)
    alive = np.ones(n_rows or n, bool)
    alive[1::6] = False
    want = jgr._gam_retrieve_q(
        jnp.asarray(users), jm.factors_q, jm.scales, jnp.asarray(q_tau),
        jnp.asarray(q_mask), jnp.asarray(alive), jm.item_bits_t,
        jm.block_union, jm.block_spill, jm.spill8, kappa=pool,
        min_overlap=mo, bq=bq, bn=jm.bn, words=jm.words, n_pad=jm.n_pad,
        interpret=True, loop_merge=False)
    decoded = dequantize_int8(tm.factors_q, tm.scales[0], tm.bn)
    got = tile_walk(_t(users), decoded, _t(q_tau), _t(q_mask), tm, pool,
                    min_overlap=mo, alive=_t(alive), bq=bq, q_tile=q_tile,
                    seed=n)
    excused = _assert_pool_close(got, want, users, decoded.numpy())
    assert excused <= q // 4, f"{excused} of {q} queries excused"
    _assert_equal(got, tgr.gam_retrieve_q_plain(
        _t(users), _t(q_tau), _t(q_mask), tm, pool, min_overlap=mo,
        alive=_t(alive), bq=bq))
