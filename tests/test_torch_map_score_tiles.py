"""The map kernel (``csrc/tess_project.cu``) and the dense masked scorer
(``csrc/gam_score.cu``) modelled on the CPU.

The CUDA kernels cannot run here, so this file writes the orders they
compute in as small numpy functions and holds them against the JAX
reference (``repro.kernels.tess_project`` and ``repro.kernels.gam_score`` in
interpret mode) and the port's plain versions, on seeded numpy inputs.

``tess_project``: a bitonic network in its flip form (every comparator puts
the larger value at the lower position; pads at the end never move, so
comparators that reach them are dropped) sorts each row descending:

- narrow route (k <= 32): one thread's registers, exactly k |z| bits
  (32-bit values), slot i holding coordinate ``(i + row % k) % k`` (the
  rotation that spares shared-memory banks); the support is the values at
  least the one at rank t*, thr, unless a value equal to thr also lies past
  rank t*: then of the coordinates equal to thr only the t* + 1 - (count
  above thr) with the lowest indices are in it (a second pass in index
  order);
- warp route (k <= 1024): the |z| bits (pads 0), position ``lane * E + s``
  in register s of a lane, coordinate ``s * 32 + lane`` loaded there, the
  exchanges across lanes by XOR shuffles (the flip pairs slot s with the
  partner's slot E - 1 - s); of the values equal to thr, the t* + 1 -
  (count above) with the lowest indices are in the support (ballots in
  index order);
- CTA route: the 64-bit keys ``(|z_i| bits << 32) | ~i`` (distinct, so
  their order is the stable argsort's), k of them in shared memory; the
  support is the keys at least the one at rank t*.

The keys' order, and the value routes' support at every rank, must be the
stable argsort's (|z| descending, ties by index) on duplicates, all-zero
rows, thresholded zeros and -0.0.  Then the running sum in rank order (one
rounded f32 add a step), the division by the correctly rounded sqrt(t + 1)
and the first argmax t*: pattern and ``a`` equal the plain version bit for
bit and the reference except certified near-ties.

``gam_score``: each output is one fma chain over d = 0.. k padded with zeros
to the route's width (a multiple of 4, chunks of 32 on the staged route),
emulated as the plain version emulates an fma (f64 product, one rounding to
f32).  The model walks the kernels' grids (query chunks, items a thread,
ragged Q and N) and must write every output once, equal to the plain version
bit for bit and to the reference within its tolerance.
"""
import importlib
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from test_torch_tessellation import near_tie_rows  # noqa: E402

from repro.kernels.gam_score import gam_score as j_gam_score  # noqa: E402
from repro.kernels.tess_project import tess_project as j_tess_project  # noqa: E402
ttp = importlib.import_module("repro_torch.kernels.tess_project")  # noqa: E402
from repro_torch.kernels.gam_score import NEG, gam_score_plain  # noqa: E402

CSRC = Path(ttp.__file__).resolve().parent / "csrc"


# ------------------------------------------------------------ tess_project

def keys_of(z: np.ndarray) -> np.ndarray:
    """(rows, k) f32 -> (rows, k) uint64 keys (|z| bits << 32) | ~index."""
    bits = z.view(np.uint32) & np.uint32(0x7FFFFFFF)
    idx = ~np.arange(z.shape[1], dtype=np.uint32)
    return (bits.astype(np.uint64) << np.uint64(32)) | idx.astype(np.uint64)


def network(width: int) -> list:
    """The flip-form bitonic network over ``width`` positions: a list of
    stages, each a list of comparators (p, q), p < q, larger key to p."""
    stages = []
    size = 2
    while size <= width:
        stages.append([(p, p ^ (size - 1)) for p in range(width)
                       if not p & (size // 2)])
        j = size // 4
        while j:
            stages.append([(p, p | j) for p in range(width) if not p & j])
            j //= 2
        size *= 2
    return stages


def sort_flat(keys: np.ndarray, k: int | None = None) -> np.ndarray:
    """Apply the network over the columns of ``keys``; with ``k``, skip the
    comparators that reach a position >= k (the CTA route's unstored pads)."""
    keys = keys.copy()
    for stage in network(keys.shape[1]):
        p, q = (np.array(x) for x in zip(*stage))
        if k is not None:
            p, q = p[q < k], q[q < k]
        a, b = keys[:, p], keys[:, q]
        keys[:, p], keys[:, q] = np.maximum(a, b), np.minimum(a, b)
    return keys


def warp_sort(keys: np.ndarray) -> np.ndarray:
    """The warp route's exchanges on (rows, 32 lanes, E registers), step by
    step as ``warp_sort_desc`` takes them -> (rows, 32 * E), position
    lane * E + s."""
    key = keys.copy()
    e = key.shape[2]
    lane = np.arange(32)

    def keep(low, mine, other):
        return np.where(low[None, :], np.maximum(mine, other),
                        np.minimum(mine, other))

    size = 2
    while size <= 32 * e:
        if size <= e:
            for s in range(e):
                if not s & (size // 2):
                    a, b = key[:, :, s].copy(), key[:, :, s ^ (size - 1)].copy()
                    key[:, :, s] = np.maximum(a, b)
                    key[:, :, s ^ (size - 1)] = np.minimum(a, b)
        else:
            m = size // e - 1
            low = (lane & (size // (2 * e))) == 0
            for s in range(e // 2):
                r = e - 1 - s
                o0, o1 = key[:, lane ^ m, r], key[:, lane ^ m, s]
                key[:, :, s], key[:, :, r] = (keep(low, key[:, :, s], o0),
                                              keep(low, key[:, :, r], o1))
        j = size // 4
        while j:
            if j < e:
                for s in range(e):
                    if not s & j:
                        a, b = key[:, :, s].copy(), key[:, :, s | j].copy()
                        key[:, :, s] = np.maximum(a, b)
                        key[:, :, s | j] = np.minimum(a, b)
            else:
                m = j // e
                low = (lane & m) == 0
                o = key[:, lane ^ m, :]
                key = np.where(low[None, :, None], np.maximum(key, o),
                               np.minimum(key, o))
            j //= 2
        size *= 2
    return key.reshape(len(key), -1)


def abs_bits(z: np.ndarray) -> np.ndarray:
    return z.view(np.uint32) & np.uint32(0x7FFFFFFF)


def route_sort(z: np.ndarray, route: str) -> np.ndarray:
    """The keys of each row sorted as ``route`` sorts them -> (rows, k);
    the warp route sorts the |z| bits alone."""
    rows, k = z.shape
    keys = keys_of(z)
    if route == "narrow":
        rot = np.arange(rows) % 128 % k                 # row within its CTA
        slot = (np.arange(k)[None, :] + rot[:, None]) % k
        loaded = np.zeros((rows, 1 << (k - 1).bit_length()), np.uint32)
        loaded[:, :k] = np.take_along_axis(abs_bits(z), slot, axis=1)
        return sort_flat(loaded, k=k)[:, :k]
    if route == "warp":
        e = max(2, (1 << (k - 1).bit_length()) // 32)
        loaded = np.zeros((rows, 32 * e), np.uint32)
        loaded[:, :k] = abs_bits(z)                     # element s * 32 + lane
        regs = loaded.reshape(rows, e, 32).transpose(0, 2, 1)
        return warp_sort(np.ascontiguousarray(regs))[:, :k]
    width = 1 << (k - 1).bit_length()
    stored = np.zeros((rows, width), np.uint64)
    stored[:, :k] = keys
    return sort_flat(stored, k=k)[:, :k]


def warp_support(z: np.ndarray, srt: np.ndarray, t) -> np.ndarray:
    """The warp route's support at rank ``t`` (rows,): values above the one
    at rank t, and of the values equal to it the lowest-index ones, t + 1 -
    (count above) of them, counted in index order as the ballots count."""
    bits = abs_bits(z)
    thr = srt[np.arange(len(z)), t][:, None]
    above = (bits > thr).sum(axis=1, keepdims=True)
    need = np.asarray(t)[..., None] + 1 - above
    tie = bits == thr
    before = np.cumsum(tie, axis=1) - tie               # ties at lower index
    return (bits > thr) | (tie & (before < need))


def narrow_support(z: np.ndarray, srt: np.ndarray, t) -> np.ndarray:
    """The narrow route's support at rank ``t`` (rows,): |z| at least the
    value at rank t; where a value equal to it lies past rank t, a second
    pass in index order takes the lowest-index equal ones only."""
    rows, k = z.shape
    bits = abs_bits(z)
    t = np.broadcast_to(np.asarray(t), (rows,))
    thr = srt[np.arange(rows), t]
    on = bits >= thr[:, None]
    nxt = srt[np.arange(rows), np.minimum(t + 1, k - 1)]
    cut = (t + 1 < k) & (nxt == thr)
    for r in np.nonzero(cut)[0]:
        need = t[r] + 1 - int((srt[r] > thr[r]).sum())
        for j in range(k):
            if bits[r, j] == thr[r]:
                on[r, j] = need > 0
                need -= 1
    return on


def model_tess_project(z: np.ndarray, route: str):
    """The kernel's arithmetic after the sort -> (pattern int8, a f32)."""
    rows, k = z.shape
    srt = route_sort(z, route)
    down = ((srt >> np.uint64(32)).astype(np.uint32) if srt.dtype == np.uint64
            else srt).view(np.float32)
    run = np.zeros(rows, np.float32)
    zs = np.empty((rows, k), np.float32)
    for t in range(k):
        run = run + down[:, t]                          # one rounded add
        zs[:, t] = run / np.sqrt(np.float32(t + 1))
    t_star = np.argmax(zs, axis=1)                      # the first max
    if route == "warp":
        on = warp_support(z, srt, t_star)
    elif route == "narrow":
        on = narrow_support(z, srt, t_star)
    else:
        on = keys_of(z) >= srt[np.arange(rows), t_star][:, None]
    pos = z >= 0
    inv = (np.float32(1) / np.sqrt((t_star + 1).astype(np.float32)))[:, None]
    pat = np.where(on, np.where(pos, 1, -1), 0).astype(np.int8)
    a = np.where(on, np.where(pos, inv, -inv), np.float32(0)).astype(np.float32)
    return pat, a


def hard_rows(k: int, seed: int, n: int = 24) -> np.ndarray:
    """Rows that test the order: plain normals, values on a coarse grid
    (duplicates), thresholded zeros, an all-zero row, +-0.0 mixed."""
    r = np.random.default_rng(seed)
    z = r.normal(size=(n, k)).astype(np.float32)
    z[1:6] = np.round(z[1:6] * 2) / 2                   # many equal |z|
    z[6:10] = np.where(np.abs(z[6:10]) >= 0.8, z[6:10], 0.0)
    z[10] = 0.0
    z[11] = np.where(r.random(k) < 0.5, -0.0, 0.0)
    z[12] = np.where(r.random(k) < 0.5, 0.5, -0.5)      # one |z|, both signs
    z[13] = -z[13] * (r.random(k) < 0.3)                # -0.0 and values
    return z.astype(np.float32)


ROUTES = [(1, "narrow"), (31, "narrow"), (32, "narrow"), (33, "warp"),
          (512, "warp"), (1000, "warp"), (1, "cta"), (32, "cta"),
          (33, "cta"), (512, "cta"), (1000, "cta")]


def stable_ranks(z: np.ndarray) -> np.ndarray:
    az = torch.from_numpy(np.abs(z))
    order = torch.argsort(-az, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True).numpy()


@pytest.mark.parametrize("k,route", ROUTES)
def test_sorted_keys_give_the_stable_argsort_ranks(k, route):
    z = hard_rows(k, k)
    srt = route_sort(z, route)
    want = stable_ranks(z)
    if route != "cta":
        # the values in order; at every rank t the support is {rank <= t}
        np.testing.assert_array_equal(srt, -np.sort(-abs_bits(z).astype(
            np.int64), axis=1))
        support = warp_support if route == "warp" else narrow_support
        for t in range(k):
            np.testing.assert_array_equal(support(z, srt, t), want <= t)
        return
    assert (srt[:, :-1] > srt[:, 1:]).all()             # strictly descending
    # rank of each coordinate = its key's position in the sorted row
    keys = keys_of(z)
    ranks = np.stack([np.nonzero(keys[i][:, None] == srt[i][None, :])[1]
                      for i in range(len(z))])
    np.testing.assert_array_equal(ranks, want)


@pytest.mark.parametrize("e", [2, 4, 8, 16, 32])
def test_warp_exchanges_equal_the_flat_network(e):
    """Register s of lane l is position l * E + s: the cross-lane flip and
    half-cleaners are the flat network's comparators."""
    r = np.random.default_rng(e)
    keys = r.integers(0, 1 << 12, size=(5, 32 * e)).astype(np.uint32)
    regs = keys.reshape(5, 32, e)                       # position l * E + s
    np.testing.assert_array_equal(warp_sort(regs), sort_flat(keys))


@pytest.mark.parametrize("width,k", [(8, 5), (64, 33), (1024, 1000),
                                     (2048, 1025)])
def test_unstored_pads_never_move(width, k):
    """Skipping the comparators that reach positions >= k sorts the first k
    as explicit zero pads do."""
    keys = keys_of(hard_rows(k, width))
    padded = np.zeros((len(keys), width), np.uint64)
    padded[:, :k] = keys
    np.testing.assert_array_equal(sort_flat(padded)[:, :k],
                                  sort_flat(padded, k=k)[:, :k])


@pytest.mark.parametrize("k,route", ROUTES)
def test_tess_model_equals_plain_and_reference(k, route):
    z = hard_rows(k, 100 + k)
    z[14:] /= np.linalg.norm(z[14:], axis=1, keepdims=True)
    pat, a = model_tess_project(z, route)
    want_pat, want_a = ttp.tess_project_plain(torch.from_numpy(z))
    np.testing.assert_array_equal(pat, want_pat.numpy())
    np.testing.assert_array_equal(a, want_a.numpy())
    j_pat, j_a = j_tess_project(jnp.asarray(z), bb=8, interpret=True)
    diff = (pat != np.asarray(j_pat)).any(axis=1)
    assert not (diff & ~near_tie_rows(z)).any(), np.nonzero(diff)[0]
    # the reference multiplies by rsqrt(t*+1): a within a few ulp
    np.testing.assert_array_max_ulp(a[~diff], np.asarray(j_a)[~diff],
                                    maxulp=4)


def test_sqrt_table_is_correctly_rounded():
    """The narrow route's constant table of sqrtf(t + 1), t < 32."""
    src = (CSRC / "tess_project.cu").read_text()
    body = re.search(r"c_sqrt\[32\] = \{(.*?)\};", src, re.S).group(1)
    table = [float.fromhex(x.strip().rstrip("f"))
             for x in body.split(",")]
    want = np.sqrt(np.arange(1, 33, dtype=np.float32))
    np.testing.assert_array_equal(np.array(table, np.float32), want)


def test_route_limits_match_the_wrapper():
    src = (CSRC / "tess_project.cu").read_text()
    assert f"#define TESS_NARROW_MAX_K {ttp.TESS_THREAD_MAX_K}\n" in src
    assert f"#define TESS_WARP_MAX_K {ttp.TESS_WARP_MAX_K}\n" in src
    assert 12 * ttp.TESS_MAX_K + 256 <= 232448


# --------------------------------------------------------------- gam_score

def _defines(name: str) -> dict:
    """The integer #defines of csrc/<name>.cu: the model walks the grid the
    kernel's own constants give."""
    text = (CSRC / f"{name}.cu").read_text()
    return {m[0]: int(m[1]) for m in
            re.findall(r"^#define (\w+) (\d+)\b", text, re.M)}


_G = _defines("gam_score")
REG_THREADS, REG_ITEMS = _G["REG_THREADS"], _G["REG_ITEMS"]
REG_MAX_QC, REG_MIN_CTAS = _G["REG_MAX_QC"], _G["REG_MIN_CTAS"]
STG_THREADS, STG_ITEMS = _G["STG_THREADS"], _G["STG_ITEMS"]
STG_QC, STG_KC = _G["STG_QC"], _G["STG_KC"]


def fma_chain(u: np.ndarray, v: np.ndarray, width: int) -> np.ndarray:
    """(Q, k) x (N, k) -> (Q, N): one emulated fma a step over d < width,
    the rows padded with zeros past k."""
    k = u.shape[1]
    up = np.zeros((len(u), width), np.float64)
    vp = np.zeros((len(v), width), np.float64)
    up[:, :k], vp[:, :k] = u, v
    acc = np.zeros((len(u), len(v)), np.float32)
    for d in range(width):
        acc = (acc.astype(np.float64)
               + up[:, d, None] * vp[None, :, d]).astype(np.float32)
    return acc


def register_grid(q: int, n: int) -> tuple[int, int, int]:
    """``launch_reg``: (item CTAs, query chunk, query chunks)."""
    bx = -(-n // (REG_THREADS * REG_ITEMS))
    qc = min(q, REG_MAX_QC)
    if bx < REG_MIN_CTAS:
        cut = q // -(-REG_MIN_CTAS // bx)
        if cut < qc:
            qc = max(cut, 1)
    return bx, qc, -(-q // qc)


def model_gam_score(u, v, mask):
    """Walk the kernel's grid: each CTA, thread and item it owns, each query
    of its chunk -> (scores, times each output was written)."""
    q, k = u.shape
    n = v.shape[0]
    out = np.zeros((q, n), np.float32)
    writes = np.zeros((q, n), np.int64)
    if k <= 32:                                         # register route
        bx, qc, by = register_grid(q, n)
        width = 4 * -(-k // 4)
        for y in range(by):
            qs = np.arange(y * qc, min(q, (y + 1) * qc))
            for x in range(bx):
                n0 = (x * REG_THREADS + np.arange(REG_THREADS)) * REG_ITEMS
                items = (n0[:, None] + np.arange(REG_ITEMS)).ravel()
                items = items[items < n]
                sc = fma_chain(u[qs], v[items], width)
                sel = np.ix_(qs, items)
                out[sel] = np.where(mask[sel], sc, NEG)
                writes[sel] += 1
        return out, writes
    chunks = -(-k // STG_KC)                            # staged route
    for y in range(-(-q // STG_QC)):
        qs = np.arange(y * STG_QC, min(q, (y + 1) * STG_QC))
        for x in range(-(-n // (STG_THREADS * STG_ITEMS))):
            t = np.arange(STG_THREADS)
            items = (x * STG_THREADS * STG_ITEMS + t[:, None]
                     + STG_THREADS * np.arange(STG_ITEMS)).ravel()
            items = items[items < n]
            acc = np.zeros((len(qs), len(items)), np.float32)
            for c in range(chunks):                     # one stage at a time
                d0 = c * STG_KC
                dn = min(STG_KC, k - d0)
                w = 4 * -(-dn // 4)
                us = np.zeros((len(qs), w), np.float64)
                vs = np.zeros((len(items), w), np.float64)
                us[:, :dn] = u[qs, d0:d0 + dn]
                vs[:, :dn] = v[items, d0:d0 + dn]
                for d in range(w):
                    acc = (acc.astype(np.float64)
                           + us[:, d, None] * vs[None, :, d]).astype(
                               np.float32)
            sel = np.ix_(qs, items)
            out[sel] = np.where(mask[sel], acc, NEG)
            writes[sel] += 1
    return out, writes


SCORE_SHAPES = [(4, 64, 8), (37, 1000, 10), (130, 513, 32), (3, 1027, 1),
                (256, 2049, 10), (1, 2048, 64), (9, 300, 33), (17, 257, 100),
                (8, 1000, 512)]


@pytest.mark.parametrize("q,n,k", SCORE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_score_walk_equals_plain_and_reference(q, n, k, dtype):
    r = np.random.default_rng(q * n + k)
    u = r.normal(size=(q, k)).astype(np.float32)
    v = r.normal(size=(n, k)).astype(np.float32)
    mask = r.random((q, n)) < 0.3
    tdt = getattr(torch, dtype)
    ut, vt = torch.from_numpy(u).to(tdt), torch.from_numpy(v).to(tdt)
    # the kernel widens bf16 to f32 before the chain
    got, writes = model_gam_score(ut.float().numpy(), vt.float().numpy(),
                                  mask)
    assert (writes == 1).all()
    want = gam_score_plain(ut, vt, torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    ref = j_gam_score(jnp.asarray(u, dtype), jnp.asarray(v, dtype),
                      jnp.asarray(mask), bq=32, bn=128, interpret=True)
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got, np.asarray(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("q,n", [(256, 1 << 20), (256, 100003), (8, 32000),
                                 (1, 5), (300, 4096), (70000, 64)])
def test_register_grid_covers_every_query_once(q, n):
    """The query chunks cut for small N: every query in exactly one chunk,
    at most REG_MAX_QC a chunk, within the grid's y extent."""
    bx, qc, by = register_grid(q, n)
    assert 1 <= qc <= REG_MAX_QC and by <= 65535
    assert (by - 1) * qc < q <= by * qc
    assert bx * by >= min(REG_MIN_CTAS, bx * q)
