"""The arithmetic and the tile walk of the port's ``gam_coarse`` kernel, on
the CPU.

``csrc/gam_coarse.cu`` runs h (B, d) f32 against the int8 patterns (d, V)
on bf16 tensor-core ``mma.sync`` or ``wgmma`` with f32 sums: h split
exactly into three bf16 terms (``attn::split3``), each pattern byte
converted exactly to bf16 by bit operations, and one f32 accumulator an
output that takes the three terms' products of each 16-deep step of d in
order.  The kernel cannot run here,
so this file checks what it relies on:

- the int8 -> bf16 conversion (``i8pair_bf16x2``: a byte permute, two masks
  and one bf16x2 fma, modelled bit by bit) is exact for all 256 values, at
  every byte position;
- the three-term split is exact for every f32 h with |h| >= 2^-110, signs
  mixed, up to 2^120; below 2^-110 bf16's subnormal grid drops less than
  2^-133 a value;
- a model of one launch at the level of lanes and registers (the plan's
  config, the tensor map's box with its zero fill and 128-byte swizzle,
  each lane's four 32-bit words and A fragments, the split h's core-matrix
  layout as the wgmma descriptor, or ``ldmatrix`` on the ``mma.sync``
  route, reads it, the accumulator layout, the epilogue's stores)
  gives, bit for bit, what a model of the function in the kernel's
  summation order gives: the mapping of columns, rows and d to fragments is
  right, and every pattern byte is staged once for B <= 256;
- that summation order, each mma modelled as one f32 rounding of its
  partial sum, agrees with the JAX reference (``repro.kernels.gam_coarse``
  in interpret mode, and ``kernels.ref.gam_coarse_ref``) within
  ``coarse_tolerance``, at the shapes of ``tests/test_kernels.py``, ragged V
  and d, int8 in [-128, 127], and h from 2^-60 to 2^60 with cancelling signs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")
hypothesis = pytest.importorskip("hypothesis")
st = pytest.importorskip("hypothesis.strategies")

from repro.kernels import ref  # noqa: E402
from repro.kernels.gam_coarse import gam_coarse as jax_coarse  # noqa: E402
from repro_torch.kernels import gam_coarse as gc  # noqa: E402

TV = gc.TILE_V
U32 = np.uint64                  # 32-bit words held in uint64 for shifts


# ----------------------------------------------------------- bit models


def prmt(a, b, sel: int):
    """``__byte_perm(a, b, sel)``: byte i of the result is byte
    ``(sel >> 4 i) & 7`` of the eight bytes b:a (a the low four)."""
    src = (np.asarray(b, U32) << U32(32)) | np.asarray(a, U32)
    out = np.zeros_like(src)
    for i in range(4):
        n = (sel >> (4 * i)) & 7
        out |= ((src >> U32(8 * n)) & U32(0xFF)) << U32(8 * i)
    return out


def bf16_value(bits) -> np.ndarray:
    """uint16 bit patterns -> their bf16 values as f64."""
    t = torch.from_numpy(np.asarray(bits, np.uint16).astype(np.int16))
    return t.view(torch.bfloat16).double().numpy()


def bf16_bits(x) -> np.ndarray:
    """f64 values rounded to bf16 (to nearest, even) -> uint16 patterns."""
    t = torch.from_numpy(np.asarray(x, np.float64)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().astype(np.uint16)


def i8pair_bf16x2(w0, w1, j: int):
    """The kernel's conversion of byte j of w0 and of w1 into one bf16x2
    register (w0's byte in the low half): x = prmt, a = 128 + low 7 bits,
    s = 128 or 256, then fma.rn.bf16x2(s, -1, a) rounded once to bf16."""
    x = prmt(w0, w1, j | ((4 + j) << 8))
    a = (x & U32(0x007F007F)) | U32(0x43004300)
    s = (x & U32(0x00800080)) | U32(0x43004300)
    out = np.zeros_like(x)
    for half in (0, 1):
        sh = U32(16 * half)
        av = bf16_value((a >> sh) & U32(0xFFFF))
        sv = bf16_value((s >> sh) & U32(0xFFFF))
        out |= bf16_bits(av - sv).astype(U32) << sh     # exact, then rn
    return out


def halves(reg) -> np.ndarray:
    """bf16x2 registers (...) -> (..., 2) values, the low half first."""
    reg = np.asarray(reg, U32)
    return np.stack([bf16_value(reg & U32(0xFFFF)),
                     bf16_value(reg >> U32(16))], axis=-1)


def split3(x: np.ndarray) -> np.ndarray:
    """``attn::split3`` on f32 values -> (3, ...) f64: hi, mid, lo."""
    t = torch.from_numpy(np.asarray(x, np.float32))
    hi = t.to(torch.bfloat16).float()
    r = t - hi                                          # exact
    mid = r.to(torch.bfloat16).float()
    lo = (r - mid).to(torch.bfloat16).float()
    return np.stack([hi.double().numpy(), mid.double().numpy(),
                     lo.double().numpy()])


# ------------------------------------------------------ the conversion


@pytest.mark.parametrize("j", [0, 1, 2, 3])
def test_int8_to_bf16_is_exact_for_all_256_values_at_every_byte(j):
    vals = np.arange(-128, 128, dtype=np.int64)
    # byte j of w0 runs over all 256 values; w1's byte j over them reversed;
    # the other bytes hold noise the permute must not carry over
    noise = np.random.default_rng(j).integers(0, 1 << 32, size=(2, 256))
    keep = ~(0xFF << (8 * j)) & 0xFFFFFFFF
    w0 = (noise[0] & keep) | ((vals & 0xFF) << (8 * j))
    w1 = (noise[1] & keep) | ((vals[::-1] & 0xFF) << (8 * j))
    got = halves(i8pair_bf16x2(w0, w1, j))
    np.testing.assert_array_equal(got[:, 0], vals)
    np.testing.assert_array_equal(got[:, 1], vals[::-1])


@hypothesis.settings(deadline=None, max_examples=300)
@hypothesis.given(st.integers(0, 2 ** 32 - 1), st.integers(0, 2 ** 32 - 1),
                  st.integers(0, 3))
@hypothesis.example(0x80808080, 0x7F7F7F7F, 0)
@hypothesis.example(0xFFFFFFFF, 0x00000000, 3)
def test_int8_to_bf16_is_exact_for_any_words(w0, w1, j):
    got = halves(i8pair_bf16x2(np.array([w0]), np.array([w1]), j))[0]
    want = [(w >> (8 * j)) & 0xFF for w in (w0, w1)]
    assert list(got) == [float(v - 256 if v >= 128 else v) for v in want]


# ------------------------------------------------------------ the split


def _check_split_exact(x: np.ndarray) -> None:
    terms = split3(x)
    for t in terms:                                  # each a bf16 number
        np.testing.assert_array_equal(bf16_value(bf16_bits(t)), t)
    np.testing.assert_array_equal(terms.sum(0), x.astype(np.float64))


@hypothesis.settings(deadline=None, max_examples=300)
@hypothesis.given(st.lists(st.tuples(st.integers(-110, 119),
                                     st.integers(0, 2 ** 23 - 1),
                                     st.booleans()), min_size=1, max_size=64))
@hypothesis.example([(-110, 2 ** 23 - 1, True)])
@hypothesis.example([(119, 2 ** 23 - 1, False)])
def test_split_is_exact_for_general_f32(parts):
    """Every f32 with exponent in [-110, 119] (|x| in [2^-110, 2^120)),
    any significand, either sign."""
    x = np.array([(-1.0 if neg else 1.0) * (1 + m / 2 ** 23) * 2.0 ** e
                  for e, m, neg in parts], np.float32)
    _check_split_exact(x)


@hypothesis.settings(deadline=None, max_examples=200)
@hypothesis.given(st.lists(st.tuples(st.integers(-120, -111),
                                     st.integers(0, 2 ** 23 - 1),
                                     st.booleans()), min_size=1, max_size=64))
def test_split_below_2_to_minus_110_drops_under_2_to_minus_133(parts):
    x = np.array([(-1.0 if neg else 1.0) * (1 + m / 2 ** 23) * 2.0 ** e
                  for e, m, neg in parts], np.float32)
    terms = split3(x)
    for t in terms:
        np.testing.assert_array_equal(bf16_value(bf16_bits(t)), t)
    assert np.all(np.abs(terms.sum(0) - x.astype(np.float64)) < 2.0 ** -133)


# ------------------------------------------------------- the two models


def order_model(h: np.ndarray, pat: np.ndarray, inv: np.ndarray,
                n_terms: int = 3):
    """The function in the kernel's order: for each 16-deep step of d and
    each term (hi, mid, lo; the first ``n_terms`` of them), acc = f32(acc +
    the step's 16 products), the products and their sum taken in f64 (each
    mma's partial sum), then acc * inv in f32."""
    b, d = h.shape
    steps = -(-d // 16)
    hp = np.zeros((b, 16 * steps), np.float32)
    hp[:, :d] = h
    terms = split3(hp)
    pp = np.zeros((16 * steps, pat.shape[1]), np.float64)
    pp[:d] = pat
    acc = np.zeros((b, pat.shape[1]), np.float32)
    for s in range(steps):
        sl = slice(16 * s, 16 * s + 16)
        for t in terms[:n_terms]:
            acc = (acc.astype(np.float64) + t[:, sl] @ pp[sl]).astype(
                np.float32)
    return acc * inv[None, :].astype(np.float32)


# PTX fragment coordinates of mma.m16n8k16 (bf16), lane = 4 gid + tig
LANE = np.arange(32)
GID, TIG = LANE >> 2, LANE & 3
A_ROW = [GID, GID + 8, GID, GID + 8]              # a[i], both halves
A_COL = [2 * TIG, 2 * TIG, 2 * TIG + 8, 2 * TIG + 8]   # + half
C_ROW = [GID, GID, GID + 8, GID + 8]
C_COL = [2 * TIG, 2 * TIG + 1, 2 * TIG, 2 * TIG + 1]


LBO, SBO = 128, 256        # the B descriptor's core-matrix strides, bytes


def split_block(terms: np.ndarray) -> np.ndarray:
    """One term's (rows, 16) bf16 values of a step laid out as the split
    kernel writes them: word (i & 3) of row qq % 8 of core matrix
    (qq / 8, i / 4) holds the pair d = 2 i, 2 i + 1 -> flat (rows * 16,)."""
    rows = terms.shape[0]
    qq, i = np.meshgrid(np.arange(rows), np.arange(8), indexing="ij")
    pos = ((((qq >> 3) * 2 + (i >> 2)) * 8 + (qq & 7)) * 4 + (i & 3))
    flat = np.zeros(rows * 16)
    flat[2 * pos] = terms[qq, 2 * i]
    flat[2 * pos + 1] = terms[qq, 2 * i + 1]
    return flat


def desc_read(flat: np.ndarray, row: np.ndarray, k: np.ndarray):
    """B[k, n] as wgmma reads it through a no-swizzle K-major descriptor:
    byte (row / 8) SBO + (k / 8) LBO + (row % 8) 16 + (k % 8) 2."""
    byte = (row >> 3) * SBO + (k >> 3) * LBO + (row & 7) * 16 + (k & 7) * 2
    return flat[byte // 2]


def kernel_model(h: np.ndarray, pat: np.ndarray, inv: np.ndarray,
                 offset: int = 0):
    """One launch of ``coarse_mma_kernel`` as the plan configures it, lane
    by lane: (out (B, V) f32, pattern bytes staged from the matrix)."""
    b, d = h.shape
    v = pat.shape[1]
    plan = gc.coarse_plan(b, d, v, offset)
    rows, kd, _, _ = gc.CONFIGS[plan.cfg]
    nt, n_wn = min(rows, 64) // 8, max(1, rows // 64)
    steps_per = kd // 16
    n_steps = plan.chunks * steps_per
    # the split kernel: per pass, step and term a block of the pass's rows
    hp = np.zeros((plan.passes * rows, 16 * n_steps), np.float32)
    hp[:b, :d] = h
    terms = split3(hp).reshape(3, plan.passes, rows, n_steps, 16)
    hs = np.stack([[[split_block(terms[x, pas, :, st])
                     for x in range(3)] for st in range(n_steps)]
                   for pas in range(plan.passes)])
    assert plan.scratch == hs.size
    pat_u8 = pat.view(np.uint8)
    out = np.full((b, v), np.nan, np.float32)
    staged = 0
    piece = 2 * np.arange(4)[:, None] + (GID >> 2)            # (wm, lane)
    lane_even = (2 * TIG * TV + ((piece ^ (2 * TIG)) << 4) + 4 * (GID & 3))
    lane_odd = ((2 * TIG + 1) * TV + ((piece ^ (2 * TIG + 1)) << 4)
                + 4 * (GID & 3))
    for tile in range(plan.tiles):
        for pas in range(plan.passes):
            # acc[wn, wm, n-tile, m-tile, lane, e]
            acc = np.zeros((n_wn, 4, nt, 2, 32, 4), np.float32)
            for chunk in range(plan.chunks):
                # the tensor map's box: kd rows x 128 bytes, zero past d and
                # V, each row's 16-byte pieces swizzled by the row mod 8
                box = np.zeros((kd, TV), np.uint8)
                seg = pat_u8[chunk * kd:(chunk + 1) * kd,
                             tile * TV:(tile + 1) * TV]
                box[:seg.shape[0], :seg.shape[1]] = seg
                staged += seg.size
                smem = np.zeros(kd * TV, np.uint8)
                for row in range(kd):
                    for c in range(8):
                        o = row * TV + ((c ^ (row & 7)) << 4)
                        smem[o:o + 16] = box[row, 16 * c:16 * c + 16]
                words = smem.view("<u4").astype(U32)
                hsm = hs[pas, chunk * steps_per:(chunk + 1) * steps_per]
                for sp in range(steps_per):
                    for wn in range(n_wn):
                        for wm in range(4):
                            base = sp * 16 * TV
                            w = [words[(base + lane_even[wm]) // 4],
                                 words[(base + lane_odd[wm]) // 4],
                                 words[(base + 8 * TV + lane_even[wm]) // 4],
                                 words[(base + 8 * TV + lane_odd[wm]) // 4]]
                            a = np.zeros((2, 16, 16))
                            for t in range(2):
                                regs = [i8pair_bf16x2(w[0], w[1], 2 * t),
                                        i8pair_bf16x2(w[0], w[1], 2 * t + 1),
                                        i8pair_bf16x2(w[2], w[3], 2 * t),
                                        i8pair_bf16x2(w[2], w[3], 2 * t + 1)]
                                for i, reg in enumerate(regs):
                                    hv = halves(reg)
                                    for e in (0, 1):
                                        a[t, A_ROW[i], A_COL[i] + e] = hv[:, e]
                            for n in range(nt):
                                # rows of this warpgroup's n-tile n, read
                                # from the descriptor of its first row
                                q = n * 8 + np.arange(8)
                                for x in range(3):
                                    blk = hsm[sp, x][wn * nt * 128:]
                                    bm = desc_read(blk, q[None, :],
                                                   np.arange(16)[:, None])
                                    for t in range(2):
                                        cm = np.zeros((16, 8))
                                        for e in range(4):
                                            cm[C_ROW[e], C_COL[e]] = \
                                                acc[wn, wm, n, t, :, e]
                                        cm = (cm + a[t] @ bm).astype(
                                            np.float32)
                                        for e in range(4):
                                            acc[wn, wm, n, t, :, e] = \
                                                cm[C_ROW[e], C_COL[e]]
            for wn in range(n_wn):
                for wm in range(4):
                    v0 = tile * TV + 32 * wm + 4 * GID
                    for n in range(nt):
                        for e in (0, 1):
                            q = pas * rows + wn * 8 * nt + n * 8 + 2 * TIG + e
                            o = [acc[wn, wm, n, 0, :, e],
                                 acc[wn, wm, n, 0, :, e + 2],
                                 acc[wn, wm, n, 1, :, e],
                                 acc[wn, wm, n, 1, :, e + 2]]
                            for j in range(4):
                                ok = (q < b) & (v0 + j < v)
                                vv = np.minimum(v0 + j, v - 1)
                                out[q[ok], (v0 + j)[ok]] = (
                                    o[j] * inv[vv].astype(np.float32))[ok]
    return out, staged


def _inputs(b, d, v, lo=-1, hi=2, seed=None):
    r = np.random.default_rng(b * d + v if seed is None else seed)
    h = r.normal(size=(b, d)).astype(np.float32)
    pat = r.integers(lo, hi, size=(d, v)).astype(np.int8)
    nnz = np.abs(pat.astype(np.float32)).sum(0)
    inv = (1.0 / np.sqrt(np.maximum(nnz, 1.0))).astype(np.float32)
    return h, pat, inv


def _tolerance(h, pat, inv):
    return gc.coarse_tolerance(*(torch.from_numpy(x) for x in
                                 (h, pat, inv))).numpy()


# ---------------------------------------------------- the lane model


@pytest.mark.parametrize("b,d,v,lo,hi,offset", [
    (1, 16, 128, -1, 2, 0),          # one step, one tile
    (8, 100, 300, -128, 128, 0),     # ragged d and V, two chunks
    (3, 40, 257, -1, 2, 1),          # V = 1 mod 16, a misaligned view
    (13, 70, 129, -128, 128, 0),     # two n-tiles, V just past a tile
    (40, 33, 160, -1, 2, 0),         # four n-tiles
    (70, 20, 64, -128, 128, 0),      # eight n-tiles, two warp rows
    (150, 17, 32, -1, 2, 0),         # four warp rows, k 32 a stage
])
def test_lane_model_equals_order_model(b, d, v, lo, hi, offset):
    h, pat, inv = _inputs(b, d, v, lo, hi)
    got, staged = kernel_model(h, pat, inv, offset)
    np.testing.assert_array_equal(got, order_model(h, pat, inv))
    assert staged == d * v            # every pattern byte staged once


def test_lane_model_takes_one_pass_per_256_rows():
    h, pat, inv = _inputs(300, 16, 16)
    plan = gc.coarse_plan(300, 16, 16)
    assert plan.passes == 2 and plan.rows_per_pass == 256
    got, staged = kernel_model(h, pat, inv)
    np.testing.assert_array_equal(got, order_model(h, pat, inv))
    assert staged == 2 * 16 * 16


# ------------------------------------------- the order against the JAX


@pytest.mark.parametrize("b,d,v,lo,hi", [
    (1, 64, 500, -1, 2), (4, 128, 4096, -1, 2), (8, 32, 100, -1, 2),
    (2, 256, 2049, -1, 2),                    # tests/test_kernels.py
    (3, 100, 33, -128, 128), (13, 300, 1001, -1, 2), (5, 7, 17, -128, 128),
    (64, 2048, 96, -1, 2), (1, 1, 1, -128, 128), (256, 48, 40, -128, 128)])
def test_order_model_matches_reference_within_tolerance(b, d, v, lo, hi):
    h, pat, inv = _inputs(b, d, v, lo, hi)
    got = order_model(h, pat, inv)
    jh, jp, ji = jnp.asarray(h), jnp.asarray(pat), jnp.asarray(inv)
    tol = _tolerance(h, pat, inv)
    for want in (jax_coarse(jh, jp, ji, bv=512, interpret=True),
                 ref.gam_coarse_ref(jh, jp, ji)):
        assert np.all(np.abs(got - np.asarray(want)) <= tol)


@pytest.mark.parametrize("b,d,v", [(8, 512, 64), (3, 2048, 48), (1, 77, 20)])
def test_order_model_within_tolerance_on_adversarial_h(b, d, v):
    """h from 2^-60 to 2^60 in one row, with pairs of equal magnitude and
    opposite sign, against int8 over its whole range."""
    r = np.random.default_rng(d)
    half = (2.0 ** r.integers(-60, 61, size=(b, -(-d // 2)))
            * r.uniform(1, 2, (b, -(-d // 2)))).astype(np.float32)
    h = np.empty((b, d), np.float32)
    h[:, 0::2] = half
    h[:, 1::2] = -half[:, :d // 2]
    pat = r.integers(-128, 128, size=(d, v)).astype(np.int8)
    inv = r.uniform(0.01, 1.0, v).astype(np.float32)
    got = order_model(h, pat, inv)
    tol = _tolerance(h, pat, inv)
    want = gc.gam_coarse_plain(*(torch.from_numpy(x) for x in (h, pat, inv)))
    assert np.all(np.abs(got - want.numpy()) <= tol)
    oracle = np.asarray(ref.gam_coarse_ref(jnp.asarray(h), jnp.asarray(pat),
                                           jnp.asarray(inv)))
    assert np.all(np.abs(got - oracle) <= tol)


@pytest.mark.parametrize("b,d,v", [(8, 512, 64), (3, 2048, 48),
                                   (64, 256, 40), (1, 30, 17)])
def test_third_term_probe_tells_three_terms_from_two(b, d, v):
    """On the probe's inputs the kernel's order with all three terms of h
    lands far inside the error of the same order with two; the card's check
    (``chip_smoke.py``, the card tests) holds the kernel to an eighth of
    the two-term error."""
    h, pat, inv = gc.third_term_probe(b, d, v, seed=d)
    args = [x.numpy() for x in (h, pat, inv)]
    three = torch.from_numpy(order_model(*args))
    two = torch.from_numpy(order_model(*args, n_terms=2))
    err3, err2 = gc.third_term_errors(three, h, pat, inv)
    assert err3 <= err2 / 64
    assert gc.third_term_errors(two, h, pat, inv)[0] >= err2 / 2
    assert torch.all((three - gc.gam_coarse_plain(h, pat, inv)).abs()
                     <= gc.coarse_tolerance(h, pat, inv))


# --------------------------------------------------------- the plan


@pytest.mark.parametrize("b,cfg,rows,threads", [
    (1, 0, 8, 128), (8, 0, 8, 128), (9, 1, 16, 128), (32, 2, 32, 128),
    (64, 3, 64, 128), (65, 4, 128, 256), (256, 5, 256, 512),
    (257, 5, 256, 512)])
def test_plan_takes_all_rows_of_up_to_256_in_one_pass(b, cfg, rows, threads):
    plan = gc.coarse_plan(b, 2048, 32000)
    assert (plan.cfg, plan.rows_per_pass, plan.threads) == (cfg, rows,
                                                            threads)
    assert plan.passes == (1 if b <= 256 else -(-b // 256))
    assert plan.vec and plan.tiles == 250
    # persistent CTAs, one or two an SM, never more than the tiles
    assert 1 <= plan.ctas_per_sm <= 2
    assert plan.grid == min(250, 132 * plan.ctas_per_sm)
    assert plan.smem + gc.SMEM_PER_CTA_RESERVED <= 232_448
    rows, kd, _, route = gc.CONFIGS[cfg]
    assert plan.route == route == ("mma" if rows <= 16 else "wgmma")
    assert plan.chunks == 2048 // kd
    assert plan.scratch == plan.passes * 128 * 3 * rows * 16


@pytest.mark.parametrize("v,offset,vec", [(32000, 0, True), (32001, 0, False),
                                          (32000, 1, False), (48, 16, True),
                                          (48, 8, False)])
def test_plan_route_by_alignment(v, offset, vec):
    assert gc.coarse_plan(8, 64, v, offset).vec is vec
