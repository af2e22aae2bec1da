"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present (decided
inside the test, never at import).  The file imports nothing of JAX, so it
also runs where JAX is not installed, without the suite's conftest:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.compress import quantize_int8  # noqa: E402
from repro_torch.core.inverted_index import build_segment  # noqa: E402
from repro_torch.core.mapping import GamConfig, sparse_map  # noqa: E402
from repro_torch.kernels import gam_retrieve as gr  # noqa: E402
from repro_torch.kernels import gam_score as gs  # noqa: E402
from repro_torch.kernels import tess_project as tp  # noqa: E402
from repro_torch.retriever import RetrieverSpec, open_retriever  # noqa: E402

pytestmark = pytest.mark.cuda

CFG = GamConfig(k=16, scheme="parse_tree", threshold=0.2)


def unit_factors(n: int, k: int = 16, seed: int = 0) -> np.ndarray:
    z = np.random.default_rng(seed).normal(size=(n, k)).astype(np.float32)
    return z / np.linalg.norm(z, axis=1, keepdims=True)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("b,k", [(4, 8), (100, 16), (257, 10), (32, 64),
                                 (1, 12), (5000, 256)])
def test_tess_project_kernel_equals_plain(dev, b, k):
    z = torch.from_numpy(np.random.default_rng(b + k).normal(size=(b, k))
                         .astype(np.float32)).to(dev)
    z[:, k // 2:] *= (z[:, k // 2:].abs() > 0.5)        # thresholded zeros
    pat, a = tp.tess_project(z)
    torch.cuda.synchronize()
    want_pat, want_a = tp.tess_project_plain(z)
    assert torch.equal(pat, want_pat)
    assert torch.equal(a, want_a)


def near_tie_rows(z: np.ndarray, ulp: int = 4) -> np.ndarray:
    """Rows whose top two float64 scaled running sums of Algorithm 2 are
    within ``ulp`` f32 ulp: their t* depends on rounding."""
    az = -np.sort(-np.abs(np.asarray(z, np.float64)), axis=-1)
    zs = np.cumsum(az, axis=-1) / np.sqrt(np.arange(1, az.shape[-1] + 1))
    top2 = -np.sort(-zs, axis=-1)[:, :2]
    return top2[:, 0] - top2[:, 1] <= ulp * np.spacing(
        top2[:, 0].astype(np.float32))


@pytest.mark.parametrize("b,k", [(7, 257), (64, 300), (3, 1000), (2, 4100)])
def test_tess_project_wide_kernel_equals_plain(dev, b, k):
    """The one-CTA-per-row kernel past TESS_THREAD_MAX_K (its first width,
    and rows wider than the 48 KB default shared memory): bit for bit as the
    plain version."""
    z = torch.from_numpy(np.random.default_rng(b * k).normal(size=(b, k))
                         .astype(np.float32)).to(dev)
    z[:, k // 2:] *= (z[:, k // 2:].abs() > 0.5)        # thresholded zeros
    z[0] = 0.0                                          # an all-zero row
    pat, a = tp.tess_project(z)
    torch.cuda.synchronize()
    want_pat, want_a = tp.tess_project_plain(z)
    assert torch.equal(pat, want_pat)
    assert torch.equal(a, want_a)


@pytest.mark.parametrize("k", [512, 2048])
def test_tess_project_wide_rows_equal_plain_except_near_ties(dev, k):
    """32,000 unit rows (the GAM head maps the vocab at k = d_model): equal
    to the plain version except rows certified as near-ties, counted."""
    z = np.random.default_rng(k).normal(size=(32000, k)).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    zt = torch.from_numpy(z).to(dev)
    before = tp.tess_project.launches
    pat, a = tp.tess_project(zt)
    torch.cuda.synchronize()
    assert tp.tess_project.launches == before + 1
    want_pat, want_a = tp.tess_project_plain(zt)
    diff = (pat != want_pat).any(dim=1).cpu().numpy()
    rows = np.nonzero(diff)[0]
    assert near_tie_rows(z[rows]).all(), rows[:8]
    same = torch.from_numpy(~diff).to(dev)
    assert torch.equal(a[same], want_a[same])
    print(f"k={k}: {rows.size} near-tie rows of 32000")


def test_tess_project_rejects_rows_past_shared_memory(dev):
    z = torch.zeros((2, tp.TESS_MAX_K + 1), device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        tp.tess_project(z)


@pytest.mark.parametrize("q,n,k", [(4, 64, 8), (128, 512, 16), (37, 1000, 10),
                                   (1, 2048, 64), (130, 513, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gam_score_kernel_equals_plain(dev, q, n, k, dtype):
    r = np.random.default_rng(q * n + k)
    u = torch.from_numpy(r.normal(size=(q, k)).astype(np.float32)).to(dev, dtype)
    v = torch.from_numpy(r.normal(size=(n, k)).astype(np.float32)).to(dev, dtype)
    mask = torch.from_numpy(r.random((q, n)) < 0.3).to(dev)
    got = gs.gam_score(u, v, mask)
    torch.cuda.synchronize()
    want = gs.gam_score_plain(u, v, mask)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


RETRIEVE_CASES = [
    (350, 16, 10, 2, 512, 128, 32),
    (300, 7, 5, 1, 4, 64, 8),
    (123, 3, 50, 3, 256, 32, 8),
    (513, 11, 17, 2, 8, 96, 8),
    (200, 9, 10, 0, 512, 64, 12),
    (5000, 300, 128, 1, 64, 256, 32),
]


def _catalog(dev, n, q, bucket, bn, quantize="none"):
    cfg = CFG
    items = torch.from_numpy(unit_factors(n, 16, n)).to(dev)
    users = torch.from_numpy(unit_factors(q, 16, n + 1)).to(dev)
    tau, vals = sparse_map(items, cfg)
    q_tau, q_vals = sparse_map(users, cfg)
    _, _, spill = build_segment(tau.cpu().numpy(), cfg.p, bucket,
                                (vals != 0).cpu().numpy())
    meta = gr.build_retrieval_meta(tau, vals != 0, cfg.p, spill_rows=spill,
                                   bn=bn, factors=items, quantize=quantize,
                                   device=dev)
    return items, users, q_tau, q_vals, meta


def _max_ulp(a: torch.Tensor, b: torch.Tensor) -> int:
    a = a.contiguous().view(torch.int32).long()
    b = b.contiguous().view(torch.int32).long()
    return int((a - b).abs().max()) if a.numel() else 0


@pytest.mark.parametrize("n,q,kappa,mo,bucket,bn,bq", RETRIEVE_CASES)
def test_gam_retrieve_kernel_equals_plain(dev, n, q, kappa, mo, bucket, bn, bq):
    items, users, q_tau, q_vals, meta = _catalog(dev, n, q, bucket, bn)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    alive[::7] = False
    for al in (None, alive):
        got = gr.gam_retrieve(users, items, q_tau, q_vals != 0, meta,
                              min(kappa, n), min_overlap=mo, bq=bq, alive=al)
        torch.cuda.synchronize()
        want = gr.gam_retrieve_plain(users, items, q_tau, q_vals != 0, meta,
                                     min(kappa, n), min_overlap=mo, bq=bq,
                                     alive=al)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


# past the shared-memory fast path: kappa-lists and/or query rows in global
# memory (kappa > GAM_RETRIEVE_SMEM_KAPPA, k > GAM_RETRIEVE_SMEM_K)
WIDE_CASES = [
    # n, q, kappa, k, scheme, mo, bn, bq
    (5000, 37, 200, 16, "parse_tree", 1, 256, 32),
    (3000, 9, 512, 16, "parse_tree", 0, 128, 8),
    (300, 20, 10, 1536, "one_hot", 2, 64, 8),
    (700, 11, 200, 1536, "one_hot", 1, 128, 8),
]


def _wide_catalog(dev, n, q, k, scheme, bn, quantize="none"):
    cfg = GamConfig(k=k, scheme=scheme, threshold=0.5 / k ** 0.5)
    items = torch.from_numpy(unit_factors(n, k, n + k)).to(dev)
    users = torch.from_numpy(unit_factors(q, k, n + k + 1)).to(dev)
    tau, vals = sparse_map(items, cfg)
    q_tau, q_vals = sparse_map(users, cfg)
    _, _, spill = build_segment(tau.cpu().numpy(), cfg.p, 64,
                                (vals != 0).cpu().numpy())
    meta = gr.build_retrieval_meta(tau, vals != 0, cfg.p, spill_rows=spill,
                                   bn=bn, factors=items, quantize=quantize,
                                   device=dev)
    return items, users, q_tau, q_vals != 0, meta


@pytest.mark.parametrize("n,q,kappa,k,scheme,mo,bn,bq", WIDE_CASES)
def test_gam_retrieve_kernel_equals_plain_past_shared_memory(
        dev, n, q, kappa, k, scheme, mo, bn, bq):
    """Replaces the test that the kernel refused kappa > 128: any kappa and
    k now run, bit for bit as the plain version."""
    items, users, q_tau, q_mask, meta = _wide_catalog(dev, n, q, k, scheme,
                                                      bn)
    assert kappa > gr.GAM_RETRIEVE_SMEM_KAPPA or k > gr.GAM_RETRIEVE_SMEM_K
    got = gr.gam_retrieve(users, items, q_tau, q_mask, meta, kappa,
                          min_overlap=mo, bq=bq)
    torch.cuda.synchronize()
    want = gr.gam_retrieve_plain(users, items, q_tau, q_mask, meta, kappa,
                                 min_overlap=mo, bq=bq)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_gam_device_retriever_on_card_equals_cpu(dev):
    spec = RetrieverSpec(cfg=CFG, backend="gam-device", min_overlap=2)
    items, users = unit_factors(3000, 16, 3), unit_factors(70, 16, 4)
    before = gr.gam_retrieve.launches
    on_card = open_retriever(spec, items=items).query(users, explain=True)
    on_cpu = open_retriever(spec, items=items, device="cpu").query(
        users, explain=True)
    assert gr.gam_retrieve.launches == before + 1
    np.testing.assert_array_equal(on_card.ids, on_cpu.ids)
    np.testing.assert_array_equal(on_card.scores, on_cpu.scores)
    assert on_card.explain == on_cpu.explain


@pytest.mark.parametrize("n,q,pool,mo,bucket,bn,bq", RETRIEVE_CASES)
def test_gam_retrieve_q_kernel_equals_plain(dev, n, q, pool, mo, bucket, bn,
                                            bq):
    """Pool rows, counts and skip map exact; pool scores within 4 ulp."""
    _, users, q_tau, q_vals, meta = _catalog(dev, n, q, bucket, bn, "int8")
    pool = min(pool, meta.n_pad)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    alive[::7] = False
    for al in (None, alive):
        args = (users, q_tau, q_vals != 0, meta, pool)
        got = gr.gam_retrieve_q(*args, min_overlap=mo, bq=bq, alive=al)
        torch.cuda.synchronize()
        want = gr.gam_retrieve_q_plain(*args, min_overlap=mo, bq=bq, alive=al)
        for name in ("rows", "blk_counts", "skipped"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert _max_ulp(got.vals, want.vals) <= 4


def test_int8_slab_on_card_equals_cpu_slab(dev):
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(4096, 10)) * 3).astype(np.float32)
    x[512:1024] = 0.0                                   # an all-zero block
    cpu_q, cpu_s = quantize_int8(torch.from_numpy(x), block=256)
    card_q, card_s = quantize_int8(torch.from_numpy(x).to(dev), block=256)
    assert torch.equal(card_q.cpu(), cpu_q)
    assert torch.equal(card_s.cpu().view(torch.int32), cpu_s.view(torch.int32))
    meta_card = _catalog(dev, 3000, 4, 64, 256, "int8")[-1]
    meta_cpu = _catalog(torch.device("cpu"), 3000, 4, 64, 256, "int8")[-1]
    assert torch.equal(meta_card.factors_q.cpu(), meta_cpu.factors_q)
    assert torch.equal(meta_card.scales.cpu().view(torch.int32),
                       meta_cpu.scales.view(torch.int32))


@pytest.mark.parametrize("pool", [256, 512])
@pytest.mark.parametrize("n,q,_kappa,k,scheme,mo,bn,bq", WIDE_CASES)
def test_gam_retrieve_q_kernel_equals_plain_wide_pool(
        dev, pool, n, q, _kappa, k, scheme, mo, bn, bq):
    """Replaces the test that the int8 kernel refused a pool > 128: pools of
    256 and 512 (and k = 1536) equal the plain version (rows, counts and
    skip map exact, scores within 4 ulp)."""
    _, users, q_tau, q_mask, meta = _wide_catalog(dev, n, q, k, scheme, bn,
                                                  "int8")
    pool = min(pool, meta.n_pad)
    args = (users, q_tau, q_mask, meta, pool)
    got = gr.gam_retrieve_q(*args, min_overlap=mo, bq=bq)
    torch.cuda.synchronize()
    want = gr.gam_retrieve_q_plain(*args, min_overlap=mo, bq=bq)
    for name in ("rows", "blk_counts", "skipped"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert _max_ulp(got.vals, want.vals) <= 4


def test_int8_gam_device_retriever_on_card_equals_cpu(dev):
    spec = RetrieverSpec(cfg=CFG, backend="gam-device", min_overlap=2,
                         quantize="int8", compress_postings=True,
                         rerank_factor=4)
    items, users = unit_factors(3000, 16, 3), unit_factors(70, 16, 4)
    before_q, before_f32 = gr.gam_retrieve_q.launches, gr.gam_retrieve.launches
    on_card = open_retriever(spec, items=items).query(users, explain=True)
    on_cpu = open_retriever(spec, items=items, device="cpu").query(
        users, explain=True)
    assert gr.gam_retrieve_q.launches == before_q + 1
    assert gr.gam_retrieve.launches == before_f32
    np.testing.assert_array_equal(on_card.ids, on_cpu.ids)
    np.testing.assert_array_equal(on_card.scores, on_cpu.scores)
    assert on_card.explain == on_cpu.explain


# ------------------------------------------------------- decode_attention

DECODE_SHAPES = [
    # b, hkv, g, hd, s: the reference suite's shapes, the slice's serving
    # shape (tinyllama-1.1b, batch 8, capacity 1064), the decode_32k widths
    # at a smaller batch, an odd head dim (scalar loads) and wide groups
    (1, 1, 1, 32, 64), (2, 2, 4, 64, 128), (3, 1, 8, 64, 100),
    (2, 4, 2, 128, 257), (1, 2, 16, 64, 1024), (8, 4, 8, 64, 1064),
    (4, 4, 8, 64, 32768), (2, 3, 6, 100, 333), (2, 1, 16, 256, 520),
    (1, 1, 48, 256, 130), (2, 2, 3, 8, 7),
]


def _decode_inputs(dev, b, hkv, g, hd, s, dtype, seed):
    r = np.random.default_rng(seed)
    mk = (lambda *shape: torch.from_numpy(r.normal(size=shape).astype(
        np.float32)).to(dev, dtype))
    return mk(b, hkv, g, hd), mk(b, s, hkv, hd), mk(b, s, hkv, hd)


@pytest.mark.parametrize("b,hkv,g,hd,s", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_equals_plain(dev, b, hkv, g, hd, s, dtype):
    """f32 within 1e-5; bf16 within 2e-2 (the output is rounded once to
    bf16, relative step 2^-8, and the kernel's split softmax sums in another
    order than the plain version)."""
    from repro_torch.kernels import decode_attention as da
    q, k, v = _decode_inputs(dev, b, hkv, g, hd, s, dtype, b * s + hd)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for length in (s - 1, s // 2, 0):
        n_len = torch.tensor(length, dtype=torch.int32, device=dev)
        before = da.decode_attention.launches
        got = da.decode_attention(q, k, v, n_len)
        torch.cuda.synchronize()
        assert da.decode_attention.launches == before + 1
        want = da.decode_attention_plain(q, k, v, n_len)
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


def test_decode_attention_kernel_ignores_positions_past_length(dev):
    from repro_torch.kernels import decode_attention as da
    q, k, v = _decode_inputs(dev, 2, 2, 4, 64, 600, torch.bfloat16, 3)
    out1 = da.decode_attention(q, k, v, 300)
    k[:, 301:] = 99.0
    v[:, 301:] = -99.0
    out2 = da.decode_attention(q, k, v, 300)
    assert torch.equal(out1, out2)


def test_decode_kernel_model_path_equals_einsum_path(dev):
    """Reduced tinyllama widened to G = 8 on the card: the decode steps
    through the kernel equal the reference's einsum path within 1e-4 (f32),
    and the kernel launches once per layer and step."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models import Model
    cfg = get_reduced_config("tinyllama-1.1b").with_(n_heads=8, n_kv_heads=1,
                                                     vocab=300)
    plain, kern = Model(cfg), Model(cfg.with_(use_decode_kernel=True))
    params = plain.init(0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 300, (4, 20))).to(dev)
    _, cp = plain.prefill(params, {"tokens": tokens}, 40)
    _, ck = kern.prefill(params, {"tokens": tokens}, 40)
    tok = tokens[:, :1]
    before = da.decode_attention.launches
    for _ in range(5):
        lp, cp = plain.decode_step(params, cp, tok)
        lk, ck = kern.decode_step(params, ck, tok)
        torch.testing.assert_close(lk, lp, rtol=1e-4, atol=1e-4)
        tok = lp[:, 0].argmax(-1, keepdim=True)
    assert da.decode_attention.launches == before + 5 * cfg.n_layers


# ------------------------------------------------------------ flash_prefill

PREFILL_SHAPES = [(1, 64, 1, 1, 32), (2, 128, 2, 4, 64), (1, 96, 1, 8, 64),
                  (2, 256, 4, 2, 32), (1, 100, 2, 3, 48), (1, 77, 1, 8, 128),
                  (8, 1024, 4, 8, 64)]


@pytest.mark.parametrize("b,s,hkv,g,hd", PREFILL_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_prefill_kernel_equals_plain(dev, b, s, hkv, g, hd, dtype):
    """f32 within 2e-5, the reference's tolerance (the kernel's online
    softmax sums in another order than the plain version).  bf16 within one
    bf16 step: both sides compute in f32 on the same bf16 inputs and round
    once, so rtol 2^-7 of the value over an atol of 1e-5.  The last shape is
    tinyllama's prefill."""
    from repro_torch.kernels import flash_prefill as fp
    r = np.random.default_rng(b * s + hd + g)
    mk = (lambda *shape: torch.from_numpy(r.normal(size=shape).astype(
        np.float32)).to(dev, dtype))
    q, k, v = mk(b, s, hkv, g, hd), mk(b, s, hkv, hd), mk(b, s, hkv, hd)
    before = fp.flash_prefill.launches
    got = fp.flash_prefill(q, k, v)
    torch.cuda.synchronize()
    assert fp.flash_prefill.launches == before + 1
    want = fp.flash_prefill_plain(q, k, v)
    assert got.dtype == dtype and got.shape == q.shape
    rtol, atol = (2e-5, 2e-5) if dtype == torch.float32 else (2.0 ** -7, 1e-5)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def test_flash_prefill_kernel_is_causal(dev):
    from repro_torch.kernels import flash_prefill as fp
    g = torch.Generator(dev).manual_seed(11)
    q = torch.randn((1, 200, 2, 4, 64), device=dev, generator=g)
    k = torch.randn((1, 200, 2, 64), device=dev, generator=g)
    v = torch.randn((1, 200, 2, 64), device=dev, generator=g)
    out1 = fp.flash_prefill(q, k, v)
    k[:, 130:] = 77.0
    v[:, 130:] = -77.0
    out2 = fp.flash_prefill(q, k, v)
    assert torch.equal(out1[:, :130], out2[:, :130])


# ------------------------------------------------------------ gam_coarse


@pytest.mark.parametrize("b,d,v,lo,hi", [
    (1, 64, 500, -1, 2), (4, 128, 4096, -1, 2), (8, 32, 100, -1, 2),
    (2, 256, 2049, -1, 2), (3, 100, 33, -128, 128), (13, 300, 1001, -1, 2),
    (8, 2048, 32000, -1, 2), (8, 512, 32000, -1, 2)])
def test_gam_coarse_kernel_equals_plain(dev, b, d, v, lo, hi):
    """Within the rounding bound of two d-term f32 sums in other orders
    (``coarse_tolerance``); the last two shapes are tinyllama's head width
    at d 2048 and at the GAM head's d 512."""
    from repro_torch.kernels import gam_coarse as gc
    r = np.random.default_rng(b * d + v)
    h = torch.from_numpy(r.normal(size=(b, d)).astype(np.float32)).to(dev)
    pat = torch.from_numpy(r.integers(lo, hi, size=(d, v)).astype(
        np.int8)).to(dev)
    inv = torch.from_numpy(r.random(v).astype(np.float32)).to(dev)
    before = gc.gam_coarse.launches
    got = gc.gam_coarse(h, pat, inv)
    torch.cuda.synchronize()
    assert gc.gam_coarse.launches == before + 1
    want = gc.gam_coarse_plain(h, pat, inv)
    assert bool(((got - want).abs() <= gc.coarse_tolerance(h, pat,
                                                            inv)).all())


# ------------------------------------------------------------ sharded tier


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_sharded_retriever_on_card_equals_cpu(dev, quantize, tmp_path):
    """The service tier on the card answers like the same backend on the
    CPU, bit for bit: build, mutations, a background compaction, a
    repartition to narrow blocks (bn 8 and 16) and a snapshot round trip;
    ``gam_retrieve`` launches once per bn-group and once for the delta."""
    from repro_torch.kernels import gam_retrieve as gr
    items = unit_factors(700, 16, 5)
    users = unit_factors(24, 16, 6)
    spec = RetrieverSpec(cfg=CFG, backend="sharded", n_shards=4,
                         min_overlap=2, bucket=512, quantize=quantize,
                         rerank_factor=2,
                         options=(("compact_slice_rows", 128),
                                  ("rebalance_target_blocks", 16)))
    rs = {d: open_retriever(spec, items=items, device=d)
          for d in ("cpu", "cuda")}

    def same(tag, **kw):
        a = rs["cpu"].query(users, **kw)
        b = rs["cuda"].query(users, **kw)
        np.testing.assert_array_equal(a.ids, b.ids, err_msg=tag)
        np.testing.assert_array_equal(a.scores, b.scores, err_msg=tag)
        np.testing.assert_array_equal(a.n_scored, b.n_scored, err_msg=tag)

    same("build")
    same("build exact", exact=True)
    for r in rs.values():
        r.upsert(np.arange(690, 720), unit_factors(30, 16, 7))
        r.delete(np.arange(0, 700, 11))
    kernel = gr.gam_retrieve_q if quantize == "int8" else gr.gam_retrieve
    before = kernel.launches
    same("mutations")
    assert kernel.launches == before + 2       # one group + the delta
    for r in rs.values():
        r.compact(async_=True)
    while rs["cuda"].maintenance_stats()["compaction"]["active"]:
        same("mid-compaction")
    for lengths, bns in (((100, 200, 150, 200), (8, 16, 16, 64)),
                         ((300, 100, 100, 150), (16, 8, 8, 16))):
        for r in rs.values():
            ids, fac = r._catalog_arrays()
            part = type(r.base.partition).from_lengths(
                (lengths[0], lengths[1], lengths[2],
                 ids.size - sum(lengths[:3])), bns)
            r.compact(partition=part)
            r.upsert([5000], unit_factors(1, 16, 8))
        n_groups = len(rs["cuda"].base.metas)
        before = kernel.launches
        same(f"partition {bns}")
        assert kernel.launches == before + n_groups + 1
    # the repartitioner's own plan: 16 blocks a shard gives bn 8-16 here
    parts = [r.repartition(async_=False) for r in rs.values()]
    assert parts[0] == parts[1] and max(parts[1].bns) <= 16
    same("repartitioned")
    path = str(tmp_path / "sharded.npz")
    rs["cuda"].snapshot(path)
    back = open_retriever(spec, snapshot=path, device="cuda")
    a, b = back.query(users), rs["cpu"].query(users)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.scores, b.scores)
