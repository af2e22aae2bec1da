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


def test_gam_retrieve_kernel_rejects_large_kappa(dev):
    items = torch.from_numpy(unit_factors(64, 16, 1)).to(dev)
    cfg = GamConfig(k=16)
    tau, vals = sparse_map(items, cfg)
    meta = gr.build_retrieval_meta(tau, vals != 0, cfg.p, bn=32, device=dev)
    with pytest.raises(ValueError):
        gr.gam_retrieve(items[:2].contiguous(), items, tau[:2].contiguous(),
                        (vals[:2] != 0).contiguous(), meta,
                        gr.GAM_RETRIEVE_MAX_KAPPA + 1)


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


def test_gam_retrieve_q_kernel_rejects_wide_pool(dev):
    _, users, q_tau, q_vals, meta = _catalog(dev, 600, 3, 64, 32, "int8")
    with pytest.raises(ValueError, match="GAM_RETRIEVE_MAX_KAPPA"):
        gr.gam_retrieve_q(users, q_tau, q_vals != 0, meta,
                          gr.GAM_RETRIEVE_MAX_KAPPA + 1)


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
