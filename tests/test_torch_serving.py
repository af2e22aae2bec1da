"""The port's serving engine and GAM LM head against the JAX reference.

The fixture is the reference suite's (``tests/test_serving.py``): reduced
tinyllama-1.1b at vocab 256, weights from the reference's init carried into
the port by ``models/convert.py``.  Prompts and hidden states are made with
numpy from a seed.

What must match: greedy tokens exactly (ties go to the lowest vocab id in
both packages); the GAM head's candidate masks, top-kappa ids and the
engine's ``n_scored_vocab`` / ``discard_frac`` exactly; top-kappa scores
within 4 ulp of each query's dot-product scale (the reference's XLA dot and
the port's fused multiply-add loop sum in different orders, see
``assert_scores_close`` in ``tests/test_torch_gam_retrieve.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.registry import get_reduced_config as jget_reduced  # noqa: E402
from repro.core.retrieval import masked_topk as jmasked_topk  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import GamHead as JGamHead  # noqa: E402
from repro.serving import ServeConfig as JServeConfig  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.core.retrieval import masked_topk  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.serving import Engine, GamHead, ServeConfig  # noqa: E402

ULP = 4


@pytest.fixture(scope="module")
def small_lm():
    jcfg = jget_reduced("tinyllama-1.1b").with_(vocab=256)
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_reduced_config("tinyllama-1.1b").with_(vocab=256)
    params = params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def heads(small_lm):
    """Both packages' GAM heads over lm_head.T, at the engine's defaults."""
    jcfg, jparams, cfg, params = small_lm
    jhead = JGamHead.build(jparams["lm_head"].T, threshold=1.5, min_overlap=2)
    head = GamHead.build(params["lm_head"].T, threshold=1.5, min_overlap=2,
                         device="cpu")
    return jhead, head


def assert_scores_close(got, want, users, items):
    """(Q, kappa) scores within 4 ulp of each query's dot-product scale."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = (np.linalg.norm(np.asarray(users, np.float64), axis=1)
             * np.linalg.norm(np.asarray(items, np.float64), axis=1).max())
    tol = ULP * np.spacing(scale.astype(np.float32))[:, None]
    bad = np.abs(got.astype(np.float64) - want) > tol
    assert not bad.any(), (got[bad][:5], want[bad][:5])


def _prompt(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("kernel", [False, True], ids=["einsum", "kernel"])
def test_engine_greedy_tokens_equal_reference(small_lm, kernel):
    jcfg, jparams, cfg, params = small_lm
    prompt = _prompt(cfg.vocab, 3, 12, 0)
    want = JEngine(jcfg, jparams, JServeConfig(max_new_tokens=6),
                   capacity=64).generate({"tokens": jnp.asarray(prompt)})
    eng = Engine(cfg.with_(use_decode_kernel=kernel), params,
                 ServeConfig(max_new_tokens=6), capacity=64, device="cpu")
    got = eng.generate({"tokens": torch.from_numpy(prompt)})
    assert got.tokens.shape == (3, 6) and got.tokens.dtype == np.int32
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.n_scored_vocab == want.n_scored_vocab == float(cfg.vocab)
    assert got.discard_frac == want.discard_frac == 0.0
    assert got.prefill_ms is None and got.step_ms is None     # CPU: no events


def test_engine_greedy_ties_go_to_lowest_id(small_lm):
    """An unembedding with duplicated rows makes exact logit ties; both
    packages must pick the lowest of the tied ids."""
    jcfg, jparams, cfg, params = small_lm
    lm = np.asarray(jparams["lm_head"]).copy()
    lm[:, 128:] = lm[:, :128]                # id j + 128 ties with id j
    jp = dict(jparams, lm_head=jnp.asarray(lm))
    tp = dict(params, lm_head=torch.from_numpy(lm))
    prompt = _prompt(cfg.vocab, 4, 8, 2)
    want = JEngine(jcfg, jp, JServeConfig(max_new_tokens=5),
                   capacity=32).generate({"tokens": jnp.asarray(prompt)})
    got = Engine(cfg, tp, ServeConfig(max_new_tokens=5), capacity=32,
                 device="cpu").generate({"tokens": torch.from_numpy(prompt)})
    assert (got.tokens < 128).all()
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_gam_head_candidates_topk_equal_reference(small_lm, heads):
    jcfg, jparams, cfg, params = small_lm
    jhead, head = heads
    h = np.random.default_rng(1).normal(size=(8, cfg.d_model)).astype(
        np.float32)
    jmask = np.asarray(jhead.candidates(jnp.asarray(h)))
    mask = head.candidates(torch.from_numpy(h))
    np.testing.assert_array_equal(mask.numpy(), jmask)
    assert 0 < jmask.sum() < jmask.size      # something kept, something not
    jvals, jids, _ = jhead.topk(jnp.asarray(h), 8)
    vals, ids, mask2 = head.topk(torch.from_numpy(h), 8)
    np.testing.assert_array_equal(mask2.numpy(), jmask)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    embed = np.asarray(jparams["lm_head"]).T
    assert_scores_close(vals.numpy(), np.asarray(jvals), h, embed)
    # the same as the dense oracle on the same masks
    o_vals, o_ids = masked_topk(torch.from_numpy(h), head.raw_embed, mask, 8)
    np.testing.assert_array_equal(o_ids.numpy(), ids.numpy())
    j_o_vals, j_o_ids = jmasked_topk(jnp.asarray(h), jnp.asarray(embed),
                                     jnp.asarray(jmask), 8)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_o_ids))
    disc = head.discard_fraction(torch.from_numpy(h)).numpy()
    np.testing.assert_array_equal(disc, np.asarray(jhead.discard_fraction(
        jnp.asarray(h))))
    evals, eids, none = head.topk(torch.from_numpy(h), 8, exact=True)
    jevals, jeids, _ = jhead.topk(jnp.asarray(h), 8, exact=True)
    assert none is None
    np.testing.assert_array_equal(eids.numpy(), np.asarray(jeids))
    assert_scores_close(evals.numpy(), np.asarray(jevals), h, embed)


def test_gam_head_index_equals_reference(heads):
    """The vocab index: the same unit rows, patterns and posting table."""
    jhead, head = heads
    np.testing.assert_array_equal(head.embed.numpy(), np.asarray(jhead.embed))
    np.testing.assert_array_equal(head.raw_embed.numpy(),
                                  np.asarray(jhead.raw_embed))
    assert head.cfg.k == jhead.cfg.k and head.cfg.p == jhead.cfg.p
    assert head.cfg.threshold == jhead.cfg.threshold
    np.testing.assert_array_equal(head.index.table.numpy(),
                                  np.asarray(jhead.index.table))
    np.testing.assert_array_equal(head.index.spill.numpy(),
                                  np.asarray(jhead.index.spill))


def test_engine_gam_head_equals_reference(small_lm):
    jcfg, jparams, cfg, params = small_lm
    prompt = _prompt(cfg.vocab, 4, 10, 1)
    sc = dict(max_new_tokens=8, use_gam_head=True, gam_threshold=1.5,
              gam_min_overlap=2)
    want = JEngine(jcfg, jparams, JServeConfig(**sc), capacity=64).generate(
        {"tokens": jnp.asarray(prompt)})
    got = Engine(cfg.with_(use_decode_kernel=True), params, ServeConfig(**sc),
                 capacity=64, device="cpu").generate(
        {"tokens": torch.from_numpy(prompt)})
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.n_scored_vocab == want.n_scored_vocab
    assert got.discard_frac == want.discard_frac
    assert 0.0 < got.discard_frac < 1.0


def test_gam_head_snapshot_restores_the_same_masks(tmp_path, heads):
    from repro_torch.retriever import open_retriever
    _, head = heads
    path = str(tmp_path / "vocab.npz")
    head.snapshot(path)
    again = open_retriever(head.retriever.spec, snapshot=path, device="cpu")
    h = np.random.default_rng(3).normal(size=(4, head.cfg.k)).astype(
        np.float32)
    hn = torch.from_numpy(h / (np.linalg.norm(h, axis=1, keepdims=True)
                               + 1e-9))
    np.testing.assert_array_equal(again.candidate_masks(hn).numpy(),
                                  head.retriever.candidate_masks(hn).numpy())


def test_engine_temperature_sampling_is_seeded(small_lm):
    _, _, cfg, params = small_lm
    eng = Engine(cfg, params, ServeConfig(max_new_tokens=5, temperature=0.8),
                 capacity=32, device="cpu")
    prompt = {"tokens": torch.from_numpy(_prompt(cfg.vocab, 2, 6, 4))}
    a, b = eng.generate(prompt, seed=7), eng.generate(prompt, seed=7)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert ((a.tokens >= 0) & (a.tokens < cfg.vocab)).all()
