"""``repro_torch.launch.steps`` against ``repro.launch.steps``: the abstract
specs (meta tensors against ``jax.eval_shape``, at the published widths of
every arch and every input shape, nothing allocated), the per-shape config
adaptation, and the serve steps (greedy, and the GAM head's coarse +
exact step) on ``tests/test_serving.py``'s small LM.

The GAM step is compared token for token.  A row may pick another token
only on a certified near-tie: on the reference's hidden state (in f64) the
|h| at the ``coarse_k`` boundary, the coarse scores at the ``budget``
boundary, or the two best exact logits lie within ``NEAR_TIE`` (relative)
of each other, where the packages' f32 sums in another order may cross.
Such rows are counted."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.registry import ARCH_IDS  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import get_reduced_config as jget_reduced  # noqa: E402,E501
from repro.configs.shapes import SHAPES as JSHAPES  # noqa: E402
from repro.core.tessellation import ternary_pattern  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

NEAR_TIE = 1e-4
CAPACITY = 32
_JPARAMS: dict = {}


def _leaves(tree, prefix=""):
    """path -> leaf, flattened as ``jax.tree_util`` flattens (sorted keys)."""
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree)
                for p, v in _leaves(tree[k], f"{prefix}[{k!r}]").items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {p: v for n in tree._fields
                for p, v in _leaves(getattr(tree, n), f"{prefix}.{n}").items()}
    return {prefix: tree}


def _same_specs(got, want):
    """Every leaf of the port's meta tree has the reference leaf's shape and
    dtype, and is a meta tensor (nothing allocated)."""
    g, w = _leaves(got), _leaves(want)
    assert list(g) == list(w)
    for path, spec in w.items():
        leaf = g[path]
        assert leaf.is_meta, path
        assert tuple(leaf.shape) == tuple(spec.shape), path
        assert str(leaf.dtype).removeprefix("torch.") == str(spec.dtype), path


def _reference_params(jcfg):
    if jcfg not in _JPARAMS:
        _JPARAMS[jcfg] = jsteps.abstract_params(JModel(jcfg))
    return _JPARAMS[jcfg]


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_specs_equal_eval_shape(arch, shape):
    jcfg = jsteps.shape_adapted_config(jget_config(arch), JSHAPES[shape])
    cfg = steps.shape_adapted_config(get_config(arch), SHAPES[shape])
    assert cfg.attn_kind == jcfg.attn_kind and cfg.window == jcfg.window
    sh = SHAPES[shape]
    _same_specs(steps.input_specs(cfg, sh),
                jsteps.input_specs(jcfg, JSHAPES[shape]))
    model = Model(cfg, device="cpu")
    params = steps.abstract_params(model)
    jparams = _reference_params(jcfg)
    _same_specs(params, jparams)
    _same_specs(steps.abstract_opt_state(params),
                jsteps.abstract_opt_state(jparams))
    if sh.kind != "train":
        _same_specs(steps.abstract_cache(model, sh.global_batch, sh.seq_len),
                    jsteps.abstract_cache(JModel(jcfg), sh.global_batch,
                                          sh.seq_len))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shape_adapted_config_and_decode_text_len(arch):
    for name in SHAPES:
        cfg = steps.shape_adapted_config(get_config(arch), SHAPES[name])
        jcfg = jsteps.shape_adapted_config(jget_config(arch), JSHAPES[name])
        assert cfg.__dict__ == jcfg.__dict__
        for s in (8, 33, 4_096, SHAPES[name].seq_len):
            assert steps.decode_text_len(cfg, s) == \
                jsteps.decode_text_len(jcfg, s)
    _same_specs(steps.gam_head_inputs(get_config(arch)),
                jsteps.gam_head_inputs(jget_config(arch)))


@pytest.fixture(scope="module")
def small_lm():
    """``tests/test_serving.py``'s small LM in both packages, with the same
    weights, and the GAM head's side inputs."""
    jcfg = jget_reduced("tinyllama-1.1b").with_(vocab=256)
    cfg = get_reduced_config("tinyllama-1.1b").with_(vocab=256)
    jm = JModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    params = params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    pat = ternary_pattern(jparams["lm_head"].T.astype(jnp.float32))
    nnz = jnp.sum(jnp.abs(pat.astype(jnp.float32)), axis=1)
    jgam = {"patterns": pat.T.astype(jnp.int8),
            "inv_sqrt_nnz": 1.0 / jnp.sqrt(jnp.maximum(nnz, 1.0))}
    gam = {k: torch.from_numpy(np.array(v)) for k, v in jgam.items()}
    return jm, jparams, jgam, Model(cfg, device="cpu"), params, gam


def _prompt(cfg, b, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, 12)).astype(
        np.int32)


def test_prefill_and_serve_steps_equal_the_model_calls(small_lm):
    jm, jparams, _, model, params, _ = small_lm
    tokens = _prompt(model.cfg, 3, 5)
    logits, cache = steps.make_prefill_step(model, CAPACITY)(
        params, {"tokens": tokens})
    want_logits, want_cache = model.prefill(params, {"tokens": tokens},
                                            CAPACITY)
    assert torch.equal(logits, want_logits)
    for k in cache:
        assert torch.equal(cache[k], want_cache[k]), k
    tok = torch.zeros((3, 1), dtype=torch.int32)
    step_logits, _ = model.decode_step(params, {k: v.clone() for k, v in
                                                want_cache.items()}, tok)
    nxt, cache = steps.make_serve_step(model)(params, cache, tok)
    assert nxt.dtype == torch.int32 and nxt.shape == (3, 1)
    assert torch.equal(nxt, torch.argmax(step_logits, dim=-1).int())
    assert int(cache["len"]) == 13
    # and the reference's serve step picks the same tokens
    _, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                           CAPACITY)
    jnxt, _ = jsteps.make_serve_step(jm)(jparams, jcache, jnp.asarray(tok))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))


def _near_tie(h, pattern, inv_nnz, embed, coarse_k, budget) -> bool:
    """On the reference's hidden state (f64): a boundary of the GAM step
    within NEAR_TIE relative."""
    def close(vals, i):
        v = np.sort(vals)[::-1]
        return abs(v[i - 1] - v[i]) <= NEAR_TIE * max(abs(v[0]), 1e-30)

    a = np.abs(h)
    cols = np.argsort(-a, kind="stable")[:coarse_k]
    coarse = (h[cols] @ pattern[cols].astype(np.float64)) * inv_nnz
    cand = np.argsort(-coarse, kind="stable")[:budget]
    exact = embed[cand] @ h
    return ((coarse_k < len(a) and close(a, coarse_k))
            or (budget < len(coarse) and close(coarse, budget))
            or close(exact, 1))


@pytest.mark.parametrize("coarse_k,budget", [(64, 128), (32, 16), (256, 256)])
def test_gam_serve_step_matches_reference(small_lm, coarse_k, budget):
    """Six teacher-forced decode steps at batch 8, both packages from the
    same cache: equal tokens except on counted near-ties."""
    jm, jparams, jgam, model, params, gam = small_lm
    b = 8
    tokens = _prompt(model.cfg, b, 7)
    jstep = jax.jit(jsteps.make_gam_serve_step(jm, coarse_k=coarse_k,
                                               budget=budget))
    tstep = steps.make_gam_serve_step(model, coarse_k=coarse_k,
                                      budget=budget)
    _, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                           CAPACITY)
    _, cache = model.prefill(params, {"tokens": tokens}, CAPACITY)
    pattern = np.asarray(jgam["patterns"], np.float64)          # (d, V)
    inv_nnz = np.asarray(jgam["inv_sqrt_nnz"], np.float64)
    embed = np.asarray(jparams["lm_head"], np.float64).T           # (V, d)
    feed = np.random.default_rng(8).integers(0, model.cfg.vocab, (6, b, 1))
    ties = same = 0
    for i in range(6):
        tok = feed[i].astype(np.int32)
        hidden, _ = jm.decode_step(jparams, jcache, jnp.asarray(tok),
                                   return_hidden=True)
        want, jcache = jstep(jparams, jgam, jcache, jnp.asarray(tok))
        got, cache = tstep(params, gam, cache, torch.from_numpy(tok))
        assert got.dtype == torch.int32 and got.shape == (b, 1)
        h = np.asarray(hidden, np.float64)[:, 0]
        for r in range(b):
            if int(got[r, 0]) == int(want[r, 0]):
                same += 1
                continue
            assert _near_tie(h[r], pattern, inv_nnz, embed, coarse_k,
                             budget), (i, r)
            ties += 1
    print(f"coarse_k {coarse_k} budget {budget}: {same} equal, {ties} "
          "certified near-ties")
    assert same >= 44


def test_top_k_breaks_ties_toward_the_lower_index():
    x = np.array([[1.0, 3.0, 3.0, 0.0, 3.0, 1.0, 0.0, 0.0]], np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(x), 6)[1])
    np.testing.assert_array_equal(steps._top_k(torch.from_numpy(x), 6).numpy(),
                                  want)
    np.testing.assert_array_equal(want, [[1, 2, 4, 0, 5, 3]])
