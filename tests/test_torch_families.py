"""The port's other LM families against the JAX reference Model: MoE
(olmoe-1b-7b), MLA + MoE with shared experts (deepseek-v2-236b), SSM
(mamba2-780m), the RG-LRU hybrid (recurrentgemma-9b), encoder-decoder
(whisper-tiny) and VLM (internvl2-26b), at each family's ``reduced()``
config in f32.

Both packages get the same weights: the reference initialises its tree, the
norm scales, biases and the leaves the reference keeps in f32 (the SSM's A,
D and dt bias, the RG-LRU's gate biases and Lambda, ...) are replaced by
seeded random values, and ``models/convert.py`` carries the tree into the
port.  Tokens, frames and image embeddings are made with numpy from a seed.

Tolerance: f32 logits, aux losses, cache leaves and hidden states within
1e-4 (absolute and relative), as ``test_torch_models.py`` states it: the two
packages run the same f32 arithmetic in another order (XLA's dot against
torch's matmul, scans against loops, XLA's associative-scan tree against
the port's doubling scan), which moves a value of order 1 by a few 1e-6 per
layer.  Routing (which experts, which pairs kept) and greedy tokens must be
equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.configs.registry import ARCH_IDS  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import ServeConfig as JServeConfig  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import (params_from_reference,  # noqa: E402
                                        params_to_reference)
from repro_torch.models.layers import F32_LEAVES  # noqa: E402
from repro_torch.serving import Engine, ServeConfig  # noqa: E402

TOL = 1e-4
VOCAB = 96

# (name, arch, overrides): every family at its reduced config; the decode
# kernel's plain version where the reference takes the kernel branch; a
# hybrid with a tail of two rec blocks
CASES = [
    ("olmoe", "olmoe-1b-7b", {}),
    ("olmoe-kernel", "olmoe-1b-7b", dict(use_decode_kernel=True)),
    ("deepseek-v2-mla", "deepseek-v2-236b", {}),
    ("mamba2", "mamba2-780m", {}),
    ("recurrentgemma", "recurrentgemma-9b", {}),
    ("recurrentgemma-tail", "recurrentgemma-9b", dict(n_layers=5)),
    ("whisper", "whisper-tiny", {}),
    ("whisper-kernel", "whisper-tiny", dict(use_decode_kernel=True)),
    ("internvl2", "internvl2-26b", {}),
    ("internvl2-kernel", "internvl2-26b", dict(use_decode_kernel=True)),
]
IDS = [c[0] for c in CASES]
# leaves given seeded values around their init (scale-like ones around 1)
_ONES = {"scale", "q_norm", "kv_norm", "norm", "d_skip"}
_PERTURBED = _ONES | {"bias", "bq", "bk", "bv", "conv_b", "a_log", "dt_bias",
                      "b_a", "b_i", "lam"}
_MODELS: dict = {}


def _perturb(tree, rng):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _perturb(val, rng)
            continue
        a = np.array(val, np.float32)
        if key in _PERTURBED:
            base = 1.0 if key in _ONES else a
            a = (base + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        out[key] = a
    return out


def _cfgs(arch, overrides, dtype="float32"):
    kw = dict(vocab=VOCAB, dtype=dtype, **overrides)
    jcfg = jreduced(jget_config(arch)).with_(**kw)
    tcfg = reduced(get_config(arch)).with_(**kw)
    assert jcfg == jcfg.__class__(**{f: getattr(tcfg, f)
                                     for f in tcfg.__dataclass_fields__})
    return jcfg, tcfg


def _models(name):
    """(jcfg, jmodel, jparams, model, params, tree) of a case, built once."""
    if name not in _MODELS:
        _, arch, overrides = CASES[IDS.index(name)]
        jcfg, tcfg = _cfgs(arch, overrides)
        jm = JModel(jcfg)
        tree = _perturb(jax.tree.map(np.asarray,
                                     jm.init(jax.random.PRNGKey(0))),
                        np.random.default_rng(1))
        jparams = jax.tree.map(jnp.asarray, tree)
        tm = Model(tcfg, device="cpu")
        _MODELS[name] = (jcfg, jm, jparams, tm,
                         params_from_reference(tree, tcfg, device="cpu"),
                         tree)
    return _MODELS[name]


def _batch(cfg, b, s, seed):
    """numpy inputs: tokens and the family's extras, as the reference's
    launcher makes them (frames of 4 per token)."""
    r = np.random.default_rng(seed)
    batch = {"tokens": r.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = r.normal(size=(b, 4 * s, cfg.d_frontend)).astype(
            np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = r.normal(
            size=(b, cfg.n_image_tokens, cfg.d_frontend)).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _flat(sub, prefix + (k,)).items()}
    return {prefix: tree}


def _close_caches(tcache, jcache):
    t, j = _flat(tcache), _flat(jax.tree.map(np.asarray, jcache))
    assert set(t) == set(j)
    for path, want in j.items():
        got = t[path]
        assert tuple(got.shape) == want.shape, path
        assert got.dtype == {np.dtype(np.float32): torch.float32,
                             np.dtype(np.int32): torch.int32}[want.dtype], path
        _close(got.numpy(), want)


@pytest.mark.parametrize("name", IDS)
def test_forward_matches_reference(name):
    jcfg, jm, jparams, tm, tparams, _ = _models(name)
    batch = _batch(jcfg, 2, 12, 3)
    jl, jaux = jax.jit(jm.forward)(jparams, _j(batch))
    tl, aux = tm.forward(tparams, _t(batch))
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    _close(tl.numpy(), jl)
    _close(aux.numpy(), jaux)
    assert (float(aux) > 0) == (jcfg.family == "moe")


@pytest.mark.parametrize("name", IDS)
def test_prefill_cache_and_decode_steps_match_reference(name):
    """Prefill (last logits and every cache leaf), then teacher-forced
    decode steps (logits, hidden states) and the cache after them.  The
    hybrid's prompt passes its ring of 16 slots, so the ring wraps in the
    prefill and again while decoding."""
    jcfg, jm, jparams, tm, tparams, _ = _models(name)
    prompt, capacity, steps = 20, 32, 4
    batch = _batch(jcfg, 3, prompt, 4)
    jl, jcache = jax.jit(lambda p, b: jm.prefill(p, b, capacity))(
        jparams, _j(batch))
    tl, tcache = tm.prefill(tparams, _t(batch), capacity)
    _close(tl.numpy(), jl)
    _close_caches(tcache, jcache)
    jstep = jax.jit(jm.decode_step)
    jhidden = jax.jit(lambda p, c, t: jm.decode_step(p, c, t,
                                                     return_hidden=True))
    feed = _batch(jcfg, 3, steps, 5)["tokens"]
    for i in range(steps):
        tok = feed[:, i:i + 1]
        jh, _ = jhidden(jparams, jcache, jnp.asarray(tok))
        jl, jcache = jstep(jparams, jcache, jnp.asarray(tok))
        snapshot = jax.tree.map(lambda t: t.clone(), tcache)
        th, _ = tm.decode_step(tparams, snapshot, torch.from_numpy(tok),
                               return_hidden=True)
        tl, tcache = tm.decode_step(tparams, tcache, torch.from_numpy(tok))
        _close(th.numpy(), jh)
        _close(tl.numpy(), jl)
    _close_caches(tcache, jcache)
    assert int(tcache["len"]) == int(jcache["len"])


@pytest.mark.parametrize("name", IDS)
def test_prefill_then_decode_equals_forward(name):
    """The serving invariant inside the port: decode logits = the forward's
    last position (the reduced MoE configs are dropless, E / K)."""
    jcfg, _, _, tm, tparams, _ = _models(name)
    batch = _t(_batch(jcfg, 2, 14, 6))
    full, _ = tm.forward(tparams, batch)
    prompt = dict(batch, tokens=batch["tokens"][:, :10])
    logits, cache = tm.prefill(tparams, prompt, 16 + tm.n_prefix())
    _close(logits[:, 0].numpy(), full[:, -5].numpy())
    for t in range(10, 14):
        logits, cache = tm.decode_step(tparams, cache,
                                       batch["tokens"][:, t:t + 1])
        _close(logits[:, 0].numpy(), full[:, t - 14].numpy())


@pytest.mark.parametrize("name", IDS)
def test_generate_tokens_match_reference(name):
    jcfg, jm, jparams, tm, tparams, _ = _models(name)
    batch = _batch(jcfg, 2, 6, 7)
    capacity = 6 + 8 + 8 + tm.n_prefix()
    want = JEngine(jcfg, jparams, JServeConfig(max_new_tokens=8),
                   capacity=capacity).generate(_j(batch))
    got = Engine(tm.cfg, tparams, ServeConfig(max_new_tokens=8),
                 capacity=capacity, device="cpu").generate(_t(batch))
    np.testing.assert_array_equal(got.tokens, want.tokens)


@pytest.mark.parametrize("name", IDS)
def test_convert_round_trip_exact(name):
    *_, tm, tparams, tree = _models(name)
    back = params_to_reference(tparams)
    assert set(_flat(back)) == set(_flat(tree))
    for path, a in _flat(tree).items():
        np.testing.assert_array_equal(_flat(back)[path], a)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_tree_is_the_references_leaf_for_leaf(arch):
    """Model.init at bf16 gives the reference's tree: the same paths,
    shapes and dtypes, f32 exactly where the reference keeps f32."""
    jcfg, tcfg = _cfgs(arch, {}, dtype="bfloat16")
    jtree = _flat(jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0)))
    ttree = _flat(Model(tcfg, device="cpu").init(0))
    assert set(ttree) == set(jtree)
    for path, want in jtree.items():
        got = ttree[path]
        assert tuple(got.shape) == want.shape, path
        assert str(got.dtype).split(".")[-1] == str(want.dtype), path


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-236b",
                                  "mamba2-780m", "recurrentgemma-9b"])
def test_convert_keeps_the_references_f32_leaves_f32(arch):
    """Under a bf16 config the router, the SSM's A / D / dt bias and the
    RG-LRU's gate biases and Lambda stay f32 (a bf16 router would pick other
    experts), every other float leaf becomes bf16; Model.init agrees."""
    jcfg, tcfg = _cfgs(arch, {}, dtype="bfloat16")
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    got = _flat(params_from_reference(tree, tcfg, device="cpu"))
    init = _flat(Model(tcfg, device="cpu").init(0))
    f32 = [p for p in got if p[-1] in F32_LEAVES]
    assert f32
    for path, want in _flat(jparams).items():
        dt = torch.float32 if want.dtype == jnp.float32 else torch.bfloat16
        assert got[path].dtype == init[path].dtype == dt, path
        assert (dt == torch.float32) == (path in f32), path
        np.testing.assert_array_equal(got[path].float().numpy(),
                                      np.asarray(want, np.float32))


# ------------------------------------------------------------- modules


def _moe_params(cfg, seed, tie=False, concentrate=0.0):
    from repro.models.moe import moe_init
    p = jax.tree.map(np.array, moe_init(jax.random.PRNGKey(seed), cfg,
                                        jnp.float32))
    if concentrate:
        p["router"][:, 0] += concentrate     # most tokens prefer expert 0
    if tie:
        p["router"][:, 2] = p["router"][:, 1]   # equal probabilities
    return p


def _jax_routing(params, x, cfg):
    """The reference's routing steps (``repro.models.moe.moe_ffn`` up to the
    dispatch): expert ids (T, K) and, per (token, slot) pair, kept or not."""
    t, e, k = x.shape[0] * x.shape[1], cfg.n_experts, cfg.moe_top_k
    xt = jnp.asarray(x).reshape(t, -1)
    probs = jax.nn.softmax(xt @ jnp.asarray(params["router"]), axis=-1)
    gate, idx = jax.lax.top_k(probs, k)
    gate = gate / jnp.sum(gate, -1, keepdims=True)
    capacity = int(max(1, cfg.capacity_factor * t * k / e))
    fe, fg = idx.reshape(-1), gate.reshape(-1)
    order = jnp.argsort(fe.astype(jnp.float32) * 2.0 - fg / (jnp.max(fg)
                                                            + 1e-9))
    se = fe[order]
    i = jnp.arange(t * k)
    start = jax.lax.associative_scan(jnp.maximum, jnp.where(
        jnp.concatenate([jnp.ones(1, bool), se[1:] != se[:-1]]), i, -1))
    keep = np.zeros(t * k, bool)
    keep[np.asarray(order)] = np.asarray(i - start < capacity)
    return np.asarray(idx), keep


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-236b"])
def test_moe_ffn_drops_the_same_pairs_as_reference(arch, tie):
    """capacity_factor 1.0 and a router that sends most tokens to expert 0:
    pairs are dropped.  The experts picked, the pairs kept, the output and
    the aux loss match the reference.  With ``tie``, experts 1 and 2 have
    equal probabilities (top-k keeps the lower index) and tokens repeat, so
    equal gates compete for one expert's capacity (pair order decides)."""
    from repro.models.moe import moe_ffn as jmoe
    from repro_torch.models.moe import moe_ffn, route
    jcfg, tcfg = _cfgs(arch, dict(capacity_factor=1.0))
    params = _moe_params(jcfg, 2, tie=tie, concentrate=0.5)
    x = np.random.default_rng(3).normal(size=(2, 8, jcfg.d_model)).astype(
        np.float32)
    if tie:
        x[:, 4:] = x[:, :4]
    want_idx, want_keep = _jax_routing(params, x, jcfg)
    tp = jax.tree.map(torch.from_numpy, params)
    r = route(tp, torch.from_numpy(x).reshape(16, -1), tcfg)
    keep = np.zeros(16 * tcfg.moe_top_k, bool)
    keep[r.order.numpy()] = r.keep.numpy()
    np.testing.assert_array_equal(r.expert.numpy(), want_idx)
    np.testing.assert_array_equal(keep, want_keep)
    assert 0 < int((~r.keep).sum()) == int((~want_keep).sum())
    jout, jaux = jmoe(jax.tree.map(jnp.asarray, params), jnp.asarray(x), jcfg)
    out, aux = moe_ffn(tp, torch.from_numpy(x), tcfg)
    _close(out.numpy(), jout)
    _close(aux.numpy(), jaux)


@pytest.mark.parametrize("length", [64, 32, 50])
def test_ssd_chunked_matches_reference(length):
    """Chunks of 32: two chunks, one, and a length the chunk does not divide
    (the whole sequence becomes one chunk)."""
    from repro.models.ssm import _ssd_chunked as jssd
    from repro_torch.models.ssm import _ssd_chunked
    jcfg, tcfg = _cfgs("mamba2-780m", {})
    r = np.random.default_rng(length)
    h, p, g, n = jcfg.ssm_heads, jcfg.ssm_head_dim, jcfg.ssm_groups, \
        jcfg.ssm_state
    x = r.normal(size=(2, length, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(r.normal(size=(2, length, h)))).astype(np.float32)
    a = -np.exp(0.3 * r.normal(size=(h,))).astype(np.float32)
    b_mat, c_mat = (r.normal(size=(2, length, g, n)).astype(np.float32)
                    for _ in range(2))
    jy, js = jssd(*(jnp.asarray(v) for v in (x, dt, a, b_mat, c_mat)), jcfg)
    ty, ts = _ssd_chunked(*(torch.from_numpy(v) for v in
                            (x, dt, a, b_mat, c_mat)), tcfg)
    assert np.isfinite(ty.numpy()).all()
    _close(ty.numpy(), jy)
    _close(ts.numpy(), js)


def test_rglru_train_at_odd_length_and_tanh_gelu_match_reference():
    """An odd L (37: the doubling scan's last round is partial) with the
    state it returns, and the tanh-approximate GELU of ``jax.nn.gelu``."""
    from repro.models.rglru import rglru_init, rglru_train as jtrain
    from repro_torch.models.layers import gelu_tanh
    from repro_torch.models.rglru import rglru_train
    jcfg, tcfg = _cfgs("recurrentgemma-9b", {})
    params = _perturb(jax.tree.map(np.asarray, rglru_init(
        jax.random.PRNGKey(4), jcfg, jnp.float32)), np.random.default_rng(5))
    u = np.random.default_rng(6).normal(size=(2, 37, jcfg.d_model)).astype(
        np.float32)
    jout, (jconv, jh) = jtrain(jax.tree.map(jnp.asarray, params),
                               jnp.asarray(u), jcfg, return_state=True)
    out, (conv, h) = rglru_train(jax.tree.map(torch.from_numpy, params),
                                 torch.from_numpy(u), tcfg, return_state=True)
    _close(out.numpy(), jout)
    _close(conv.numpy(), jconv)
    _close(h.numpy(), jh)
    z = np.linspace(-6, 6, 1001, dtype=np.float32)
    np.testing.assert_allclose(gelu_tanh(torch.from_numpy(z)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(z))),
                               rtol=1e-6, atol=1e-6)


def test_mla_decode_equals_mla_train_and_reference():
    """Absorbed-matrix decode against the latent cache = the materialised
    per-head attention of ``mla_train`` at each position, and = the
    reference's ``mla_decode``."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    jcfg, tcfg = _cfgs("deepseek-v2-236b", {})
    params = _perturb(jax.tree.map(np.asarray, jattn.mla_init(
        jax.random.PRNGKey(7), jcfg, jnp.float32)), np.random.default_rng(8))
    tp = jax.tree.map(torch.from_numpy, params)
    jp = jax.tree.map(jnp.asarray, params)
    x = np.random.default_rng(9).normal(size=(2, 9, jcfg.d_model)).astype(
        np.float32)
    full, (c_kv, k_rope) = tattn.mla_train(tp, torch.from_numpy(x), tcfg,
                                           return_latent=True)
    _close(full.numpy(), jattn.mla_train(jp, jnp.asarray(x), jcfg))
    cap, pre = 12, 6
    cache = {"c_kv": torch.zeros((2, cap, tcfg.kv_lora)),
             "k_rope": torch.zeros((2, cap, tcfg.qk_rope_dim)),
             "len": torch.tensor(pre, dtype=torch.int32)}
    cache["c_kv"][:, :pre] = c_kv[:, :pre]
    cache["k_rope"][:, :pre] = k_rope[:, :pre]
    jcache = jax.tree.map(lambda t: jnp.asarray(t.numpy()), cache)
    for t in range(pre, 9):
        out, cache = tattn.mla_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                      tcfg, dict(cache))
        jout, jcache = jattn.mla_decode(jp, jnp.asarray(x[:, t:t + 1]), jcfg,
                                        jcache)
        _close(out[:, 0].numpy(), full[:, t].numpy())
        _close(out.numpy(), jout)
        cache["len"] = cache["len"] + 1
        jcache = dict(jcache, len=jcache["len"] + 1)
    _close(cache["c_kv"].numpy(), jcache["c_kv"])
    _close(cache["k_rope"].numpy(), jcache["k_rope"])


def test_cross_attention_and_encode_kv_match_reference():
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    jcfg, tcfg = _cfgs("whisper-tiny", {})
    params = jax.tree.map(np.asarray, jattn.cross_attn_init(
        jax.random.PRNGKey(10), jcfg, jnp.float32))
    r = np.random.default_rng(11)
    enc = r.normal(size=(2, 23, jcfg.d_model)).astype(np.float32)
    x = r.normal(size=(2, 5, jcfg.d_model)).astype(np.float32)
    jp, tp = (jax.tree.map(jnp.asarray, params),
              jax.tree.map(torch.from_numpy, params))
    jkv = jattn.encode_kv(jp, jnp.asarray(enc), jcfg)
    tkv = tattn.encode_kv(tp, torch.from_numpy(enc), tcfg)
    for got, want in zip(tkv, jkv):
        _close(got.numpy(), want)
    _close(tattn.cross_attention(tp, torch.from_numpy(x), tkv, tcfg).numpy(),
           jattn.cross_attention(jp, jnp.asarray(x), jkv, jcfg))


def test_prefill_counts_image_tokens_against_capacity():
    jcfg, _, _, tm, tparams, _ = _models("internvl2")
    batch = _t(_batch(jcfg, 1, 6, 12))
    _, cache = tm.prefill(tparams, batch, 6 + jcfg.n_image_tokens)
    assert int(cache["len"]) == 6 + jcfg.n_image_tokens
    with pytest.raises(ValueError, match="image tokens included"):
        tm.prefill(tparams, batch, 6 + jcfg.n_image_tokens - 1)
