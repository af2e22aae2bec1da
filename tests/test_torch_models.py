"""The port's dense-family Model against the JAX reference Model.

Both packages get the same weights: the reference initialises its tree, the
norm scales and biases are replaced by seeded random values (so they are
exercised, not left at 1 and 0), and ``models/convert.py`` carries the tree
into the port.  Tokens are made with numpy from a seed.

Tolerance: f32 logits, cache entries and hidden states within 1e-4
(absolute and relative).  The two packages run the same f32 arithmetic in a
different order (XLA's dot against torch's matmul over d_model and d_ff,
scans against loops), which moves a value of order 1 by a few 1e-6 per
layer; 1e-4 leaves a factor of ten over the drift of these two-layer
models.  Where bf16 enters, 5e-2: the bf16 model (the dtype served on the
card) rounds its residual stream to bf16 in each layer (relative step 2^-8),
and the ``attn_f32=False`` knob keeps the prefill's scores and
probabilities in bf16; the two frameworks round at different places.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import (params_from_reference,  # noqa: E402
                                        params_to_reference)

TOL = 1e-4
BF16_TOL = 5e-2

# (name, arch, overrides): reduced configs of the dense family
CASES = [
    ("tinyllama-g8", "tinyllama-1.1b", dict(n_heads=8, n_kv_heads=1)),
    ("tinyllama-g8-kernel", "tinyllama-1.1b",
     dict(n_heads=8, n_kv_heads=1, use_decode_kernel=True)),
    ("tinyllama-padded-vocab", "tinyllama-1.1b",
     dict(n_heads=8, n_kv_heads=2, vocab=600, q_chunk=8)),
    ("qwen2-bias-tied", "qwen2-1.5b", dict(use_decode_kernel=True)),
    ("olmo-ln-nonparam", "olmo-1b", dict(q_chunk=8, attn_truncate=True)),
    ("tinyllama-ln", "tinyllama-1.1b", dict(norm="ln", attn_f32=False)),
]
IDS = [c[0] for c in CASES]


def _perturb(tree, rng):
    """Seeded random norm scales / biases, on a numpy copy of the tree."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _perturb(val, rng)
            continue
        a = np.asarray(val, np.float32)
        if key in ("scale", "bias", "bq", "bk", "bv"):
            base = 1.0 if key == "scale" else 0.0
            a = (base + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        out[key] = a
    return out


def _models(arch, overrides, dtype="float32"):
    jcfg = jreduced(jget_config(arch)).with_(dtype=dtype, **overrides)
    tcfg = reduced(get_config(arch)).with_(dtype=dtype, **overrides)
    assert jcfg == jcfg.__class__(**{f: getattr(tcfg, f)
                                     for f in tcfg.__dataclass_fields__})
    jm = JModel(jcfg)
    tree = _perturb(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))),
                    np.random.default_rng(1))
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jdt), tree)
    tm = Model(tcfg, device="cpu")
    tparams = params_from_reference(tree, tcfg, device="cpu")
    return jcfg, jm, jparams, tm, tparams, tree


def _tol(overrides) -> float:
    return TOL if overrides.get("attn_f32", True) else BF16_TOL


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("name,arch,overrides", CASES, ids=IDS)
def test_convert_round_trip_exact(name, arch, overrides):
    *_, tm, tparams, tree = _models(arch, overrides)
    back = params_to_reference(tparams)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(flat_b[path], a)
    again = params_from_reference(back, tm.cfg, device="cpu")
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(tparams),
                                jax.tree_util.tree_leaves_with_path(again)):
        assert pa == pb and torch.equal(a, b)


@pytest.mark.parametrize("name,arch,overrides", CASES, ids=IDS)
def test_forward_matches_reference(name, arch, overrides):
    jcfg, jm, jparams, tm, tparams, _ = _models(arch, overrides)
    tokens = _tokens(jcfg, 2, 16, 3)
    jl, _ = jax.jit(jm.forward)(jparams, {"tokens": jnp.asarray(tokens)})
    tl, aux = tm.forward(tparams, {"tokens": torch.from_numpy(tokens)})
    assert tl.shape == (2, 16, jcfg.vocab_padded) and tl.dtype == torch.float32
    assert float(aux) == 0.0
    _close(tl.numpy(), jl, _tol(overrides))
    if jcfg.vocab_padded != jcfg.vocab:
        assert (tl[..., jcfg.vocab:] == -1e30).all()


@pytest.mark.parametrize("name,arch,overrides", CASES, ids=IDS)
def test_prefill_and_decode_steps_match_reference(name, arch, overrides):
    """Prefill (last logits and the padded cache), then decode steps that
    run past the cache's capacity (the write slot clamps to capacity - 1)."""
    jcfg, jm, jparams, tm, tparams, _ = _models(arch, overrides)
    prompt, capacity, steps = 10, 12, 4
    tokens = _tokens(jcfg, 3, prompt, 4)
    jl, jcache = jax.jit(lambda p, b: jm.prefill(p, b, capacity))(
        jparams, {"tokens": jnp.asarray(tokens)})
    tl, tcache = tm.prefill(tparams, {"tokens": torch.from_numpy(tokens)},
                            capacity)
    tol = _tol(overrides)
    _close(tl.numpy(), jl, tol)
    for name_ in ("k", "v"):
        assert tcache[name_].shape == jcache[name_].shape
        _close(tcache[name_].numpy(), jcache[name_], tol)
    assert int(tcache["len"]) == int(jcache["len"]) == prompt
    jstep = jax.jit(jm.decode_step)
    jhidden = jax.jit(lambda p, c, t: jm.decode_step(p, c, t,
                                                     return_hidden=True))
    feed = _tokens(jcfg, 3, steps, 5)
    for i in range(steps):
        tok = feed[:, i:i + 1]
        jh, _ = jhidden(jparams, jcache, jnp.asarray(tok))
        jl, jcache = jstep(jparams, jcache, jnp.asarray(tok))
        th, _ = tm.decode_step(tparams, {k: v.clone() for k, v in
                                         tcache.items()},
                               torch.from_numpy(tok), return_hidden=True)
        tl, tcache = tm.decode_step(tparams, tcache, torch.from_numpy(tok))
        assert tl.shape == (3, 1, jcfg.vocab_padded)
        _close(th.numpy(), jh, tol)
        _close(tl.numpy(), jl, tol)
        assert int(tcache["len"]) == int(jcache["len"]) == prompt + i + 1
    _close(tcache["k"].numpy(), jcache["k"], tol)
    _close(tcache["v"].numpy(), jcache["v"], tol)


@pytest.mark.parametrize("ring,window,cur", [
    (False, None, 5), (False, 4, 7), (True, None, 11), (True, 3, 13),
    (False, None, 20)])
def test_attention_decode_masks_match_reference(ring, window, cur):
    """One decode step of the attention itself, with the ring-buffer and
    sliding-window masks (no dense config of the port reaches them, the
    reference's hybrid family does) and the write slot clamped past
    capacity: output and cache against ``repro.models.attention``."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    jcfg, jm, jparams, tm, tparams, tree = _models(
        "tinyllama-1.1b", dict(n_heads=8, n_kv_heads=2))
    layer = jax.tree.map(lambda a: a[0], jparams["blocks"]["attn"])
    tlayer = {k: v[0] for k, v in tparams["blocks"]["attn"].items()}
    r = np.random.default_rng(cur)
    cap = 8
    x = r.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
    kc, vc = (r.normal(size=(2, cap, jcfg.n_kv_heads, jcfg.hd)).astype(
        np.float32) for _ in range(2))
    jout, jc = jattn.attention_decode(
        layer, jnp.asarray(x), jcfg,
        {"k": jnp.asarray(kc), "v": jnp.asarray(vc),
         "len": jnp.asarray(cur, jnp.int32)}, window=window, ring=ring)
    tc = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy()),
          "len": torch.tensor(cur, dtype=torch.int32)}
    tout, tc = tattn.attention_decode(tlayer, torch.from_numpy(x), tm.cfg, tc,
                                      window=window, ring=ring)
    _close(tout.numpy(), jout)
    _close(tc["k"].numpy(), jc["k"])
    _close(tc["v"].numpy(), jc["v"])


def test_bf16_decode_matches_reference():
    """The dtype served on the card, through the kernel's plain version."""
    jcfg, jm, jparams, tm, tparams, _ = _models(
        "tinyllama-1.1b", dict(n_heads=8, n_kv_heads=1,
                               use_decode_kernel=True), dtype="bfloat16")
    assert tparams["embed"].dtype == torch.bfloat16
    tokens = _tokens(jcfg, 2, 9, 6)
    jl, jcache = jax.jit(lambda p, b: jm.prefill(p, b, 16))(
        jparams, {"tokens": jnp.asarray(tokens)})
    tl, tcache = tm.prefill(tparams, {"tokens": torch.from_numpy(tokens)}, 16)
    _close(tl.numpy(), jl, BF16_TOL)
    tok = tokens[:, :1]
    for _ in range(3):
        jl, jcache = jm.decode_step(jparams, jcache, jnp.asarray(tok))
        tl, tcache = tm.decode_step(tparams, tcache, torch.from_numpy(tok))
        _close(tl.numpy(), jl, BF16_TOL)
        tok = np.asarray(jnp.argmax(jl[:, 0], -1))[:, None].astype(np.int32)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-780m",
                                  "deepseek-v2-236b", "whisper-tiny"])
def test_other_families_raise_naming_the_roadmap(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(reduced(get_config(arch)), device="cpu")


def test_model_without_device_never_runs_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(reduced(get_config("tinyllama-1.1b")))
