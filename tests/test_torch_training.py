"""LM training in the port against the JAX reference: ``Model.loss`` and its
gradients, ``launch.steps.make_train_step`` (AdamW included),
``training.eval_batches``, ``launch.train.build_batch``, the train launcher
and the reference's training integration tests, for every family at its
``reduced()`` config in f32 (vocab 128, and a padded-vocab case).

Both packages get the same weights (the reference's init with the norm
scales, biases and f32 leaves given seeded values, carried over by
``models/convert.py``) and the same numpy batches.

Tolerances:
* loss, nll, aux and ppl within 1e-5 relative (measured at most 3e-7);
* each gradient leaf within 1e-5 x the reference leaf's largest |g|
  (measured at most 3.5e-6 x): the two packages sum in another order;
* a train step, from the reference's params and AdamW state (carried by
  ``training/convert.py``), three steps in a row: metrics within 1e-5
  relative, mu and nu within 2e-5 x the leaf's largest value (measured at
  most 7e-6 x), params within 1e-5 absolute except where AdamW's
  denominator is eps-dominated: there the update g / (|g| + eps) moves with
  the gradient's own relative error, which is large because the gradient is
  tiny.  Each such element must have sqrt(v_hat) below 100 eps in the
  reference's state; they are counted (measured: 36-120 of 0.9-3.3 M, all
  in the first step, sqrt(v_hat) at most 15 eps).
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import get_reduced_config as jget_reduced  # noqa: E402,E501
from repro.data import TokenPipeline as JTokenPipeline  # noqa: E402
from repro.launch import train as jtrain_mod  # noqa: E402
from repro.launch.steps import make_train_step as jmake_train_step  # noqa: E402,E501
from repro.models.model import Model as JModel  # noqa: E402
from repro.training import eval_batches as jeval_batches  # noqa: E402
from repro.training.optimizer import AdamWConfig as JAdamWConfig  # noqa: E402,E501
from repro.training.optimizer import AdamWState as JAdamWState  # noqa: E402
from repro.training.optimizer import adamw_init as jadamw_init  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config, reduced  # noqa: E402,E501
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.training import (AdamWConfig, adamw_init,  # noqa: E402
                                  eval_batches)
from repro_torch.training.convert import (  # noqa: E402
    opt_state_from_reference, opt_state_to_reference)

LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
MOMENT_TOL = 2e-5
PARAM_TOL = 1e-5
EPS_DOMINATED = 100.0       # sqrt(v_hat) below this many AdamW eps
VOCAB = 128
B, S = 2, 33                # 32 input positions a row

CASES = [
    ("dense", "tinyllama-1.1b", {}),
    ("dense-padded-vocab", "tinyllama-1.1b", dict(vocab=600)),
    ("moe", "olmoe-1b-7b", {}),
    ("mla", "deepseek-v2-236b", {}),
    ("ssm", "mamba2-780m", {}),
    ("hybrid", "recurrentgemma-9b", {}),
    ("encdec", "whisper-tiny", {}),
    ("vlm", "internvl2-26b", {}),
]
IDS = [c[0] for c in CASES]
_ONES = {"scale", "q_norm", "kv_norm", "norm", "d_skip"}
_PERTURBED = _ONES | {"bias", "bq", "bk", "bv", "conv_b", "a_log", "dt_bias",
                      "b_a", "b_i", "lam"}
_CACHE: dict = {}


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


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _flat(sub, prefix + (k,)).items()}
    return {prefix: tree}


def _np(tree):
    return {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                else np.asarray(v)) for k, v in _flat(tree).items()}


def _case(name):
    """(jcfg, jmodel, tree, tcfg, model) of a case, built once."""
    if name not in _CACHE:
        _, arch, overrides = CASES[IDS.index(name)]
        kw = dict(dict(vocab=VOCAB, dtype="float32"), **overrides)
        jcfg = jreduced(jget_config(arch)).with_(**kw)
        tcfg = reduced(get_config(arch)).with_(**kw)
        jm = JModel(jcfg)
        tree = _perturb(jax.tree.map(np.asarray,
                                     jm.init(jax.random.PRNGKey(0))),
                        np.random.default_rng(1))
        _CACHE[name] = (jcfg, jm, tree, tcfg, Model(tcfg, device="cpu"))
    return _CACHE[name]


def _batch(cfg, seed):
    """A (B, S) token batch and the family's extras, in numpy."""
    r = np.random.default_rng(seed)
    batch = {"tokens": r.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = r.normal(size=(B, S - 1, cfg.d_frontend)).astype(
            np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = r.normal(
            size=(B, cfg.n_image_tokens, cfg.d_frontend)).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel(got, want):
    got, want = float(got), float(want)
    return abs(got - want) / max(abs(want), 1e-30)


def _reference_value_and_grad(name):
    key = ("vg", name)
    if key not in _CACHE:
        jcfg, jm, tree, _, _ = _case(name)
        (loss, met), grads = jax.value_and_grad(jm.loss, has_aux=True)(
            jax.tree.map(jnp.asarray, tree), _j(_batch(jcfg, 2)))
        _CACHE[key] = (float(loss), {k: float(v) for k, v in met.items()},
                       _np(jax.tree.map(np.asarray, grads)))
    return _CACHE[key]


@pytest.mark.parametrize("name", IDS)
def test_loss_matches_reference(name):
    jcfg, _, tree, tcfg, model = _case(name)
    want, want_met, _ = _reference_value_and_grad(name)
    params = params_from_reference(tree, tcfg, device="cpu")
    with torch.no_grad():
        total, met = model.loss(params, _t(_batch(jcfg, 2)))
    assert _rel(total, want) <= LOSS_TOL
    for k in ("nll", "aux", "ppl"):
        assert abs(float(met[k]) - want_met[k]) <= LOSS_TOL * max(
            abs(want_met[k]), 1e-6), k
    assert np.isclose(float(total), float(met["nll"]) + 0.01 * float(
        met["aux"]), rtol=1e-6)
    if jcfg.family == "moe":
        assert float(met["aux"]) > 0


@pytest.mark.parametrize("name", IDS)
def test_every_gradient_leaf_matches_reference(name):
    jcfg, _, tree, tcfg, model = _case(name)
    _, _, want = _reference_value_and_grad(name)
    params = params_from_reference(tree, tcfg, device="cpu")
    leaves = _flat(params)
    for p in leaves.values():
        p.requires_grad_(True)
    total, _ = model.loss(params, _t(_batch(jcfg, 2)))
    grads = torch.autograd.grad(total, list(leaves.values()))
    assert set(leaves) == set(want)
    for path, g in zip(leaves, grads):
        g, w = g.numpy(), want[path]
        assert np.isfinite(g).all(), path
        bound = GRAD_TOL * np.abs(w).max()
        assert np.abs(g - w).max() <= bound, (path, np.abs(g - w).max(),
                                              bound)


def _opt_cfgs():
    kw = dict(lr=2e-3, warmup_steps=1, total_steps=3)
    return JAdamWConfig(**kw), AdamWConfig(**kw)


@pytest.mark.parametrize("name", IDS)
def test_three_train_steps_match_reference(name):
    """Each of three steps starts both packages from the reference's state
    (params and AdamW state converted into the port) on the same batch."""
    jcfg, jm, tree, tcfg, model = _case(name)
    jo, to = _opt_cfgs()
    jstep = jax.jit(jmake_train_step(jm, jo))
    tstep = make_train_step(model, to)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jadamw_init(jparams)
    eps_dominated = 0
    for i in range(3):
        params = params_from_reference(jax.tree.map(np.asarray, jparams),
                                       tcfg, device="cpu")
        state = opt_state_from_reference(jstate, device="cpu")
        assert int(state.step) == i
        batch = _batch(jcfg, 10 + i)
        jparams, jstate, jmet = jstep(jparams, jstate, _j(batch))
        params, state, met = tstep(params, state, _t(batch))
        assert set(met) == set(jmet) == {"loss", "nll", "aux", "ppl",
                                         "grad_norm", "lr"}
        for k in met:
            assert abs(float(met[k]) - float(jmet[k])) <= LOSS_TOL * max(
                abs(float(jmet[k])), 1e-6), (i, k)
        assert int(state.step) == int(jstate.step) == i + 1
        b2c = 1 - jo.b2 ** (i + 1)
        got_p, want_p = _np(params), _np(jax.tree.map(np.asarray, jparams))
        got_m, want_m = _np(state.mu), _np(jax.tree.map(np.asarray,
                                                        jstate.mu))
        got_v, want_v = _np(state.nu), _np(jax.tree.map(np.asarray,
                                                        jstate.nu))
        for path in want_p:
            for got, want in ((got_m, want_m), (got_v, want_v)):
                assert got[path].dtype == np.float32
                assert np.abs(got[path] - want[path]).max() <= \
                    MOMENT_TOL * np.abs(want[path]).max(), (i, path)
            off = np.abs(got_p[path] - want_p[path]) > PARAM_TOL
            vhat = np.sqrt(want_v[path][off] / b2c)
            assert (vhat < EPS_DOMINATED * jo.eps).all(), (i, path,
                                                           vhat.max())
            eps_dominated += int(off.sum())
    n = sum(v.size for v in _flat(tree).values())
    print(f"{name}: {eps_dominated} of {n} params past {PARAM_TOL} after "
          "an eps-dominated update")
    assert eps_dominated <= 1e-4 * n


@pytest.mark.parametrize("name", ["dense", "moe", "encdec", "vlm"])
def test_eval_batches_matches_reference(name):
    jcfg, jm, tree, tcfg, model = _case(name)
    batches = [_batch(jcfg, 20 + i) for i in range(3)]
    want = jeval_batches(jm, jax.tree.map(jnp.asarray, tree),
                         [_j(b) for b in batches])
    got = eval_batches(model, params_from_reference(tree, tcfg,
                                                    device="cpu"),
                       [_t(b) for b in batches])
    assert set(got) == set(want)
    assert got["n_tokens"] == want["n_tokens"] == 3 * B * (S - 1)
    assert _rel(got["nll"], want["nll"]) <= LOSS_TOL
    assert _rel(got.ppl, want.ppl) <= LOSS_TOL
    assert got["top1_acc"] == want["top1_acc"]


def test_eval_batches_runs_without_autograd():
    _, _, tree, tcfg, model = _case("dense")
    params = params_from_reference(tree, tcfg, device="cpu")
    for p in _flat(params).values():
        p.requires_grad_(True)
    batch = _t(_batch(tcfg, 3))
    assert eval_batches(model, params, [batch])["n_tokens"] == B * (S - 1)
    assert torch.is_grad_enabled()


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "whisper-tiny",
                                  "internvl2-26b"])
def test_build_batch_equals_reference(arch):
    cfg, jcfg = get_reduced_config(arch), jget_reduced(arch)
    tokens = TokenPipeline(vocab=cfg.vocab, seq_len=16, batch=2,
                           seed=0).batch_at(0)
    np.testing.assert_array_equal(
        tokens, JTokenPipeline(vocab=cfg.vocab, seq_len=16, batch=2,
                               seed=0).batch_at(0))
    got = train_mod.build_batch(cfg, tokens, np.random.default_rng(5),
                                "cpu")
    want = jtrain_mod.build_batch(jcfg, tokens, np.random.default_rng(5))
    assert set(got) == set(want)
    for k in want:
        assert got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_opt_state_round_trip_keeps_dtypes():
    _, _, tree, _, _ = _case("ssm")
    jstate = jadamw_init(jax.tree.map(jnp.asarray, tree))
    jstate = JAdamWState(jnp.asarray(7, jnp.int32),
                         jax.tree.map(lambda x: x + 0.5, jstate.mu),
                         jax.tree.map(lambda x: x + 0.25, jstate.nu))
    state = opt_state_from_reference(jstate, device="cpu")
    assert state.step.dtype == torch.int32 and int(state.step) == 7
    for leaf in list(_flat(state.mu).values()) + list(
            _flat(state.nu).values()):
        assert leaf.dtype == torch.float32
    back = opt_state_to_reference(state)
    assert back.step.dtype == np.int32 and int(back.step) == 7
    for got, want in ((back.mu, jstate.mu), (back.nu, jstate.nu)):
        w = _np(jax.tree.map(np.asarray, want))
        for path, g in _flat(got).items():
            np.testing.assert_array_equal(g, w[path])


# ---------------------------------------------- the reference's own cases


def test_train_launcher_reduced_arch():
    """Port of ``tests/test_launchers.py::test_train_launcher_reduced_arch``."""
    losses = train_mod.train("olmo-1b", reduced=True, steps=12, batch_size=2,
                             seq=32, lr=2e-3, vocab=128, log_every=100,
                             device="cpu")
    assert len(losses) == 12
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_train_launcher_moe_arch():
    """Port of ``tests/test_launchers.py::test_train_launcher_moe_arch``."""
    losses = train_mod.train("olmoe-1b-7b", reduced=True, steps=6,
                             batch_size=2, seq=16, lr=2e-3, vocab=64,
                             log_every=100, device="cpu")
    assert np.isfinite(losses).all()


def test_train_launcher_prints_the_references_lines(capsys, tmp_path):
    ckpt = str(tmp_path / "ck.npz")
    train_mod.train("olmo-1b", reduced=True, steps=3, batch_size=2, seq=16,
                    vocab=64, log_every=1, ckpt=ckpt, device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=olmo-1b params=")
    assert [line.split()[0] for line in out[1:4]] == ["step"] * 3
    assert out[4].startswith("eval: ppl ") and "over 128 tokens" in out[4]
    assert out[5] == f"checkpoint -> {ckpt}"


def test_lm_training_loop_integration():
    """Port of ``tests/test_system.py::test_lm_training_loop_integration``:
    data pipeline -> model -> AdamW for 30 steps, loss strictly learns."""
    cfg = get_reduced_config("olmo-1b").with_(vocab=128)
    model = Model(cfg, device="cpu")
    params = model.init(0)
    opt_cfg = AdamWConfig(lr=2e-3, warmup_steps=5, total_steps=30)
    opt = adamw_init(params)
    step = make_train_step(model, opt_cfg)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=32, batch=4, seed=0)
    losses = []
    m = None
    for i, tokens in zip(range(30), pipe):
        params, opt, m = step(params, opt, {"tokens": tokens})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses
    assert np.isfinite(losses).all()
    assert float(m["nll"]) < np.log(cfg.vocab)


def test_eval_harness_tracks_training():
    """Port of ``tests/test_substrates.py::test_eval_harness_tracks_training``:
    held-out ppl falls under training and top-1 beats chance."""
    cfg = get_reduced_config("olmo-1b").with_(vocab=64)
    model = Model(cfg, device="cpu")
    params = model.init(0)
    held_out = [{"tokens": t} for t, _ in zip(
        TokenPipeline(vocab=64, seq_len=32, batch=4, seed=999), range(3))]
    before = eval_batches(model, params, held_out)
    step = make_train_step(model, AdamWConfig(lr=2e-3, warmup_steps=5,
                                              total_steps=40))
    opt = adamw_init(params)
    pipe = TokenPipeline(vocab=64, seq_len=32, batch=4, seed=0)
    for i, tokens in zip(range(40), pipe):
        params, opt, _ = step(params, opt, {"tokens": tokens})
    after = eval_batches(model, params, held_out)
    assert after["ppl"] < before["ppl"] * 0.8
    assert after["top1_acc"] > 1.5 / 64


# ----------------------------------------------------------- the launcher


class _Parsed(Exception):
    pass


def _parser_of(main, monkeypatch):
    """The ``ArgumentParser`` a launcher's ``main`` builds (stopped at
    ``parse_args``)."""
    import argparse

    def stop(self, *a, **k):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(_Parsed) as exc:
        main()
    monkeypatch.undo()
    return exc.value.args[0]


def _flags(parser) -> dict:
    return {a.option_strings[0]: (a.default, a.type, a.choices)
            for a in parser._actions if a.option_strings}


def test_train_launcher_flags_are_the_references_plus_device(monkeypatch):
    got = _flags(_parser_of(train_mod.main, monkeypatch))
    want = _flags(_parser_of(jtrain_mod.main, monkeypatch))
    assert got.pop("--device") == ("cuda", None, ("cuda", "cpu"))
    assert got == want


def test_train_launcher_without_device_never_runs_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "olmo-1b",
                                      "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_mod.main()
    with pytest.raises(RuntimeError, match="CUDA"):
        train_mod.train("olmo-1b", reduced=True, steps=1, batch_size=1,
                        seq=8)
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "olmo-1b",
                                      "--reduced", "--steps", "2",
                                      "--batch", "1", "--seq", "8",
                                      "--vocab", "32", "--device", "cpu"])
    train_mod.main()
