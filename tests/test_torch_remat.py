"""Rematerialisation in the port (``models/transformer.remat_wrap`` at the
reference's three boundaries of ``models/model.py``) against its own
``"none"``, the JAX reference's ``remat_wrap`` and the cost counter.

* For every family (reduced, f32, vocab 128; recurrentgemma at 5 layers,
  one period-3 group and two tail blocks), ``cfg.remat`` ``"full"`` and
  ``"dots"`` give ``"none"``'s loss and every gradient leaf bit for bit.
  The test runs on one thread: the embedding gradient's backward adds its
  rows in no fixed order across threads, so two runs of one mode may
  differ in that leaf at 8 threads.
* For tinyllama, olmoe, recurrentgemma and whisper under ``"full"`` and
  ``"dots"`` on both packages (weights carried by ``models/convert.py``),
  loss within 1e-5 relative and each gradient leaf within 1e-5 x the
  reference leaf's largest |g|: the tolerances of
  ``tests/test_torch_training.py``.
* ``DOT_OPS`` holds every aten op with a flop formula that a family's
  forward runs (what ``"dots"`` must save, as ``checkpoint_dots`` saves
  every ``dot_general``).
* On meta tensors through ``launch.cost.CostCounter`` (the counter's own
  live-storage peak: checkpointing installs its own saved-tensor hooks, so
  an outer hook would not see what it keeps): ``"full"`` counts more flops
  and bytes and a lower peak than ``"none"``; ``"dots"`` counts ``"none"``'s
  flops, bytes between the two and a peak between the two.  The recompute
  of ``"full"`` is charged once per op: on a dense model it adds exactly
  each block's forward flops but its last product's, which the backward
  does not need; on a one-rank DTensor mesh each mode counts the plain
  flops, and on a fake 2 x 2 mesh the recompute's collectives are counted.
* A sharded train step on four gloo ranks (a (2, 2) data x model mesh,
  ``tests/multihost/run_mesh_torch.py --suite remat``) under ``"full"``
  (tinyllama, olmoe, recurrentgemma) and ``"dots"`` (tinyllama) against one
  device's step under ``"none"``, within ``tests/test_torch_sharding.py``'s
  bounds.
* ``remat_wrap`` raises on an unknown mode, returns the function itself
  under ``"none"``, and is a plain call with grad disabled.

Every test leaves no process group behind (the fixture checks).
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import torch.distributed as dist  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils.flop_counter import flop_registry  # noqa: E402

from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch.dryrun import Lowered, build_lowered  # noqa: E402
from repro_torch.launch.mesh import fake_mesh  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.training import adamw_init  # noqa: E402
from repro_torch.training.optimizer import tree_map  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
RUNNER = ROOT / "tests" / "multihost" / "run_mesh_torch.py"

LOSS_TOL = 1e-5             # tests/test_torch_training.py's
GRAD_TOL = 1e-5
VOCAB = 128
B, S = 2, 33                # 32 input positions a row
MODES = ("full", "dots")

FAMILIES = {
    "dense": ("tinyllama-1.1b", {}),
    "moe": ("olmoe-1b-7b", {}),
    "mla": ("deepseek-v2-236b", {}),
    "ssm": ("mamba2-780m", {}),
    "hybrid": ("recurrentgemma-9b", dict(n_layers=5)),
    "encdec": ("whisper-tiny", {}),
    "vlm": ("internvl2-26b", {}),
}
REFERENCE_FAMILIES = ("dense", "moe", "hybrid", "encdec")
_ONES = {"scale", "q_norm", "kv_norm", "norm", "d_skip"}
_PERTURBED = _ONES | {"bias", "bq", "bk", "bv", "conv_b", "a_log", "dt_bias",
                      "b_a", "b_i", "lam"}


@pytest.fixture(autouse=True)
def no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized(), "a test left a process group behind"


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(family, mode="none", pkg="torch"):
    arch, over = FAMILIES[family]
    kw = dict(vocab=VOCAB, dtype="float32", remat=mode, **over)
    if pkg == "jax":
        return jreduced(jget_config(arch)).with_(**kw)
    return reduced(get_config(arch)).with_(**kw)


def _batch(cfg, seed=2, b=B, s=S):
    r = np.random.default_rng(seed)
    batch = {"tokens": r.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = r.normal(size=(b, s - 1, cfg.d_frontend)).astype(
            np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = r.normal(
            size=(b, cfg.n_image_tokens, cfg.d_frontend)).astype(np.float32)
    return batch


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


def _loss_and_grads(cfg, params, batch):
    """The port's (loss, {path: grad}) on CPU tensors."""
    model = Model(cfg, device="cpu")
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    flat = _flat(live)
    loss, _ = model.loss(live, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss.detach(), dict(zip(flat, grads))


# ------------------------------------------------- (a) equal to "none"


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_gradients_equal_none_bit_for_bit(family, mode, one_thread):
    cfg = _cfg(family)
    params = Model(cfg, device="cpu").init(0)
    batch = _batch(cfg)
    want_loss, want = _loss_and_grads(cfg, params, batch)
    loss, got = _loss_and_grads(cfg.with_(remat=mode), params, batch)
    assert torch.equal(loss, want_loss), (float(loss), float(want_loss))
    assert got.keys() == want.keys()
    for path, g in got.items():
        assert torch.equal(g, want[path]), path


def test_dot_ops_cover_every_familys_products():
    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.add(func)
            return func(*args, **(kwargs or {}))

    for family in FAMILIES:
        cfg = _cfg(family)
        model = Model(cfg, device="meta")
        params = model.init(0)
        batch = {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype,
                                device="meta")
                 for k, v in _batch(cfg).items()}
        with Ops() as ops, torch.no_grad():
            model.forward(params, dict(batch, tokens=batch["tokens"][:, 1:]))
        products = {f for f in ops.seen if f._overloadpacket in flop_registry}
        assert products and products <= transformer.DOT_OPS, (family,
                                                              products)


# --------------------------------------- (b) against the JAX reference


_REF: dict = {}


def _reference(family, mode):
    """(tree, loss, {path: grad}) of the reference under ``mode``."""
    key = (family, mode)
    if key not in _REF:
        jcfg = _cfg(family, mode, pkg="jax")
        jm = JModel(jcfg)
        tree = _perturb(jax.tree.map(np.asarray,
                                     jm.init(jax.random.PRNGKey(0))),
                        np.random.default_rng(1))
        (loss, _), grads = jax.value_and_grad(jm.loss, has_aux=True)(
            jax.tree.map(jnp.asarray, tree),
            {k: jnp.asarray(v) for k, v in _batch(jcfg).items()})
        _REF[key] = (tree, float(loss),
                     {k: np.asarray(v) for k, v in _flat(grads).items()})
    return _REF[key]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", REFERENCE_FAMILIES)
def test_loss_and_gradients_match_reference_under_remat(family, mode):
    tree, want_loss, want = _reference(family, mode)
    cfg = _cfg(family, mode)
    loss, got = _loss_and_grads(
        cfg, params_from_reference(tree, cfg, device="cpu"), _batch(cfg))
    assert abs(float(loss) - want_loss) <= LOSS_TOL * abs(want_loss)
    assert got.keys() == want.keys()
    for path, g in got.items():
        w = want[path]
        bound = GRAD_TOL * np.abs(w).max()
        assert np.abs(g.numpy() - w).max() <= bound, path


# ------------------------------------------------ (c) the cost counter


def _meta_batch(cfg, b, s):
    batch = {"tokens": torch.empty((b, s + 1), dtype=torch.int32,
                                   device="meta")}
    if cfg.family == "encdec":
        batch["frames"] = torch.empty((b, s, cfg.d_frontend), device="meta")
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.empty(
            (b, cfg.n_image_tokens, cfg.d_frontend), device="meta")
    return batch


def _count(cfg, b=4, s=256) -> dict:
    """The train step of ``cfg`` counted on meta tensors."""
    model = Model(cfg, device="meta")
    params = model.init(0)
    return Lowered(make_train_step(model), (
        params, adamw_init(params), _meta_batch(cfg, b, s))).count().record()


def _flops(rec) -> float:
    return sum(rec["flops"].values())


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_counted_work_and_peak_order_by_mode(family):
    over = dict(n_layers=6) if family == "hybrid" else {}
    none, full, dots = (_count(_cfg(family, m).with_(**over))
                        for m in ("none", "full", "dots"))
    assert _flops(full) > _flops(none) == _flops(dots)
    assert full["bytes_accessed"] > dots["bytes_accessed"] \
        > none["bytes_accessed"]
    peak = {m: r["memory"]["peak"] for m, r in
            (("none", none), ("full", full), ("dots", dots))}
    assert peak["full"] < peak["none"], peak
    assert peak["full"] <= peak["dots"] < peak["none"], peak


def test_the_recompute_is_charged_once():
    """"full" adds each block's forward flops but its MLP's down product
    (the backward needs nothing after the product's input, so the
    recompute stops there); "dots" recomputes no product."""
    cfg = _cfg("dense")
    b, s = 4, 256

    def forward_flops(n_layers):
        model = Model(cfg.with_(n_layers=n_layers), device="meta")
        batch = _meta_batch(cfg, b, s)
        with torch.no_grad():
            rec = Lowered(model.forward, (
                model.init(0), dict(batch, tokens=batch["tokens"][:, 1:]))
            ).count().record()
        return _flops(rec)

    block = forward_flops(2) - forward_flops(1)
    down = 2.0 * b * s * cfg.d_ff * cfg.d_model
    counts = {m: _count(cfg.with_(remat=m), b, s) for m in
              ("none", "full", "dots")}
    assert (_flops(counts["full"]) - _flops(counts["none"])
            == cfg.n_layers * (block - down))
    assert _flops(counts["dots"]) == _flops(counts["none"])
    shape = ShapeConfig("train_small", seq_len=s, global_batch=b,
                        kind="train")
    # on DTensors: one rank counts the plain flops under every mode; on
    # four, the recompute's collectives are counted too
    for mode, rec in counts.items():
        with fake_mesh((1, 1), ("data", "model")) as mesh:
            on_mesh = build_lowered(cfg.with_(remat=mode), shape,
                                    mesh).count().record()
        assert on_mesh["flops"] == rec["flops"], mode
    four = {}
    for mode in ("none", "full", "dots"):
        with fake_mesh((2, 2), ("data", "model")) as mesh:
            four[mode] = build_lowered(cfg.with_(remat=mode), shape,
                                       mesh).count().record()
    assert _flops(four["full"]) > _flops(four["none"]) \
        == _flops(four["dots"])
    assert (sum(four["full"]["collectives"].values())
            > sum(four["none"]["collectives"].values()))
    assert (four["full"]["collectives"]["all-gather"]
            > four["none"]["collectives"]["all-gather"])


# ----------------------------------------------------- (d) on a mesh


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("remat") / "remat.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, str(RUNNER), "--suite", "remat", "--device", "cpu",
         "--processes", "4", "--out", str(out)],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(out.read_text())


def _runner_checks():
    import importlib.util
    spec = importlib.util.spec_from_file_location("run_mesh_torch", RUNNER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return [name for name, _ in mod.REMAT_CHECKS]


@pytest.mark.parametrize("check", _runner_checks())
def test_sharded_train_step_under_remat_equals_one_device(check, mesh_run):
    res = mesh_run[check]
    assert res["ok"], res["detail"]


# ----------------------------------------------------- (e) the wrapper


def test_remat_wrap_raises_on_an_unknown_mode():
    cfg = _cfg("dense").with_(remat="offload")
    with pytest.raises(ValueError, match="offload"):
        transformer.remat_wrap(lambda x: x, cfg)


def test_remat_wrap_is_plain_without_grad(monkeypatch):
    def fn(x):
        calls.append(1)
        return x * 2.0

    calls = []
    assert transformer.remat_wrap(fn, _cfg("dense")) is fn
    monkeypatch.setattr(transformer, "checkpoint", lambda *a, **k: (
        pytest.fail("checkpoint called with grad disabled")))
    x = torch.ones(3, requires_grad=True)
    for mode in MODES:
        wrapped = transformer.remat_wrap(fn, _cfg("dense", mode))
        with torch.no_grad():
            assert torch.equal(wrapped(x), x * 2.0)
    assert len(calls) == 2
    # and the model's eval forward takes the plain calls
    cfg = _cfg("hybrid", "full")
    model = Model(cfg, device="cpu")
    with torch.no_grad():
        logits, _ = model.forward(model.init(0), {
            "tokens": torch.zeros((1, 4), dtype=torch.int32)})
    assert logits.shape == (1, 4, cfg.vocab_padded)


def test_remat_wrap_runs_the_body_again_in_the_backward():
    calls = []

    def fn(x, w):
        calls.append(1)
        return torch.tanh(x @ w), x.sum()

    x = torch.randn(4, 3, requires_grad=True)
    w = torch.randn(3, 3, requires_grad=True)
    for mode, runs in (("none", 1), ("full", 2), ("dots", 2)):
        calls.clear()
        y, s = transformer.remat_wrap(fn, _cfg("dense", mode))(x, w)
        gx, gw = torch.autograd.grad((y.sum() + s), (x, w))
        assert len(calls) == runs, mode
        want = torch.autograd.grad(
            torch.tanh(x @ w).sum() + x.sum(), (x, w))
        assert torch.equal(gx, want[0]) and torch.equal(gw, want[1])
