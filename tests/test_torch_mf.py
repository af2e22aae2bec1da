"""The port's matrix-factorisation trainer against ``repro``'s, on the CPU.

Both packages get the same numpy ratings and seeds.  They draw the same
initial factors and permutations, but XLA orders the fused sums of a step
differently from the port, so the factors are not expected to be bit-equal:

* one ``mf_minibatch_step``: params and velocity within 4 ulp of each
  array's largest magnitude (a row's gradient is a sum over its ratings,
  and the two packages add them in different orders), the step's mse
  within rtol 1e-6;
* ``train_mf`` over a few epochs: U and V within 1e-5 absolute (about 40
  ulp at the trained factors' scale of 2.5), the per-epoch mse history
  within rtol 1e-6.

Within the port, everything is bit-exact: two runs with one seed,
``return_state=True`` against plain, a warm start from the reference's
state, and the state converters both ways.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

import repro.factorization as jf  # noqa: E402
import repro.online as jo  # noqa: E402
import repro_torch.factorization as tf  # noqa: E402
import repro_torch.online as to  # noqa: E402
from repro.data import movielens_like_ratings  # noqa: E402
from repro_torch.factorization.convert import (  # noqa: E402
    COUNTERS, mf_state_from_reference, mf_state_to_reference,
    streaming_from_reference, streaming_to_reference)
from repro_torch.factorization.mf import scatter_rows  # noqa: E402

K = 10
STEP_ULPS = 4
FACTOR_TOL = dict(rtol=0, atol=1e-5)
HISTORY_RTOL = 1e-6
# a streaming trainer after a few batches: factors, velocities and the
# AdaGrad sums of squares within these
STREAM_TOL = dict(rtol=1e-5, atol=1e-6)


def _ratings(n_users=12, n_items=20, n=256, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_users, n), rng.integers(0, n_items, n),
            rng.normal(loc=3.0, size=n).astype(np.float32))


def assert_within_ulps_of_scale(got, want, ulps):
    """|got - want| <= ``ulps`` f32 ulp of want's largest magnitude."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = ulps * np.spacing(np.abs(want).max())
    err = np.abs(got.astype(np.float64) - want).max()
    assert err <= tol, f"max error {err} beyond {ulps} ulp of the scale"


def test_scatter_rows_sums_duplicates_in_batch_order():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 7, 500)
    g = rng.normal(size=(500, 3)).astype(np.float32)
    got = scatter_rows(9, torch.as_tensor(rows), torch.as_tensor(g)).numpy()
    want = np.zeros((9, 3), np.float32)
    for r, x in zip(rows, g):                  # one add at a time, in order
        want[r] = want[r] + x
    np.testing.assert_array_equal(got, want)


def test_minibatch_step_matches_reference():
    rng = np.random.default_rng(1)
    params = {"u": rng.normal(size=(30, K)).astype(np.float32),
              "v": rng.normal(size=(40, K)).astype(np.float32)}
    vel = {k: rng.normal(size=p.shape).astype(np.float32)
           for k, p in params.items()}
    rows, cols = rng.integers(0, 30, 200), rng.integers(0, 40, 200)
    vals = rng.normal(size=200).astype(np.float32)
    cfg = dict(k=K, lr=0.01, reg=0.05, momentum=0.8)
    # the port's step updates its tensors in place: give it copies, since
    # a jax array on the CPU may share the numpy arrays' memory and the
    # reference's step may still be reading them (dispatch is asynchronous)
    t_in = [{k: torch.tensor(a) for k, a in tree.items()}
            for tree in (params, vel)]
    jp, jv, jmse = jf.mf_minibatch_step(
        {k: jnp.asarray(a) for k, a in params.items()},
        {k: jnp.asarray(a) for k, a in vel.items()},
        jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
        jf.MfConfig(**cfg))
    tp, tv, tmse = tf.mf_minibatch_step(
        *t_in, torch.as_tensor(rows), torch.as_tensor(cols),
        torch.as_tensor(vals), tf.MfConfig(**cfg))
    for key in ("u", "v"):
        assert_within_ulps_of_scale(tp[key].numpy(), jp[key], STEP_ULPS)
        assert_within_ulps_of_scale(tv[key].numpy(), jv[key], STEP_ULPS)
    np.testing.assert_allclose(float(tmse), float(jmse), rtol=1e-6)


@pytest.mark.parametrize("data,cfg", [
    # the §6.2 surrogate (73,786 ratings) at the paper's k
    ("movielens", dict(k=K, epochs=3)),
    # small batches, no centring, another seed
    ("small", dict(k=K, epochs=4, batch=64, center=False, seed=9,
                   momentum=0.5, lr=0.01)),
])
def test_train_mf_matches_reference(data, cfg):
    if data == "movielens":
        rows, cols, vals = movielens_like_ratings(seed=0)
        n_users, n_items = 943, 1682
    else:
        (rows, cols, vals), n_users, n_items = _ratings(), 12, 20
    ju, jv, jh = jf.train_mf(rows, cols, vals, n_users, n_items,
                             jf.MfConfig(**cfg))
    tu, tv, th = tf.train_mf(rows, cols, vals, n_users, n_items,
                             tf.MfConfig(**cfg), device="cpu")
    np.testing.assert_allclose(tu, ju, **FACTOR_TOL)
    np.testing.assert_allclose(tv, jv, **FACTOR_TOL)
    np.testing.assert_allclose(th, jh, rtol=HISTORY_RTOL)
    assert th[-1] < th[0]


def test_train_mf_is_deterministic_and_return_state_keeps_the_bits():
    rows, cols, vals = movielens_like_ratings(seed=1, n_users=200,
                                              n_items=300)
    cfg = tf.MfConfig(k=K, epochs=2, batch=2048, seed=4)
    u0, v0, h0 = tf.train_mf(rows, cols, vals, 200, 300, cfg, device="cpu")
    u1, v1, h1, state = tf.train_mf(rows, cols, vals, 200, 300, cfg,
                                    return_state=True, device="cpu")
    np.testing.assert_array_equal(u0, u1)
    np.testing.assert_array_equal(v0, v1)
    assert h0 == h1
    assert isinstance(state, tf.MfState)
    np.testing.assert_array_equal(state.params["u"].numpy(), u1)
    assert state.offset == pytest.approx(float(vals.mean()))
    assert state.vel["v"].shape == (300, K)


def test_train_mf_runs_on_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: None means it")
    rows, cols, vals = _ratings()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.train_mf(rows, cols, vals, 12, 20, tf.MfConfig(k=K, epochs=1))


@pytest.mark.parametrize("via", ["converter", "numpy_state"])
def test_warm_start_adopts_reference_mf_state_bit_exactly(via):
    rows, cols, vals = _ratings()
    cfg = dict(k=K, epochs=2, batch=128, seed=9)
    u, v, _, js = jf.train_mf(rows, cols, vals, 12, 20, jf.MfConfig(**cfg),
                              return_state=True)
    params = {k: np.asarray(a) for k, a in js.params.items()}
    vel = {k: np.asarray(a) for k, a in js.vel.items()}
    if via == "converter":
        state = mf_state_from_reference(params, vel, js.offset, device="cpu")
        assert isinstance(state.params["u"], torch.Tensor)
    else:
        state = tf.MfState(params=params, vel=vel, offset=js.offset)
    t = to.StreamingMF.from_state(state, to.OnlineMFConfig(k=K),
                                  device="cpu")
    np.testing.assert_array_equal(t.user_factors(), u)
    np.testing.assert_array_equal(t.item_factors(), v)
    np.testing.assert_array_equal(t._vel["v"][:20].numpy(), vel["v"])
    np.testing.assert_array_equal(t._vel["u"][:12].numpy(), vel["u"])
    assert t.offset == js.offset
    assert t.capacity == (64, 64)


def test_mf_state_converters_round_trip():
    rows, cols, vals = _ratings()
    *_, state = tf.train_mf(rows, cols, vals, 12, 20,
                            tf.MfConfig(k=K, epochs=1, batch=100),
                            return_state=True, device="cpu")
    params, vel, offset = mf_state_to_reference(state)
    assert all(isinstance(a, np.ndarray) for a in (*params.values(),
                                                   *vel.values()))
    back = mf_state_from_reference(params, vel, offset, device="cpu")
    for key in ("u", "v"):
        assert torch.equal(back.params[key], state.params[key])
        assert torch.equal(back.vel[key], state.vel[key])
    assert back.offset == state.offset


def test_streaming_state_crosses_from_reference_and_continues_alike():
    """A reference trainer's tables and counters move into the port; both
    then consume the same events and stay within STREAM_TOL."""
    cfg = dict(k=K, lr=0.3, momentum=0.7, seed=5)
    sim = to.DriftSimulator(n_users=8, n_items=100, k=K, seed=2,
                            events_per_round=300)
    jsim = jo.DriftSimulator(n_users=8, n_items=100, k=K, seed=2,
                             events_per_round=300)
    j = jo.StreamingMF(jo.OnlineMFConfig(**cfg))
    j.partial_fit(jsim.step())
    sim.step()
    t = streaming_from_reference(
        {k: np.asarray(a) for k, a in j._params.items()},
        {k: np.asarray(a) for k, a in j._vel.items()},
        {k: np.asarray(a) for k, a in j._gsq.items()},
        {name: getattr(j, name) for name in COUNTERS},
        to.OnlineMFConfig(**cfg), device="cpu")
    assert t.stats() == j.stats()
    np.testing.assert_array_equal(t.item_factors(), j.item_factors())
    for _ in range(2):
        j.partial_fit(jsim.step())
        t.partial_fit(sim.step())
    np.testing.assert_allclose(t.item_factors(), j.item_factors(),
                               **STREAM_TOL)
    np.testing.assert_allclose(t._gsq["v"].numpy(), np.asarray(j._gsq["v"]),
                               **STREAM_TOL)
    # and back: the port's state as numpy restores bit for bit
    params, vel, gsq, counters = streaming_to_reference(t)
    again = streaming_from_reference(params, vel, gsq, counters,
                                     to.OnlineMFConfig(**cfg), device="cpu")
    assert again.stats() == t.stats()
    for key in ("u", "v"):
        assert torch.equal(again._params[key], t._params[key])
        assert torch.equal(again._vel[key], t._vel[key])
        assert torch.equal(again._gsq[key], t._gsq[key])
