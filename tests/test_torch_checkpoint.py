"""The port's pytree checkpoints against the reference's: the same keys
(``tree_paths``) on every arch's parameter tree and on an AdamW state, and
files that each package writes and the other restores bit for bit, bf16
leaves and the step included."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.checkpoint import restore_checkpoint as jrestore  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.checkpoint import tree_paths as jtree_paths  # noqa: E402
from repro.configs.registry import ARCH_IDS  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import get_reduced_config as jget_reduced  # noqa: E402,E501
from repro.models.model import Model as JModel  # noqa: E402
from repro.training.optimizer import AdamWState as JAdamWState  # noqa: E402
from repro.training.optimizer import adamw_init as jadamw_init  # noqa: E402
from repro_torch.checkpoint import (restore_checkpoint,  # noqa: E402
                                    save_checkpoint, tree_paths)
from repro_torch.checkpoint.checkpoint import tree_flatten_with_path as _flatten  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.launch.steps import abstract_params  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.training import AdamWState, adamw_init  # noqa: E402
from repro_torch.training.convert import opt_state_from_reference  # noqa: E402,E501
from repro_torch.training.optimizer import tree_leaves  # noqa: E402


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_tree_paths_equal_the_references_for_every_arch(arch):
    """At the published widths, on shapes only (meta tensors against
    ``jax.eval_shape``): nothing is allocated."""
    jm = JModel(jget_config(arch))
    want = jtree_paths(jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    params = abstract_params(Model(get_config(arch), device="cpu"))
    assert tree_paths(params) == want
    state = adamw_init(params)
    jstate = jax.eval_shape(jadamw_init, jax.eval_shape(
        jm.init, jax.random.PRNGKey(0)))
    assert tree_paths(state) == jtree_paths(jstate)
    assert tree_paths({"params": params}) == jtree_paths(
        {"params": jax.eval_shape(jm.init, jax.random.PRNGKey(0))})


def test_tree_paths_of_sequences_namedtuples_and_none():
    tree = {"b": {"z": 1, "a": [np.ones(2), (3, None)]}, "a": np.ones(1),
            "s": AdamWState(np.int32(0), {"w": 1.0}, [2.0])}
    jtree = {"b": {"z": 1, "a": [jnp.ones(2), (3, None)]}, "a": jnp.ones(1),
             "s": JAdamWState(jnp.int32(0), {"w": 1.0}, [2.0])}
    assert tree_paths(tree) == jtree_paths(jtree)


def _bf16_tree(seed=0):
    """A bf16 reduced olmoe (its router f32) with an AdamW state that has
    taken steps: (port tree, reference tree)."""
    jcfg = jget_reduced("olmoe-1b-7b").with_(dtype="bfloat16", vocab=96)
    cfg = get_reduced_config("olmoe-1b-7b").with_(dtype="bfloat16", vocab=96)
    jparams = JModel(jcfg).init(jax.random.PRNGKey(seed))
    r = np.random.default_rng(seed)
    jstate = jadamw_init(jparams)
    jstate = JAdamWState(
        jnp.asarray(5, jnp.int32),
        jax.tree.map(lambda x: jnp.asarray(r.normal(size=x.shape),
                                           jnp.float32), jstate.mu),
        jax.tree.map(lambda x: jnp.asarray(r.random(size=x.shape),
                                           jnp.float32), jstate.nu))
    params = params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    state = opt_state_from_reference(jstate, device="cpu")
    return ({"params": params, "opt": state},
            {"params": jparams, "opt": jstate})


def _bits(x) -> np.ndarray:
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _same_bits_by_key(tree, jtree):
    """Every leaf of the port's tree equals the reference tree's leaf at
    its key, bit for bit and in dtype; returns the dtypes seen."""
    flat = dict(_flatten(tree))
    jflat = dict(zip(jtree_paths(jtree), jax.tree.leaves(jtree)))
    assert flat.keys() == jflat.keys()
    dtypes = set()
    for key, a in flat.items():
        b = jflat[key]
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype), key
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=key)
        dtypes.add(str(b.dtype))
    return dtypes


def test_port_saves_and_reference_restores_bit_for_bit(tmp_path):
    tree, jtree = _bf16_tree()
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, tree, step=5)
    restored, step = jrestore(path, jtree)
    assert step == 5
    assert tree_paths(tree) == jtree_paths(restored)
    assert _same_bits_by_key(tree, restored) >= {"bfloat16", "float32",
                                                 "int32"}


def test_reference_saves_and_port_restores_bit_for_bit(tmp_path):
    tree, jtree = _bf16_tree(1)
    path = str(tmp_path / "ref.npz")
    jsave(path, jtree, step=11)
    like, _ = _bf16_tree(2)                 # other values, same structure
    restored, step = restore_checkpoint(path, like)
    assert step == 11
    assert isinstance(restored["opt"], AdamWState)
    assert list(restored["params"]) == list(like["params"])
    assert _same_bits_by_key(restored, jtree) >= {"bfloat16", "float32",
                                                  "int32"}
    for a, b in zip(tree_leaves(restored), tree_leaves(like)):
        assert a.dtype == b.dtype and a.device == b.device


def test_restore_takes_the_donors_dtype(tmp_path):
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, {"w": torch.arange(4, dtype=torch.bfloat16)})
    restored, step = restore_checkpoint(path, {"w": torch.zeros(4)})
    assert step is None
    assert restored["w"].dtype == torch.float32
    np.testing.assert_array_equal(restored["w"].numpy(), np.arange(4.0))


def test_checkpoint_roundtrip(tmp_path):
    """Port of ``tests/test_substrates.py::test_checkpoint_roundtrip``."""
    tree = {
        "a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "b": {"c": torch.ones(4, dtype=torch.bfloat16),
              "d": torch.tensor(3)},
    }
    p = os.path.join(tmp_path, "ckpt.npz")
    save_checkpoint(p, tree, step=42)
    restored, step = restore_checkpoint(p, tree)
    assert step == 42
    for x, y in zip(tree_leaves(tree), tree_leaves(restored)):
        np.testing.assert_array_equal(x.float().numpy(), y.float().numpy())
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert restored["b"]["d"].dtype == torch.int64


def test_checkpoint_structure_mismatch_raises(tmp_path):
    """Port of
    ``tests/test_substrates.py::test_checkpoint_structure_mismatch_raises``,
    plus a file of the reference's read against another structure."""
    p = os.path.join(tmp_path, "ckpt.npz")
    save_checkpoint(p, {"a": torch.ones(2)})
    with pytest.raises(ValueError, match="mismatch"):
        restore_checkpoint(p, {"zz": torch.ones(2)})
    jp = os.path.join(tmp_path, "ref.npz")
    jsave(jp, {"a": jnp.ones(2), "b": jnp.ones(1)})
    with pytest.raises(ValueError, match="mismatch"):
        restore_checkpoint(jp, {"a": torch.ones(2)})
    with pytest.raises(ValueError, match="mismatch"):
        restore_checkpoint(jp, [torch.ones(2), torch.ones(1)])
