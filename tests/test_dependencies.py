"""The package runs with JAX, numpy and the standard library alone: its
state classes are plain registered dataclasses (no flax) and its config
reader needs no YAML package."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from heat_cf.models.state import TrainState
from heat_cf.train.samplers import SamplerState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _train_state():
    return TrainState(
        user_emb=jnp.ones((3, 2)),
        item_emb=jnp.zeros((4, 2)),
        w0=jnp.eye(2),
        user_gacc=None,
        item_gacc=jnp.ones((4, 2)),
        lr=jnp.float32(0.1),
        step=jnp.int32(7),
        opt_slots={"user_v": jnp.ones((3, 2))},
    )


@pytest.mark.parametrize(
    "make",
    [
        _train_state,
        lambda: SamplerState(tile=jnp.arange(4), iterations=jnp.int32(3)),
    ],
    ids=["TrainState", "SamplerState"],
)
def test_state_pytree_round_trip_and_replace(make):
    state = make()
    leaves, treedef = jax.tree_util.tree_flatten(state)
    assert all(isinstance(x, jax.Array) for x in leaves)  # None is no leaf
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert type(back) is type(state)
    jax.tree.map(np.testing.assert_array_equal, back, state)
    # Through jit: the class survives as a pytree, replace() works traced.
    field = "step" if isinstance(state, TrainState) else "iterations"
    out = jax.jit(lambda s: s.replace(**{field: getattr(s, field) + 1}))(state)
    assert type(out) is type(state)
    assert int(getattr(out, field)) == int(getattr(state, field)) + 1
    # replace() returns a new object; the original is frozen and unchanged.
    assert out is not state
    with pytest.raises(AttributeError):
        setattr(state, field, 0)


def test_main_path_imports_without_flax_or_yaml():
    code = (
        "import sys\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['yaml'] = None\n"
        "import heat_cf.main\n"
        "from heat_cf.train.engine import Engine\n"
        "from heat_cf.serving import Recommender\n"
        "from heat_cf.config import load_config\n"
        "cfg, ds = load_config('benchmarks/AmazonBooks/config0.yaml')\n"
        "assert cfg.emb_dim == 64 and cfg.l_r == 0.01\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
