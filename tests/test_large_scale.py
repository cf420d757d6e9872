"""Abstract-scale validation: the 100M-user x 10M-item synthetic config.

Real allocation is impossible on test hardware, so the train step is traced
with jax.eval_shape at full scale — this validates that the program builds
(static shapes, no overflow in index math) and that the huge-table code path
(sort-dedup scatter, no O(rows) dense pass) is the one taken.
"""

import jax
import jax.numpy as jnp
import numpy as np

from heat_cf.config import CFConfig
from heat_cf.models.state import TrainState
from heat_cf.train.samplers import SamplerState
from heat_cf.train.scatter import DENSE_ROWS_THRESHOLD
from heat_cf.train.train_step import Batch, train_step

NUM_USERS = 100_000_000
NUM_ITEMS = 10_000_000
D = 128
B = 8192
K = 16
H = 100


def test_train_step_traces_at_100m_scale():
    cfg = CFConfig(
        emb_dim=D,
        num_users=NUM_USERS,
        num_items=NUM_ITEMS,
        max_his=H,
        num_negs=K,
        batch_size=B,
        his_refresh="subepoch",
    )
    assert NUM_USERS > DENSE_ROWS_THRESHOLD  # sort-dedup path for users
    assert NUM_ITEMS > DENSE_ROWS_THRESHOLD  # and for items

    s = jax.ShapeDtypeStruct
    state = TrainState(
        user_emb=s((NUM_USERS, D), jnp.float32),
        item_emb=s((NUM_ITEMS, D), jnp.float32),
        w0=s((D, D), jnp.float32),
        user_gacc=None,
        item_gacc=None,
        lr=s((), jnp.float32),
        step=s((), jnp.int32),
    )
    sstate = SamplerState(
        tile=s((1,), jnp.int32), iterations=s((), jnp.int32)
    )
    batch = Batch(
        users=s((B,), jnp.int32),
        pos=s((B,), jnp.int32),
        weight=s((B,), jnp.float32),
    )

    out_state, out_sstate, loss = jax.eval_shape(
        lambda st, ss, k, b, hi, hm, um: train_step(
            st, ss, k, b, hi, hm, cfg, user_means=um
        ),
        state,
        sstate,
        jax.random.key(0),
        batch,
        s((NUM_USERS, H), jnp.int32),
        s((NUM_USERS,), jnp.int32),
        s((NUM_USERS, D), jnp.float32),
    )
    assert out_state.user_emb.shape == (NUM_USERS, D)
    assert out_state.item_emb.shape == (NUM_ITEMS, D)
    assert loss.shape == ()


def test_int32_id_space_sufficient():
    # 100M users and 10M items fit comfortably in int32 (< 2^31).
    assert NUM_USERS < np.iinfo(np.int32).max
    assert NUM_ITEMS * H < np.iinfo(np.int64).max
