"""Parity of the batched device train step against the sequential numpy oracle.

The oracle (tests/oracle.py) implements the reference's per-sample math and
update semantics exactly. On batches whose ids are internally unique (and
whose history sets are disjoint from the touched pos/neg rows), the batched
step must reproduce the oracle's tables to f32 tolerance — in both clean
"batch" SGD mode and reference-fidelity "accum" mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from heat_cf.config import CFConfig
from heat_cf.models.state import TrainState
from heat_cf.train.samplers import NegSample, SamplerState
from heat_cf.train.train_step import Batch, train_step

import oracle

D = 16
H = 5
B = 32  # one reference aggregator minibatch -> w0 updates align exactly
NUM_USERS = 80
NUM_ITEMS = 400


def make_problem(seed=0, sgd_mode="batch"):
    rng = np.random.default_rng(seed)
    cfg = CFConfig(
        emb_dim=D,
        num_users=NUM_USERS,
        num_items=NUM_ITEMS,
        max_his=H,
        num_negs=3,
        l_r=0.05,
        clip_val=0.5,
        sgd_mode=sgd_mode,
        batch_size=B,
    )
    user_emb = rng.normal(0, 1e-2, (NUM_USERS, D)).astype(np.float32)
    item_emb = rng.normal(0, 1e-2, (NUM_ITEMS, D)).astype(np.float32)
    w0 = rng.normal(0, 1e-2, (D, D)).astype(np.float32)
    # History ids live in a reserved range [300, 400) so they are disjoint
    # from every pos/neg id used below — required for exact sequential
    # equivalence (the oracle reads item rows the batch also updates).
    his_items = rng.integers(300, NUM_ITEMS, (NUM_USERS, H)).astype(np.int32)
    his_masks = rng.integers(1, H + 1, (NUM_USERS,)).astype(np.int32)
    return cfg, user_emb, item_emb, w0, his_items, his_masks, rng


def disjoint_batch(rng, num_samples):
    """users unique; pos+negs unique across the whole batch, in [0, 300)."""
    users = rng.choice(NUM_USERS, size=num_samples, replace=False)
    items = rng.choice(300, size=num_samples * 4, replace=False)
    pos = items[:num_samples]
    negs = items[num_samples:].reshape(num_samples, 3)
    return (
        users.astype(np.int32),
        pos.astype(np.int32),
        negs.astype(np.int32),
    )


def run_batched(cfg, state, users, pos, negs, his_items, his_masks):
    """Drive train_step with pinned negatives via a stub sampler."""
    import heat_cf.train.train_step as ts

    orig = ts.sample_negatives
    try:
        ts.sample_negatives = lambda key, st, p, c, real=None: (
            NegSample(jnp.asarray(negs), None, None), st)
        sstate = SamplerState(
            tile=jnp.zeros((1,), jnp.int32), iterations=jnp.asarray(0)
        )
        batch = Batch(
            jnp.asarray(users),
            jnp.asarray(pos),
            jnp.ones((len(users),), jnp.float32),
        )
        state, _, loss = train_step(
            state,
            sstate,
            jax.random.key(0),
            batch,
            jnp.asarray(his_items),
            jnp.asarray(his_masks),
            cfg,
        )
    finally:
        ts.sample_negatives = orig
    return state, float(loss)


def make_state(cfg, user_emb, item_emb, w0):
    accum = cfg.sgd_mode == "accum"
    return TrainState(
        user_emb=jnp.asarray(user_emb),
        item_emb=jnp.asarray(item_emb),
        w0=jnp.asarray(w0),
        user_gacc=jnp.zeros_like(jnp.asarray(user_emb)) if accum else None,
        item_gacc=jnp.zeros_like(jnp.asarray(item_emb)) if accum else None,
        lr=jnp.asarray(cfg.l_r, jnp.float32),
        step=jnp.asarray(0, jnp.int32),
    )


@pytest.mark.parametrize("sgd_mode", ["batch", "accum"])
def test_batch32_matches_sequential_oracle(sgd_mode):
    cfg, user_emb, item_emb, w0, his_items, his_masks, rng = make_problem(
        seed=1, sgd_mode=sgd_mode
    )
    users, pos, negs = disjoint_batch(rng, B)

    m = oracle.OracleModel.create(user_emb, item_emb, w0)
    oracle_loss = 0.0
    for i in range(B):
        oracle_loss += oracle.forward_backward(
            m,
            int(users[i]),
            int(pos[i]),
            list(negs[i]),
            his_items,
            his_masks,
            lr=cfg.l_r,
            clip_val=cfg.clip_val,
            gamma=cfg.gamma,
            score_mul=cfg.score_mul,
            aggr_minibatch=cfg.aggr_minibatch,
        )

    state = make_state(cfg, user_emb, item_emb, w0)
    state, loss = run_batched(
        cfg, state, users, pos, negs, his_items, his_masks
    )

    np.testing.assert_allclose(loss, oracle_loss, rtol=1e-4)
    np.testing.assert_allclose(
        np.asarray(state.user_emb), m.user_emb, rtol=2e-4, atol=2e-6
    )
    np.testing.assert_allclose(
        np.asarray(state.item_emb), m.item_emb, rtol=2e-4, atol=2e-6
    )
    np.testing.assert_allclose(
        np.asarray(state.w0), m.w0, rtol=2e-4, atol=2e-6
    )


def test_two_batches_accum_mode_matches_oracle():
    """Second batch reuses the first batch's rows: exercises the persistent
    grad tables (gamma rescale, clip-in-place) across batch boundaries."""
    cfg, user_emb, item_emb, w0, his_items, his_masks, rng = make_problem(
        seed=2, sgd_mode="accum"
    )
    users, pos, negs = disjoint_batch(rng, B)

    m = oracle.OracleModel.create(user_emb, item_emb, w0)
    for _ in range(2):
        for i in range(B):
            oracle.forward_backward(
                m,
                int(users[i]),
                int(pos[i]),
                list(negs[i]),
                his_items,
                his_masks,
                lr=cfg.l_r,
                clip_val=cfg.clip_val,
                gamma=cfg.gamma,
                score_mul=cfg.score_mul,
                aggr_minibatch=cfg.aggr_minibatch,
            )

    state = make_state(cfg, user_emb, item_emb, w0)
    for _ in range(2):
        state, _ = run_batched(
            cfg, state, users, pos, negs, his_items, his_masks
        )

    np.testing.assert_allclose(
        np.asarray(state.user_emb), m.user_emb, rtol=5e-4, atol=5e-6
    )
    np.testing.assert_allclose(
        np.asarray(state.item_emb), m.item_emb, rtol=5e-4, atol=5e-6
    )
    np.testing.assert_allclose(
        np.asarray(state.w0), m.w0, rtol=5e-4, atol=5e-6
    )
    np.testing.assert_allclose(
        np.asarray(state.user_gacc), m.user_gacc, rtol=5e-4, atol=5e-6
    )
    np.testing.assert_allclose(
        np.asarray(state.item_gacc), m.item_gacc, rtol=5e-4, atol=5e-6
    )


def test_padding_rows_are_inert():
    cfg, user_emb, item_emb, w0, his_items, his_masks, rng = make_problem(
        seed=3
    )
    users, pos, negs = disjoint_batch(rng, 8)
    state = make_state(cfg, user_emb, item_emb, w0)

    # Padded batch: 8 real + 8 weight-0 rows pointing at *other* real rows.
    pad_users = rng.choice(NUM_USERS, size=8, replace=False).astype(np.int32)
    pad_pos = rng.integers(0, 300, 8).astype(np.int32)
    pad_negs = rng.integers(0, 300, (8, 3)).astype(np.int32)

    import heat_cf.train.train_step as ts

    all_negs = np.concatenate([negs, pad_negs])
    orig = ts.sample_negatives
    try:
        ts.sample_negatives = lambda key, st, p, c, real=None: (
            NegSample(jnp.asarray(all_negs), None, None), st)
        sstate = SamplerState(
            tile=jnp.zeros((1,), jnp.int32), iterations=jnp.asarray(0)
        )
        batch = Batch(
            jnp.asarray(np.concatenate([users, pad_users])),
            jnp.asarray(np.concatenate([pos, pad_pos])),
            jnp.concatenate(
                [jnp.ones((8,), jnp.float32), jnp.zeros((8,), jnp.float32)]
            ),
        )
        padded_state, _, padded_loss = train_step(
            state,
            sstate,
            jax.random.key(0),
            batch,
            jnp.asarray(his_items),
            jnp.asarray(his_masks),
            cfg,
        )
    finally:
        ts.sample_negatives = orig

    state2 = make_state(cfg, user_emb, item_emb, w0)
    unpadded_state, unpadded_loss = run_batched(
        cfg, state2, users, pos, negs, his_items, his_masks
    )
    np.testing.assert_allclose(padded_loss, unpadded_loss, rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(padded_state.user_emb),
        np.asarray(unpadded_state.user_emb),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(padded_state.item_emb),
        np.asarray(unpadded_state.item_emb),
        rtol=1e-6,
    )


def test_duplicate_ids_sum_gradients():
    """Two occurrences of a user in one batch must apply the summed grad."""
    cfg, user_emb, item_emb, w0, his_items, his_masks, rng = make_problem(
        seed=4
    )
    users = np.array([5, 5], np.int32)
    pos = np.array([10, 11], np.int32)
    negs = np.array([[20, 21, 22], [23, 24, 25]], np.int32)
    state = make_state(cfg, user_emb, item_emb, w0)
    new_state, loss = run_batched(
        cfg, state, users, pos, negs, his_items, his_masks
    )
    assert np.isfinite(loss)
    # The duplicated user's row changed and is finite.
    row = np.asarray(new_state.user_emb[5])
    assert np.all(np.isfinite(row))
    assert not np.allclose(row, user_emb[5])
    # Untouched rows identical.
    untouched = np.setdiff1d(np.arange(NUM_USERS), users)
    np.testing.assert_array_equal(
        np.asarray(new_state.user_emb[untouched]), user_emb[untouched]
    )
