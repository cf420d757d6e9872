"""Negative-sampler tests: ranges, pos-avoidance, tile refresh cadence."""

import jax
import jax.numpy as jnp
import numpy as np

from heat_cf.config import CFConfig, NEG_SAMPLER_TILE
from heat_cf.train.samplers import init_sampler_state, sample_negatives


def test_uniform_range_and_pos_avoidance():
    cfg = CFConfig(num_items=50, num_negs=8, ignore_pos=True)
    state = init_sampler_state(cfg, jax.random.key(0))
    pos = jnp.asarray(np.full(256, 7), jnp.int32)
    sample, state = sample_negatives(jax.random.key(1), state, pos, cfg)
    negs = sample.ids
    n = np.asarray(negs)
    assert n.shape == (256, 8)
    assert n.min() >= 0 and n.max() < 50
    # A first-draw collision with pos is redrawn; double collision odds are
    # (1/50)^2 per slot — none expected in 2048 draws with this key.
    assert (n == 7).mean() < 0.01
    assert int(state.iterations) == 256


def test_uniform_covers_item_space():
    cfg = CFConfig(num_items=20, num_negs=4, ignore_pos=False)
    state = init_sampler_state(cfg, jax.random.key(0))
    pos = jnp.zeros(500, jnp.int32)
    sample, _ = sample_negatives(jax.random.key(2), state, pos, cfg)
    negs = sample.ids
    seen = np.unique(np.asarray(negs))
    assert len(seen) == 20  # all items reachable


def test_tile_sampler_draws_within_tile():
    cfg = CFConfig(
        num_items=1000,
        num_negs=4,
        neg_sampler=NEG_SAMPLER_TILE,
        tile_size=16,
        refresh_interval=10_000,
    )
    state = init_sampler_state(cfg, jax.random.key(3))
    pos = jnp.zeros(64, jnp.int32)
    sample, state2 = sample_negatives(jax.random.key(4), state, pos, cfg)
    negs = sample.ids
    tile = set(np.asarray(state2.tile).tolist())
    assert set(np.asarray(negs).ravel().tolist()) <= tile
    assert len(tile) <= 16


def test_tile_refresh_on_interval_crossing():
    cfg = CFConfig(
        num_items=100_000,
        num_negs=2,
        neg_sampler=NEG_SAMPLER_TILE,
        tile_size=32,
        refresh_interval=128,
    )
    state = init_sampler_state(cfg, jax.random.key(5))
    pos = jnp.zeros(64, jnp.int32)
    # batch 1 covers samples [0, 64): sample 0 triggers a refresh.
    _, s1 = sample_negatives(jax.random.key(6), state, pos, cfg)
    t1 = np.asarray(s1.tile)
    # batch 2 covers [64, 128): no multiple of 128 inside -> unchanged.
    _, s2 = sample_negatives(jax.random.key(7), s1, pos, cfg)
    assert np.array_equal(np.asarray(s2.tile), t1)
    # batch 3 covers [128, 192): sample 128 triggers a refresh.
    _, s3 = sample_negatives(jax.random.key(8), s2, pos, cfg)
    assert not np.array_equal(np.asarray(s3.tile), t1)


def test_derive_tile_params_auto_tuning():
    """Alg.-1-style auto tile sizing: reproduces the reference's shipped
    AmazonBooks tuning at its geometry, rounds to lanes, respects the item
    count, and never fires more than one refresh per batch."""
    from heat_cf.train.samplers import derive_tile_params

    cfg = CFConfig(
        emb_dim=64, num_negs=16, batch_size=8192, num_items=91_599,
        neg_sampler=1, tile_size=0,
    )
    t, r = derive_tile_params(cfg)
    assert t == 512 and r == 8192  # AmazonBooks config0.yaml values

    small = CFConfig(
        emb_dim=16, num_negs=8, batch_size=256, num_items=300,
        neg_sampler=1, tile_size=0,
    )
    t, r = derive_tile_params(small)
    assert t % 128 == 0 and t <= 300
    assert r >= small.batch_size

    from heat_cf.data.synthetic import synthetic_click_dataset
    from heat_cf.train.engine import Engine

    train, test = synthetic_click_dataset(
        num_users=100, num_items=400, clicks_per_user=10, max_his=4, seed=1
    )
    cfg = CFConfig(
        emb_dim=16, num_negs=8, batch_size=256, neg_sampler=1, tile_size=0,
        max_his=4,
    )
    eng = Engine(cfg, train, test)
    assert eng.cfg.tile_size > 0  # auto-resolved before sampler init
    loss = eng.train_one_epoch()
    assert np.isfinite(loss)


def test_constrained_tile_sampling_touches_only_pool_rows():
    """Sub-epoch partition-complement constraint with the TILE sampler
    (round 4: the whole-tile fast path now composes with constraints by
    remapping the tile through the pool): the item-table update may touch
    only positive rows and pool member rows — never a partitioned-out
    item."""
    import dataclasses

    from heat_cf.config import CFConfig as C
    from heat_cf.models.state import init_train_state
    from heat_cf.train.train_step import Batch, train_step

    cfg = C(
        num_users=40, num_items=60, emb_dim=8, num_negs=4, max_his=5,
        batch_size=16, l_r=0.1, clip_val=1.0, neg_sampler=NEG_SAMPLER_TILE,
        tile_size=8, refresh_interval=16, his_refresh="subepoch",
    )
    key = jax.random.key(0)
    state = init_train_state(cfg, key)
    sstate = init_sampler_state(cfg, key)
    pool = jnp.asarray(np.arange(30, 55, dtype=np.int32))  # complement
    users = jnp.arange(16, dtype=jnp.int32)
    pos = jnp.asarray(np.arange(16, dtype=np.int32))  # rows 0..15
    batch = Batch(users, pos, jnp.ones((16,), jnp.float32))
    his = jnp.zeros((40, 5), jnp.int32)
    masks = jnp.zeros((40,), jnp.int32)
    means = jnp.zeros((40, 8))
    new_state, _, _ = train_step(
        state, sstate, jax.random.key(3), batch, his, masks, cfg,
        neg_candidates=pool, user_means=means,
        neg_candidates_size=jnp.asarray(20, jnp.int32),  # valid prefix
    )
    changed = np.where(
        np.any(np.asarray(new_state.item_emb) != np.asarray(state.item_emb),
               axis=1)
    )[0]
    allowed = set(range(16)) | set(np.asarray(pool[:20]).tolist())
    assert set(changed.tolist()) <= allowed, (
        sorted(set(changed.tolist()) - allowed)
    )
