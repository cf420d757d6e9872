"""SimpleX aggregation variants: mean / self-attention / user-attention.

The reference names all three choices (behavior_aggregators.cpp:27) but
implements only average pooling; the attention variants back the paper's
ACCL configurations (ICS'23 section 5.2). These tests pin the pooling math
against a numpy oracle and exercise end-to-end training with each variant.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from heat_cf.config import CFConfig, config_from_dicts
from heat_cf.data.synthetic import synthetic_click_dataset
from heat_cf.models.aggregator import (
    history_mean,
    history_mean_fused,
    pool_history,
)
from heat_cf.models.state import init_train_state
from heat_cf.train.engine import Engine, compute_user_pools


def _np_attention_pool(his, mask, query):
    """Oracle: masked scaled-dot softmax pooling, per batch row."""
    b, h, d = his.shape
    out = np.zeros((b, d), np.float32)
    for i in range(b):
        n = int(mask[i])
        if n == 0:
            continue
        logits = his[i, :n] @ query[i] / np.sqrt(d)
        e = np.exp(logits - logits.max())
        a = e / e.sum()
        out[i] = a @ his[i, :n]
    return out


@pytest.fixture(scope="module")
def pool_inputs():
    rng = np.random.default_rng(3)
    b, h, d = 6, 5, 8
    his = rng.normal(size=(b, h, d)).astype(np.float32)
    mask = np.array([5, 3, 1, 0, 2, 4], np.int32)
    u = rng.normal(size=(b, d)).astype(np.float32)
    q = rng.normal(size=(d,)).astype(np.float32)
    return his, mask, u, q


def test_pool_mean_matches_history_mean(pool_inputs):
    his, mask, _, _ = pool_inputs
    got = pool_history(jnp.asarray(his), jnp.asarray(mask), kind="mean")
    want = history_mean(jnp.asarray(his), jnp.asarray(mask))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("h", [3, 5, 7, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_history_mean_fused_matches_gathered(h, dtype):
    """The chunked gather-fused mean must equal gather + history_mean on
    arbitrary ids/masks (incl. H not divisible by the chunk, empty
    histories, and bf16 tables)."""
    rng = np.random.default_rng(7)
    i_n, d, b = 500, 16, 64
    table = jnp.asarray(
        rng.normal(scale=0.1, size=(i_n, d)).astype(np.float32)
    ).astype(dtype)
    ids = jnp.asarray(rng.integers(0, i_n, (b, h)).astype(np.int32))
    mask = jnp.asarray(rng.integers(0, h + 1, (b,)).astype(np.int32))
    got = np.asarray(
        jax.jit(history_mean_fused)(table, ids, mask), np.float32
    )
    want = np.asarray(
        history_mean(table[ids], mask), np.float32
    )
    tol = 1e-6 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * 0.1)
    assert np.all(got[np.asarray(mask) == 0] == 0.0)


def test_self_attention_pool_oracle(pool_inputs):
    his, mask, _, q = pool_inputs
    got = np.asarray(
        pool_history(
            jnp.asarray(his),
            jnp.asarray(mask),
            attn_q=jnp.asarray(q),
            kind="self_attention",
        )
    )
    want = _np_attention_pool(his, mask, np.broadcast_to(q, his[:, 0].shape))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # Empty history pools to exactly zero.
    np.testing.assert_array_equal(got[3], 0.0)


def test_user_attention_pool_oracle(pool_inputs):
    his, mask, u, _ = pool_inputs
    got = np.asarray(
        pool_history(
            jnp.asarray(his),
            jnp.asarray(mask),
            u=jnp.asarray(u),
            kind="user_attention",
        )
    )
    want = _np_attention_pool(his, mask, u)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[3], 0.0)


def test_attention_gradients_flow_and_are_finite(pool_inputs):
    his, mask, u, q = pool_inputs

    def f_q(q):
        return jnp.sum(
            pool_history(
                jnp.asarray(his), jnp.asarray(mask), attn_q=q,
                kind="self_attention",
            )
            ** 2
        )

    def f_u(u):
        return jnp.sum(
            pool_history(
                jnp.asarray(his), jnp.asarray(mask), u=u,
                kind="user_attention",
            )
            ** 2
        )

    g_q = np.asarray(jax.grad(f_q)(jnp.asarray(q)))
    g_u = np.asarray(jax.grad(f_u)(jnp.asarray(u)))
    assert np.isfinite(g_q).all() and np.abs(g_q).sum() > 0
    assert np.isfinite(g_u).all()
    # Empty-history row contributes no gradient (the where() guard must not
    # leak NaNs from the masked softmax).
    np.testing.assert_array_equal(g_u[3], 0.0)
    assert np.abs(g_u[np.array([0, 1, 2, 4, 5])]).sum() > 0


def test_config_aggregator_keys():
    cfg = config_from_dicts({"aggregation": "self_attention"})
    assert cfg.aggregator == "self_attention"
    with pytest.raises(ValueError):
        CFConfig(aggregator="bogus")


def test_state_has_attn_q_only_for_self_attention():
    key = jax.random.key(0)
    s = init_train_state(CFConfig(aggregator="self_attention"), key)
    assert s.attn_q is not None and s.attn_q.shape == (64,)
    s = init_train_state(CFConfig(aggregator="user_attention"), key)
    assert s.attn_q is None


@pytest.fixture(scope="module")
def data():
    return synthetic_click_dataset(
        num_users=300,
        num_items=500,
        num_clusters=8,
        clicks_per_user=30,
        max_his=10,
        seed=11,
    )


def _cfg(**kw):
    base = dict(
        emb_dim=16,
        num_negs=8,
        max_his=10,
        l_r=0.05,
        clip_val=1.0,
        batch_size=256,
        seed=7,
        metrics=["Recall(k=20)"],
    )
    base.update(kw)
    return CFConfig(**base)


@pytest.mark.parametrize("agg", ["self_attention", "user_attention"])
def test_attention_aggregator_trains(data, agg):
    train, test = data
    eng = Engine(_cfg(aggregator=agg), train, test)
    losses = [eng.train_one_epoch() for _ in range(6)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.8, losses
    m = eng.evaluate()
    assert m["Recall(k=20)"] > 0.15, m


def test_user_attention_with_cached_pools_and_tile_sampler(data):
    # his_refresh=subepoch caches the attention-pooled history per epoch
    # (refresh-time query) — the fast path must stay numerically sane and
    # keep learning under the tile sampler too.
    train, test = data
    eng = Engine(
        _cfg(
            aggregator="user_attention",
            his_refresh="subepoch",
            neg_sampler=1,
            tile_size=128,
            refresh_interval=512,
        ),
        train,
        test,
    )
    losses = [eng.train_one_epoch() for _ in range(6)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_self_attention_rejects_cached_pools():
    # Under cached pooling attn_q's only gradient path is severed; the
    # config must refuse rather than silently train a frozen random query.
    with pytest.raises(ValueError, match="self_attention"):
        _cfg(aggregator="self_attention", his_refresh="subepoch")


def test_self_attention_query_actually_trains(data):
    train, _ = data
    eng = Engine(_cfg(aggregator="self_attention"), train)
    q0 = np.asarray(eng.state.attn_q).copy()
    eng.train_one_epoch()
    assert np.abs(np.asarray(eng.state.attn_q) - q0).max() > 0


def test_compute_user_pools_matches_pool_history(data):
    train, _ = data
    cfg = _cfg(aggregator="user_attention")
    eng = Engine(cfg, train)
    his_2d = jnp.asarray(train.his_items, jnp.int32)
    direct = pool_history(
        eng.state.item_emb[his_2d],
        eng.his_masks,
        u=eng.state.user_emb,
        kind="user_attention",
    )
    for his, max_his in ((his_2d, None), (eng.his_items, cfg.max_his)):
        # eng.his_items is the flat (U*H,) layout (small max_his); both
        # layouts must pool identically.
        pooled = compute_user_pools(
            eng.state.item_emb,
            his,
            eng.his_masks,
            user_emb=eng.state.user_emb,
            aggregator="user_attention",
            chunk=64,  # force multiple chunks + a clamped partial chunk
            max_his=max_his,
        )
        np.testing.assert_allclose(
            np.asarray(pooled), np.asarray(direct), rtol=1e-5, atol=1e-6
        )
