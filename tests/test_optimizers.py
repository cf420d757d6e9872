"""Optimizer menu: SGD (reference) plus row-sparse Adagrad / lazy Adam.

The reference YAMLs carry ``optimizer: sgd`` and the engine hardcodes SGD
regardless (engine.cpp:16); here the key is honored and the sparse
Adagrad/Adam transforms are pinned against numpy oracles (duplicate-id
combine -> clip -> moment update), the sorted huge-table path against the
dense path, and end-to-end training with each optimizer.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from heat_cf.config import CFConfig, config_from_dicts
from heat_cf.data.synthetic import synthetic_click_dataset
from heat_cf.models.state import init_train_state
from heat_cf.parallel.mesh import make_mesh
from heat_cf.train.engine import Engine
from heat_cf.train.scatter import (
    _apply_row_updates_opt_dense,
    _apply_row_updates_opt_sorted,
    dense_opt_update,
)

EPS = 1e-8


def _combine_clip(ids, grads, num_rows, clip_val):
    acc = np.zeros((num_rows, grads.shape[1]), np.float32)
    for i, g in zip(ids, grads):
        if i < num_rows:
            acc[i] += g
    return np.clip(acc, -clip_val, clip_val)


@pytest.fixture()
def rows():
    rng = np.random.default_rng(5)
    num_rows, d = 10, 4
    table = rng.normal(size=(num_rows, d)).astype(np.float32)
    # duplicates (3 appears twice) and one padding id == num_rows
    ids = np.array([3, 7, 3, 0, 10], np.int32)
    grads = rng.normal(size=(5, d)).astype(np.float32)
    return num_rows, table, ids, grads


def test_adagrad_dense_oracle(rows):
    num_rows, table, ids, grads = rows
    clip_val, lr = 0.5, 0.1
    v0 = np.abs(np.random.default_rng(1).normal(size=table.shape)).astype(
        np.float32
    )
    new_table, new_m, new_v = _apply_row_updates_opt_dense(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(grads),
        lr=jnp.float32(lr), clip_val=clip_val, step=jnp.int32(1),
        m=None, v=jnp.asarray(v0), beta1=0.9, beta2=0.999, eps=EPS, l2=0.0,
    )
    assert new_m is None
    g = _combine_clip(ids, grads, num_rows, clip_val)
    want_v = v0 + g * g
    want_table = table - lr * g / (np.sqrt(want_v) + EPS)
    np.testing.assert_allclose(np.asarray(new_v), want_v, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(new_table), want_table, rtol=1e-5)
    # Untouched rows unchanged.
    np.testing.assert_array_equal(np.asarray(new_table)[1], table[1])


def test_adam_dense_oracle_two_steps(rows):
    num_rows, table, ids, grads = rows
    clip_val, lr, b1, b2 = 0.5, 0.1, 0.9, 0.999
    m = np.zeros_like(table)
    v = np.zeros_like(table)
    t_j = jnp.asarray(table)
    m_j = jnp.asarray(m)
    v_j = jnp.asarray(v)
    for step in (1, 2):
        t_j, m_j, v_j = _apply_row_updates_opt_dense(
            t_j, jnp.asarray(ids), jnp.asarray(grads),
            lr=jnp.float32(lr), clip_val=clip_val, step=jnp.int32(step),
            m=m_j, v=v_j, beta1=b1, beta2=b2, eps=EPS, l2=0.0,
        )
        g = _combine_clip(ids, np.asarray(grads), num_rows, clip_val)
        touched = np.zeros((num_rows, 1), bool)
        for i in ids:
            if i < num_rows:
                touched[i] = True
        m = np.where(touched, b1 * m + (1 - b1) * g, m)
        v = np.where(touched, b2 * v + (1 - b2) * g * g, v)
        m_hat = m / (1 - b1**step)
        v_hat = v / (1 - b2**step)
        table = table - lr * (m_hat / (np.sqrt(v_hat) + EPS)) * touched
    # rtol 1e-4: the device computes beta**t bias corrections in f32
    # (the oracle is f64) and 1 - 0.999**t is catastrophically small.
    np.testing.assert_allclose(np.asarray(t_j), table, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(m_j), m, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(v_j), v, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("with_m", [False, True])
def test_sorted_path_matches_dense(rows, with_m):
    num_rows, table, ids, grads = rows
    kw = dict(
        lr=jnp.float32(0.05), clip_val=0.3, step=jnp.int32(3),
        beta1=0.9, beta2=0.999, eps=EPS, l2=1e-3,
    )
    m0 = jnp.abs(jnp.asarray(table)) * 0.1 if with_m else None
    v0 = jnp.abs(jnp.asarray(table)) * 0.2 + 0.01
    d_t, d_m, d_v = _apply_row_updates_opt_dense(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(grads),
        m=m0, v=v0, **kw,
    )
    s_t, s_m, s_v = _apply_row_updates_opt_sorted(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(grads),
        m=m0, v=v0, **kw,
    )
    np.testing.assert_allclose(np.asarray(d_t), np.asarray(s_t), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(d_v), np.asarray(s_v), rtol=1e-5, atol=1e-7)
    if with_m:
        np.testing.assert_allclose(
            np.asarray(d_m), np.asarray(s_m), rtol=1e-5, atol=1e-7
        )


def test_dense_opt_update_adam_oracle():
    rng = np.random.default_rng(2)
    w = rng.normal(size=(4, 4)).astype(np.float32)
    g = rng.normal(size=(4, 4)).astype(np.float32)
    slots = {
        "w0_m": jnp.zeros((4, 4), jnp.float32),
        "w0_v": jnp.zeros((4, 4), jnp.float32),
    }
    new_w, new_slots = dense_opt_update(
        jnp.asarray(w), jnp.asarray(g), slots, "w0",
        lr=jnp.float32(0.01), step=jnp.int32(1),
        beta1=0.9, beta2=0.999, eps=EPS,
    )
    m = 0.1 * g
    v = 0.001 * g * g
    m_hat = m / 0.1
    v_hat = v / 0.001
    want = w - 0.01 * m_hat / (np.sqrt(v_hat) + EPS)
    np.testing.assert_allclose(np.asarray(new_w), want, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(new_slots["w0_m"]), m, rtol=1e-6)


def test_config_optimizer_validation():
    cfg = config_from_dicts({"optimizer": "Adam"})
    assert cfg.optimizer == "adam"
    with pytest.raises(ValueError):
        CFConfig(optimizer="rmsprop")
    with pytest.raises(ValueError):
        CFConfig(optimizer="adam", sgd_mode="accum")


def test_state_slots_shapes():
    key = jax.random.key(0)
    s = init_train_state(CFConfig(optimizer="adagrad"), key)
    assert set(s.opt_slots) == {"user_v", "item_v", "w0_v"}
    s = init_train_state(
        CFConfig(optimizer="adam", aggregator="self_attention"), key
    )
    assert set(s.opt_slots) == {
        "user_v", "item_v", "w0_v", "attn_q_v",
        "user_m", "item_m", "w0_m", "attn_q_m",
    }
    assert s.opt_slots["attn_q_m"].shape == (64,)
    s = init_train_state(CFConfig(), key)
    assert s.opt_slots is None


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
        l_r=0.01,
        clip_val=1.0,
        batch_size=256,
        seed=7,
        metrics=["Recall(k=20)"],
    )
    base.update(kw)
    return CFConfig(**base)


@pytest.mark.parametrize("opt", ["adagrad", "adam"])
def test_optimizer_trains(data, opt):
    train, test = data
    eng = Engine(_cfg(optimizer=opt), train, test)
    losses = [eng.train_one_epoch() for _ in range(6)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9, losses
    m = eng.evaluate()
    assert m["Recall(k=20)"] > 0.1, m


def test_adam_with_tile_sampler_trains(data):
    train, test = data
    eng = Engine(
        _cfg(optimizer="adam", neg_sampler=1, tile_size=128,
             refresh_interval=512),
        train,
        test,
    )
    losses = [eng.train_one_epoch() for _ in range(4)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_adam_on_mesh_trains(data):
    assert len(jax.devices()) >= 8
    train, test = data
    mesh = make_mesh(2, 4, jax.devices()[:8])
    # num_users=300 not divisible by data axis is fine single-process;
    # sharding pads internally via GSPMD.
    eng = Engine(_cfg(optimizer="adam"), train, test, mesh=mesh)
    losses = [eng.train_one_epoch() for _ in range(3)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
