"""Sharded execution equivalence: the same epoch on an 8-device mesh must
match single-device results (XLA collectives are exact, SURVEY.md section 7:
determinism tests replace the reference's hogwild race tolerance)."""

import jax
import numpy as np
import pytest

from heat_cf.config import CFConfig
from heat_cf.data.synthetic import synthetic_click_dataset
from heat_cf.parallel.mesh import default_mesh_shape, make_mesh
from heat_cf.train.engine import Engine


def _cfg():
    return CFConfig(
        emb_dim=16,
        num_negs=4,
        max_his=8,
        l_r=0.05,
        batch_size=128,
        milestones=[10],
        seed=3,
    )


@pytest.fixture(scope="module")
def data():
    return synthetic_click_dataset(
        num_users=128,
        num_items=256,
        clicks_per_user=20,
        max_his=8,
        seed=9,
    )


def test_mesh_shapes():
    assert default_mesh_shape(8) == (2, 4)
    assert default_mesh_shape(4) == (1, 4)
    assert default_mesh_shape(2) == (1, 2)
    assert default_mesh_shape(1) == (1, 1)


def test_sharded_step_matches_single_device(data):
    """One fused step (batch >= all pairs) must match the unsharded result
    tightly; across many sequential steps f32 reduction-order noise
    amplifies chaotically, so multi-epoch runs are compared qualitatively
    in test_sharded_multi_epoch_training below."""
    train, test = data
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    cfg = _cfg()
    cfg.batch_size = 1 << 12  # > train_size -> a single batched step

    e_single = Engine(cfg, train, test)
    loss_single = e_single.train_one_epoch()

    mesh = make_mesh(2, 4, jax.devices()[:8])
    cfg2 = _cfg()
    cfg2.batch_size = 1 << 12
    e_sharded = Engine(cfg2, train, test, mesh=mesh)
    loss_sharded = e_sharded.train_one_epoch()

    np.testing.assert_allclose(loss_sharded, loss_single, rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(e_sharded.state.user_emb),
        np.asarray(e_single.state.user_emb),
        rtol=1e-4,
        atol=5e-6,
    )
    # Item rows receive up to B*(1+K) scatter contributions whose reduction
    # order differs under sharding; tolerance reflects f32 noise on ~1e-2
    # magnitudes, not a semantic difference.
    np.testing.assert_allclose(
        np.asarray(e_sharded.state.item_emb),
        np.asarray(e_single.state.item_emb),
        rtol=1e-2,
        atol=2e-6,
    )
    # The sharded run kept its layout.
    assert "data" in str(e_sharded.state.user_emb.sharding)


def test_sharded_multi_epoch_training(data):
    train, test = data
    mesh = make_mesh(2, 4, jax.devices()[:8])
    e_single = Engine(_cfg(), train, test)
    e_sharded = Engine(_cfg(), train, test, mesh=mesh)
    ls = [e_single.train_one_epoch() for _ in range(3)]
    lsh = [e_sharded.train_one_epoch() for _ in range(3)]
    assert lsh[-1] < lsh[0]
    np.testing.assert_allclose(lsh, ls, rtol=5e-2)


def test_sharded_fused_epochs_match_per_epoch(data):
    """train_epochs(n) under a mesh (the fused multi-epoch device program,
    now shardable) must reproduce n sequential
    train_one_epoch calls on the SAME mesh: same key draws, same shuffle,
    same batch shardings, same losses and tables."""
    train, test = data
    mesh = make_mesh(2, 4, jax.devices()[:8])
    e_seq = Engine(_cfg(), train, test, mesh=mesh)
    e_fused = Engine(_cfg(), train, test, mesh=mesh)
    seq = [e_seq.train_one_epoch() for _ in range(3)]
    fused = e_fused.train_epochs(3)
    np.testing.assert_allclose(fused, seq, rtol=1e-5)
    assert e_fused.epoch == 3
    np.testing.assert_allclose(
        np.asarray(e_fused.state.user_emb),
        np.asarray(e_seq.state.user_emb),
        rtol=1e-5, atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(e_fused.state.item_emb),
        np.asarray(e_seq.state.item_emb),
        rtol=1e-5, atol=1e-6,
    )
    # The fused run keeps the mesh layout on its outputs.
    assert e_fused.state.user_emb.sharding.is_equivalent_to(
        e_seq.state.user_emb.sharding, e_seq.state.user_emb.ndim
    )


def test_sharded_fused_epochs_odd_tables(data):
    """Fused epochs + mesh-divisibility padding (odd table sizes) compose."""
    train, test = data
    mesh = make_mesh(2, 4, jax.devices()[:8])
    cfg = _cfg()
    e = Engine(cfg, train, test, mesh=mesh)
    assert e._pad_items or e._pad_users or (
        train.num_users % 2 == 0 and train.num_items % 4 == 0
    )
    losses = e.train_epochs(2)
    assert np.isfinite(losses).all() and losses[1] < losses[0]


def test_sharded_evaluate(data):
    train, test = data
    mesh = make_mesh(4, 2, jax.devices()[:8])
    eng = Engine(_cfg(), train, test, mesh=mesh)
    eng.train_one_epoch()
    m = eng.evaluate()
    assert 0.0 <= m["Recall(k=20)"] <= 1.0


def test_sharded_tile_sampler_matches_single_device(data):
    """The whole-tile MXU scoring path (multiplicity-weighted losses, tile
    gradient via transposed matmul) under the 8-device mesh must match the
    unsharded tile run — the headline bench configuration is tile mode, so
    its sharded lowering (tile gather across "model" shards + replicated
    counts) needs the same equivalence guarantee as the uniform path."""
    train, test = data
    cfg = _cfg()
    cfg.batch_size = 1 << 12
    cfg.neg_sampler = 1
    cfg.tile_size = 64
    cfg.refresh_interval = 1 << 12

    e_single = Engine(cfg, train, test)
    loss_single = e_single.train_one_epoch()

    mesh = make_mesh(2, 4, jax.devices()[:8])
    cfg2 = _cfg()
    cfg2.batch_size = 1 << 12
    cfg2.neg_sampler = 1
    cfg2.tile_size = 64
    cfg2.refresh_interval = 1 << 12
    e_sharded = Engine(cfg2, train, test, mesh=mesh)
    loss_sharded = e_sharded.train_one_epoch()

    np.testing.assert_allclose(loss_sharded, loss_single, rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(e_sharded.state.user_emb),
        np.asarray(e_single.state.user_emb),
        rtol=1e-4,
        atol=5e-6,
    )
    np.testing.assert_allclose(
        np.asarray(e_sharded.state.item_emb),
        np.asarray(e_single.state.item_emb),
        rtol=1e-2,
        atol=2e-6,
    )


def test_sharded_odd_table_sizes_padded(data):
    """Table row counts not divisible by the mesh axes get padded dead
    rows (single-process meshes); training matches the unsharded run and
    evaluate()/unpadded_state() hide the padding."""
    odd = synthetic_click_dataset(
        num_users=131,   # prime: not divisible by data axis 2
        num_items=253,   # 11*23: not divisible by model axis 4
        clicks_per_user=20,
        max_his=8,
        seed=13,
    )
    train, test = odd
    cfg = _cfg()
    cfg.batch_size = 1 << 12  # single batched step

    e_single = Engine(cfg, train, test)
    loss_single = e_single.train_one_epoch()

    mesh = make_mesh(2, 4, jax.devices()[:8])
    cfg2 = _cfg()
    cfg2.batch_size = 1 << 12
    e_sharded = Engine(cfg2, train, test, mesh=mesh)
    assert e_sharded._pad_users == 1 and e_sharded._pad_items == 3
    assert e_sharded.state.user_emb.shape[0] == 132
    assert e_sharded.state.item_emb.shape[0] == 256
    loss_sharded = e_sharded.train_one_epoch()
    np.testing.assert_allclose(loss_sharded, loss_single, rtol=1e-5)

    st = e_sharded.unpadded_state()
    assert st.user_emb.shape[0] == 131 and st.item_emb.shape[0] == 253
    np.testing.assert_allclose(
        np.asarray(st.user_emb),
        np.asarray(e_single.state.user_emb),
        rtol=1e-4,
        atol=5e-6,
    )
    np.testing.assert_allclose(
        np.asarray(st.item_emb),
        np.asarray(e_single.state.item_emb),
        rtol=1e-2,
        atol=2e-6,
    )
    m_sh = e_sharded.evaluate()
    m_si = e_single.evaluate()
    for k in m_si:
        np.testing.assert_allclose(m_sh[k], m_si[k], rtol=0.2, atol=0.02)

    # Tile sampler + cached means through the padded tables.
    cfg3 = _cfg()
    cfg3.batch_size = 1 << 12
    cfg3.neg_sampler = 1
    cfg3.tile_size = 32
    cfg3.refresh_interval = 4096
    cfg3.his_refresh = "subepoch"
    e_tile = Engine(cfg3, train, test, mesh=mesh)
    l0 = e_tile.train_one_epoch()
    l1 = e_tile.train_one_epoch()
    assert np.isfinite(l0) and np.isfinite(l1)


def test_sharded_direct_update_mode(data):
    """update_mode='direct' scatter-adds straight into the row-sharded
    tables. Unlike the dedup path (one combined update per row), the
    per-occurrence adds apply in partition-dependent order, so the sharded
    run matches the single-device run only up to f32 associativity noise
    (which SGD then amplifies) — assert tracking, not bit equality."""
    train, test = data
    cfg1 = _cfg()
    cfg1.update_mode = "direct"
    e_single = Engine(cfg1, train, test)
    l_single = [e_single.train_one_epoch() for _ in range(2)]

    mesh = make_mesh(2, 4, jax.devices()[:8])
    cfg2 = _cfg()
    cfg2.update_mode = "direct"
    e_sharded = Engine(cfg2, train, test, mesh=mesh)
    l_sharded = [e_sharded.train_one_epoch() for _ in range(2)]
    np.testing.assert_allclose(l_sharded[0], l_single[0], rtol=5e-4)
    np.testing.assert_allclose(l_sharded[1], l_single[1], rtol=2e-2)
    assert np.isfinite(l_sharded).all()


def test_sharded_emb_pad_composes(data):
    """Physical column padding (CFConfig.emb_pad) composes with the mesh's
    row-sharding (and row-divisibility padding): the padded-width tables
    row-shard over the same layout, train, and evaluate like the
    unsharded padded engine."""
    train, test = data
    mesh = make_mesh(2, 4, jax.devices()[:8])
    cfg_kw = dict(
        emb_dim=16, num_negs=4, max_his=10, l_r=0.05, batch_size=256,
        seed=7, metrics=["Recall(k=20)"], emb_pad=128,
    )
    e_mesh = Engine(CFConfig(**cfg_kw), train, test, mesh=mesh)
    e_ref = Engine(CFConfig(**cfg_kw), train, test)
    losses_mesh = [e_mesh.train_one_epoch() for _ in range(2)]
    losses_ref = [e_ref.train_one_epoch() for _ in range(2)]
    np.testing.assert_allclose(losses_mesh, losses_ref, rtol=5e-2)
    assert e_mesh.state.user_emb.shape[1] == 128
    # Tails stay zero under sharded updates too.
    ue = np.asarray(e_mesh.state.user_emb)
    assert not ue[:, 16:].any()
    m = e_mesh.evaluate()
    assert 0.0 <= m["Recall(k=20)"] <= 1.0


def test_scaling_smoke_sweep():
    """The demoted scaling harness (scripts/scaling_smoke.py) runs as a
    labeled functional smoke in the test flow: every mesh size trains with
    finite, 1-device-consistent losses (throughput is NOT measured — real
    multi-chip scaling is hardware-blocked; see BASELINE.md)."""
    import importlib.util
    import pathlib

    path = (
        pathlib.Path(__file__).resolve().parents[1]
        / "scripts" / "scaling_smoke.py"
    )
    spec = importlib.util.spec_from_file_location("scaling_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    losses = mod.sweep(counts=[1, 4, 8])
    assert set(losses) == {1, 4, 8}


@pytest.mark.parametrize(
    "agg,refresh",
    [
        ("user_attention", "subepoch"),
        ("user_attention", "step"),
        ("self_attention", "step"),
    ],
    ids=["user_cached", "user_step", "self_step"],
)
def test_sharded_attention_aggregators(data, agg, refresh):
    """Round 5: the ACCL attention aggregators under the mesh — one
    batched step matches the single-device result (attn_q replicated,
    pooling with the user-row / learned query under GSPMD), and
    multi-epoch training stays finite and descends."""
    train, test = data
    cfg = _cfg()
    cfg.aggregator = agg
    cfg.his_refresh = refresh
    cfg.batch_size = 1 << 12  # single batched step for the tight compare
    e_single = Engine(cfg, train, test)
    loss_single = e_single.train_one_epoch()
    mesh = make_mesh(2, 4, jax.devices()[:8])
    cfg2 = _cfg()
    cfg2.aggregator = agg
    cfg2.his_refresh = refresh
    cfg2.batch_size = 1 << 12
    e_sharded = Engine(cfg2, train, test, mesh=mesh)
    loss_sharded = e_sharded.train_one_epoch()
    np.testing.assert_allclose(loss_sharded, loss_single, rtol=1e-5)
    if agg == "self_attention":
        np.testing.assert_allclose(
            np.asarray(e_sharded.state.attn_q),
            np.asarray(e_single.state.attn_q),
            rtol=1e-4, atol=1e-7,
        )
    losses = [e_sharded.train_one_epoch() for _ in range(2)]
    assert np.isfinite(losses).all()
    assert losses[-1] < loss_sharded
