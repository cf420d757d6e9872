"""End-to-end engine tests on synthetic data: learning signal, determinism,
sub-epoch partitioning, accum mode, and the evaluate() path."""

import numpy as np
import pytest

from heat_cf.config import CFConfig
from heat_cf.data.synthetic import synthetic_click_dataset
from heat_cf.train.engine import Engine


def small_cfg(**kw):
    base = dict(
        emb_dim=16,
        num_negs=8,
        max_his=10,
        l_r=0.05,
        clip_val=1.0,
        batch_size=256,
        milestones=[10],
        seed=7,
        metrics=["Recall(k=20)", "NDCG(k=20)"],
    )
    base.update(kw)
    return CFConfig(**base)


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


def test_loss_decreases_and_recall_beats_random(data):
    train, test = data
    eng = Engine(small_cfg(), train, test)
    losses = [eng.train_one_epoch() for _ in range(6)]
    assert losses[-1] < losses[0] * 0.8, losses
    m = eng.evaluate()
    # Random ranking recall ~ E[|hit| in 20 of 500]/|true| ~ 0.04.
    assert m["Recall(k=20)"] > 0.15, m


def test_determinism_same_seed(data):
    train, test = data
    e1 = Engine(small_cfg(), train, test)
    e2 = Engine(small_cfg(), train, test)
    l1 = [e1.train_one_epoch() for _ in range(2)]
    l2 = [e2.train_one_epoch() for _ in range(2)]
    np.testing.assert_allclose(l1, l2, rtol=1e-6)
    np.testing.assert_array_equal(
        np.asarray(e1.state.user_emb), np.asarray(e2.state.user_emb)
    )


def test_subepoch_partitioning_mode(data):
    train, test = data
    eng = Engine(small_cfg(num_subepochs=2), train, test)
    losses = [eng.train_one_epoch() for _ in range(4)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_accum_mode_trains(data):
    # Accum mode compounds gradient rows within a sub-epoch (the reference's
    # momentum-like quirk), so it needs a gentler lr to descend smoothly.
    train, test = data
    eng = Engine(
        small_cfg(sgd_mode="accum", num_subepochs=2, l_r=0.01), train, test
    )
    losses = [eng.train_one_epoch() for _ in range(3)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_his_refresh_subepoch_accuracy_parity(data):
    """Per-epoch history-mean caching must reach comparable ranking quality
    to the exact per-step recompute (the staleness trade behind fast mode)."""
    train, test = data
    e_exact = Engine(small_cfg(), train, test)
    e_fast = Engine(small_cfg(his_refresh="subepoch"), train, test)
    for _ in range(6):
        e_exact.train_one_epoch()
        e_fast.train_one_epoch()
    r_exact = e_exact.evaluate()["Recall(k=20)"]
    r_fast = e_fast.evaluate()["Recall(k=20)"]
    assert r_fast > 0.15
    assert r_fast > r_exact * 0.85, (r_exact, r_fast)


def test_tile_sampler_trains(data):
    train, test = data
    eng = Engine(
        small_cfg(neg_sampler=1, tile_size=64, refresh_interval=512),
        train,
        test,
    )
    losses = [eng.train_one_epoch() for _ in range(3)]
    assert losses[-1] < losses[0]


def test_bfloat16_tables_train(data):
    """bf16 embedding tables (compute stays f32): trains and ranks well."""
    train, test = data
    eng = Engine(small_cfg(param_dtype="bfloat16", l_r=0.08), train, test)
    losses = [eng.train_one_epoch() for _ in range(6)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9
    assert str(eng.state.user_emb.dtype) == "bfloat16"
    m = eng.evaluate()
    assert m["Recall(k=20)"] > 0.12, m


def test_bfloat16_compute_trains(data):
    """bf16 scoring matmuls (f32 tables/updates): the bench fast-mode
    speed lever; must keep the learning signal and ranking quality."""
    train, test = data
    eng = Engine(
        small_cfg(
            compute_dtype="bfloat16",
            neg_sampler=1,
            tile_size=64,
            refresh_interval=512,
            his_refresh="subepoch",
        ),
        train,
        test,
    )
    losses = [eng.train_one_epoch() for _ in range(6)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9
    m = eng.evaluate()
    assert m["Recall(k=20)"] > 0.12, m


def test_lr_schedule_applied(data):
    train, test = data
    eng = Engine(small_cfg(milestones=[1, 2], l_r=0.1), train, test)
    eng.train_one_epoch()
    assert float(eng.state.lr) == pytest.approx(0.1)
    eng.train_one_epoch()  # epoch 1 -> decayed once
    assert float(eng.state.lr) == pytest.approx(0.01)
    eng.train_one_epoch()  # epoch 2 -> decayed twice
    assert float(eng.state.lr) == pytest.approx(0.001)


@pytest.mark.parametrize(
    "variant",
    [
        # gamma=1.0 disables behavior aggregation -> pure matrix
        # factorization (the reference's Model base without SimpleX).
        dict(gamma=1.0),
        dict(loss="CosineContrastiveLoss", l_r=0.02),
        dict(loss="SigmoidPairwiseLoss"),
        # dot similarity on sigma=1e-2 init yields ~1e-3 scores, so grads
        # are tiny; a larger lr is needed to see movement in 3 epochs.
        dict(similarity="dot", l_r=0.5, clip_val=0.1),
        dict(l2_enabled=True, l2=1e-4),
        dict(ignore_pos=False),
    ],
    ids=["pure_mf", "ccl", "sigmoid", "dot", "l2", "no_ignore_pos"],
)
def test_loss_and_similarity_variants_train(data, variant):
    train, test = data
    eng = Engine(small_cfg(**variant), train, test)
    losses = [eng.train_one_epoch() for _ in range(3)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], (variant, losses)


def test_evaluate_with_aggregated_users(data):
    """The live equivalent of the reference's commented evaluate1."""
    train, test = data
    eng = Engine(small_cfg(), train, test)
    eng.train_one_epoch()
    m = eng.evaluate(aggregate_users=True)
    assert 0.0 <= m["Recall(k=20)"] <= 1.0
    breakdown = eng.performance_breakdown()
    assert "f_b" in breakdown and "eval" in breakdown


def test_evaluate0_matches_embedding_product(data):
    train, test = data
    eng = Engine(small_cfg(), train, test)
    eng.train_one_epoch()
    sim = eng.evaluate0()
    want = np.asarray(eng.state.user_emb) @ np.asarray(eng.state.item_emb).T
    np.testing.assert_allclose(sim, want, rtol=1e-4, atol=1e-5)


def test_kitchen_sink_config_trains(data):
    """Every knob at once: sub-epoch partitioning + tile sampler + cached
    pools + adam + user-attention + bf16 compute + lane padding (round 5:
    emb_pad composes with attention). Guards against feature interactions
    that each pairwise test would miss."""
    train, test = data
    eng = Engine(
        small_cfg(
            num_subepochs=2,
            neg_sampler=1,
            tile_size=64,
            refresh_interval=512,
            his_refresh="subepoch",
            optimizer="adam",
            aggregator="user_attention",
            compute_dtype="bfloat16",
            l_r=0.01,
            emb_pad=128,
        ),
        train,
        test,
    )
    losses = [eng.train_one_epoch() for _ in range(5)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    m = eng.evaluate()
    assert m["Recall(k=20)"] > 0.08, m


def test_flat_history_layout_equivalent(data):
    """Engine stores history flat (U*H,) for small max_his (a layout
    choice to re-derive on the GPU, DESIGN.md §8); the flat gather in
    train_step must reproduce the (U, H) row-gather bit-for-bit through a
    real train step."""
    import jax
    import jax.numpy as jnp

    from heat_cf.models.state import init_train_state
    from heat_cf.train.samplers import init_sampler_state
    from heat_cf.train.train_step import Batch, train_step

    train, _ = data
    cfg = small_cfg(his_refresh="step")
    cfg.num_users = train.num_users
    cfg.num_items = train.num_items
    key = jax.random.key(3)
    state = init_train_state(cfg, key)
    ss = init_sampler_state(cfg, key)
    his2d = jnp.asarray(train.his_items, jnp.int32)
    masks = jnp.asarray(train.masks, jnp.int32)
    b = cfg.batch_size
    users = jax.random.randint(key, (b,), 0, cfg.num_users, dtype=jnp.int32)
    pos = jax.random.randint(key, (b,), 0, cfg.num_items, dtype=jnp.int32)
    batch = Batch(users, pos, jnp.ones((b,), jnp.float32))

    s2d, _, loss2d = train_step(state, ss, key, batch, his2d, masks, cfg)
    sflat, _, lossflat = train_step(
        state, ss, key, batch, his2d.reshape(-1), masks, cfg
    )
    assert float(loss2d) == float(lossflat)
    np.testing.assert_array_equal(
        np.asarray(s2d.user_emb), np.asarray(sflat.user_emb)
    )
    np.testing.assert_array_equal(
        np.asarray(s2d.item_emb), np.asarray(sflat.item_emb)
    )


def test_engine_uses_flat_history_for_small_max_his(data):
    train, _ = data
    eng = Engine(small_cfg(), train)  # max_his=10 < 64 -> flat
    assert eng.his_items.ndim == 1
    big = Engine(small_cfg(max_his=64), train)
    assert big.his_items.ndim == 2


def test_shuffle_modes_train_and_cache(data):
    """shuffle_mode: "none" packs in parse order; "once" reuses one packed
    stream across epochs; both still learn on the planted clusters."""
    import jax.numpy as jnp

    from heat_cf.train.engine import _pack_batches

    train, _ = data
    data = train

    # "none" == parse order: first batch equals the head of the pair list.
    cfg = small_cfg(shuffle_mode="none")
    eng = Engine(cfg, data, test_data=data)
    users, pos, weight = eng._make_batches(eng.pairs)
    np.testing.assert_array_equal(
        np.asarray(users).reshape(-1)[: data.train_size],
        np.asarray(data.pairs[:, 0]),
    )
    np.testing.assert_array_equal(
        np.asarray(pos).reshape(-1)[: data.train_size],
        np.asarray(data.pairs[:, 1]),
    )
    l0 = eng.train_one_epoch()
    l1 = eng.train_one_epoch()
    assert l1 < l0

    # "once": identical batch stream on every epoch (cached object), and
    # it is a real shuffle (differs from parse order).
    cfg = small_cfg(shuffle_mode="once")
    eng = Engine(cfg, data, test_data=data)
    u1, p1, _ = eng._make_batches(eng.pairs)
    u2, p2, _ = eng._make_batches(eng.pairs)
    assert u1 is u2 and p1 is p2
    assert not np.array_equal(
        np.asarray(u1).reshape(-1)[: data.train_size],
        np.asarray(data.pairs[:, 0]),
    )
    l0 = eng.train_one_epoch()
    l1 = eng.train_one_epoch()
    assert l1 < l0

    # _pack_batches padding: weights zero on the tail, ids tiled.
    pairs = jnp.asarray(np.arange(10, dtype=np.int32).reshape(5, 2))
    u, p, w = _pack_batches(pairs, 2, 4)
    assert u.shape == (2, 4)
    assert float(w.sum()) == 5.0
    np.testing.assert_array_equal(
        np.asarray(u).reshape(-1)[:5], np.asarray(pairs[:, 0])
    )


def test_update_mode_direct_trains_and_matches_dedup(data):
    """update_mode='direct' (per-occurrence scatter-add updates — the
    reference live path's own clip-per-sample ordering) trains to the same
    quality as the dedup path. The loss trajectories are NOT bitwise
    comparable where the clip binds on duplicated rows (sum-of-clipped vs
    clipped-sum), so this asserts end-metric parity."""
    train, test = data
    e_dedup = Engine(small_cfg(), train, test)
    e_direct = Engine(small_cfg(update_mode="direct"), train, test)
    l_dedup = [e_dedup.train_one_epoch() for _ in range(6)]
    l_direct = [e_direct.train_one_epoch() for _ in range(6)]
    assert np.isfinite(l_direct).all() and l_direct[-1] < l_direct[0] * 0.8
    np.testing.assert_allclose(l_direct[-1], l_dedup[-1], rtol=0.1)
    m_dedup = e_dedup.evaluate()
    m_direct = e_direct.evaluate()
    assert m_direct["Recall(k=20)"] > 0.15, m_direct
    np.testing.assert_allclose(
        m_direct["Recall(k=20)"], m_dedup["Recall(k=20)"], rtol=0.2, atol=0.02
    )


def test_update_mode_direct_tile_l2_trains(data):
    """direct mode through the tile fast path with l2 enabled (the
    headline bench configuration at small scale)."""
    train, test = data
    cfg = small_cfg(
        update_mode="direct",
        neg_sampler=1,
        tile_size=64,
        refresh_interval=1024,
        his_refresh="subepoch",
        l2=1e-7,
        l2_enabled=True,
    )
    eng = Engine(cfg, train, test)
    losses = [eng.train_one_epoch() for _ in range(4)]
    assert losses[-1] < losses[0], losses
    assert np.isfinite(losses).all()


def test_update_mode_direct_validation():
    with pytest.raises(ValueError, match="direct"):
        small_cfg(update_mode="direct", optimizer="adam")
    with pytest.raises(ValueError, match="direct"):
        small_cfg(update_mode="direct", sgd_mode="accum")
    with pytest.raises(ValueError, match="update_mode"):
        small_cfg(update_mode="bogus")


def test_train_epochs_matches_sequential(data):
    """train_epochs(n) (one multi-epoch device program) must reproduce n
    sequential train_one_epoch calls: same key draws, same LR schedule,
    same losses, same final tables."""
    train, test = data
    cfg = small_cfg(milestones=[2])  # schedule kicks in mid-window
    e_seq = Engine(cfg, train, test)
    e_multi = Engine(cfg, train, test)
    seq = [e_seq.train_one_epoch() for _ in range(4)]
    multi = e_multi.train_epochs(4)
    np.testing.assert_allclose(multi, seq, rtol=1e-6)
    assert e_multi.epoch == e_seq.epoch == 4
    np.testing.assert_allclose(
        np.asarray(e_multi.state.user_emb),
        np.asarray(e_seq.state.user_emb),
        rtol=2e-6, atol=2e-7,
    )
    np.testing.assert_allclose(
        np.asarray(e_multi.state.item_emb),
        np.asarray(e_seq.state.item_emb),
        rtol=2e-6, atol=2e-7,
    )
    # Interleaving keeps the key stream aligned: more epochs agree too.
    np.testing.assert_allclose(
        e_multi.train_epochs(2),
        [e_seq.train_one_epoch() for _ in range(2)],
        rtol=1e-6,
    )


def test_train_epochs_fallback_paths(data):
    """Configs outside the fast path fall back to sequential epochs with
    identical results."""
    train, test = data
    cfg = small_cfg(num_subepochs=2)
    e1 = Engine(cfg, train, test)
    e2 = Engine(cfg, train, test)
    seq = [e1.train_one_epoch() for _ in range(2)]
    multi = e2.train_epochs(2)
    np.testing.assert_allclose(multi, seq, rtol=1e-6)


def test_train_epochs_tile_sampler(data):
    """SamplerState (tile + refresh countdown) carries across the epoch
    scan exactly as across sequential calls."""
    train, test = data
    cfg = small_cfg(neg_sampler=1, tile_size=64, refresh_interval=512)
    e_seq = Engine(cfg, train, test)
    e_multi = Engine(cfg, train, test)
    seq = [e_seq.train_one_epoch() for _ in range(3)]
    multi = e_multi.train_epochs(3)
    np.testing.assert_allclose(multi, seq, rtol=1e-6)


def test_history_dedup_exact_equivalence(data):
    """The history-gather dedup (gather H rows once per DISTINCT batch
    user when the stream is fixed, train_step uniq_users path) must be an
    EXACT rewrite: identical losses and tables vs the undeduped step on
    the same parse-order (user-grouped) stream."""
    train, test = data
    cfg = small_cfg(shuffle_mode="none", his_refresh="step")
    e_dedup = Engine(cfg, train, test)
    e_plain = Engine(cfg, train, test)
    # Disable dedup on the control engine only.
    e_plain._history_dedup = lambda pairs, users: None

    l_d = [e_dedup.train_one_epoch() for _ in range(2)]
    l_p = [e_plain.train_one_epoch() for _ in range(2)]
    # The dedup actually engaged (parse order is user-grouped: ~B/clicks
    # distinct users per batch).
    cache = e_dedup._dedup_cache
    assert cache is not None and cache[1] is not None, (
        "dedup did not engage on a user-grouped stream"
    )
    bu = cache[1][0].shape[1]
    assert bu < 0.7 * cfg.batch_size, bu
    np.testing.assert_allclose(l_d, l_p, rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(e_dedup.state.user_emb),
        np.asarray(e_plain.state.user_emb),
        rtol=1e-6, atol=1e-7,
    )
    np.testing.assert_allclose(
        np.asarray(e_dedup.state.item_emb),
        np.asarray(e_plain.state.item_emb),
        rtol=1e-6, atol=1e-7,
    )


def test_visit_order_user_matches_presorted_and_enables_dedup(data):
    """cfg.visit_order='user' on an ARBITRARY file order must reproduce
    (bitwise — identical stream + key draws) an engine fed an externally
    user-sorted file, and must engage the history-gather dedup that a
    scrambled fixed stream alone would miss (the knob's whole point:
    the grouped-stream speedups without pre-sorting the click file)."""
    import dataclasses

    train, test = data
    pairs = np.asarray(train.pairs)
    rng = np.random.default_rng(3)
    scrambled = dataclasses.replace(
        train, pairs=pairs[rng.permutation(len(pairs))]
    )
    spairs = np.asarray(scrambled.pairs)
    presorted = dataclasses.replace(
        scrambled, pairs=spairs[np.argsort(spairs[:, 0], kind="stable")]
    )
    cfg_auto = small_cfg(
        shuffle_mode="none", his_refresh="step", visit_order="user"
    )
    cfg_file = small_cfg(shuffle_mode="none", his_refresh="step")
    e_auto = Engine(cfg_auto, scrambled, test)
    e_file = Engine(cfg_file, presorted, test)
    np.testing.assert_array_equal(
        np.asarray(e_auto.pairs), np.asarray(e_file.pairs)
    )
    l_a = [e_auto.train_one_epoch() for _ in range(2)]
    l_f = [e_file.train_one_epoch() for _ in range(2)]
    np.testing.assert_array_equal(l_a, l_f)
    np.testing.assert_array_equal(
        np.asarray(e_auto.state.user_emb), np.asarray(e_file.state.user_emb)
    )
    cache = e_auto._dedup_cache
    assert cache is not None and cache[1] is not None, (
        "dedup did not engage under visit_order='user'"
    )


def test_visit_order_item_matches_presorted(data):
    """cfg.visit_order='item' == training on an externally item-sorted
    file (the measured-best CCL order, DESIGN.md 6h)."""
    import dataclasses

    train, test = data
    pairs = np.asarray(train.pairs)
    rng = np.random.default_rng(5)
    scrambled = dataclasses.replace(
        train, pairs=pairs[rng.permutation(len(pairs))]
    )
    spairs = np.asarray(scrambled.pairs)
    presorted = dataclasses.replace(
        scrambled, pairs=spairs[np.argsort(spairs[:, 1], kind="stable")]
    )
    cfg_auto = small_cfg(shuffle_mode="none", visit_order="item")
    cfg_file = small_cfg(shuffle_mode="none")
    e_auto = Engine(cfg_auto, scrambled, test)
    e_file = Engine(cfg_file, presorted, test)
    l_a = [e_auto.train_one_epoch() for _ in range(2)]
    l_f = [e_file.train_one_epoch() for _ in range(2)]
    np.testing.assert_array_equal(l_a, l_f)


def test_history_dedup_skipped_for_shuffled_streams(data):
    """Per-epoch shuffled batches have mostly-unique users: the dedup must
    not activate (it would only add a gather)."""
    train, test = data
    cfg = small_cfg(shuffle_mode="epoch", his_refresh="step")
    eng = Engine(cfg, train, test)
    eng.train_one_epoch()
    assert getattr(eng, "_dedup_cache", None) is None


def test_train_epochs_fixed_stream_matches_sequential(data):
    """Fixed-stream fused epochs (shuffle "none"/"once" -> ONE device
    program, with the dedup maps riding along) must reproduce sequential
    train_one_epoch calls exactly, including accum mode's epoch-end
    grad-table zeroing."""
    train, test = data
    for mode, sgd_mode in (
        ("none", "batch"), ("once", "batch"), ("none", "accum"),
    ):
        cfg = small_cfg(
            shuffle_mode=mode, sgd_mode=sgd_mode, milestones=[2],
            his_refresh="step",
        )
        e_seq = Engine(cfg, train, test)
        e_fused = Engine(cfg, train, test)
        seq = [e_seq.train_one_epoch() for _ in range(3)]
        fused = e_fused.train_epochs(3)
        np.testing.assert_allclose(fused, seq, rtol=1e-6, err_msg=str((mode, sgd_mode)))
        np.testing.assert_allclose(
            np.asarray(e_fused.state.user_emb),
            np.asarray(e_seq.state.user_emb),
            rtol=2e-6, atol=2e-7,
        )
        np.testing.assert_allclose(
            np.asarray(e_fused.state.item_emb),
            np.asarray(e_seq.state.item_emb),
            rtol=2e-6, atol=2e-7,
        )
        # Key stream stays aligned across further mixed calls.
        np.testing.assert_allclose(
            e_fused.train_epochs(2),
            [e_seq.train_one_epoch() for _ in range(2)],
            rtol=1e-6,
        )


def test_emb_pad_identical_math(data):
    """Physical row padding (CFConfig.emb_pad): the padded model must
    compute IDENTICAL math — zero tail columns are invariant through
    gathers, grads, updates, and w0's outer-product gradient — while the
    tables carry the padded width."""
    train, test = data
    # Single-step semantic pin: one batch covering the whole epoch — only
    # f32 reduction-tree grouping can differ (the wider rows group the 16
    # real summands differently), so the real block matches to ~1e-5.
    e_b1 = Engine(small_cfg(batch_size=16384), train, seed=3)
    e_p1 = Engine(small_cfg(batch_size=16384, emb_pad=128), train, seed=3)
    l_b1 = e_b1.train_one_epoch()
    l_p1 = e_p1.train_one_epoch()
    np.testing.assert_allclose(l_p1, l_b1, rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(e_p1.state.user_emb)[:, :16],
        np.asarray(e_b1.state.user_emb),
        atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(e_p1.state.item_emb)[:, :16],
        np.asarray(e_b1.state.item_emb),
        atol=1e-5,
    )
    # Multi-epoch run: per-step grouping drift amplifies chaotically
    # (losses stay ~5e-4; table elements decorrelate), so the multi-epoch
    # claims are the loss band and the STRICT tail invariant.
    e_base = Engine(small_cfg(), train, test, seed=3)
    base_losses = e_base.train_epochs(2)
    e_pad = Engine(small_cfg(emb_pad=128), train, test, seed=3)
    pad_losses = e_pad.train_epochs(2)
    np.testing.assert_allclose(pad_losses, base_losses, rtol=2e-3)
    ue = np.asarray(e_pad.state.user_emb)
    ie = np.asarray(e_pad.state.item_emb)
    w0 = np.asarray(e_pad.state.w0)
    assert ue.shape[1] == 128 and w0.shape == (128, 128)
    # The tails stayed EXACTLY zero — the invariant the knob relies on
    # (any semantic leak between pad and real columns lands here).
    assert not ue[:, 16:].any() and not ie[:, 16:].any()
    assert not w0[16:, :].any() and not w0[:, 16:].any()
    # Evaluation flows at the padded width.
    m_pad = e_pad.evaluate()
    m_base = e_base.evaluate()
    for k in m_base:
        assert abs(m_pad[k] - m_base[k]) < 0.05, (k, m_pad[k], m_base[k])


def test_emb_pad_validation():
    with pytest.raises(ValueError, match="emb_pad"):
        CFConfig(emb_dim=64, emb_pad=32)
    # Round 5: emb_pad composes with the attention aggregators (the
    # softmax scales by the logical width and attn_q pads zero-tail).
    CFConfig(emb_dim=16, emb_pad=128, aggregator="user_attention")


@pytest.mark.parametrize(
    "agg,refresh",
    [("user_attention", "subepoch"), ("self_attention", "step")],
    ids=["user", "self"],
)
def test_emb_pad_attention_identical_math(data, agg, refresh):
    """emb_pad x attention (round 5): the padded model computes identical
    math — the softmax temperature uses the LOGICAL width and attn_q's
    pad tail is provably zero — so a single batched step matches the
    unpadded model and the tails stay exactly zero through training."""
    train, test = data
    kw = dict(batch_size=16384, aggregator=agg, his_refresh=refresh)
    e_b = Engine(small_cfg(**kw), train, seed=3)
    e_p = Engine(small_cfg(emb_pad=128, **kw), train, seed=3)
    l_b = e_b.train_one_epoch()
    l_p = e_p.train_one_epoch()
    np.testing.assert_allclose(l_p, l_b, rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(e_p.state.user_emb)[:, :16],
        np.asarray(e_b.state.user_emb),
        atol=1e-5,
    )
    ue = np.asarray(e_p.state.user_emb)
    ie = np.asarray(e_p.state.item_emb)
    assert not ue[:, 16:].any() and not ie[:, 16:].any()
    if agg == "self_attention":
        q = np.asarray(e_p.state.attn_q)
        assert q.shape == (128,) and not q[16:].any()
        np.testing.assert_allclose(
            q[:16], np.asarray(e_b.state.attn_q), atol=1e-6
        )


def test_subepoch_fused_matches_per_bucket(data):
    """The one-dispatch sub-epoch epoch program (make_subepoch_epoch_fn)
    must reproduce the per-bucket dispatch path exactly: same key-draw
    order, same bucket packing (buckets here exceed batch_size so the
    packed widths agree), padded pool entries never sampled, accum-mode
    grad zeroing at sub-epoch boundaries inside the program."""
    train, test = data
    kw = dict(num_subepochs=3, sgd_mode="accum", batch_size=64)
    e_fused = Engine(small_cfg(**kw), train, test, seed=5)
    fused = [e_fused.train_one_epoch() for _ in range(2)]
    e_seq = Engine(small_cfg(**kw), train, test, seed=5)
    e_seq._fuse_subepochs = False
    seq = [e_seq.train_one_epoch() for _ in range(2)]
    np.testing.assert_allclose(fused, seq, rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(e_fused.state.user_emb),
        np.asarray(e_seq.state.user_emb),
        rtol=1e-5, atol=1e-7,
    )
    np.testing.assert_allclose(
        np.asarray(e_fused.state.item_emb),
        np.asarray(e_seq.state.item_emb),
        rtol=1e-5, atol=1e-7,
    )


def test_run_epochs_with_eval_resumed_schedule(data):
    """A resumed run must evaluate at the same ABSOLUTE epochs as an
    uninterrupted one (reference_schedule anchored at engine.epoch, the
    reference keys its eval check off the absolute epoch counter,
    cf/main.py:115-124): resume at epoch 3 of 7 with interval 2 still
    evals after epochs 4 and 6 — not 5 — and matches both the unfused
    resumed path and the uninterrupted run's metrics at those epochs."""
    from heat_cf.train.run import reference_schedule

    assert reference_schedule(4, 2, start_epoch=3) == ((2, True), (2, True))
    assert reference_schedule(7, 2) == ((3, True), (2, True), (2, True))
    train, test = data
    mets = ["Recall(k=20)"]
    e_full = Engine(small_cfg(), train, test)
    losses_full, evals_full = e_full.run_epochs_with_eval(7, 2, metrics=mets)
    assert [ev["epoch"] for ev in evals_full] == [2, 4, 6]
    e_res = Engine(small_cfg(), train, test)
    e_res.train_epochs(3)
    losses_f, evals_f = e_res.run_epochs_with_eval(4, 2, metrics=mets)
    assert [ev["epoch"] for ev in evals_f] == [4, 6]
    e_res2 = Engine(small_cfg(), train, test)
    e_res2.train_epochs(3)
    losses_s, evals_s = e_res2.run_epochs_with_eval(
        4, 2, metrics=mets, fused=False
    )
    assert [ev["epoch"] for ev in evals_s] == [4, 6]
    np.testing.assert_allclose(losses_f, losses_s, rtol=1e-5)
    # Same key draws as the uninterrupted run → the resumed tail matches
    # its losses and its eval values at the shared absolute epochs.
    np.testing.assert_allclose(losses_f, losses_full[3:], rtol=1e-5)
    for ef, es, efull in zip(evals_f, evals_s, evals_full[1:]):
        np.testing.assert_allclose(ef[mets[0]], es[mets[0]], rtol=1e-5)
        np.testing.assert_allclose(ef[mets[0]], efull[mets[0]], rtol=1e-5)


def test_run_epochs_with_eval_fused_matches_unfused(data):
    """The fused full-run program (train/run.py: every epoch scan and
    every tiled-top-k + metric reduction in ONE device program) must
    reproduce the unfused shape — train_epochs segments + evaluate at
    each reference-schedule boundary (cf/main.py:106-124) — exactly:
    same per-epoch losses (same key draws) and same metric values."""
    train, test = data
    e_fused = Engine(small_cfg(), train, test)
    losses_f, evals_f = e_fused.run_epochs_with_eval(
        5, 2, metrics=["Recall(k=20)", "NDCG(k=20)"]
    )
    e_seq = Engine(small_cfg(), train, test)
    losses_s, evals_s = e_seq.run_epochs_with_eval(
        5, 2, metrics=["Recall(k=20)", "NDCG(k=20)"], fused=False
    )
    assert len(losses_f) == len(losses_s) == 5
    np.testing.assert_allclose(losses_f, losses_s, rtol=1e-5)
    # Reference schedule: evals after epochs 2 and 4 (0-based).
    assert [ev["epoch"] for ev in evals_f] == [2, 4]
    assert [ev["epoch"] for ev in evals_s] == [2, 4]
    for ef, es in zip(evals_f, evals_s):
        for m in ("Recall(k=20)", "NDCG(k=20)"):
            np.testing.assert_allclose(ef[m], es[m], rtol=1e-5)
    # Engines end in the same state (epoch counter and tables).
    assert e_fused.epoch == e_seq.epoch == 5
    np.testing.assert_allclose(
        np.asarray(e_fused.state.user_emb),
        np.asarray(e_seq.state.user_emb),
        rtol=1e-5, atol=1e-7,
    )


def test_run_epochs_with_eval_fused_tile_headline_config(data):
    """Fused full run under the headline bench config (tile sampler +
    cached pools + direct updates): losses finite and decreasing-ish,
    metrics sane, and the fused/unfused trajectories agree."""
    train, test = data
    kw = dict(
        neg_sampler=1, tile_size=64, refresh_interval=256,
        his_refresh="subepoch", update_mode="direct",
    )
    e_fused = Engine(small_cfg(**kw), train, test)
    losses_f, evals_f = e_fused.run_epochs_with_eval(
        4, 2, metrics=["Recall(k=20)"]
    )
    e_seq = Engine(small_cfg(**kw), train, test)
    losses_s, evals_s = e_seq.run_epochs_with_eval(
        4, 2, metrics=["Recall(k=20)"], fused=False
    )
    np.testing.assert_allclose(losses_f, losses_s, rtol=1e-5)
    assert [ev["epoch"] for ev in evals_f] == [2]
    np.testing.assert_allclose(
        evals_f[0]["Recall(k=20)"], evals_s[0]["Recall(k=20)"], rtol=1e-5
    )
    assert evals_f[0]["Recall(k=20)"] > 0.04  # beats random at 300x500


def test_subepoch_complement_scope_fused_matches_per_bucket(data):
    """subepoch_neg_scope="complement" (the reference's written
    constraint, engine.cpp:222-238 — opt-in after the DESIGN.md 6g
    collapse finding; the DEFAULT is "global") still has exact
    fused == per-bucket equivalence, and its negatives genuinely come
    from the partition complement (different trajectories than
    global scope on the same seed)."""
    train, test = data
    kw = dict(
        num_subepochs=3, batch_size=64, neg_sampler=1, tile_size=32,
        refresh_interval=256, subepoch_neg_scope="complement",
    )
    e_fused = Engine(small_cfg(**kw), train, test, seed=5)
    fused = [e_fused.train_one_epoch() for _ in range(2)]
    e_seq = Engine(small_cfg(**kw), train, test, seed=5)
    e_seq._fuse_subepochs = False
    seq = [e_seq.train_one_epoch() for _ in range(2)]
    np.testing.assert_allclose(fused, seq, rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(e_fused.state.user_emb),
        np.asarray(e_seq.state.user_emb),
        rtol=1e-5, atol=1e-7,
    )
    # Scope changes the math (same key draws, different candidate map).
    e_glob = Engine(
        small_cfg(**{**kw, "subepoch_neg_scope": "global"}),
        train, test, seed=5,
    )
    glob = [e_glob.train_one_epoch() for _ in range(2)]
    assert abs(glob[0] - fused[0]) > 1e-6


def test_subepoch_neg_scope_validation():
    with pytest.raises(ValueError, match="subepoch_neg_scope"):
        CFConfig(emb_dim=16, subepoch_neg_scope="nope")


def test_train_epochs_subepoch_fused_matches_sequential(data):
    """Round 4: ``train_epochs`` fuses n sub-epoch epochs into ONE
    device program (an epochs-scan over the on-device-bucketed epoch,
    train_step.make_subepoch_multi_epoch_fn). Must match n sequential
    ``train_one_epoch`` calls exactly — same perm/key draws (independent
    numpy/jax streams), same losses, tables, and sampler state.
    batch_size is below every bucket size so the packed width is
    epoch-invariant (the production regime)."""
    train, test = data
    kw = dict(
        num_subepochs=2, batch_size=64, neg_sampler=1, tile_size=32,
        refresh_interval=256,
    )
    e_fused = Engine(small_cfg(**kw), train, test, seed=9)
    fused = e_fused.train_epochs(3)
    # Guard against a silent fall-back to per-epoch dispatch.
    assert getattr(e_fused, "_subep_multi_cache", None) is not None
    e_seq = Engine(small_cfg(**kw), train, test, seed=9)
    seq = [e_seq.train_one_epoch() for _ in range(3)]
    np.testing.assert_allclose(fused, seq, rtol=1e-6)
    assert e_fused.epoch == e_seq.epoch == 3
    np.testing.assert_allclose(
        np.asarray(e_fused.state.user_emb),
        np.asarray(e_seq.state.user_emb),
        rtol=1e-5, atol=1e-7,
    )
    np.testing.assert_allclose(
        np.asarray(e_fused.state.item_emb),
        np.asarray(e_seq.state.item_emb),
        rtol=1e-5, atol=1e-7,
    )
    np.testing.assert_array_equal(
        np.asarray(e_fused.sampler_state.tile),
        np.asarray(e_seq.sampler_state.tile),
    )
    assert int(e_fused.sampler_state.iterations) == int(
        e_seq.sampler_state.iterations
    )


def test_run_epochs_with_eval_fused_subepoch_default_shape(data):
    """Round 4: the fused full-run program covers SUB-EPOCH configs —
    the reference's actual DEFAULT deployment shape (cf_config.py:7
    combines tile_size with num_subepoches=2; cf/main.py:106-124
    interleaves evals): the whole schedule runs as ONE device program
    built over the on-device-bucketed epoch program
    (train/run.make_run_fn_subepoch). Must reproduce the unfused
    fallback (per-epoch device dispatch + evaluate at boundaries)
    exactly: same key draws, same losses, same metrics, same final
    tables and sampler state. batch_size is below every bucket size so
    the packed width is epoch-invariant (the production regime)."""
    train, test = data
    kw = dict(
        num_subepochs=2, batch_size=64, neg_sampler=1, tile_size=32,
        refresh_interval=256,
    )
    mets = ["Recall(k=20)", "NDCG(k=20)"]
    e_fused = Engine(small_cfg(**kw), train, test, seed=5)
    losses_f, evals_f = e_fused.run_epochs_with_eval(5, 2, metrics=mets)
    # Guard against a silent fall-back to the unfused shape.
    assert getattr(e_fused, "_run_fn_subep_cache", None) is not None
    e_seq = Engine(small_cfg(**kw), train, test, seed=5)
    losses_s, evals_s = e_seq.run_epochs_with_eval(
        5, 2, metrics=mets, fused=False
    )
    np.testing.assert_allclose(losses_f, losses_s, rtol=1e-5)
    assert [ev["epoch"] for ev in evals_f] == [2, 4]
    assert [ev["epoch"] for ev in evals_s] == [2, 4]
    for ef, es in zip(evals_f, evals_s):
        for m in mets:
            np.testing.assert_allclose(ef[m], es[m], rtol=1e-5)
    assert e_fused.epoch == e_seq.epoch == 5
    np.testing.assert_allclose(
        np.asarray(e_fused.state.user_emb),
        np.asarray(e_seq.state.user_emb),
        rtol=1e-5, atol=1e-7,
    )
    np.testing.assert_allclose(
        np.asarray(e_fused.state.item_emb),
        np.asarray(e_seq.state.item_emb),
        rtol=1e-5, atol=1e-7,
    )
    np.testing.assert_array_equal(
        np.asarray(e_fused.sampler_state.tile),
        np.asarray(e_seq.sampler_state.tile),
    )


def test_subepoch_fused_matches_per_bucket_tile_sampler(data):
    """Round 4: the fused sub-epoch program now covers the TILE sampler
    (the reference's defaults combine tile_size with num_subepoches,
    cf_config.py:7). Weight-aware iteration accounting makes the padded
    batches sampler no-ops, so fused == per-bucket exactly (buckets
    exceed batch_size, so packed widths agree), including the tile state
    and refresh cadence."""
    train, test = data
    kw = dict(
        num_subepochs=3, batch_size=64, neg_sampler=1, tile_size=32,
        refresh_interval=256,
    )
    e_fused = Engine(small_cfg(**kw), train, test, seed=5)
    fused = [e_fused.train_one_epoch() for _ in range(2)]
    e_seq = Engine(small_cfg(**kw), train, test, seed=5)
    e_seq._fuse_subepochs = False
    seq = [e_seq.train_one_epoch() for _ in range(2)]
    np.testing.assert_allclose(fused, seq, rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(e_fused.state.user_emb),
        np.asarray(e_seq.state.user_emb),
        rtol=1e-5, atol=1e-7,
    )
    # Sampler state must agree exactly: same tile, same REAL-sample count
    # (padding batches contributed nothing).
    np.testing.assert_array_equal(
        np.asarray(e_fused.sampler_state.tile),
        np.asarray(e_seq.sampler_state.tile),
    )
    assert int(e_fused.sampler_state.iterations) == int(
        e_seq.sampler_state.iterations
    ) == 2 * train.train_size


def test_subepoch_fused_matches_per_bucket_adam(data):
    """Round 4: fused sub-epochs with a moment optimizer — the optimizer
    step counter advances only on batches with real samples and the dense
    w0 moment update is gated, so the fused program matches per-bucket
    dispatch (which never sees the padding batches)."""
    train, test = data
    kw = dict(num_subepochs=3, batch_size=64, optimizer="adam", l_r=0.005)
    e_fused = Engine(small_cfg(**kw), train, test, seed=5)
    fused = [e_fused.train_one_epoch() for _ in range(2)]
    e_seq = Engine(small_cfg(**kw), train, test, seed=5)
    e_seq._fuse_subepochs = False
    seq = [e_seq.train_one_epoch() for _ in range(2)]
    np.testing.assert_allclose(fused, seq, rtol=1e-6)
    for attr in ("user_emb", "item_emb", "w0"):
        np.testing.assert_allclose(
            np.asarray(getattr(e_fused.state, attr)),
            np.asarray(getattr(e_seq.state, attr)),
            rtol=1e-5, atol=1e-7, err_msg=attr,
        )
    assert int(e_fused.state.step) == int(e_seq.state.step)
    np.testing.assert_allclose(
        np.asarray(e_fused.state.opt_slots["w0_v"]),
        np.asarray(e_seq.state.opt_slots["w0_v"]),
        rtol=1e-5, atol=1e-9,
    )


def test_subepoch_multi_prep_bails_and_rewinds_on_geometry_growth(data):
    """_subepoch_multi_prep must return None — with BOTH the numpy rng
    and the grow-only geometry cache rewound — when the packed geometry
    would vary across the fused epochs: nb feeds the device program's
    key splits (jax.random.split(k_epoch, nb)), so a mid-prep regrow
    would void the bit-exact fused==sequential equivalence, and a
    mutated cache would leak the grown nb into the per-epoch fallback
    (advisor r4 findings 1-2)."""
    train, test = data
    eng = Engine(
        small_cfg(num_subepochs=2, batch_size=64), train, test, seed=3
    )
    # Seed the grow-only cache at the real first-epoch geometry.
    prep = eng._subepoch_multi_prep(2)
    assert prep is not None
    geom_before = eng._subep_geom
    rng_before = eng._np_rng.bit_generator.state
    # Force a geometry change partway through prep: the second epoch's
    # call sees a cache whose nb no longer covers it.
    calls = {"n": 0}
    orig = eng._subepoch_geometry

    def growing(ns):
        calls["n"] += 1
        if calls["n"] == 2:
            b, nb = orig(ns)
            eng._subep_geom = (b, nb + 7)  # simulate an overflow regrow
            return eng._subep_geom
        return orig(ns)

    eng._subepoch_geometry = growing
    assert eng._subepoch_multi_prep(2) is None
    eng._subepoch_geometry = orig
    # Rewound: same rng state, same cache as before the failed prep.
    assert eng._subep_geom == geom_before
    assert eng._np_rng.bit_generator.state == rng_before
    # And a clean re-prep still succeeds (drawing the exact perms the
    # bailed attempt rewound — state equality above proves the stream).
    prep2 = eng._subepoch_multi_prep(2)
    assert prep2 is not None
    assert prep2[0] == prep[0] and prep2[1] == prep[1]


@pytest.mark.parametrize(
    "agg", ["self_attention", "user_attention"], ids=["self", "user"]
)
def test_history_dedup_attention_single_step_bitwise(agg):
    """Round 5: the history-gather dedup extends to the ATTENTION
    aggregators (pool once per distinct user inside the loss;
    user_attention's query sliced from the first occurrence of the same
    differentiable u_rows gather). The semantics proof is single-STEP
    bitwise equality on a duplicate-heavy batch — loss, both tables, and
    attn_q identical with dedup inputs vs without. (Epoch-level table
    equality is NOT attainable: attention training is chaotic — a
    measured 1-ulp perturbation of one element grows to ~2.7e-3 table
    drift within 3 epochs — and different XLA program shapes round
    differently; the engine-level test below asserts loss-trajectory
    agreement instead.)"""
    import jax
    import jax.numpy as jnp

    from heat_cf.models.state import init_train_state
    from heat_cf.train.samplers import init_sampler_state
    from heat_cf.train.train_step import Batch, train_step

    cfg = CFConfig(
        emb_dim=16, num_users=50, num_items=80, max_his=6, num_negs=4,
        batch_size=32, l_r=0.05, clip_val=1.0, seed=0,
        his_refresh="step", aggregator=agg,
    )
    key = jax.random.key(0)
    state = init_train_state(cfg, key)
    ss = init_sampler_state(cfg, key)
    rng = np.random.default_rng(1)
    users_np = np.sort(rng.integers(0, 50, 32)).astype(np.int32)
    assert len(np.unique(users_np)) < 32  # duplicates present
    pos_np = rng.integers(0, 80, 32).astype(np.int32)
    his = jnp.asarray(rng.integers(0, 80, (50, 6)).astype(np.int32))
    masks = jnp.asarray(rng.integers(1, 7, 50).astype(np.int32))
    uu, first, inv = np.unique(
        users_np, return_index=True, return_inverse=True
    )
    bu = -(-len(uu) // 8) * 8
    uu_p = np.full(bu, uu[0], np.int32)
    uu_p[: len(uu)] = uu
    uf_p = np.full(bu, first[0], np.int32)
    uf_p[: len(uu)] = first
    batch = Batch(
        jnp.asarray(users_np), jnp.asarray(pos_np), jnp.ones(32)
    )
    k = jax.random.key(5)
    s1, _, l1 = train_step(state, ss, k, batch, his, masks, cfg)
    s2, _, l2 = train_step(
        state, ss, k, batch, his, masks, cfg,
        uniq_users=jnp.asarray(uu_p),
        uniq_inverse=jnp.asarray(inv.astype(np.int32)),
        uniq_first=jnp.asarray(uf_p),
    )
    assert float(l1) == float(l2)
    np.testing.assert_array_equal(
        np.asarray(s1.user_emb), np.asarray(s2.user_emb)
    )
    np.testing.assert_array_equal(
        np.asarray(s1.item_emb), np.asarray(s2.item_emb)
    )
    if s1.attn_q is not None:
        np.testing.assert_array_equal(
            np.asarray(s1.attn_q), np.asarray(s2.attn_q)
        )


@pytest.mark.parametrize(
    "agg", ["self_attention", "user_attention"], ids=["self", "user"]
)
def test_history_dedup_attention_engine_equivalence(data, agg):
    """Engine-level attention dedup on a user-grouped fixed stream: the
    dedup engages (with uniq_first maps), and the loss trajectory
    matches the undeduped engine's within reduction-order noise (see the
    single-step bitwise test for why table equality is the wrong
    assertion here)."""
    train, test = data
    cfg = small_cfg(
        shuffle_mode="none", his_refresh="step", aggregator=agg
    )
    e_dedup = Engine(cfg, train, test)
    e_plain = Engine(cfg, train, test)
    e_plain._history_dedup = lambda pairs, users: None
    l_d = [e_dedup.train_one_epoch() for _ in range(2)]
    l_p = [e_plain.train_one_epoch() for _ in range(2)]
    cache = e_dedup._dedup_cache
    assert cache is not None and cache[1] is not None, (
        "dedup did not engage on a user-grouped stream"
    )
    assert len(cache[1]) == 3 and cache[1][2] is not None  # uniq_first
    np.testing.assert_allclose(l_d, l_p, rtol=1e-4)
    # Ranking quality agrees (chaos scrambles low bits, not learning).
    m_d = e_dedup.evaluate()["Recall(k=20)"]
    m_p = e_plain.evaluate()["Recall(k=20)"]
    assert abs(m_d - m_p) < 0.03, (m_d, m_p)


def test_history_dedup_gated_for_user_attention_direct(data):
    """user_attention + update_mode='direct' must NOT engage the dedup:
    the concentrated first-occurrence query gradient clips differently
    under per-occurrence clipping than the spread per-occurrence grads
    (advisor r5 finding) — the engine falls back to the exact undeduped
    step."""
    train, test = data
    eng = Engine(
        small_cfg(
            shuffle_mode="none", his_refresh="step",
            aggregator="user_attention", update_mode="direct",
        ),
        train, test,
    )
    eng.train_one_epoch()
    cache = getattr(eng, "_dedup_cache", None)
    assert cache is None or cache[1] is None
    # The dedup-mode update path (combine-then-clip) still engages.
    eng2 = Engine(
        small_cfg(
            shuffle_mode="none", his_refresh="step",
            aggregator="user_attention",
        ),
        train, test,
    )
    eng2.train_one_epoch()
    assert eng2._dedup_cache[1] is not None
