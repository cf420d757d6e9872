"""Serving: trained-model recommendations exclude seen items and rank the
planted structure highly."""

import numpy as np

from heat_cf.config import CFConfig
from heat_cf.data.synthetic import synthetic_click_dataset
from heat_cf.serving import Recommender
from heat_cf.train.engine import Engine


def test_recommender_masks_seen_and_finds_structure():
    train, test = synthetic_click_dataset(
        num_users=120, num_items=300, clicks_per_user=25, max_his=8, seed=6
    )
    cfg = CFConfig(
        emb_dim=16, num_negs=8, max_his=8, l_r=0.05, batch_size=256, seed=2
    )
    eng = Engine(cfg, train, test)
    for _ in range(6):
        eng.train_one_epoch()

    rec = Recommender(
        eng.state,
        cfg,
        seen_pairs=train.pairs,
        his_items=train.his_items,
        his_masks=train.masks,
    )
    ids = rec.recommend([0, 5, 17], k=20)
    assert ids.shape == (3, 20)
    seen = {(u, i) for u, i in map(tuple, train.pairs)}
    for row, u in zip(ids, (0, 5, 17)):
        for item in row:
            assert (u, int(item)) not in seen
    # recommendations recover held-out items well above chance
    hits = sum(
        len(set(map(int, rec_row)) & set(test.user_items[u]))
        for rec_row, u in zip(rec.recommend_all(20), range(120))
    )
    total_true = sum(len(t) for t in test.user_items)
    assert hits / total_true > 0.15

    # aggregated-user variant also works
    ids2 = rec.recommend([0], k=5, aggregate_users=True)
    assert ids2.shape == (1, 5)


def test_chunked_request_path_matches_one_shot(monkeypatch):
    """The huge-item-table chunked request path (item-axis scan with a
    running top-k merge, engaged above _CHUNKED_REQUEST_MIN_ITEMS) must
    reproduce the one-shot path's ranking exactly — forced on at small
    scale via the module thresholds."""
    import heat_cf.serving as serving

    train, test = synthetic_click_dataset(
        num_users=120, num_items=700, clicks_per_user=25, max_his=8, seed=6
    )
    cfg = CFConfig(
        emb_dim=16, num_negs=8, max_his=8, l_r=0.05, batch_size=256, seed=2
    )
    eng = Engine(cfg, train, test)
    for _ in range(3):
        eng.train_one_epoch()
    rec_one = serving.Recommender(eng.state, cfg, seen_pairs=train.pairs)
    assert not rec_one._chunked_request
    monkeypatch.setattr(serving, "_CHUNKED_REQUEST_MIN_ITEMS", 64)
    monkeypatch.setattr(serving, "_REQUEST_PAD_MULTIPLE", 256)
    rec_chunk = serving.Recommender(eng.state, cfg, seen_pairs=train.pairs)
    assert rec_chunk._chunked_request
    uids = list(range(0, 120, 3))
    ids_one = rec_one.recommend(uids, 10)
    ids_chunk = rec_chunk.recommend(uids, 10)
    np.testing.assert_array_equal(ids_chunk, ids_one)
    # The seen-mask contract holds on the padded arrays too.
    seen = {(u, i) for u, i in map(tuple, train.pairs)}
    for row, u in zip(ids_chunk, uids):
        for item in row:
            assert (u, int(item)) not in seen


def test_unmasked_retrieve_filter_path_matches_bitmap(monkeypatch):
    """The no-bitmap huge-table request path (top-(k+cap) unmasked
    retrieve + host-side seen filter) must reproduce the packed-bitmap
    path's ranking exactly — forced on by shrinking the bitmap budget
    and the chunk thresholds."""
    import heat_cf.evaluation.evaluator as ev_mod
    import heat_cf.serving as serving

    train, test = synthetic_click_dataset(
        num_users=120, num_items=700, clicks_per_user=25, max_his=8, seed=6
    )
    cfg = CFConfig(
        emb_dim=16, num_negs=8, max_his=8, l_r=0.05, batch_size=256, seed=2
    )
    eng = Engine(cfg, train, test)
    for _ in range(3):
        eng.train_one_epoch()
    rec_bitmap = serving.Recommender(eng.state, cfg, seen_pairs=train.pairs)
    assert rec_bitmap._bits_flat is not None
    monkeypatch.setattr(serving, "_CHUNKED_REQUEST_MIN_ITEMS", 64)
    monkeypatch.setattr(serving, "_REQUEST_PAD_MULTIPLE", 256)
    monkeypatch.setattr(ev_mod, "MASK_BITS_MAX_BYTES", 16)
    rec_filter = serving.Recommender(eng.state, cfg, seen_pairs=train.pairs)
    assert rec_filter._bits_flat is None and rec_filter._chunked_request
    assert rec_filter._seen_keys is not None
    # Small request slice (2*bpad < num_users) so the retrieve+filter
    # path is the one exercised, not the whole-table routing guard.
    uids = list(range(0, 120, 8))
    np.testing.assert_array_equal(
        rec_filter.recommend(uids, 10), rec_bitmap.recommend(uids, 10)
    )
    # A request covering most users routes to the whole-table ranking.
    all_uids = list(range(120))
    np.testing.assert_array_equal(
        rec_filter.recommend(all_uids, 10),
        rec_bitmap.recommend_all(10),
    )
    # No seen_pairs at all: plain unmasked top-k through the same path.
    rec_nomask = serving.Recommender(eng.state, cfg, seen_pairs=None)
    assert rec_nomask._chunked_request and rec_nomask._seen_keys is None
    ids = rec_nomask.recommend(uids, 10)
    assert ids.shape == (len(uids), 10)


def test_recommend_cold_from_history():
    """Cold-start: users scored purely from a history list (no trained
    row) must recover their held-out items above chance and never
    recommend the provided history back."""
    train, test = synthetic_click_dataset(
        num_users=120, num_items=300, clicks_per_user=25, max_his=8, seed=6
    )
    cfg = CFConfig(
        emb_dim=16, num_negs=8, max_his=8, l_r=0.05, batch_size=256, seed=2
    )
    eng = Engine(cfg, train, test)
    for _ in range(6):
        eng.train_one_epoch()
    rec = Recommender(eng.state, cfg, seen_pairs=train.pairs)

    # Treat existing users as cold: feed only their click history.
    user_hist = [[] for _ in range(120)]
    for u, i in train.pairs:
        user_hist[u].append(int(i))
    ids = rec.recommend_cold(user_hist, k=20)
    assert ids.shape == (120, 20)
    hits = 0
    for u in range(120):
        row = set(map(int, ids[u]))
        assert not (row & set(user_hist[u])), "history leaked into top-k"
        hits += len(row & set(test.user_items[u]))
    total_true = sum(len(t) for t in test.user_items)
    assert hits / total_true > 0.10, hits / total_true

    # Empty input and empty history are well-defined.
    assert rec.recommend_cold([], k=5).shape == (0, 5)
    assert rec.recommend_cold([[]], k=5).shape == (1, 5)


def test_recommender_accepts_engine_flat_history():
    """Engine stores history flat (U*H,) for small max_his; Recommender's
    aggregate_users path must accept that layout (and match the 2-D one)."""
    train, _ = synthetic_click_dataset(
        num_users=60, num_items=150, clicks_per_user=12, max_his=6, seed=4
    )
    cfg = CFConfig(
        emb_dim=16, num_negs=4, max_his=6, l_r=0.05, batch_size=128, seed=2
    )
    eng = Engine(cfg, train)
    eng.train_one_epoch()
    assert eng.his_items.ndim == 1  # the flat layout is what's under test

    rec_flat = Recommender(
        eng.state,
        cfg,
        seen_pairs=train.pairs,
        his_items=eng.his_items,
        his_masks=eng.his_masks,
    )
    rec_2d = Recommender(
        eng.state,
        cfg,
        seen_pairs=train.pairs,
        his_items=train.his_items,
        his_masks=train.masks,
    )
    np.testing.assert_array_equal(
        rec_flat.recommend_all(10, aggregate_users=True),
        rec_2d.recommend_all(10, aggregate_users=True),
    )


def test_recommender_with_emb_pad_state():
    """Serving from a lane-padded state (CFConfig.emb_pad): the zero tail
    columns change no score, so recommendations match the unpadded
    model's exactly (same seeds -> same init real block)."""
    train, test = synthetic_click_dataset(
        num_users=80, num_items=200, clicks_per_user=20, max_his=6, seed=9
    )
    kw = dict(
        emb_dim=16, num_negs=8, max_his=6, l_r=0.02, batch_size=4096,
        seed=4,
    )
    e_base = Engine(CFConfig(**kw), train, test)
    e_pad = Engine(CFConfig(**kw, emb_pad=128), train, test)
    e_base.train_one_epoch()  # single step: f32 grouping drift only
    e_pad.train_one_epoch()
    rec_base = Recommender(e_base.state, e_base.cfg, seen_pairs=train.pairs,
                           his_items=train.his_items, his_masks=train.masks)
    rec_pad = Recommender(e_pad.state, e_pad.cfg, seen_pairs=train.pairs,
                          his_items=train.his_items, his_masks=train.masks)
    np.testing.assert_array_equal(
        rec_pad.recommend([0, 3, 7], k=10),
        rec_base.recommend([0, 3, 7], k=10),
    )
    # Cold-start aggregation flows at the padded width too.
    cold = rec_pad.recommend_cold([[1, 2, 3]], k=5)
    assert cold.shape == (1, 5)


def test_recommender_emb_pad_attention_state():
    """Round 5 (emb_pad x attention): serving from a lane-padded
    user_attention state — the softmax uses the logical width
    (pool_history logical_dim), so aggregated recommendations match the
    unpadded model's, and cold-start flows at the padded width."""
    train, test = synthetic_click_dataset(
        num_users=80, num_items=200, clicks_per_user=20, max_his=6, seed=9
    )
    kw = dict(
        emb_dim=16, num_negs=8, max_his=6, l_r=0.02, batch_size=4096,
        seed=4, aggregator="user_attention",
    )
    e_base = Engine(CFConfig(**kw), train, test)
    e_pad = Engine(CFConfig(**kw, emb_pad=128), train, test)
    e_base.train_one_epoch()
    e_pad.train_one_epoch()
    rec_base = Recommender(e_base.state, e_base.cfg, seen_pairs=train.pairs,
                           his_items=train.his_items, his_masks=train.masks)
    rec_pad = Recommender(e_pad.state, e_pad.cfg, seen_pairs=train.pairs,
                          his_items=train.his_items, his_masks=train.masks)
    np.testing.assert_array_equal(
        rec_pad.recommend([0, 3, 7], k=10, aggregate_users=True),
        rec_base.recommend([0, 3, 7], k=10, aggregate_users=True),
    )
    cold = rec_pad.recommend_cold([[1, 2, 3]], k=5)
    assert cold.shape == (1, 5)


def test_recommender_sparse_seen_ids():
    """Seen pairs whose max item id sits far below the item count must not
    shrink the request path's mask width (the evaluator would otherwise
    infer num_items from the pairs)."""
    train, test = synthetic_click_dataset(
        num_users=60, num_items=150, clicks_per_user=10, max_his=6, seed=2
    )
    cfg = CFConfig(emb_dim=16, num_negs=4, max_his=6, batch_size=512, seed=1)
    eng = Engine(cfg, train, test)
    eng.train_one_epoch()
    # Only low-id items are "seen": max seen id 19 << 150 items.
    seen = np.stack(
        [np.arange(20, dtype=np.int32), np.arange(20, dtype=np.int32)], 1
    )
    rec = Recommender(eng.state, cfg, seen_pairs=seen)
    ids = rec.recommend(list(range(20)), k=10)
    assert ids.shape == (20, 10) and ids.max() < 150
    for u in range(20):
        assert u not in set(map(int, ids[u]))  # the (u, u) seen pair masked


def test_from_engine_mesh_sharded_state():
    """Recommender.from_engine on a single-process MESH engine:
    divisibility-padding rows are sliced off (odd item count
    forces padding on the model axis), pad items never surface in
    results, and the request path matches a Recommender built by hand on
    the unpadded state."""
    import jax

    from heat_cf.parallel.mesh import make_mesh

    train, test = synthetic_click_dataset(
        num_users=96, num_items=47, clicks_per_user=12, max_his=6, seed=3
    )
    cfg = CFConfig(
        emb_dim=16, num_negs=4, max_his=6, batch_size=64, l_r=0.05,
        clip_val=0.5, seed=9,
    )
    mesh = make_mesh(2, 4, jax.devices()[:8])
    eng = Engine(cfg, train, test, mesh=mesh)
    for _ in range(2):
        eng.train_one_epoch()
    assert eng._pad_items > 0  # 47 does not divide the model axis
    rec = Recommender.from_engine(eng)
    assert rec.state.user_emb.shape[0] == 96
    assert rec.state.item_emb.shape[0] == 47
    uids = np.asarray([0, 5, 17, 95])
    got = rec.recommend(uids, 5)
    assert got.shape == (4, 5) and got.max() < 47
    manual = Recommender(
        eng.unpadded_state(), cfg,
        seen_pairs=np.asarray(train.pairs),
        his_items=train.his_items, his_masks=train.masks,
    )
    np.testing.assert_array_equal(got, manual.recommend(uids, 5))
    np.testing.assert_array_equal(
        rec.recommend_all(5), manual.recommend_all(5)
    )
    # Cold-start flows from the mesh-trained state too.
    cold = rec.recommend_cold([[1, 2, 3]], 5)
    assert cold.shape == (1, 5) and cold.max() < 47
