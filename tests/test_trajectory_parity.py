"""Epoch-LEVEL trajectory parity of the Engine against the sequential oracle.

test_parity.py asserts step-level parity on a single batch; this module
closes the gap to the reference's de-facto integration test (the README
Step 6 loss trajectory — unreproducible here, see DATA.md) by driving the
FULL Engine for several epochs and comparing against tests/oracle.py run
sample-by-sample:

* exact test: a medium dataset constructed so every parse-order batch of 32
  is id-disjoint (users unique per block; pos/neg ids disjoint per block;
  histories in a reserved never-updated id range), negatives pinned to the
  same per-sample draws on both sides. The engine's per-epoch loss curve
  and final tables must match the oracle to f32-drift tolerance.
  Reference anchors: engine.cpp:380-384 (loss accounting),
  engine.cpp:345-347 (grad tables zeroed at every sub-epoch end),
  matrix_factorization.cpp:15-181 (per-sample kernel).

* statistical test: planted-cluster data with realistic histories, each
  side drawing its own negatives — per-epoch losses must track within a
  small relative band and final Recall@20 must agree.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracle
from heat_cf.config import CFConfig
from heat_cf.data.datasets import ClickDataset
from heat_cf.data.synthetic import synthetic_click_dataset
from heat_cf.evaluation.evaluator import TiledEvaluator
from heat_cf.evaluation.metrics import evaluate_metrics
from heat_cf.train.engine import Engine
from heat_cf.train.samplers import NegSample


def _block_disjoint_dataset(rng, num_users, items_train, num_items, max_his,
                            block, n_blocks, num_negs):
    """Pairs whose consecutive parse-order blocks of ``block`` samples have
    unique users and globally-disjoint pos/neg ids within the block, with
    histories drawn from the reserved range [items_train, num_items) that
    no pos/neg ever updates — the conditions under which a batched step is
    exactly equivalent to the sequential reference kernel."""
    pairs, negs = [], []
    for _ in range(n_blocks):
        users = rng.choice(num_users, size=block, replace=False)
        ids = rng.choice(items_train, size=block * (1 + num_negs),
                         replace=False)
        pos = ids[:block]
        neg = ids[block:].reshape(block, num_negs)
        pairs.append(np.stack([users, pos], axis=1))
        negs.append(neg)
    pairs = np.concatenate(pairs).astype(np.int32)
    negs = np.concatenate(negs).astype(np.int32)
    his = rng.integers(items_train, num_items,
                       (num_users, max_his)).astype(np.int32)
    masks = rng.integers(1, max_his + 1, (num_users,)).astype(np.int32)
    data = ClickDataset(
        pairs=pairs,
        his_items=his,
        masks=masks,
        num_users=num_users,
        num_items=num_items,
        max_his=max_his,
        user_items=[np.empty(0, np.int32)] * num_users,
    )
    return data, negs


def _run_oracle_epochs(m, data, neg_draws, cfg, epochs, zero_at_epoch_end):
    """Sequential oracle over ``epochs`` parse-order passes; returns the
    per-epoch mean losses. ``neg_draws`` is (epochs * N, K)."""
    n = data.train_size
    losses = []
    for e in range(epochs):
        total = 0.0
        for i in range(n):
            u, p = int(data.pairs[i, 0]), int(data.pairs[i, 1])
            total += oracle.forward_backward(
                m, u, p, list(neg_draws[e * n + i]),
                data.his_items, data.masks,
                lr=cfg.l_r, clip_val=cfg.clip_val, gamma=cfg.gamma,
                score_mul=cfg.score_mul, aggr_minibatch=cfg.aggr_minibatch,
            )
        if zero_at_epoch_end:
            m.user_gacc[:] = 0.0
            m.item_gacc[:] = 0.0
        losses.append(total / n)
    return losses


def _run_oracle_epochs_order(m, data, neg_draws, cfg, epochs, order):
    """Like _run_oracle_epochs but visiting samples in ``order`` (a
    permutation that must be semantically neutral, i.e. only permute within
    id-disjoint blocks)."""
    n = data.train_size
    losses = []
    for e in range(epochs):
        total = 0.0
        for i in order:
            u, p = int(data.pairs[i, 0]), int(data.pairs[i, 1])
            total += oracle.forward_backward(
                m, u, p, list(neg_draws[e * n + i]),
                data.his_items, data.masks,
                lr=cfg.l_r, clip_val=cfg.clip_val, gamma=cfg.gamma,
                score_mul=cfg.score_mul, aggr_minibatch=cfg.aggr_minibatch,
            )
        m.user_gacc[:] = 0.0
        m.item_gacc[:] = 0.0
        losses.append(total / n)
    return losses


def test_multi_epoch_trajectory_matches_oracle_exactly():
    """3 full epochs through the Engine vs the sequential oracle, with
    pinned negatives and aligned parse order.

    Tolerance is *measured*, not guessed: per-sample SGD at this lr is
    chaotic — the oracle run against itself with a semantically-neutral
    reordering (reversing each id-disjoint block, which only changes f32
    summation order) already drifts ~0.03%/0.6%/1.0% in per-epoch loss and
    completely decorrelates table elements by epoch 3. The engine is
    required to stay within 3x that self-drift envelope per epoch (plus a
    1e-3 floor for the first epoch where self-drift is near zero), which
    pins the semantics while respecting f32 chaos. Element-wise final-table
    parity is asserted at step level in test_parity.py where it is
    well-defined."""
    rng = np.random.default_rng(7)
    B, K, H, D = 32, 4, 8, 32
    U, I_TRAIN, I = 512, 1536, 2048
    N_BLOCKS, EPOCHS = 128, 3
    data, base_negs = _block_disjoint_dataset(
        rng, U, I_TRAIN, I, H, B, N_BLOCKS, K
    )
    n = data.train_size
    assert n % B == 0 and n % 32 == 0  # w0 minibatch cadence alignment
    # Fresh pinned draws per epoch, same schedule for both sides.
    per_epoch = [base_negs]
    for e in range(1, EPOCHS):
        # Re-derive block-disjoint negatives for later epochs the same way.
        blocks = []
        for b0 in range(N_BLOCKS):
            blocks.append(
                rng.choice(I_TRAIN, size=B * K, replace=False).reshape(B, K)
            )
        per_epoch.append(np.concatenate(blocks).astype(np.int32))
    neg_draws = np.concatenate(per_epoch, axis=0)  # (EPOCHS * n, K)

    cfg = CFConfig(
        emb_dim=D, max_his=H, num_negs=K, batch_size=B,
        l_r=0.05, clip_val=0.5, sgd_mode="accum", shuffle_mode="none",
        his_refresh="step", seed=11,
    )

    engine = Engine(cfg, data, seed=11)
    # The oracle starts from the engine's initialized tables.
    init = (
        np.asarray(engine.state.user_emb),
        np.asarray(engine.state.item_emb),
        np.asarray(engine.state.w0),
    )
    m = oracle.OracleModel.create(*init)
    oracle_losses = _run_oracle_epochs(
        m, data, neg_draws, cfg, EPOCHS, zero_at_epoch_end=True
    )
    # Control: the same oracle under a neutral reordering (reverse each
    # id-disjoint block) measures pure f32 summation-order drift.
    m_ctrl = oracle.OracleModel.create(*init)
    rev_order = np.concatenate(
        [np.arange(b * B, (b + 1) * B)[::-1] for b in range(N_BLOCKS)]
    )
    ctrl_losses = _run_oracle_epochs_order(
        m_ctrl, data, neg_draws, cfg, EPOCHS, rev_order
    )

    # Pin the engine's negative draws to the same schedule, indexed by the
    # sampler's cumulative sample counter.
    import heat_cf.train.train_step as ts

    neg_table = jnp.asarray(neg_draws)
    orig = ts.sample_negatives

    def pinned(key, sstate, pos_ids, _cfg, real=None):
        b = pos_ids.shape[0]
        idx = sstate.iterations + jnp.arange(b, dtype=jnp.int32)
        return (
            NegSample(neg_table[idx], None, None),
            sstate.replace(iterations=sstate.iterations + b),
        )

    engine_losses = []
    try:
        ts.sample_negatives = pinned
        for _ in range(EPOCHS):
            engine_losses.append(engine.train_one_epoch())
    finally:
        ts.sample_negatives = orig

    for e in range(EPOCHS):
        self_drift = abs(ctrl_losses[e] - oracle_losses[e])
        band = max(3.0 * self_drift, 1e-3 * oracle_losses[e])
        diff = abs(engine_losses[e] - oracle_losses[e])
        assert diff <= band, (
            f"epoch {e}: engine {engine_losses[e]:.6f} vs oracle "
            f"{oracle_losses[e]:.6f} (|diff| {diff:.2e} > band {band:.2e}; "
            f"neutral-order self-drift {self_drift:.2e})"
        )
    # Both trajectories must actually descend in lockstep shape.
    assert engine_losses[0] > engine_losses[1] > engine_losses[2]


def _overlapping_block_dataset(rng, num_users, items_train, num_items,
                               max_his, block, n_blocks, num_negs):
    """Like _block_disjoint_dataset, but consecutive parse-order blocks
    SHARE half their users and half their pos/neg ids with the previous
    block (ids still disjoint WITHIN each block, histories reserved) —
    every step reads user rows and grad-accumulator rows the previous
    step just updated, and positives recur while their accumulated
    gradients are hot. This is the cross-step read-after-write /
    accumulator stress the fully block-disjoint dataset cannot exert."""
    pairs, negs = [], []
    prev_users = prev_ids = None
    half_u = block // 2
    m_ids = block * (1 + num_negs)
    half_i = m_ids // 2
    for _ in range(n_blocks):
        if prev_users is None:
            users = rng.choice(num_users, size=block, replace=False)
            ids = rng.choice(items_train, size=m_ids, replace=False)
        else:
            keep_u = rng.choice(prev_users, size=half_u, replace=False)
            pool_u = np.setdiff1d(np.arange(num_users), keep_u)
            users = np.concatenate([
                keep_u,
                rng.choice(pool_u, size=block - half_u, replace=False),
            ])
            rng.shuffle(users)
            keep_i = rng.choice(prev_ids, size=half_i, replace=False)
            pool_i = np.setdiff1d(np.arange(items_train), keep_i)
            ids = np.concatenate([
                keep_i,
                rng.choice(pool_i, size=m_ids - half_i, replace=False),
            ])
            rng.shuffle(ids)
        prev_users, prev_ids = users, ids
        pairs.append(np.stack([users, ids[:block]], axis=1))
        negs.append(ids[block:].reshape(block, num_negs))
    pairs = np.concatenate(pairs).astype(np.int32)
    negs = np.concatenate(negs).astype(np.int32)
    his = rng.integers(items_train, num_items,
                       (num_users, max_his)).astype(np.int32)
    masks = rng.integers(1, max_his + 1, (num_users,)).astype(np.int32)
    data = ClickDataset(
        pairs=pairs,
        his_items=his,
        masks=masks,
        num_users=num_users,
        num_items=num_items,
        max_his=max_his,
        user_items=[np.empty(0, np.int32)] * num_users,
    )
    return data, negs


def test_overlapping_blocks_trajectory_matches_oracle():
    """The exact engine-vs-oracle comparison on OVERLAPPING consecutive
    blocks: half of each step's users/items were updated by the previous
    step, so accum-mode gamma-decay on revisited user-grad rows, the
    clipped item accumulators under immediate reuse, and the epoch-end
    accumulator zeroing are all exercised under read-after-write ACROSS
    steps — which the block-disjoint case never triggers. Within-block
    disjointness keeps batch == sequential exact, so at a SHORT horizon
    (24 steps/epoch — before f32 chaos can amplify the per-step
    reduction-order drift; at 96 blocks the loss drift alone reaches
    ~2% regardless of semantics, measured against ulp-perturbation
    controls) the comparison can be near-bit: per-epoch losses to 0.1%
    and final tables elementwise to 1e-4."""
    rng = np.random.default_rng(17)
    B, K, H, D = 32, 4, 8, 32
    U, I_TRAIN, I = 256, 1024, 1536
    N_BLOCKS, EPOCHS = 8, 3
    data, base_negs = _overlapping_block_dataset(
        rng, U, I_TRAIN, I, H, B, N_BLOCKS, K
    )
    n = data.train_size
    assert n % B == 0 and n % 32 == 0
    per_epoch = [base_negs]
    for _ in range(1, EPOCHS):
        blocks = []
        for b0 in range(N_BLOCKS):
            # Fresh negatives disjoint from this block's positives (and
            # from each other) so within-block exactness is preserved.
            block_pos = data.pairs[b0 * B : (b0 + 1) * B, 1]
            pool = np.setdiff1d(np.arange(I_TRAIN), block_pos)
            blocks.append(
                rng.choice(pool, size=B * K, replace=False).reshape(B, K)
            )
        per_epoch.append(np.concatenate(blocks).astype(np.int32))
    neg_draws = np.concatenate(per_epoch, axis=0)

    cfg = CFConfig(
        emb_dim=D, max_his=H, num_negs=K, batch_size=B,
        l_r=0.05, clip_val=0.5, sgd_mode="accum", shuffle_mode="none",
        his_refresh="step", seed=23,
    )
    engine = Engine(cfg, data, seed=23)
    init = (
        np.asarray(engine.state.user_emb),
        np.asarray(engine.state.item_emb),
        np.asarray(engine.state.w0),
    )
    m = oracle.OracleModel.create(*init)
    oracle_losses = _run_oracle_epochs(
        m, data, neg_draws, cfg, EPOCHS, zero_at_epoch_end=True
    )

    import heat_cf.train.train_step as ts

    neg_table = jnp.asarray(neg_draws)
    orig = ts.sample_negatives

    def pinned(key, sstate, pos_ids, _cfg, real=None):
        b = pos_ids.shape[0]
        idx = sstate.iterations + jnp.arange(b, dtype=jnp.int32)
        return (
            NegSample(neg_table[idx], None, None),
            sstate.replace(iterations=sstate.iterations + b),
        )

    engine_losses = []
    try:
        ts.sample_negatives = pinned
        for _ in range(EPOCHS):
            engine_losses.append(engine.train_one_epoch())
    finally:
        ts.sample_negatives = orig

    for e in range(EPOCHS):
        diff = abs(engine_losses[e] - oracle_losses[e])
        assert diff <= 1e-3 * oracle_losses[e], (
            f"epoch {e}: engine {engine_losses[e]:.6f} vs oracle "
            f"{oracle_losses[e]:.6f}"
        )
    # Final tables elementwise, quantile-based. Measured envelope:
    # per-step f32 drift ~1e-6/row; elements whose accumulator sits at
    # the clip threshold can bifurcate (clip's kink) and retain ~1e-2 —
    # but only a HANDFUL do (8/49k measured). A semantic bug in the
    # revisit path (wrong gamma decay, wrong clip composition) perturbs
    # EVERY revisited row (~half the touched rows) at ~lr*clip scale,
    # failing both the 99.9%-tight criterion and the hard cap.
    def mostly_equal(got, want, tight=1e-3, frac=0.999, hard=3e-2):
        diff = np.abs(np.asarray(got) - want)
        assert (diff <= tight).mean() >= frac, (
            f"only {(diff <= tight).mean():.5f} of elements within "
            f"{tight} (max {diff.max():.2e})"
        )
        assert diff.max() <= hard, diff.max()

    mostly_equal(engine.state.user_emb, m.user_emb)
    mostly_equal(engine.state.item_emb, m.item_emb)
    mostly_equal(engine.state.w0, m.w0, tight=1e-4, hard=1e-3)


def test_dedup_multi_epoch_trajectory_identical():
    """History-gather dedup over MULTI-EPOCH training with user-grouped
    parse order (heavy in-batch user duplication -> the uniq_users path
    is active) and accum-mode grad tables: dedup-on vs dedup-off engines
    must produce numerically identical trajectories and tables — the
    dedup/accumulator interaction across epochs that the single-step
    equivalence check cannot cover."""
    train, _ = synthetic_click_dataset(
        60, 200, clicks_per_user=20, max_his=6, seed=9
    )
    order = np.argsort(train.pairs[:, 0], kind="stable")
    train = dataclasses.replace(train, pairs=train.pairs[order])
    kw = dict(
        emb_dim=16, max_his=6, num_negs=4, batch_size=64,
        l_r=0.05, clip_val=0.5, sgd_mode="accum", shuffle_mode="none",
        his_refresh="step", seed=21,
    )
    e_on = Engine(CFConfig(**kw), train, seed=21)
    losses_on = e_on.train_epochs(3)
    cache = getattr(e_on, "_dedup_cache", None)
    assert cache is not None and cache[1] is not None, (
        "dedup path did not engage — the test is vacuous"
    )
    e_off = Engine(CFConfig(**kw), train, seed=21)
    e_off._history_dedup = lambda *a, **k: None
    losses_off = e_off.train_epochs(3)
    np.testing.assert_allclose(losses_on, losses_off, rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(e_on.state.user_emb),
        np.asarray(e_off.state.user_emb),
        rtol=1e-5, atol=1e-7,
    )
    np.testing.assert_allclose(
        np.asarray(e_on.state.item_emb),
        np.asarray(e_off.state.item_emb),
        rtol=1e-5, atol=1e-7,
    )


def test_trajectory_tracks_oracle_statistically():
    """Real-shaped data (planted clusters, ragged histories, duplicate ids
    inside batches), each side drawing its own negatives: the loss curves
    must track and the final ranking metrics must agree."""
    U, I, H, K, EPOCHS = 400, 800, 10, 4, 3
    train, test = synthetic_click_dataset(
        U, I, clicks_per_user=24, max_his=H, seed=3
    )
    # Parse order groups each user's clicks consecutively, which would put
    # ~B/14 duplicate user rows in every batch — a genuinely different
    # (minibatch) algorithm than the sequential reference. Pre-shuffle ONCE
    # with a shared permutation so both sides walk the same decorrelated
    # order; residual in-batch duplicates are the honest price of batching
    # and are covered by the tolerance band.
    perm = np.random.default_rng(123).permutation(train.train_size)
    train = dataclasses.replace(train, pairs=train.pairs[perm])
    cfg = CFConfig(
        emb_dim=32, max_his=H, num_negs=K, batch_size=64,
        l_r=0.05, clip_val=0.5, sgd_mode="accum", shuffle_mode="none",
        his_refresh="step", ignore_pos=True, seed=5,
    )
    engine = Engine(cfg, train, test_data=test, seed=5)
    m = oracle.OracleModel.create(
        np.asarray(engine.state.user_emb),
        np.asarray(engine.state.item_emb),
        np.asarray(engine.state.w0),
    )
    n = train.train_size
    rng = np.random.default_rng(99)
    draws = rng.integers(0, train.num_items, (EPOCHS * n, K)).astype(np.int32)
    # ignore_pos: redraw collisions once (the distributional equivalent of
    # uniform_random_negative_sampler.cpp:26-36).
    pos_col = np.tile(train.pairs[:, 1][:, None], (EPOCHS, K))
    redraw = rng.integers(0, train.num_items, draws.shape).astype(np.int32)
    draws = np.where(draws == pos_col, redraw, draws)
    oracle_losses = _run_oracle_epochs(
        m, train, draws, cfg, EPOCHS, zero_at_epoch_end=True
    )
    engine_losses = [engine.train_one_epoch() for _ in range(EPOCHS)]

    # Same data, same order, same hyperparameters, independent negative
    # streams. Epoch 1 carries the honest batching difference (in-batch
    # duplicate users read stale rows while gradients are still large:
    # measured 7.4% here) and the trajectories then CONVERGE (2.9%, 0.8%)
    # — so the band tightens per epoch, which a semantically-broken step
    # cannot satisfy. Bands are ~2x the measured envelope, so e.g. a ~5%
    # scale bug inside epochs 2-3 now fails.
    bands = [0.10, 0.058, 0.016]
    for (le, lo), band in zip(zip(engine_losses, oracle_losses), bands):
        assert abs(le - lo) / lo < band, (engine_losses, oracle_losses)
    # Loss must actually decrease across epochs on both sides.
    assert engine_losses[-1] < engine_losses[0] * 0.9
    assert oracle_losses[-1] < oracle_losses[0] * 0.9

    # Final ranking quality parity (the paper's Recall@20 +-0.0003 claim is
    # against run-to-run variance; planted clusters at this scale have
    # higher variance, so the band is wider but still discriminative).
    metrics = ["Recall(k=20)"]
    eng = engine.evaluate(metrics)["Recall(k=20)"]
    ev = TiledEvaluator(train.pairs, U, num_items=train.num_items)
    _, ids = ev.topk(m.user_emb, m.item_emb, 20)
    orc = evaluate_metrics(metrics, ids, test.user_items)["Recall(k=20)"]
    assert eng > 3 * (20.0 / I)  # well above the random-ranking baseline
    assert abs(eng - orc) / orc < 0.15, (eng, orc)
